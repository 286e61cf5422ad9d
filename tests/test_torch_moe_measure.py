"""Port vs reference: the measurement of MoE search points.

* The committed corpus's mixtral-8x7b witnesses and controls
  (``parity.corpus_points(..., moe=True)``): the port reports the kinds of
  a fresh run of the reference (not the committed verdicts: both A1
  witnesses show no A1 in the reference today), except the listed
  ``parity.KIND_DIFFERENCES`` (both kind sets and the deciding counter's
  values); the useful-FLOP ratio within ``parity.USEFUL_RATIO_REL_BOUND``
  of the reference's, except the listed differences; ``parity.REFERENCE``
  keeps the reference's values for the card.
* MoE points of ``benchmarks/results/bench_fidelity_pairs.json``: train_s
  under every preset (on both meshes, and with 4 microbatches under ep),
  and a decode, a prefill and a long point, measured by the port's engine
  and held to the reference's kinds today, except
  ``parity.PAIR_KIND_DIFFERENCES``.

No trace fails, and only the ops ``parity.REPLICATED_OPS`` admits at a
point's class run replicated.  The reference measures in a subprocess with
32 host devices while the port traces (as ``test_torch_measure.py``).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.core import anomaly as ref_anomaly
from repro_torch.core import anomaly, parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.counters import measure_cell
from repro_torch.core.engine import Engine
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch.steps import build_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS = ROOT / "benchmarks" / "results" / "anomaly_corpus.json"
PAIRS = ROOT / "benchmarks" / "results" / "bench_fidelity_pairs.json"
POINTS = parity.corpus_points(CORPUS, moe=True)
META = json.loads(CORPUS.read_text())["meta"]
# pairs-file MoE points (mixtral-8x7b) by index: train_s under dp (multi),
# fsdp (multi), tp (single, remat dots) and ep (multi; single with 4
# microbatches); decode_s under dp, prefill_s under ep, long_s under fsdp
MOE_PAIR_INDICES = (111, 109, 18, 89, 45, 31, 40, 53)


def _moe_pairs():
    data = json.loads(PAIRS.read_text())
    return ({i: tuple(data["pairs"][i]) for i in MOE_PAIR_INDICES},
            data["archs"], data["restrict"])


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """Both packages' counters at the corpus's MoE points and the chosen
    pairs points: -> (corpus rows [(port, reference)], pairs rows
    [(index, point, port counters, reference counters)], the engine)."""
    pairs, p_archs, p_restrict = _moe_pairs()
    pair_pts = [pairs[i][0] for i in MOE_PAIR_INDICES]
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = []
    for name, pts, archs, restrict in (("corpus", [p for *_, p in POINTS], META["archs"],
                                        META["restrict"]),
                                       ("pairs", pair_pts, p_archs, p_restrict)):
        arg = tmp / f"{name}.json"
        arg.write_text(json.dumps([pts, archs, restrict]))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "reference_counters.py"), str(arg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    space = SearchSpace(bench_archs(META["archs"]), BENCH_SHAPES,
                        restrict={k: tuple(v) for k, v in META["restrict"].items()})
    meshes = bench_meshes()
    port = []
    for _, _, _, p in POINTS:
        cfg, shape, policy, mk = space.to_run(space.normalize(p))
        m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]), device="cpu")
        port.append({"counters": m.counters(), "kinds": sorted(anomaly.kinds(m.counters(),
                                                                             policy.remat)),
                     "unlisted_replications": parity.unlisted_replications(
                         m.hlo["replicated_ops"], cfg.name, policy.sharding_preset,
                         shape.kind, policy.n_microbatch)})
    pspace = SearchSpace(bench_archs(p_archs), BENCH_SHAPES,
                         restrict={k: tuple(v) for k, v in p_restrict.items()})
    eng = Engine(pspace, meshes, persistent_cache=False, device="cpu")
    got = eng.measure_batch(pair_pts)
    eng.close()
    ref = []
    for proc in procs:
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        ref.append(json.loads(out.strip().splitlines()[-1]))
    pair_rows = [(i, p, c, r) for i, p, c, r in zip(MOE_PAIR_INDICES, pair_pts, got, ref[1])]
    return list(zip(port, ref[0])), pair_rows, eng


def test_corpus_has_four_moe_witnesses_and_two_controls():
    roles = [role for _, _, role, _ in POINTS]
    assert roles.count("witness") == 4 and roles.count("control") == 2
    assert {p["arch"] for *_, p in POINTS} == {"mixtral-8x7b"}


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{s}-{r}-{p['shape']}-{p['preset']}-mb{p['n_microbatch']}"
                              for s, _, r, p in POINTS])
def test_moe_corpus_point_matches_reference(measured, i):
    sig, kind, role, p = POINTS[i]
    port, ref = measured[0][i]
    ref_kinds = tuple(sorted(ref_anomaly.kinds(ref, p["remat"])))
    got, want = port["counters"]["perf.useful_flops_ratio"], ref["perf.useful_flops_ratio"]
    print(f"{sig} {role} {parity.point_key(p)} x{p['n_microbatch']}: port {port['kinds']} "
          f"ref {ref_kinds}; useful {got:.4f} vs {want:.4f}")
    key = parity.corpus_key(p, role)
    assert parity.REFERENCE[key] == (ref_kinds, round(want, 4))
    listed = parity.KIND_DIFFERENCES.get(key)
    if listed is None:
        assert tuple(port["kinds"]) == ref_kinds
    else:
        kinds_port, kinds_ref, counter, v_port, v_ref, _ = listed
        assert (tuple(port["kinds"]), ref_kinds) == (kinds_port, kinds_ref)
        assert (f"{port['counters'][counter]:.4g}", f"{ref[counter]:.4g}") == \
            (f"{v_port:.4g}", f"{v_ref:.4g}")
    assert tuple(port["kinds"]) == parity.expected_kinds(p, role)
    assert parity.useful_ok(key, got, want), (got, want)
    assert port["unlisted_replications"] == []
    assert port["counters"]["diag.shard_fallbacks"] == ref["diag.shard_fallbacks"]


@pytest.mark.parametrize("j", range(len(MOE_PAIR_INDICES)),
                         ids=[str(i) for i in MOE_PAIR_INDICES])
def test_moe_pair_point_kinds_match_reference(measured, j):
    _, rows, eng = measured
    i, p, port_counters, now = rows[j]
    assert eng.n_failures == 0, eng.errors
    assert not parity.unlisted_at(eng.replicated_at)
    assert port_counters is not None
    got = tuple(sorted(anomaly.kinds(port_counters, p["remat"])))
    now_kinds = tuple(sorted(ref_anomaly.kinds(now, p["remat"])))
    listed = parity.PAIR_KIND_DIFFERENCES.get(i)
    if listed is None:
        assert got == now_kinds, (p, port_counters, now)
        return
    port_kinds, ref_kinds, values, _ = listed
    assert (got, now_kinds) == (port_kinds, ref_kinds)
    for counter, (port_v, ref_v) in values.items():
        assert port_counters[counter] == pytest.approx(port_v, rel=1e-3)
        assert now[counter] == pytest.approx(ref_v, rel=1e-3)
