"""The port's engine and search on real traces (fake ``cpu`` tensors).

* Simulated annealing over a small non-MoE bench space (qwen2-1.5b-bench,
  decode points) gives the same trajectory at ``n_workers`` 1 and 3, with no
  failed trace; the traces are serialised by ``counters.TRACE_LOCK`` (no
  two ever run at once, at a short switch interval), so the threads change
  nothing but who waits.
* A warm run on the persistent cache does no trace at all and gives the
  same trajectory.
* A point's ``lower_cell`` fingerprint and its counters are equal in two
  processes with different ``PYTHONHASHSEED``s.
* Points of ``benchmarks/results/bench_fidelity_pairs.json`` that need no
  MoE, decode, long, prefill and train points under every preset (dp and
  fsdp train points with and without microbatches, on both meshes), get
  counters from the port's engine (two whose traces take minutes from an
  engine of their own without the structural dedup, a process each beside
  it) whose kinds equal the
  reference's, or are listed in ``core/parity.py`` with both values; the
  kinds ``chip_smoke.py`` holds the card to (``parity.SMOKE_PAIRS``) are the
  fresh reference's.  The reference is run
  afresh on the same points (``reference_counters.py``, in a subprocess
  with 32 host devices): its
  kinds equal those of the file's stored counters, or the point is listed
  in ``parity.PAIR_STORED_DIFFERENCES`` with both values.
* At the dp train point on the multi mesh with 1, 4 and 16 microbatches the
  port's useful-FLOP ratio and wire bytes, and the fresh reference's, equal
  ``parity.MICROBATCH_COUNTERS``; at 16 the port's kinds are the
  reference's.
* Ops run replicated only where ``parity.REPLICATED_OPS`` admits them at
  the traced point's class.

The fake process group the first trace starts stays for the worker's life
(see ``test_torch_measure.py``).
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
from repro_torch.core.engine import Engine
from repro_torch.core.sa import simulated_annealing
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch import steps

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAIRS = ROOT / "benchmarks" / "results" / "bench_fidelity_pairs.json"


def decode_space():
    return SearchSpace(bench_archs(["qwen2-1.5b"]), BENCH_SHAPES,
                       restrict={"shape": ("decode_s",), "grad_compress": ("none",)})


def _trajectory(r):
    return ([(sorted(e.point.items()), sorted(e.kinds), e.counter_value, e.n_spent,
              None if e.new_mfs is None else
              (e.new_mfs.kind, sorted(e.new_mfs.conditions.items()), e.new_mfs.n_tests))
             for e in r.events],
            [(m.kind, sorted(m.conditions.items()), sorted(m.witness.items()))
             for m in r.anomalies],
            r.n_attempts)


def _search(n_workers, cache):
    space = decode_space()
    eng = Engine(space, bench_meshes(), n_workers=n_workers, persistent_cache=cache,
                 device="cpu")
    r = simulated_annealing(eng, space, "perf.useful_flops_ratio", "min", seed=2,
                            budget_compiles=10)
    eng.close()
    return _trajectory(r), eng


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The serial run, the threaded run (a short switch interval, every
    trace's entry and exit counted) and the warm run."""
    cache = str(tmp_path_factory.mktemp("cache") / "c.sqlite")
    serial = _search(1, cache)
    active, overlap = [0], [0]
    run = steps.Cell._run

    def counted(self, *args, **kwargs):
        active[0] += 1
        overlap[0] = max(overlap[0], active[0])
        try:
            return run(self, *args, **kwargs)
        finally:
            active[0] -= 1

    interval = sys.getswitchinterval()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps.Cell, "_run", counted)
        sys.setswitchinterval(1e-5)
        try:
            threaded = _search(3, False)
        finally:
            sys.setswitchinterval(interval)
    warm = _search(1, cache)
    return serial, threaded, warm, overlap[0]


def test_search_is_independent_of_workers_and_fails_no_trace(runs):
    (t1, e1), (t3, e3), _, overlap = runs
    assert t1 == t3
    assert overlap == 1, "two traces ran at once"
    for eng in (e1, e3):
        s = eng.stats()
        assert s["n_failures"] == 0, eng.errors
        assert s["n_compiles"] > 0 and s["n_lowerings"] >= s["n_compiles"]
        assert not parity.unlisted_at(eng.replicated_at)
    assert e1.stats()["n_attempts"] == e3.stats()["n_attempts"]
    assert t1[0], "no event recorded"


def test_warm_cache_run_traces_nothing(runs):
    (t1, e1), _, (tw, ew), _ = runs
    assert tw == t1
    s = ew.stats()
    assert s["n_compiles"] == 0 and s["n_lowerings"] == 0 and s["n_failures"] == 0
    assert s["n_disk_hits"] == e1.stats()["n_cache_misses"]


_FP = r"""
import json
from repro_torch.core import counters
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch.steps import build_cell
space = SearchSpace(bench_archs(["qwen2-1.5b"]), BENCH_SHAPES)
p = {k: v[0] for k, v in space.factors.items()}
p.update(arch="qwen2-1.5b", shape="decode_s", preset="tp", mesh="multi", cache_shard=False)
cfg, shape, policy, mesh_kind = space.to_run(space.normalize(p))
lc = counters.lower_cell(build_cell(cfg, shape, policy, bench_meshes()[mesh_kind]),
                         device="cpu")
m = counters.compile_lowered(lc)
print(json.dumps({"fp": lc.fingerprint, "counters": m.counters(),
                  "replicated": m.hlo["replicated_ops"]}, sort_keys=True))
"""


def test_fingerprint_and_counters_do_not_depend_on_the_hash_seed():
    procs = [subprocess.Popen([sys.executable, "-c", _FP], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
                                   "PYTHONHASHSEED": seed})
             for seed in ("1", "4242")]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        outs.append(out.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    assert len(json.loads(outs[0])["fp"]) == 24


# a handful of the pairs file's points (by index): each non-MoE arch; the
# decode, long and prefill shapes; train points under tp (13), dp with 8
# microbatches (30) and with one on the multi mesh (149), fsdp (33, 205);
# the listed differences of both tables; one point of each repaired
# cause: a decode step against an unsharded cache under tp (19), the scans'
# stacks and XLA's microbatch layout (29), the f32 collectives over joint
# groups (126), beside the two guards (33: remat dots, 0.9 % over A1's
# threshold; 49: the unembedding's gradient under ZeRO-1)
PAIR_INDICES = (0, 1, 5, 9, 11, 13, 15, 17, 19, 29, 30, 33, 49, 126, 149, 205)
# the two whose traces take minutes (rwkv6-7b's microbatched train steps):
# each measured in a process of its own beside the engine, by an engine
# without the structural dedup (which skips the global trace that only
# fingerprints a point)
SLOW_INDICES = (29, 126)

_TRACE = """
import json, sys
from repro_torch.core import parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.engine import Engine
from repro_torch.core.searchspace import SearchSpace
archs, restrict, rows = parity.pair_points(sys.argv[1])
p = next(p for i, p, _ in rows if i == int(sys.argv[2]))
eng = Engine(SearchSpace(bench_archs(archs), BENCH_SHAPES, restrict=restrict), bench_meshes(),
             persistent_cache=False, struct_dedup=False, device="cpu")
c = eng.measure(p)
eng.close()
print(json.dumps([c, eng.errors, parity.unlisted_at(eng.replicated_at)]))
"""

def _microbatch_points(rows):
    base = next(p for i, p, _ in rows if i == 149)
    return [{**base, "n_microbatch": n} for n in parity.MICROBATCH_COUNTERS]


@pytest.fixture(scope="module")
def pair_measurements(tmp_path_factory):
    """The port's engine and a fresh run of the reference on the chosen pairs
    points and the microbatch points: -> (pair rows [(index, point, stored
    counters, port counters, reference counters)], microbatch rows [(point,
    port counters, reference counters)], the engine)."""
    archs, restrict, rows = parity.pair_points(PAIRS)
    by_index = {i: (p, m) for i, p, m in rows}
    pair_pts = [by_index[i][0] for i in PAIR_INDICES]
    micro_pts = _microbatch_points(rows)
    arg = tmp_path_factory.mktemp("reference") / "points.json"
    arg.write_text(json.dumps([pair_pts + micro_pts, archs, restrict]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "reference_counters.py"),
                            str(arg)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    slow = {i: subprocess.Popen([sys.executable, "-c", _TRACE, str(PAIRS), str(i)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
            for i in SLOW_INDICES}
    space = SearchSpace(bench_archs(archs), BENCH_SHAPES, restrict=restrict)
    eng = Engine(space, bench_meshes(), persistent_cache=False, device="cpu")
    fast = [p for i, p in zip(PAIR_INDICES, pair_pts) if i not in slow]
    got = iter(eng.measure_batch(fast + micro_pts))
    eng.close()
    traced = {}
    for i, proc in slow.items():
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        counters, errors, unlisted = json.loads(out.strip().splitlines()[-1])
        assert counters is not None, (i, errors)
        assert unlisted == [], (i, unlisted)
        traced[i] = counters
    port = [traced[i] if i in traced else next(got) for i in PAIR_INDICES]
    out, err = ref.communicate(timeout=900)
    assert ref.returncode == 0, err[-3000:]
    now = json.loads(out.strip().splitlines()[-1])
    n = len(pair_pts)
    pairs = [(i, p, by_index[i][1], c, r)
             for i, p, c, r in zip(PAIR_INDICES, pair_pts, port, now[:n])]
    return pairs, list(zip(micro_pts, list(got), now[n:])), eng


def _kinds(counters, remat):
    return tuple(sorted(ref_anomaly.kinds(counters, remat)))


@pytest.mark.parametrize("j", range(len(PAIR_INDICES)))
def test_pair_point_kinds_match_reference(pair_measurements, j):
    rows, _, eng = pair_measurements
    i, p, stored, port_counters, now = rows[j]
    assert eng.n_failures == 0, eng.errors
    assert port_counters is not None
    assert not parity.unlisted_at(eng.replicated_at)
    stored_kinds, now_kinds = _kinds(stored, p["remat"]), _kinds(now, p["remat"])
    stale = parity.PAIR_STORED_DIFFERENCES.get(i)
    if stale is None:
        assert now_kinds == stored_kinds, (p, now)
    else:
        assert (stored_kinds, now_kinds) == stale[:2]
        for counter, (stored_v, now_v) in stale[2].items():
            assert stored[counter] == pytest.approx(stored_v, rel=1e-3)
            assert now[counter] == pytest.approx(now_v, rel=1e-3)
    got = tuple(sorted(anomaly.kinds(port_counters, p["remat"])))
    listed = parity.PAIR_KIND_DIFFERENCES.get(i)
    if listed is None:
        assert got == now_kinds, (p, port_counters)
        return
    port_kinds, ref_kinds, values, _ = listed
    assert (got, now_kinds) == (port_kinds, ref_kinds)
    for counter, (port_v, ref_v) in values.items():
        assert port_counters[counter] == pytest.approx(port_v, rel=1e-3)
        assert now[counter] == pytest.approx(ref_v, rel=1e-3)


@pytest.mark.parametrize("i", sorted(set(parity.SMOKE_PAIRS)
                                     & {i for i, _, _ in parity.pair_points(PAIRS)[2]}))
def test_the_card_pairs_are_todays_reference_kinds(pair_measurements, i):
    """The kinds chip_smoke.py's measure pairs phase holds the card to
    (``parity.SMOKE_PAIRS``) are today's reference's, at its points that
    need no MoE (``test_torch_moe_micro.py`` holds the MoE one)."""
    rows, _, _ = pair_measurements
    _, p, _, _, now = next(r for r in rows if r[0] == i)
    assert _kinds(now, p["remat"]) == parity.SMOKE_PAIRS[i]


@pytest.mark.parametrize("n_micro", sorted(parity.MICROBATCH_COUNTERS))
def test_dp_microbatch_counters_against_reference(pair_measurements, n_micro):
    """The dp train point on the multi mesh, split into microbatches: the
    port's useful-FLOP ratio and wire bytes and the reference's are the
    listed ones (equal FLOPs at 1; see parity.MICROBATCH_COUNTERS)."""
    _, rows, eng = pair_measurements
    p, port_counters, now = next(r for r in rows if r[0]["n_microbatch"] == n_micro)
    assert port_counters is not None, eng.errors
    for counter, (port_v, ref_v) in parity.MICROBATCH_COUNTERS[n_micro].items():
        assert port_counters[counter] == pytest.approx(port_v, rel=1e-3), counter
        assert now[counter] == pytest.approx(ref_v, rel=1e-3), counter


def test_dp_microbatch_kinds_at_16_are_the_references(pair_measurements):
    """In 16 microbatches of 2 rows (``xlaforms._Body``: a row a rank on
    half of the model axis, the weights split over data in the loop) the
    port's kinds are the fresh reference's, which ``chip_smoke.py`` holds
    the card to (``parity.SMOKE_MICROBATCH``)."""
    _, rows, eng = pair_measurements
    p, port_counters, now = next(r for r in rows if r[0]["n_microbatch"] == 16)
    assert port_counters is not None, eng.errors
    assert not parity.unlisted_at(eng.replicated_at)
    assert _kinds(port_counters, p["remat"]) == _kinds(now, p["remat"]) \
        == parity.SMOKE_MICROBATCH[(149, 16)]


@pytest.mark.parametrize("n_micro", [2, 4])
def test_microbatch_split_of_a_fully_sharded_batch_runs_replicated(n_micro):
    """A batch of 32 on the multi mesh's 32 ranks, split into microbatches:
    DTensor refuses the split into 2 (it would reshape the sharded dim) and
    plans the split into 4 over 32 ranks on a dim of 4, where the local view
    would fail.  The hook runs either view replicated and counts it.  The
    train step no longer views its batch so (``xlaforms._microbatches`` cuts
    each microbatch sharded), so such a view is no longer admitted at a
    dense dp train point."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch import traceanalysis
    fake = FakeTensorMode()
    dm = bench_meshes()["multi"].device_mesh("cpu")
    rec = traceanalysis.Recorder(fake)
    with fake:
        a = DTensor.from_local(torch.empty(1, 256), dm, [Shard(0)] * 3, run_check=False,
                               shape=torch.Size((32, 256)), stride=(256, 1))
    with fake, rec, traceanalysis.dtensor_hooks(rec):
        b = a.reshape(n_micro, 32 // n_micro, 256)
    assert tuple(b.shape) == tuple(b.to_local().shape) == (n_micro, 32 // n_micro, 256)
    assert rec.replicated == {"aten.view.default": 1}
    assert parity.unlisted_replications(rec.replicated, "qwen2-1.5b-bench", "dp", "train",
                                        n_micro) == ["aten.view.default"]


def test_a_view_planned_strided_runs_replicated():
    """A view that merges a dim sharded behind an unsharded one, as in the
    backward of 2-row microbatches under fsdp on the multi mesh: DTensor
    plans the merged dim strided-sharded, which the registered product's
    strategies cannot take, so the hook runs the view replicated and counts
    it.  With the microbatch split sharded (``xlaforms._microbatches``)
    qwen2's train points need such a view no longer, and none is admitted
    there."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import traceanalysis
    fake = FakeTensorMode()
    dm = bench_meshes()["multi"].device_mesh("cpu")
    rec = traceanalysis.Recorder(fake)
    with fake:
        a = DTensor.from_local(torch.empty(1, 256, 2, 8), dm, [Shard(0), Shard(3), Replicate()],
                               run_check=False, shape=torch.Size((2, 256, 2, 32)),
                               stride=(16384, 64, 32, 1))
    with fake, rec, traceanalysis.dtensor_hooks(rec):
        b = a.reshape(2, 256, 64)
    assert tuple(b.shape) == (2, 256, 64)
    assert not any(type(pl).__name__ == "_StridedShard" for pl in b.placements)
    assert rec.replicated == {"aten.view.default": 1}
    assert parity.unlisted_replications(rec.replicated, "qwen2-1.5b-bench", "fsdp",
                                        "train", 16) == ["aten.view.default"]
    assert parity.unlisted_replications(rec.replicated, "qwen2-1.5b-bench", "fsdp",
                                        "train", 1) == ["aten.view.default"]
