"""Port vs reference: the measurement of the frontend archs' search points.

A set of ``internvl2-1b-bench`` and ``musicgen-medium-bench`` points on the
single bench mesh (train_s under dp and tp; prefill_s and decode_s under
fsdp and tp), measured by the port's ``measure_cell`` on fake cpu tensors
and by the reference's (an XLA compile with 32 host devices, in
subprocesses, while the port traces): ``parity.POINT_REFERENCE`` holds the
reference's kinds and useful-FLOP ratio today, the port reports those kinds
or a listed difference (``parity.POINT_KIND_DIFFERENCES``, both values of
the deciding counter) and the ratio within ``parity.USEFUL_RATIO_REL_BOUND``,
the same shard fallbacks, and runs no op replicated.
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
from repro_torch.core.minimize import baseline_point
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch.steps import build_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["internvl2-1b", "musicgen-medium"]
SPACE = SearchSpace(bench_archs(ARCHS), BENCH_SHAPES)
PICKS = [("train_s", "dp"), ("train_s", "tp"), ("prefill_s", "fsdp"), ("prefill_s", "tp"),
         ("decode_s", "fsdp"), ("decode_s", "tp")]
POINTS = [SPACE.normalize({**baseline_point(SPACE, a, sh), "preset": pr, "mesh": "single"})
          for a in ARCHS for sh, pr in PICKS]
N_PROCS = 2


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """[(the port's measurement, the reference's counters)] at POINTS."""
    tmp = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = []
    for i in range(N_PROCS):
        arg = tmp / f"points{i}.json"
        arg.write_text(json.dumps([POINTS[i::N_PROCS], ARCHS, {}]))
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "reference_counters.py"), str(arg)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env))
    meshes = bench_meshes()
    port = []
    for p in POINTS:
        cfg, shape, policy, mk = SPACE.to_run(p)
        port.append(measure_cell(build_cell(cfg, shape, policy, meshes[mk]), device="cpu"))
    ref = [None] * len(POINTS)
    for i, proc in enumerate(procs):
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-3000:]
        for j, c in enumerate(json.loads(out.strip().splitlines()[-1])):
            ref[i + j * N_PROCS] = c
    return list(zip(port, ref))


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{p['arch'].split('-')[0]}-{p['shape']}-{p['preset']}"
                              for p in POINTS])
def test_frontend_point_matches_reference(measured, i):
    p = POINTS[i]
    m, ref = measured[i]
    c = m.counters()
    key = parity.grid_key(p)
    kinds = tuple(sorted(anomaly.kinds(c, p["remat"])))
    ref_kinds = tuple(sorted(ref_anomaly.kinds(ref, p["remat"])))
    got, want = c["perf.useful_flops_ratio"], ref["perf.useful_flops_ratio"]
    print(f"{key}: port {kinds} ref {ref_kinds}; useful {got:.4f} vs {want:.4f}; roofline "
          f"{c['perf.roofline_efficiency']:.4g} vs {ref['perf.roofline_efficiency']:.4g}")
    assert parity.POINT_REFERENCE[key] == (ref_kinds, round(want, 4))
    listed = parity.POINT_KIND_DIFFERENCES.get(key)
    if listed is None:
        assert kinds == ref_kinds
    else:
        kinds_port, kinds_ref, counter, v_port, v_ref, _ = listed
        assert (kinds, ref_kinds) == (kinds_port, kinds_ref)
        assert (f"{c[counter]:.4g}", f"{ref[counter]:.4g}") == (f"{v_port:.4g}", f"{v_ref:.4g}")
    assert abs(got / want - 1) <= parity.USEFUL_RATIO_REL_BOUND
    assert m.hlo["replicated_ops"] == {}
    assert c["diag.shard_fallbacks"] == ref["diag.shard_fallbacks"]
