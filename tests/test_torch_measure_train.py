"""Port vs reference: ``perf.useful_flops_ratio`` of the main path's train
cell, ``qwen2-1.5b-bench`` at ``train_s`` on the single bench mesh, under
each sharding preset with remat none, dots and full.

Within ``parity.USEFUL_RATIO_REL_BOUND`` of the reference's, except the
listed differences of construction (``parity.USEFUL_RATIO_DIFFERENCES``,
each with both values and its cause), and with no op run replicated: under
tp and ep the 12 query heads over 2 KV heads on 4 model ranks stay sharded
(``xlaforms._group_heads``).  The bytes and wire bytes per device
are printed beside the reference's, not gated.  The reference measures in a
subprocess with 32 host devices; the port in-process, on the fake default
process group that the first trace starts (it stays for the worker's life,
as in ``test_torch_measure.py``).
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.core import parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.counters import measure_cell
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch.steps import build_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
_BASE = {"arch": "qwen2-1.5b", "attn_impl": "auto", "cache_shard": True,
         "capacity_factor": 1.25, "grad_compress": "none", "mesh": "single",
         "n_microbatch": 1, "optimizer": "adamw", "params_f32": True, "preset": "fsdp",
         "remat": "none", "scan_layers": True, "seq_shard": True, "shape": "train_s",
         "vocab_shard": True, "zero1": True}
POINTS = [dict(_BASE, preset=pr, remat=r)
          for pr in ("fsdp", "tp", "ep", "dp") for r in ("none", "dots", "full")]

_REF = r"""
import json, sys, time
from repro.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro.core.counters import measure_cell
from repro.core.searchspace import SearchSpace
from repro.launch.steps import build_cell
points = json.loads(open(sys.argv[1]).read())
space = SearchSpace(bench_archs(["qwen2-1.5b"]), BENCH_SHAPES)
meshes = bench_meshes()
out = []
for p in points:
    cfg, shape, policy, mk = space.to_run(space.normalize(p))
    t0 = time.time()
    m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]))
    out.append({"useful": m.perf["useful_flops_ratio"],
                "hlo_bytes_per_dev": m.roofline["hlo_bytes_per_dev"],
                "collective_wire_per_dev": m.roofline["collective_wire_per_dev"],
                "compile_s": time.time() - t0})
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    arg = tmp_path_factory.mktemp("ref") / "points.json"
    arg.write_text(json.dumps(POINTS))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(arg)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    space = SearchSpace(bench_archs(["qwen2-1.5b"]), BENCH_SHAPES)
    meshes = bench_meshes()
    port = []
    for p in POINTS:
        cfg, shape, policy, mk = space.to_run(space.normalize(p))
        m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]), device="cpu")
        port.append({"useful": m.perf["useful_flops_ratio"],
                     "replicated_ops": m.hlo["replicated_ops"],
                     "hlo_bytes_per_dev": m.roofline["hlo_bytes_per_dev"],
                     "collective_wire_per_dev": m.roofline["collective_wire_per_dev"],
                     "trace_s": m.compile_s})
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return list(zip(port, json.loads(out.strip().splitlines()[-1])))


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{p['preset']}-{p['remat']}" for p in POINTS])
def test_train_cell_useful_flops_ratio_within_bound(measured, i):
    port, ref = measured[i]
    key = parity.point_key(POINTS[i])
    print(f"{key}: useful {port['useful']:.4f} vs {ref['useful']:.4f}; bytes/dev "
          f"{port['hlo_bytes_per_dev']:.4g} vs {ref['hlo_bytes_per_dev']:.4g}; wire/dev "
          f"{port['collective_wire_per_dev']:.4g} vs {ref['collective_wire_per_dev']:.4g}; "
          f"trace {port['trace_s']:.2f} s, ref compile {ref['compile_s']:.2f} s")
    listed = parity.USEFUL_RATIO_DIFFERENCES.get(key)
    if listed is None:
        assert abs(port["useful"] - ref["useful"]) <= \
            parity.USEFUL_RATIO_REL_BOUND * ref["useful"], (port["useful"], ref["useful"])
    else:
        assert (round(port["useful"], 4), round(ref["useful"], 4)) == listed[:2]


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{p['preset']}-{p['remat']}" for p in POINTS])
def test_train_cell_runs_no_op_replicated(measured, i):
    port, _ = measured[i]
    assert port["replicated_ops"] == {}, (POINTS[i]["preset"], port["replicated_ops"])
