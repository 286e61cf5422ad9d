"""Compressed cross-pod gradient reduction (``train/compression.py`` and the
``grad_compress`` branch of the train step) against the JAX package's.

* ``_quantize_int8`` on the same arrays and scales gives the reference's
  int8 values (hypothesis, as ``tests/test_compression.py``), within half a
  step of the input and in [-127, 127].
* ``reduce_grads`` in both modes against the reference's under a pure
  ("pod",) ``shard_map`` of 4 JAX CPU devices (a subprocess): the port on a
  ``gloo`` group of 4 CPU processes, each with its pod's gradients, gives
  the reference's reduced gradients and error-feedback buffers (int8: the
  same int32 sums, f32 1e-6 of the largest value; bf16: one bf16 step of the
  largest value, the sums' order and rounding in the two collectives
  differing), and error feedback converges to the true mean over 20 steps
  (within 1 %, as ``tests/test_multidevice.py``).
* The measurement: int8 under dp on the multi bench mesh, where the
  reference measures (qwen2-1.5b-bench and internvl2-1b-bench train_s),
  gives the reference's kinds and useful-FLOP ratio within
  ``parity.USEFUL_RATIO_REL_BOUND`` (a fresh reference run in a
  subprocess); each param's gradient crosses the pods in one int32 (int8
  mode) or bf16 all-reduce of its shard, counted by the trace at that width;
  at points where the reference's XLA aborts (``parity.REFERENCE_ABORTS``:
  every compressed point but int8 under dp) the port measures with no failed
  trace, and its kinds are those the table keeps.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
    from hypothesis.extra import numpy as hnp
except ImportError:          # container lacks hypothesis: seeded fallback
    from hypstub import given, settings, st, hnp

from repro.core import anomaly as ref_anomaly
from repro.train.compression import _quantize_int8 as ref_quantize
from repro_torch.core import anomaly, parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.counters import measure_cell
from repro_torch.core.minimize import baseline_point
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch.steps import build_cell
from repro_torch.models.module import flatten
from repro_torch.train.compression import _quantize_int8

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_PODS, EF_STEPS = 4, 20


# ---------------------------------------------------------------- quantizing

@given(hnp.arrays(np.float32, st.integers(1, 64), elements=st.floats(-100, 100, width=32)))
@settings(max_examples=100, deadline=None)
def test_int8_quantization_matches_reference(x):
    import jax.numpy as jnp
    scale = max(float(np.max(np.abs(x))) / 127.0, 1e-12)
    want = np.asarray(ref_quantize(jnp.asarray(x), scale))
    got = _quantize_int8(torch.from_numpy(x), torch.tensor(scale, dtype=torch.float32))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    deq = got.float().numpy() * np.float32(scale)
    assert float(np.max(np.abs(deq - x))) <= scale * 0.5 + 1e-7


def test_int8_range():
    q = _quantize_int8(torch.tensor([-1e9, 1e9, 0.0]), torch.tensor(1.0))
    assert int(q.min()) >= -127 and int(q.max()) <= 127


# ------------------------------------------------------- reduce_grads on pods

_REF = """
import sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.launch.mesh import shard_map
from repro.train.compression import reduce_grads
data = np.load(sys.argv[1])
mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("pod",))
out = {}
for mode in ("int8", "bf16"):
    def body(a, b, ea, eb):
        red, ef = reduce_grads({"a": a[0], "b": b[0]}, {"a": ea[0], "b": eb[0]}, mode, "pod")
        return red["a"], red["b"], ef["a"][None], ef["b"][None]
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"),) * 4,
                          out_specs=(P(), P(), P("pod"), P("pod")), check_vma=False))
    ea, eb = jnp.zeros_like(data["a"]), jnp.zeros_like(data["b"])
    acc = 0
    for step in range(int(sys.argv[3])):
        ra, rb, ea, eb = f(data["a"], data["b"], ea, eb)
        if step == 0:
            out[mode + "/a"], out[mode + "/b"] = np.asarray(ra), np.asarray(rb)
            out[mode + "/ef_a"], out[mode + "/ef_b"] = np.asarray(ea), np.asarray(eb)
        acc = acc + np.asarray(ra)
    out[mode + "/acc_a"] = acc
np.savez(sys.argv[2], **out)
"""

_PORT = """
import sys, numpy as np, torch, torch.distributed as dist
from repro_torch.train.compression import reduce_grads
rank, port, path, out, steps = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], int(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                        world_size=4)
data = np.load(path)
g = {k: torch.from_numpy(data[k][rank]) for k in ("a", "b")}
res = {}
for mode in ("int8", "bf16"):
    ef, acc = None, 0
    for step in range(steps):
        red, ef = reduce_grads(g, ef, mode, dist.group.WORLD)
        if step == 0:
            for k in ("a", "b"):
                res[f"{mode}/{k}"] = red[k].numpy()
                res[f"{mode}/ef_{k}"] = ef[k].numpy()
        acc = acc + red["a"].numpy()
    res[mode + "/acc_a"] = acc
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    """(inputs, the reference's results, each port rank's results)."""
    tmp = tmp_path_factory.mktemp("pods")
    rng = np.random.default_rng(0)
    data = {"a": (rng.standard_normal((N_PODS, 64)) * 3).astype(np.float32),
            "b": (rng.standard_normal((N_PODS, 3, 5)) * 1e-3).astype(np.float32)}
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={N_PODS}")
    ref = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_REF), str(tmp / "in.npz"),
                            str(tmp / "ref.npz"), str(EF_STEPS)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = _free_port()
    ranks = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_PORT), str(r), str(port),
                               str(tmp / "in.npz"), str(tmp / f"port{r}.npz"), str(EF_STEPS)],
                              env=dict(env, XLA_FLAGS=""), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(N_PODS)]
    for p in [ref] + ranks:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return (data, dict(np.load(tmp / "ref.npz")),
            [dict(np.load(tmp / f"port{r}.npz")) for r in range(N_PODS)])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("leaf", ["a", "b"])
def test_reduce_grads_matches_reference_on_a_pod_mesh(reduced, mode, leaf):
    data, ref, ranks = reduced
    want = ref[f"{mode}/{leaf}"]
    scale = float(np.max(np.abs(want)))
    tol = 1e-6 if mode == "int8" else 2.0 ** -7
    for r, got in enumerate(ranks):
        assert got[f"{mode}/{leaf}"].shape == want.shape
        assert float(np.max(np.abs(got[f"{mode}/{leaf}"] - want))) <= tol * scale, r
        # each pod's error-feedback buffer: its own rounding error
        ef = ref[f"{mode}/ef_{leaf}"][r]
        assert float(np.max(np.abs(got[f"{mode}/ef_{leaf}"] - ef))) \
            <= 1e-6 * max(float(np.max(np.abs(data[leaf]))), 1e-30), r
    # the compressed mean is off the true one by the wire format's rounding:
    # half a step of the shared int8 scale, or a bf16 step of each pod's value
    # and of the sum
    true = data[leaf].mean(axis=0)
    g_max = float(np.max(np.abs(data[leaf])))
    bound = 0.5 * g_max / 127 if mode == "int8" else g_max * 2.0 ** -7
    assert float(np.max(np.abs(want - true))) <= bound


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_error_feedback_converges_to_the_true_mean(reduced, mode):
    data, ref, ranks = reduced
    true = data["a"].mean(axis=0)
    scale = float(np.max(np.abs(true)))
    for got in ranks + [ref]:
        err = float(np.max(np.abs(got[mode + "/acc_a"] / EF_STEPS - true)))
        assert err / scale < 0.01, err / scale


# ----------------------------------------------------------- the measurement

ARCHS = ["qwen2-1.5b", "internvl2-1b", "musicgen-medium"]
SPACE = SearchSpace(bench_archs(ARCHS), BENCH_SHAPES)


def _point(arch, preset, gc, remat="none"):
    return SPACE.normalize({**baseline_point(SPACE, arch, "train_s"), "preset": preset,
                            "mesh": "multi", "grad_compress": gc, "remat": remat})


# where the reference measures: int8 under dp
MEASURED = [_point("qwen2-1.5b", "dp", "int8"), _point("internvl2-1b", "dp", "int8")]


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """The port's measurements and the reference's counters at MEASURED."""
    tmp = tmp_path_factory.mktemp("ref")
    arg = tmp / "points.json"
    arg.write_text(json.dumps([MEASURED, ARCHS, {}]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "reference_counters.py"),
                             str(arg)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    meshes = bench_meshes()
    port = []
    for p in MEASURED:
        cfg, shape, policy, mk = SPACE.to_run(p)
        port.append(measure_cell(build_cell(cfg, shape, policy, meshes[mk]), device="cpu"))
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    return port, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("i", range(len(MEASURED)), ids=[p["arch"] for p in MEASURED])
def test_int8_dp_point_matches_reference(measured, i):
    p = MEASURED[i]
    m, ref = measured[0][i], measured[1][i]
    c = m.counters()
    got, want = c["perf.useful_flops_ratio"], ref["perf.useful_flops_ratio"]
    kinds = tuple(sorted(anomaly.kinds(c, p["remat"])))
    ref_kinds = tuple(sorted(ref_anomaly.kinds(ref, p["remat"])))
    print(f"{p['arch']} int8 dp multi: port {kinds} ref {ref_kinds}; useful {got:.4f} vs "
          f"{want:.4f}; all-reduces {c['diag.n_allreduce']} vs {ref['diag.n_allreduce']}")
    assert parity.POINT_REFERENCE[parity.grid_key(p)] == (ref_kinds, round(want, 4))
    assert kinds == ref_kinds == parity.expected_point_kinds(parity.grid_key(p))
    assert abs(got / want - 1) <= parity.USEFUL_RATIO_REL_BOUND
    assert m.hlo["replicated_ops"] == {}
    assert c["diag.shard_fallbacks"] == ref["diag.shard_fallbacks"]


def _pod_all_reduces(cell):
    """(dtype, local bytes, group size) of each all-reduce over the 2 pods in
    the mesh trace of ``cell``."""
    trace = cell.trace("cpu")
    return [(r["in"][0][1], r["in_bytes"], r["group"]) for r in trace.records
            if r.get("coll") == "all-reduce" and r["group"] == 2], trace


@pytest.mark.parametrize("gc,dtype,width", [("int8", "int32", 4), ("bf16", "bfloat16", 2)])
def test_pod_all_reduce_is_counted_at_the_wire_width(gc, dtype, width):
    """One all-reduce of each param's shard over the pod group, at int32 or
    bf16 width (the local shard's elements times the width), beside the f32
    max of each int8 scale and the loss and aux means."""
    cfg, shape, policy, mk = SPACE.to_run(_point("qwen2-1.5b", "dp", gc))
    cell = build_cell(cfg, shape, policy, bench_meshes()[mk])
    pod, trace = _pod_all_reduces(cell)
    params = flatten(cell.arg_shapes[0])
    wire = [(d, b) for d, b, _ in pod if d == dtype]
    assert len(wire) == len(params)
    # dp keeps the params whole on every rank
    assert sorted(b for _, b in wire) == sorted(
        width * int(np.prod(s)) for _, (s, _) in params)
    n_f32 = sum(1 for d, _, _ in pod if d == "float32")
    assert n_f32 == (len(params) if gc == "int8" else 0) + 2
    assert trace.analyze()["collective_count"]["all-reduce"] >= len(pod)


# one point of each abort class for each arch, and the issue's tp bf16 point
ABORTS = [k for k in sorted(parity.REFERENCE_ABORTS)
          if (k[2], k[5]) in (("dp", "bf16"), ("fsdp", "int8"))
          or k == ("qwen2-1.5b", "train_s", "tp", "multi", "none", "bf16")]


def test_abort_table_covers_every_compressed_point_but_int8_dp():
    """The mapped points: 3 archs x 4 presets x 2 modes (and qwen2's fsdp
    int8 at remat dots); only int8 under dp measures in the reference."""
    got = set(parity.REFERENCE_ABORTS)
    assert len(got) == 3 * 4 * 2 - 3 + 1
    for key, (_, msg) in parity.REFERENCE_ABORTS.items():
        assert msg == parity.reference_abort(key[2], key[5]) is not None, key
    for arch in ("qwen2-1.5b", "internvl2-1b", "musicgen-medium"):
        key = (arch, "train_s", "dp", "multi", "none", "int8")
        assert key in parity.POINT_REFERENCE and key not in got
        assert parity.reference_abort("dp", "int8") is None


@pytest.mark.parametrize("key", ABORTS, ids=["-".join(k[:3] + k[4:]) for k in ABORTS])
def test_port_measures_where_the_reference_aborts(key):
    arch, shape_name, preset, mesh, remat, gc = key
    space = SearchSpace(bench_archs([arch]), BENCH_SHAPES)
    p = space.normalize({**baseline_point(space, arch, shape_name), "preset": preset,
                         "mesh": mesh, "remat": remat, "grad_compress": gc})
    assert parity.grid_key(p) == key
    cfg, shape, policy, mk = space.to_run(p)
    m = measure_cell(build_cell(cfg, shape, policy, bench_meshes()[mk]), device="cpu")
    c = m.counters()
    assert all(np.isfinite(v) for v in c.values())
    assert 0 < c["perf.useful_flops_ratio"] <= 1.2
    assert not parity.unlisted_replications(m.hlo["replicated_ops"], cfg.name, preset,
                                            shape.kind, policy.n_microbatch)
    assert tuple(sorted(anomaly.kinds(c, remat))) == parity.expected_point_kinds(key)
