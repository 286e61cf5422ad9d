"""Port vs reference: the measurement of Collie search points.

* By kinds: the committed corpus's witnesses and controls that need no MoE
  (``repro_torch.core.parity.corpus_points``), measured by both packages
  with the kernels off; the port reports exactly the reference's kinds,
  except the listed differences (``parity.KIND_DIFFERENCES``, both kind
  sets and the deciding counter's values), so a witness shows its entry's
  kind and a control does not, as the reference's corpus replay holds them.
  The reference's kinds and ratio are also those ``parity.REFERENCE`` keeps
  for the card, and only ``parity.REPLICATED_OPS`` may run replicated.
* Within a stated bound: ``perf.useful_flops_ratio`` within
  ``parity.USEFUL_RATIO_REL_BOUND`` of the reference's, except the listed
  differences of construction (``parity.USEFUL_RATIO_DIFFERENCES``).
  ``hlo_bytes_per_dev`` and ``collective_wire_per_dev`` are printed side by
  side, not gated.
* A kernels-on trace on fake tensors launches nothing, reads no data pointer,
  reaches no kernel op's real body and counts the kernels' FLOPs by their
  formulas; each kernel op on fake ``cuda`` tensors gives the CUDA path's
  output layout.  (The whole model traces on fake ``cuda`` tensors only
  where torch is built with CUDA: indexing a fake ``cuda`` tensor needs a
  device guard.  ``chip_smoke.py``'s measure phase does that on the card.)

The reference measures in a subprocess with 32 host devices (as
``test_corpus_regression.py`` replays); the port measures in-process, on the
fake default process group its first trace starts.  That group stays for
the worker's life: a destroyed and restarted group would leave DTensor's
caches holding meshes of the old one (equal meshes, dead group names), and
no other test starts a process group.
"""
import json
import os
import pathlib
import subprocess
import sys
import warnings

import pytest
import torch

from repro_torch.core import anomaly, parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.counters import measure_cell
from repro_torch.core.searchspace import SearchSpace
from repro_torch.kernels import ops
from repro_torch.kernels.traceable import visible_pairs
from repro_torch.launch.steps import build_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS = ROOT / "benchmarks" / "results" / "anomaly_corpus.json"
POINTS = parity.corpus_points(CORPUS)
META = json.loads(CORPUS.read_text())["meta"]

_REF = r"""
import json, sys, time
from repro.core import anomaly
from repro.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro.core.counters import measure_cell
from repro.core.searchspace import SearchSpace
from repro.launch.steps import build_cell
points, archs, restrict = json.loads(open(sys.argv[1]).read())
space = SearchSpace(bench_archs(archs), BENCH_SHAPES,
                    restrict={k: tuple(v) for k, v in restrict.items()} or None)
meshes = bench_meshes()
out = []
for p in points:
    cfg, shape, policy, mk = space.to_run(space.normalize(p))
    t0 = time.time()
    m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]))
    c = {**{"perf." + k: v for k, v in m.perf.items()},
         **{"diag." + k: v for k, v in m.diag.items()}}
    out.append({"counters": c, "kinds": sorted(anomaly.kinds(c, policy.remat)),
                "hlo_bytes_per_dev": m.roofline["hlo_bytes_per_dev"],
                "collective_wire_per_dev": m.roofline["collective_wire_per_dev"],
                "compile_s": time.time() - t0})
print(json.dumps(out))
"""


def _space():
    return SearchSpace(bench_archs(META["archs"]), BENCH_SHAPES,
                       restrict={k: tuple(v) for k, v in META["restrict"].items()})


def start_reference(points, archs, restrict, tmp_dir):
    """The reference's measurement of ``points``, started in a subprocess
    with 32 host devices; ``finish_reference`` collects it."""
    arg = tmp_dir / "points.json"
    arg.write_text(json.dumps([points, archs, restrict]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", _REF, str(arg)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def finish_reference(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def measured(tmp_path_factory):
    """Both packages' measurements of every corpus point: the reference's
    subprocess runs while the port traces."""
    pts = [p for _, _, _, p in POINTS]
    proc = start_reference(pts, META["archs"], META["restrict"],
                           tmp_path_factory.mktemp("ref"))
    space, meshes = _space(), bench_meshes()
    port = []
    for p in pts:
        cfg, shape, policy, mk = space.to_run(space.normalize(p))
        m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]), device="cpu")
        c = m.counters()
        port.append({"counters": c, "kinds": sorted(anomaly.kinds(c, policy.remat)),
                     "replicated_ops": m.hlo["replicated_ops"],
                     "hlo_bytes_per_dev": m.roofline["hlo_bytes_per_dev"],
                     "collective_wire_per_dev": m.roofline["collective_wire_per_dev"],
                     "trace_s": m.compile_s})
    ref = finish_reference(proc)
    return {parity.point_key(p) + (role, sig): (a, b)
            for (sig, _, role, p), a, b in zip(POINTS, port, ref)}


def test_corpus_has_the_four_non_moe_witnesses_and_six_controls():
    roles = [role for _, _, role, _ in POINTS]
    assert roles.count("witness") == 4 and roles.count("control") == 6
    assert {k for _, k, role, _ in POINTS if role == "witness"} == {"A1", "A3"}


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{k}-{r}-{p['arch']}-{p['shape']}-{p['preset']}-{p['mesh']}"
                              f"{'' if p['cache_shard'] else '-nocache'}"
                              f"{'' if p['vocab_shard'] else '-novocab'}"
                              for _, k, r, p in POINTS])
def test_corpus_point_verdict_and_useful_flops_match_reference(measured, i):
    sig, kind, role, p = POINTS[i]
    port, ref = measured[parity.point_key(p) + (role, sig)]
    print(f"{kind} {role} {parity.point_key(p)}: port kinds {port['kinds']} ref kinds "
          f"{ref['kinds']}; useful {port['counters']['perf.useful_flops_ratio']:.4f} vs "
          f"{ref['counters']['perf.useful_flops_ratio']:.4f}; bytes/dev "
          f"{port['hlo_bytes_per_dev']:.4g} vs {ref['hlo_bytes_per_dev']:.4g}; wire/dev "
          f"{port['collective_wire_per_dev']:.4g} vs {ref['collective_wire_per_dev']:.4g}; "
          f"trace {port['trace_s']:.2f} s, ref compile {ref['compile_s']:.2f} s")
    # the reference itself still gives the committed verdict, and the values
    # the port keeps of it (for the card, where the reference is not run)
    assert parity.verdict_ok(kind, role, ref["kinds"])
    key = parity.corpus_key(p, role)
    got = port["counters"]["perf.useful_flops_ratio"]
    want = ref["counters"]["perf.useful_flops_ratio"]
    assert parity.REFERENCE[key] == (tuple(ref["kinds"]), round(want, 4))
    # the port reports the reference's kinds, or a listed difference exactly
    # (both kind sets, and the deciding counter's two values to 4 digits)
    listed = parity.KIND_DIFFERENCES.get(key)
    if listed is None:
        assert port["kinds"] == ref["kinds"], (port["kinds"], ref["kinds"])
    else:
        kinds_port, kinds_ref, counter, v_port, v_ref, _ = listed
        assert (tuple(port["kinds"]), tuple(ref["kinds"])) == (kinds_port, kinds_ref)
        assert (f"{port['counters'][counter]:.4g}", f"{ref['counters'][counter]:.4g}") == \
            (f"{v_port:.4g}", f"{v_ref:.4g}")
    assert tuple(port["kinds"]) == parity.expected_kinds(p, role)
    assert parity.verdict_ok(kind, role, port["kinds"])
    assert parity.useful_ok(parity.point_key(p), got, want), (got, want)
    if parity.point_key(p) in parity.USEFUL_RATIO_DIFFERENCES:
        # a listed difference keeps its recorded values (both 4 decimals)
        listed = parity.USEFUL_RATIO_DIFFERENCES[parity.point_key(p)]
        assert (round(got, 4), round(want, 4)) == listed[:2]
    # only the listed refusals of DTensor run an op replicated
    assert set(port["replicated_ops"]) <= set(parity.REPLICATED_OPS), port["replicated_ops"]
    # exact parts of the counter dict
    for k in ("diag.shard_fallbacks",):
        assert port["counters"][k] == ref["counters"][k]


# ------------------------------------------------------- kernels on, fake cuda

_PALLAS_CASES = [("qwen2-1.5b", "train_s"), ("qwen2-1.5b", "prefill_s"),
                 ("qwen2-1.5b", "decode_s"), ("recurrentgemma-2b", "prefill_s"),
                 ("recurrentgemma-2b", "decode_s"), ("rwkv6-7b", "prefill_s"),
                 ("rwkv6-7b", "decode_s")]


def _expected_kernel_flops(cfg, shape, remat):
    """The kernels' FLOPs of one step at this bench point, from the formulas
    written out independently of the trace."""
    B, S = shape.global_batch, shape.seq_len
    pattern = cfg.block_pattern
    kinds = [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    n_attn, n_rec, n_rwkv = (kinds.count(k) for k in ("attn", "rec", "rwkv"))
    hd = B * cfg.n_heads * cfg.d_head
    if shape.kind == "decode":
        T = min(S, cfg.window) if cfg.window else S
        return {"flash_decode": 4.0 * hd * T * n_attn} if n_attn else {}
    pairs = visible_pairs(S, S, cfg.window, 0)
    out = {}
    if n_attn:
        fwd = 4.0 * hd * pairs * n_attn
        out["flash_attention_fwd"] = fwd * (2 if remat != "none" and shape.kind == "train" else 1)
        if shape.kind == "train":
            out["flash_attention_bwd_dq"] = 6.0 * hd * pairs * n_attn
            out["flash_attention_bwd_dkv"] = 8.0 * hd * pairs * n_attn
    if n_rec:
        out["rglru_scan"] = 2.0 * B * S * cfg.rec_width * n_rec
    if n_rwkv:
        out["rwkv6_wkv"] = 4.0 * B * cfg.n_heads * S * cfg.head_size ** 2 * n_rwkv
    return out


@pytest.fixture
def no_kernel_body(monkeypatch):
    """Any call of a kernel op's real body (the CUDA launch, or the CPU's
    plain version) fails the test: a fake trace must reach only the fake
    implementations.  A data-pointer read warns on a fake tensor; it is an
    error here."""
    from repro_torch.kernels import build, decode_attention, flash_attention, ref
    from repro_torch.kernels import rglru_scan, rwkv6_kernel

    def refuse(*a, **k):
        raise AssertionError("a kernel op ran its real body in a fake trace")
    monkeypatch.setattr(build, "load", refuse)
    for mod in (flash_attention, decode_attention, rglru_scan, rwkv6_kernel, ref):
        for name in dir(mod):
            if name.endswith("_ref"):
                monkeypatch.setattr(mod, name, refuse)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*data.?p(oin)?t(e)?r.*")
        yield


@pytest.mark.parametrize("arch,shape_name", _PALLAS_CASES)
def test_kernels_on_fake_trace_launches_nothing_and_counts_formulas(arch, shape_name,
                                                                    no_kernel_body):
    from repro_torch.configs.base import RunPolicy
    cfg = bench_archs([arch])[arch]
    shape = BENCH_SHAPES[shape_name]
    policy = RunPolicy(use_pallas=True, remat="none", params_f32=shape.kind == "train")
    cell = build_cell(cfg, shape, policy, bench_meshes()["single"])
    before = ops.launch_counts()
    trace = cell.lower("cpu")
    assert ops.launch_counts() == before
    got = {}
    for r in trace.records:
        if r["op"].startswith("repro_torch."):
            name = r["op"].split(".")[1]
            got[name] = got.get(name, 0.0) + r["flops"]
    assert got == _expected_kernel_flops(cfg, shape, policy.remat)
    # the kernels' FLOPs are part of the trace's (rwkv6 decodes with none)
    assert trace.analyze()["flops"] >= sum(got.values())
    assert got or (arch, shape.kind) == ("rwkv6-7b", "decode")


def test_kernel_ops_on_fake_cuda_tensors_launch_nothing(no_kernel_body):
    """Each kernel wrapper on fake ``cuda`` tensors at the bench shapes: the
    outputs' shapes, dtypes and strides are those the CUDA path allocates
    ((B,S,heads,D) memory seen as (B,heads,S,D)), nothing launches and no
    pointer is read."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq,
                                                     flash_attention_fwd)
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_kernel import rwkv6_wkv
    before = ops.launch_counts()
    bf = torch.bfloat16
    with FakeTensorMode():
        e = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device="cuda")
        q, k, v = e(32, 12, 256, 32), e(32, 2, 256, 32), e(32, 2, 256, 32)
        o, lse = flash_attention_fwd(q, k, v)
        assert o.shape == q.shape and o.stride() == (256 * 12 * 32, 32, 12 * 32, 1)
        assert lse.shape == (32, 12, 256) and lse.dtype == torch.float32
        assert o.device.type == "cuda"
        dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, o)
        assert dq.shape == q.shape and dq.stride() == o.stride() and delta.shape == lse.shape
        dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, o)
        assert dk.shape == k.shape and dk.stride() == (256 * 2 * 32, 32, 2 * 32, 1)
        d = flash_decode(e(16, 12, 32), e(16, 2, 1024, 32), e(16, 2, 1024, 32),
                         e(16, 1024, dt=torch.int32), e(16, dt=torch.int32))
        assert d.shape == (16, 12, 32) and d.is_contiguous()
        h = rglru_scan(e(8, 1024, 256, dt=torch.float32), e(8, 1024, 256, dt=torch.float32))
        assert h.shape == (8, 1024, 256) and h.is_contiguous()
        r = e(8, 8, 1024, 32)
        wo, st = rwkv6_wkv(r, r, r, e(8, 8, 1024, 32, dt=torch.float32), e(8, 32))
        assert wo.shape == r.shape and wo.dtype == torch.float32
        assert wo.stride() == (1024 * 8 * 32, 32, 8 * 32, 1) and st.shape == (8, 8, 32, 32)
    assert ops.launch_counts() == before


def test_kernels_on_mesh_trace_uses_the_sharding_rules(no_kernel_body):
    """On the mesh, the kernels run on local shards: batch split over 'data'
    (the heads, 12 over 2 KV heads, cannot split over 4 model ranks)."""
    from repro_torch.configs.base import RunPolicy
    cfg = bench_archs(["qwen2-1.5b"])["qwen2-1.5b"]
    policy = RunPolicy(use_pallas=True, remat="none", sharding_preset="dp")
    cell = build_cell(cfg, BENCH_SHAPES["train_s"], policy, bench_meshes()["single"])
    before = ops.launch_counts()
    trace = cell.trace("cpu")
    assert ops.launch_counts() == before
    fwd = [r for r in trace.records if r["op"].startswith("repro_torch.flash_attention_fwd")]
    assert len(fwd) == cfg.n_layers
    # dp: batch 32 over data x model = 16 ranks -> 2 rows a rank
    assert {r["in"][0][0] for r in fwd} == {(2, 12, 256, 32)}


def test_recurrent_kernels_on_cannot_train():
    """The RG-LRU and WKV kernels have no backward (nor have the TPU
    kernels), so a kernels-on train trace of those archs raises."""
    from repro_torch.configs.base import RunPolicy
    for arch in ("recurrentgemma-2b", "rwkv6-7b"):
        cfg = bench_archs([arch])[arch]
        cell = build_cell(cfg, BENCH_SHAPES["train_s"], RunPolicy(use_pallas=True),
                          bench_meshes()["single"])
        with pytest.raises(RuntimeError, match="no backward"):
            cell.lower("cpu")


def test_fingerprint_keys_structure_and_placements():
    """Equal points give equal fingerprints; a point that differs only in a
    constraint's resolution (seq_shard) gets another."""
    from repro_torch.configs.base import RunPolicy
    from repro_torch.core.counters import lower_cell
    cfg = bench_archs(["qwen2-1.5b"])["qwen2-1.5b"]
    mesh = bench_meshes()["single"]
    shape = BENCH_SHAPES["prefill_s"]
    fp = [lower_cell(build_cell(cfg, shape, RunPolicy(**kw), mesh), device="cpu").fingerprint
          for kw in ({}, {}, {"rule_overrides": (("seq_q", ()),)}, {"sharding_preset": "dp"})]
    assert fp[0] == fp[1]
    assert len(set(fp[1:])) == 3
