"""The CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels have no CPU
mode) and skip without one.  They import neither JAX nor the JAX package, so
they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The attention kernels take head dims 32, 64, 128 (and 256 for the forward);
each kernel op's fake implementation must give its real outputs' layout.

Tolerances: f32 2e-5 with TF32 off, bf16 2e-2; for the backward kernels
f32 5e-5 (the reference's grad bound) and bf16 2e-2, each of the call's
scale max(1, max|plain grad|): the bf16 kernels round P and dS to bf16 for
their products, as the forward rounds P.  The RG-LRU scan: 1e-5 absolute;
the RWKV-6 WKV: 1e-5 relative to the largest plain output (and state), the
reference's bounds (tests/test_kernels.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_bwd_dkv,
                                                 flash_attention_bwd_dq,
                                                 flash_attention_fwd)
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.rwkv6_kernel import rwkv6_wkv

TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = {"f32": 5e-5, "bf16": 2e-2}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _heads_major(x, seq_major):
    """(B,H,S,D) values, stored either as is or as the model stores them,
    (B,S,H,D) memory viewed through a permute."""
    return x.transpose(1, 2).contiguous().transpose(1, 2) if seq_major else x


# (B, H, KVH, Sq, Skv, window, causal shift): the first rows at Sq = 200; then
# the edges of the kernels' tiles (64 and 128 rows, 64 and 128 keys): one
# row, 63, 129, 191 and 777 rows or keys, a window that cuts a tile in the
# middle, a causal shift with Sq < Skv, and G = H / KVH of 1, 6 and 10.
ATTN_SHAPES = [
    (2, 12, 2, 200, 200, None, 0),
    (2, 12, 2, 200, 200, 50, 0),
    (2, 12, 2, 200, 237, None, 37),
    (2, 6, 6, 1, 1, None, 0),
    (1, 6, 1, 63, 63, None, 0),
    (2, 10, 1, 129, 129, 100, 0),
    (1, 12, 2, 191, 777, None, 586),
    (2, 4, 2, 777, 777, 100, 0),
    (1, 6, 1, 777, 191, None, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,window,shift", ATTN_SHAPES)
@pytest.mark.parametrize("seq_major", [False, True])
def test_cuda_flash_attention_matches_plain(dt, D, B, H, KVH, Sq, Skv, window, shift,
                                            seq_major):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda *s: _heads_major(torch.randn(*s, generator=g, device=dev).to(TDT[dt]),
                                 seq_major)
    q, k, v = mk(B, H, Sq, D), mk(B, KVH, Skv, D), mk(B, KVH, Skv, D)
    n0 = flash_attention_fwd.launches
    o, lse = flash_attention_fwd(q, k, v, window=window, causal_shift=shift)
    ro, rlse = ref.flash_attention_ref(q, k, v, window=window, causal_shift=shift)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == n0 + 1
    assert (o.float() - ro.float()).abs().max().item() < TOL[dt]
    assert (lse - rlse).abs().max().item() < TOL[dt]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 30])
@pytest.mark.parametrize("H,KVH,D", [(12, 2, 128), (12, 1, 64), (10, 1, 256), (4, 2, 256),
                                     (8, 2, 32), (4, 1, 16)])
def test_cuda_flash_decode_matches_plain(dt, window, H, KVH, D):
    """The flash-decode kernel against its plain version, one launch a call,
    and a rerun gives the same bits (every sum has a fixed order)."""
    dev = _cuda()
    rng = np.random.default_rng(1)
    B, T = 2, 500
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev, TDT[dt])
    q = mk(B, H, D)
    # the model's cache layout, (B,T,KVH,D), read through a permuted view
    k, v = (mk(B, T, KVH, D).permute(0, 2, 1, 3) for _ in range(2))
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    pos[:, T - 10:] = -1
    qpos = np.array([T - 11, T // 2], np.int32)
    pos, qpos = torch.from_numpy(pos).to(dev), torch.from_numpy(qpos).to(dev)
    n0 = flash_decode.launches
    o = flash_decode(q, k, v, pos, qpos, window=window)
    r = ref.flash_decode_ref(q, k, v, pos, qpos, window=window)
    torch.cuda.synchronize()
    assert flash_decode.launches == n0 + 1
    assert (o.float() - r.float()).abs().max().item() < TOL[dt]
    assert torch.equal(flash_decode(q, k, v, pos, qpos, window=window), o)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 128])
def test_cuda_flash_decode_f32_at_large_scores(D):
    """Scores in the thousands (after the 1/sqrt(D) scale), as random-init
    mixtral-8x7b's are: there f32 rounding of a score moves its weight by
    ~1e-4 in any f32 evaluation, so the kernel is held to the same attention
    in f64, no further from it than twice the plain f32 version (the kernel
    takes each score's difference to the running max before the scale)."""
    dev = _cuda()
    rng = np.random.default_rng(5)
    B, H, KVH, T = 2, 32, 8, 3000
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev)
    # every score near c^2 sqrt(D) (over 1000), spread by ~2 across the keys,
    # so that many keys share the weight
    c = 15.0
    q = c + mk(B, H, D)
    k = (c + (2.0 / c) * mk(B, T, KVH, D)).permute(0, 2, 1, 3)
    v = (100.0 * mk(B, T, KVH, D)).permute(0, 2, 1, 3)
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
    qpos = torch.tensor([T - 1, T // 2], dtype=torch.int32, device=dev)
    o = flash_decode(q, k, v, pos, qpos)
    r = ref.flash_decode_ref(q, k, v, pos, qpos)
    G = H // KVH
    s = torch.einsum("bkgd,bktd->bkgt", q.double().reshape(B, KVH, G, D),
                     k.double()) / D ** 0.5
    s = torch.where((pos <= qpos[:, None])[:, None, None], s, -1e300)
    exact = torch.einsum("bkgt,bktd->bkgd", torch.softmax(s, -1), v.double()).reshape(B, H, D)
    torch.cuda.synchronize()
    assert s.abs().max().item() > 1000
    scale = exact.abs().max().item()
    err, plain = ((x.double() - exact).abs().max().item() / scale for x in (o, r))
    assert err <= 2.0 * plain, (err, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 32, 128, 256])
def test_cuda_flash_decode_skips_invisible_tiles_and_empty_lanes(dt, D):
    """Lanes of 4096, 64 and 1 written slots of a 4096-slot cache (the blocks
    of the short lanes skip all or most of their tiles) and a lane with
    nothing written (qpos = -1: no visible slot, where the plain version
    gives the mean of V over all slots), with the model's cache layout."""
    dev = _cuda()
    rng = np.random.default_rng(3)
    B, H, KVH, T = 4, 6, 2, 4096
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32)).to(dev, TDT[dt])
    q = mk(B, H, D)
    k, v = (mk(B, T, KVH, D).permute(0, 2, 1, 3) for _ in range(2))
    fills = (4096, 64, 1, 0)
    pos = np.full((B, T), -1, np.int32)
    for b, n in enumerate(fills):
        pos[b, :n] = np.arange(n)
    qpos = np.array([n - 1 for n in fills], np.int32)
    pos, qpos = torch.from_numpy(pos).to(dev), torch.from_numpy(qpos).to(dev)
    o = flash_decode(q, k, v, pos, qpos)
    r = ref.flash_decode_ref(q, k, v, pos, qpos)
    torch.cuda.synchronize()
    assert (o.float() - r.float()).abs().max().item() < TOL[dt]
    assert torch.equal(flash_decode(q, k, v, pos, qpos), o)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros(1, 4, 16, 96, device=dev, dtype=torch.bfloat16)     # D = 96
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 512, device=dev, dtype=torch.bfloat16)     # D = 512
    kv = torch.zeros(1, 2, 16, 512, device=dev, dtype=torch.bfloat16)
    pos = torch.zeros(1, 16, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode(q, kv, kv, pos, pos[:, 0].contiguous())
    q = _misaligned(dev, (1, 4, 16, 64))      # TMA needs a 16-byte aligned base
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_fwd(q, q[:, :2], q[:, :2])


def _misaligned(dev, shape):
    """A bf16 tensor whose strides are multiples of 8 elements but whose data
    starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, device=dev, dtype=torch.bfloat16)[1:1 + n].view(shape)


def _scaled_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            max(1.0, want.float().abs().max().item())).item()


# The edges of the dq kernel's tiles (128 query rows in two warpgroups of 64,
# 64 keys): 127, 128 and 129 rows, 200 rows against 221 keys, windows 50 and
# 70, causal shifts 21 and 173.
BWD_SHAPES = ATTN_SHAPES + [
    (2, 12, 2, 200, 221, 70, 21),
    (1, 4, 2, 127, 127, None, 0),
    (1, 4, 2, 128, 128, 50, 0),
    (2, 4, 2, 129, 129, 70, 0),
    (2, 6, 2, 200, 221, 50, 21),
    (1, 4, 1, 48, 221, None, 173),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("B,H,KVH,Sq,Skv,window,shift", BWD_SHAPES)
@pytest.mark.parametrize("seq_major", [False, True])
def test_cuda_flash_attention_bwd_matches_plain(dt, D, B, H, KVH, Sq, Skv, window, shift,
                                                seq_major):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    mk = lambda *s: _heads_major(torch.randn(*s, generator=g, device=dev).to(TDT[dt]),
                                 seq_major)
    q, k, v = mk(B, H, Sq, D), mk(B, KVH, Skv, D), mk(B, KVH, Skv, D)
    do = mk(B, H, Sq, D)
    o, lse = ref.flash_attention_ref(q, k, v, window=window, causal_shift=shift)
    n_dq, n_dkv = flash_attention_bwd_dq.launches, flash_attention_bwd_dkv.launches
    got = flash_attention_bwd(q, k, v, o, lse, do, window=window, causal_shift=shift)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window,
                                       causal_shift=shift)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq.launches == n_dq + 1
    assert flash_attention_bwd_dkv.launches == n_dkv + 1
    for a, b, name in zip(got, want, ("dq", "dk", "dv")):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _scaled_err(a, b) < GRAD_TOL[dt], name
    # delta, which the dq kernel computes for dk/dv
    _, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, window=window,
                                      causal_shift=shift)
    assert (delta - (do.float() * o.float()).sum(-1)).abs().max().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cuda_flash_attention_function_grads(dt):
    """Autograd through FlashAttention on the card against autograd through
    the plain forward; the forward wrapper refuses inputs that need grad."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(2)
    B, H, KVH, S, D = 1, 12, 2, 300, 128
    leaves = [torch.randn(*s, generator=g, device=dev).to(TDT[dt])
              for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D))]
    w = torch.randn(B, H, S, D, generator=g, device=dev)
    a = [t.clone().requires_grad_() for t in leaves]
    b = [t.clone().requires_grad_() for t in leaves]
    (flash_attention(*a).float() * w).sum().backward()
    (ref.flash_attention_ref(*b)[0].float() * w).sum().backward()
    for x, y, name in zip(a, b, "qkv"):
        assert x.grad is not None and x.grad.abs().max().item() > 0, name
        assert _scaled_err(x.grad, y.grad) < GRAD_TOL[dt], name
    with pytest.raises(RuntimeError, match="call flash_attention"):
        flash_attention_fwd(*a)


@pytest.mark.cuda
def test_cuda_bwd_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    lse = torch.zeros(1, 4, 16, device=dev)
    for D in (96, 256):              # the backward kernels take D = 32, 64 and 128
        q = torch.zeros(1, 4, 16, D, device=dev, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention_bwd(q, q[:, :2], q[:, :2], q, lse, q)
    q = torch.zeros(1, 4, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q[:, :2], q[:, :2], q, lse.double(), q)
    q = _misaligned(dev, (1, 4, 16, 64))      # TMA needs a 16-byte aligned base
    with pytest.raises(ValueError, match="aligned"):
        flash_attention_bwd(q, q[:, :2], q[:, :2], q, lse, q)


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_dkv_is_deterministic():
    """dk/dv sums each KV head's G query-head partials in a fixed order, with
    no atomics: two calls on the same inputs give the same bits."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, KVH, S, D = 2, 12, 2, 1000, 128
    q, do = (torch.randn(B, H, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, KVH, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = ref.flash_attention_ref(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    first = flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    second = flash_attention_bwd_dkv(q, k, v, lse, delta, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_dq_is_deterministic():
    """dq keeps its sum over the KV tiles in registers and writes it once,
    with no atomics: two calls on the same inputs give the same bits (dq and
    delta)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(3)
    B, H, KVH, S, D = 2, 12, 2, 1000, 128
    q, do = (torch.randn(B, H, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, KVH, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = ref.flash_attention_ref(q, k, v)
    first = flash_attention_bwd_dq(q, k, v, o, lse, do)
    second = flash_attention_bwd_dq(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_flash_attention_bwd_is_deterministic_at_head_dim_32():
    """dq and dk/dv at head dim 32 (a 64-column tile whose columns past 32
    the loads fill with zeros), at the bench train cell's per-call shapes:
    two calls give the same bits."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    B, H, KVH, S, D = 32, 12, 2, 256, 32
    q, do = (torch.randn(B, H, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, KVH, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    o, lse = ref.flash_attention_ref(q, k, v)
    dq = [flash_attention_bwd_dq(q, k, v, o, lse, do) for _ in range(2)]
    dkv = [flash_attention_bwd_dkv(q, k, v, lse, dq[0][1], do) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*dq))
    assert all(torch.equal(a, b) for a, b in zip(*dkv))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_cuda_fake_implementations_match_the_kernels_outputs(D):
    """Each kernel op's fake implementation (what the measurement traces)
    gives the shapes, strides, dtypes and devices of the kernel's own
    outputs, and a fake call launches nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ops
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(9)
    r = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=g, device=dev).to(dt)
    q, k, v = r(2, 12, 100, D), r(2, 2, 100, D), r(2, 2, 100, D)
    o, lse = flash_attention_fwd(q, k, v)
    calls = {
        "fwd": (flash_attention_fwd, (q, k, v)),
        "dq": (flash_attention_bwd_dq, (q, k, v, o, lse, q)),
        "dkv": (flash_attention_bwd_dkv, (q, k, v, lse, lse, q)),
        "decode": (flash_decode, (r(2, 12, D), k, v,
                                  torch.arange(100, device=dev, dtype=torch.int32).expand(2, 100)
                                  .contiguous(), torch.full((2,), 99, device=dev,
                                                            dtype=torch.int32))),
        "rglru": (rglru_scan, (r(2, 70, 48, dt=torch.float32), r(2, 70, 48, dt=torch.float32))),
        "wkv": (rwkv6_wkv, (r(2, 4, 70, 32), r(2, 4, 70, 32), r(2, 4, 70, 32),
                            -torch.rand(2, 4, 70, 32, generator=g, device=dev), r(4, 32))),
    }
    for name, (fn, args) in calls.items():
        real = fn(*args)
        real = real if isinstance(real, tuple) else (real,)
        before = ops.launch_counts()
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake_args = [mode.from_tensor(a) for a in args]
            fake = fn(*fake_args)
        assert ops.launch_counts() == before, name
        fake = fake if isinstance(fake, tuple) else (fake,)
        for a, b in zip(real, fake):
            assert (a.shape, a.stride(), a.dtype, a.device) == \
                (b.shape, b.stride(), b.dtype, b.device), name


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,W", [(3, 17, 32), (2, 50, 64), (1, 256, 128), (2, 300, 100),
                                   (1, 2000, 2560), (2, 130, 33)])
def test_cuda_rglru_scan_matches_plain(B, S, W):
    """The chain rounds the product and then the sum, as the plain version
    does: the same bits, also for a W that is no multiple of 4 (the cp.async
    path) and across reruns."""
    dev = _cuda()
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32)).to(dev)
    n0 = rglru_scan.launches
    h = rglru_scan(a, b)
    r = ref.rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == n0 + 1
    assert h.shape == (B, S, W) and h.dtype == torch.float32
    assert (h - r).abs().max().item() < 1e-5
    assert torch.equal(h, r)
    assert torch.equal(rglru_scan(a, b), h)


def _wkv_inputs(dev, B, H, S, hs, dt, seq_major, decay_sd, seed=4):
    """r, k, v (dt), w_log (f32) as (B,H,S,hs) views (of (B,S,H,hs) memory
    when ``seq_major``, as the model passes them), u (H,hs) in dt.  The decays
    are exp(w_log) with w_log = -exp(N(0, decay_sd)): decay_sd 3 gives steps
    from ~1 down to ~exp(-1e4), as strong as the random-weight models' own."""
    rng = np.random.default_rng(seed)
    mk = lambda x: _heads_major(torch.from_numpy(x.astype(np.float32)).to(dev), seq_major)
    r, k, v = (mk(rng.standard_normal((B, H, S, hs))).to(TDT[dt]) for _ in range(3))
    w_log = mk(-np.exp(decay_sd * rng.standard_normal((B, H, S, hs))))
    u = torch.from_numpy(rng.standard_normal((H, hs)).astype(np.float32)).to(dev, TDT[dt])
    return r, k, v, w_log, u


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,S,hs", [(2, 3, 70, 32), (1, 2, 64, 32), (1, 1, 130, 64),
                                      (2, 4, 1, 64), (1, 8, 333, 64), (1, 2, 63, 64),
                                      (1, 2, 65, 32), (1, 2, 4097, 64), (2, 64, 700, 64)])
@pytest.mark.parametrize("seq_major", [False, True])
@pytest.mark.parametrize("decay_sd", [1.0, 3.0])
def test_cuda_rwkv6_wkv_matches_plain(dt, B, H, S, hs, seq_major, decay_sd):
    dev = _cuda()
    r, k, v, w_log, u = _wkv_inputs(dev, B, H, S, hs, dt, seq_major, decay_sd)
    n0 = rwkv6_wkv.launches
    o, state = rwkv6_wkv(r, k, v, w_log, u)
    ro, rstate = ref.rwkv6_wkv_ref(r, k, v, w_log, u)
    torch.cuda.synchronize()
    assert rwkv6_wkv.launches == n0 + 1
    assert o.shape == (B, H, S, hs) and o.dtype == torch.float32
    assert state.shape == (B, H, hs, hs) and state.dtype == torch.float32
    assert (o - ro).abs().max().item() < 1e-5 * ro.abs().max().item()
    assert (state - rstate).abs().max().item() < 1e-5 * rstate.abs().max().item()


@pytest.mark.cuda
def test_cuda_rwkv6_wkv_is_deterministic():
    """The WKV's passes sum in fixed orders, with no atomics: two calls on the
    same inputs give the same bits (output and final state)."""
    dev = _cuda()
    x = _wkv_inputs(dev, 1, 64, 3000, 64, "bf16", True, 1.0)
    first, second = rwkv6_wkv(*x), rwkv6_wkv(*x)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_recurrent_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    a = torch.rand(1, 8, 32, device=dev)
    with pytest.raises(ValueError, match="dtypes"):
        rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(a.requires_grad_(), a)
    r, k, v, w_log, u = _wkv_inputs(dev, 1, 2, 10, 64, "bf16", False, 1.0)
    with pytest.raises(ValueError, match="dtypes"):
        rwkv6_wkv(r, k, v, w_log.bfloat16(), u)
    with pytest.raises(ValueError, match="head size"):
        rwkv6_wkv(r[..., :48], k[..., :48], v[..., :48], w_log[..., :48], u[:, :48])
    strided = torch.zeros(1, 2, 10, 128, device=dev, dtype=r.dtype)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        rwkv6_wkv(strided, k, v, w_log, u)
    with pytest.raises(RuntimeError, match="no backward"):
        rwkv6_wkv(r.float().requires_grad_(), k.float(), v.float(), w_log, u)
