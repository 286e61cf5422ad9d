"""The CUDA kernels against their plain PyTorch versions, on a GPU.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels have no CPU
mode) and skip without one.  They import neither JAX nor the JAX package, so
they run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 2e-5 with TF32 off, bf16 2e-2; for the backward kernels
f32 5e-5 (the reference's grad bound) and bf16 2e-2, each of the call's
scale max(1, max|plain grad|): the bf16 kernels round P and dS to bf16 for
their products, as the forward rounds P.
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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window,shift", [(None, 0), (50, 0), (None, 37)])
@pytest.mark.parametrize("seq_major", [False, True])
def test_cuda_flash_attention_matches_plain(dt, D, window, shift, seq_major):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, KVH, Sq = 2, 12, 2, 200
    mk = lambda *s: _heads_major(torch.randn(*s, generator=g, device=dev).to(TDT[dt]),
                                 seq_major)
    q, k, v = mk(B, H, Sq, D), mk(B, KVH, Sq + shift, D), mk(B, KVH, Sq + shift, D)
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
@pytest.mark.parametrize("H,KVH,D", [(12, 2, 128), (12, 1, 64)])
def test_cuda_flash_decode_matches_plain(dt, window, H, KVH, D):
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


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros(1, 4, 16, 96, device=dev, dtype=torch.bfloat16)     # D = 96
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q, q[:, :2], q[:, :2])
    q = torch.zeros(1, 4, 16, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention_fwd(q, q[:, :2], q[:, :2])


def _scaled_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            max(1.0, want.float().abs().max().item())).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window,shift", [(None, 0), (50, 0), (None, 37), (70, 21)])
@pytest.mark.parametrize("seq_major", [False, True])
def test_cuda_flash_attention_bwd_matches_plain(dt, D, window, shift, seq_major):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    B, H, KVH, Sq = 2, 12, 2, 200
    mk = lambda *s: _heads_major(torch.randn(*s, generator=g, device=dev).to(TDT[dt]),
                                 seq_major)
    q, k, v = mk(B, H, Sq, D), mk(B, KVH, Sq + shift, D), mk(B, KVH, Sq + shift, D)
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
    q = torch.zeros(1, 4, 16, 96, device=dev, dtype=torch.bfloat16)     # D = 96
    lse = torch.zeros(1, 4, 16, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q, q[:, :2], q[:, :2], q, lse, q)
    q = torch.zeros(1, 4, 16, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q[:, :2], q[:, :2], q, lse.double(), q)
