"""The attention and WKV kernels at the head dims of the JAX package's own
tests (``tests/test_kernels.py``): D = 16 for flash attention, hs = 16 for
the WKV.

On the CPU the wrappers run their kernels' plain versions: the forward and
the gradients through the ``FlashAttention`` Function at (1, 2, 2, 16, 16,
16), window None and 24, against the JAX package's Pallas kernels in
interpret mode (f32 2e-5, bf16 2e-2, gradients 5e-5 absolute), and the WKV
at (2, 3, 70, 16) with bf16 streams against the Pallas WKV (1e-5 of the
largest value; f32 streams: ``test_torch_recurrent_kernels.py``).  Both
head dims are in the wrappers' lists, so a CUDA tensor at them launches a
kernel (``tests/test_torch_cuda.py`` runs the kernels at them on a GPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_attention import flash_attention_fwd as j_flash_attention_fwd
from repro.kernels.rwkv6_kernel import rwkv6_wkv as j_rwkv6_wkv
from repro_torch.kernels.flash_attention import (BWD_HEAD_DIMS, FWD_HEAD_DIMS,
                                                 flash_attention, flash_attention_fwd)
from repro_torch.kernels.rwkv6_kernel import HEAD_SIZES, rwkv6_wkv

SHAPE = (1, 2, 2, 16, 16, 16)          # tests/test_kernels.py's first attention case
TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = 5e-5


def test_the_wrappers_take_head_dim_16():
    assert 16 in FWD_HEAD_DIMS and 16 in BWD_HEAD_DIMS and 16 in HEAD_SIZES


def _inputs(seed=0):
    B, H, KVH, Sq, Skv, D = SHAPE
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in
            ((B, H, Sq, D), (B, KVH, Skv, D), (B, KVH, Skv, D), (B, H, Sq, D))]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 24])
def test_forward_at_head_dim_16_matches_pallas(dt, window):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    q, k, v, _ = _inputs()
    jo, jlse = j_flash_attention_fwd(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
                                     window=window, causal_shift=0, block_q=16, block_k=16,
                                     interpret=True)
    o, lse = flash_attention_fwd(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                                 window=window, causal_shift=0)
    assert float(np.max(np.abs(np.asarray(jo, np.float32) - o.float().numpy()))) < TOL[dt]
    assert float(np.max(np.abs(np.asarray(jlse, np.float32) - lse.numpy()))) < TOL[dt]


@pytest.mark.parametrize("window", [None, 24])
def test_gradients_at_head_dim_16_match_pallas(window):
    import jax
    q, k, v, w = _inputs(seed=3)

    def f_jax(q, k, v):
        return (j_flash_attention(q, k, v, window, 0, 16, 16, True) * w).sum()
    jg = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (flash_attention(tq, tk, tv, window, 0) * torch.from_numpy(w)).sum().backward()
    for a, t, name in zip(jg, (tq, tk, tv), "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), atol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("chunk", [16, 32])
def test_bf16_wkv_at_head_size_16_matches_pallas(chunk):
    B, H, S, hs = 2, 3, 70, 16             # tests/test_kernels.py's first WKV case
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal((B, H, S, hs)).astype(np.float32) for _ in range(3))
    w_log = -np.exp(rng.standard_normal((B, H, S, hs))).astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    # the bf16 streams and bonus, rounded once and handed to both packages
    r, k, v, u = (torch.from_numpy(x).bfloat16().float().numpy() for x in (r, k, v, u))
    jo = j_rwkv6_wkv(*map(jnp.asarray, (r, k, v, w_log, u)), chunk=chunk, interpret=True)
    o, state = rwkv6_wkv(*(torch.from_numpy(x).bfloat16() for x in (r, k, v)),
                         torch.from_numpy(w_log), torch.from_numpy(u).bfloat16())
    want = np.asarray(jo)
    assert o.shape == (B, H, S, hs) and state.shape == (B, H, hs, hs)
    assert float(np.max(np.abs(want - o.numpy()))) < 1e-5 * float(np.max(np.abs(want)))
    exact = np.asarray(jref.rwkv6_wkv_ref(*map(jnp.asarray, (r, k, v, w_log, u))))
    assert float(np.max(np.abs(exact - o.numpy()))) < 1e-5 * float(np.max(np.abs(exact)))
