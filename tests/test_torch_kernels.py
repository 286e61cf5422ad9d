"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain version; the Pallas kernels
run in interpret mode, as tests/test_kernels.py runs them.  Inputs are drawn
with numpy and handed to both packages.  Tolerances are the reference's own:
f32 2e-5, bf16 2e-2, and 5e-5 absolute for the f32 gradients of flash
attention (tests/test_kernels.py's bound).  The CUDA kernels themselves are
tested on a GPU by tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import flash_decode as j_flash_decode
from repro.kernels.flash_attention import flash_attention as j_flash_attention
from repro.kernels.flash_attention import flash_attention_fwd as j_flash_attention_fwd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (MAX_CLUSTER, SMEM_LIMIT, decode_plan,
                                                  flash_decode)
from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                 flash_attention_fwd)

TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = 5e-5
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def both(x, dt):
    """One numpy draw as a JAX array and a torch tensor of the same dtype."""
    return jnp.asarray(x).astype(JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) -
                               b.float().numpy())))


ATTN_SHAPES = [                   # tests/test_kernels.py sweep, plus G = 6
    (1, 2, 2, 16, 16, 16),
    (2, 4, 2, 48, 48, 32),
    (1, 6, 2, 128, 128, 64),
    (2, 2, 1, 33, 65, 32),
    (1, 12, 2, 40, 40, 32),
]


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D", ATTN_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 24])
def test_flash_attention_matches_pallas(B, H, KVH, Sq, Skv, D, dt, window):
    rng = np.random.default_rng(0)
    jq, tq = both(rng.standard_normal((B, H, Sq, D), np.float32), dt)
    jk, tk = both(rng.standard_normal((B, KVH, Skv, D), np.float32), dt)
    jv, tv = both(rng.standard_normal((B, KVH, Skv, D), np.float32), dt)
    shift = Skv - Sq
    o, lse = flash_attention_fwd(tq, tk, tv, window=window, causal_shift=shift)
    jo, jlse = j_flash_attention_fwd(jq, jk, jv, window=window, causal_shift=shift,
                                     block_q=16, block_k=16, interpret=True)
    r = jref.flash_attention_ref(jq, jk, jv, window=window, causal_shift=shift)
    assert o.dtype == TDT[dt] and o.shape == (B, H, Sq, D)
    assert err(jo, o) < TOL[dt]
    assert err(r, o) < TOL[dt]
    assert err(jlse, lse) < TOL[dt]


DECODE_SHAPES = [(2, 4, 2, 100, 32), (1, 2, 1, 64, 64), (3, 3, 3, 40, 16),
                 (2, 12, 2, 50, 32)]


def _decode_inputs(B, H, KVH, T, D, dt):
    rng = np.random.default_rng(1)
    jq, tq = both(rng.standard_normal((B, H, D), np.float32), dt)
    jk, tk = both(rng.standard_normal((B, KVH, T, D), np.float32), dt)
    jv, tv = both(rng.standard_normal((B, KVH, T, D), np.float32), dt)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    pos[:, T - 10:] = -1                        # unwritten ring slots
    qpos = np.array([T - 11] + [T // 2] * (B - 1), np.int32)
    return (jq, jk, jv, jnp.asarray(pos), jnp.asarray(qpos)), \
        (tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(qpos))


@pytest.mark.parametrize("B,H,KVH,T,D", DECODE_SHAPES)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 30])
def test_flash_decode_matches_pallas(B, H, KVH, T, D, dt, window):
    j, t = _decode_inputs(B, H, KVH, T, D, dt)
    o = flash_decode(*t, window=window)
    jo = j_flash_decode(*j, window=window, block_k=16, interpret=True)
    r = jref.flash_decode_ref(*j, window=window)
    assert o.dtype == TDT[dt] and o.shape == (B, H, D)
    assert err(jo, o) < TOL[dt]
    assert err(r, o) < TOL[dt]


def test_ops_dispatch_matches_plain_on_cpu():
    """On the CPU each wrapper is its plain version, also on the strided views
    the model passes, and counts no launch."""
    _, (q, k, v, pos, qpos) = _decode_inputs(2, 4, 2, 100, 32, "f32")
    ops.reset_launch_counts()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    assert torch.equal(flash_decode(q, kt.transpose(1, 2), vt.transpose(1, 2), pos, qpos),
                       tref.flash_decode_ref(q, k, v, pos, qpos))
    g = torch.Generator().manual_seed(0)
    qs, ks = torch.randn(1, 20, 4, 16, generator=g), torch.randn(1, 20, 2, 16, generator=g)
    qa, ka = qs.permute(0, 2, 1, 3), ks.permute(0, 2, 1, 3)
    o, lse = flash_attention_fwd(qa, ka, ka)
    ro, rlse = tref.flash_attention_ref(qa.contiguous(), ka.contiguous(), ka.contiguous())
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    do = torch.randn(1, 20, 4, 16, generator=g).permute(0, 2, 1, 3)
    grads = flash_attention_bwd(qa, ka, ka, o, lse, do)
    ref_grads = tref.flash_attention_bwd_ref(qa.contiguous(), ka.contiguous(),
                                             ka.contiguous(), o, lse, do.contiguous())
    assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads))
    assert ops.launch_counts() == {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                                   "flash_attention_bwd_dkv": 0, "flash_decode": 0,
                                   "rglru_scan": 0, "rwkv6_wkv": 0}


@pytest.mark.parametrize("B,KVH,T,n_sm", [(4, 2, 4096, 132), (1, 1, 40, 132),
                                          (64, 8, 32768, 132), (3, 3, 1000, 8)])
@pytest.mark.parametrize("D,element_size", [(16, 2), (128, 2), (256, 2), (256, 4)])
def test_decode_plan_covers_cache(B, KVH, T, n_sm, D, element_size):
    """The flash-decode plan: a power-of-two cluster of at most 16 blocks whose
    ranges of whole tiles cover every cache slot once, in shared memory a
    block can have; and a cluster the card cannot hold B * KVH of at once is
    halved."""
    plan = decode_plan(B, KVH, T, D, element_size, n_sm)
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.cluster & (plan.cluster - 1) == 0
    assert plan.slots % plan.tile == 0 and plan.smem <= SMEM_LIMIT
    covered = [t for lo, hi in plan.ranges(T) for t in range(lo, hi)]
    assert covered == list(range(T))
    assert B * KVH * plan.cluster >= min(n_sm, B * KVH * MAX_CLUSTER, B * KVH * -(-T // plan.tile)) / 2
    held = {16: 7, 8: 15, 4: 30, 2: 66}      # a card that holds fewer large clusters at once
    small = decode_plan(B, KVH, T, D, element_size, n_sm, lambda c: held[c])
    assert small.cluster <= plan.cluster
    assert small.cluster == 1 or held[small.cluster] >= B * KVH
    assert [t for lo, hi in small.ranges(T) for t in range(lo, hi)] == list(range(T))


def _grad_inputs(B, H, KVH, Sq, Skv, D, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32) for s in
            ((B, H, Sq, D), (B, KVH, Skv, D), (B, KVH, Skv, D), (B, H, Sq, D))]


@pytest.mark.parametrize("window", [None, 20])
@pytest.mark.parametrize("shift", [0, 13])
@pytest.mark.parametrize("seq_major", [False, True])
def test_flash_attention_grads_match_pallas(window, shift, seq_major):
    """Grads of sum(o * w) through the port's FlashAttention Function against
    JAX's custom_vjp flash_attention (Pallas in interpret mode), also on the
    strided (B,S,H,D)-memory views the model passes."""
    B, H, KVH, Sq, D = 2, 4, 2, 48, 32
    q, k, v, w = _grad_inputs(B, H, KVH, Sq, Sq + shift, D)

    def f_jax(q, k, v):
        return (j_flash_attention(q, k, v, window, shift, 16, 16, True) * w).sum()
    jg = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    def leaf(x):
        t = torch.from_numpy(x)
        if seq_major:                    # (B,S,heads,D) memory viewed as (B,heads,S,D)
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        return t.requires_grad_()
    tq, tk, tv = leaf(q), leaf(k), leaf(v)
    (flash_attention(tq, tk, tv, window, shift) * torch.from_numpy(w)).sum().backward()
    for a, t, name in zip(jg, (tq, tk, tv), "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(a), atol=GRAD_TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,H,KVH,Sq,Skv,D", ATTN_SHAPES)
@pytest.mark.parametrize("window", [None, 24])
def test_plain_backward_matches_autograd(B, H, KVH, Sq, Skv, D, window):
    """flash_attention_bwd_ref, written out in the kernels' layouts, against
    autograd through flash_attention_ref."""
    q, k, v, do = map(torch.from_numpy, _grad_inputs(B, H, KVH, Sq, Skv, D))
    shift = Skv - Sq
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tref.flash_attention_ref(*leaves, window=window, causal_shift=shift)
    o.backward(do)
    dq, dk, dv = tref.flash_attention_bwd_ref(q, k, v, o.detach(), lse.detach(), do,
                                              window=window, causal_shift=shift)
    for got, t, name in zip((dq, dk, dv), leaves, "qkv"):
        assert got.dtype == t.dtype and got.shape == t.shape
        assert (got - t.grad).abs().max().item() < GRAD_TOL, name
