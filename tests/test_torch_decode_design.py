"""The flash-decode kernel's design, rehearsed in plain PyTorch on the CPU.

``csrc/decode_attention.cu`` runs one cluster of blocks per (b, KV head):
each block walks only the tiles of its range that hold a visible slot, its
four consumer warps keep their own online softmax over the tiles dealt to
them in turn, the block adds the warps' states in warp order, and the
cluster merges the blocks' states.  ``rehearse`` repeats that algebra, from
the wrapper's own plan (``decode_plan``), and is held against the port's
plain version and against the JAX package's Pallas kernel in interpret mode
with the reference's tolerances (f32 2e-5, bf16 2e-2).  In bf16 the
rehearsal rounds P to bf16 for the P V product, as the kernel's mma does.
The kernel itself is tested on a GPU by tests/test_torch_cuda.py.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import flash_decode as j_flash_decode
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_plan

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
NEG_INF = tref.NEG_INF
N_CONSUMERS = 4        # consumer warps of a block (NC in the source)


def visible(pos_row, qpos, window):
    vis = (pos_row >= 0) & (pos_row <= qpos)
    if window is not None:
        vis &= pos_row > qpos - window
    return vis


def rehearse(q, k, v, pos, qpos, window, plan):
    """The kernel's algebra in f32: returns (o (B,H,D) in q's dtype, the
    tiles each block read, as {(b, kh, rank): [first slots]})."""
    B, H, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D)
    round_p = q.dtype == torch.bfloat16
    out = torch.empty((B, H, D), dtype=torch.float32)
    read = {}
    for b in range(B):
        vis = visible(pos[b], int(qpos[b]), window)
        for kh in range(KVH):
            qg = q[b, kh * G:(kh + 1) * G].float()
            blocks = []
            for rank, (lo, hi) in enumerate(plan.ranges(T)):
                # producer: the tiles of [lo, hi) with a visible slot, in order
                tiles = []
                for t0 in range(lo, hi, plan.tile):
                    mask = torch.zeros(plan.tile, dtype=torch.bool)
                    mask[:min(hi, t0 + plan.tile) - t0] = vis[t0:min(hi, t0 + plan.tile)]
                    if mask.any():
                        tiles.append((t0, mask))
                read[(b, kh, rank)] = [t0 for t0, _ in tiles]
                # consumer warp w takes tiles w, w + 4, ...
                warps = []
                for w in range(N_CONSUMERS):
                    m = torch.full((G,), NEG_INF)
                    l, o = torch.zeros(G), torch.zeros(G, D)
                    for t0, mask in tiles[w::N_CONSUMERS]:
                        rows = torch.clamp(torch.arange(t0, t0 + plan.tile), max=T - 1)
                        s = qg @ k[b, kh, rows].float().T * scale
                        s = torch.where(mask[None], s, NEG_INF)
                        mn = torch.maximum(m, s.max(-1).values)
                        alpha = torch.exp(m - mn)
                        p = torch.exp(s - mn[:, None])
                        pv = p.bfloat16().float() if round_p else p
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + pv @ v[b, kh, rows].float()
                        m = mn
                    warps.append((m, l, o))
                # the block: warps added in order, rescaled to the block's max
                cm = torch.stack([w_[0] for w_ in warps]).max(0).values
                cl, oc = torch.zeros(G), torch.zeros(G, D)
                for wm, wl, wo in warps:
                    cl = cl + wl * torch.exp(wm - cm)
                    oc = oc + wo * torch.exp(wm - cm)[:, None]
                blocks.append((cm, cl, oc, int(vis[lo:hi].sum())))
            heads = slice(kh * G, (kh + 1) * G)
            if sum(n for *_, n in blocks) == 0:
                # no visible slot: the plain version's uniform softmax, the mean of V
                out[b, heads] = v[b, kh].float().sum(0) / T
                continue
            M = torch.stack([c[0] for c in blocks]).max(0).values
            L, O = torch.zeros(G), torch.zeros(G, D)
            for cm, cl, oc, _ in blocks:
                L = L + cl * torch.exp(cm - M)
                O = O + oc * torch.exp(cm - M)[:, None]
            out[b, heads] = O / L[:, None]
    return out.to(q.dtype), read


def _inputs(B, H, KVH, T, D, dt, fills, cache, seed=5):
    """q, k, v drawn with numpy (as JAX arrays and torch tensors), and the
    positions of a linear cache (the first n slots written) or of a ring of T
    slots after n tokens (slot = position % T)."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(s, np.float32) for s in ((B, H, D), (B, KVH, T, D), (B, KVH, T, D))]
    pos = np.full((B, T), -1, np.int32)
    for b, n in enumerate(fills):
        p = np.arange(max(0, n - T) if cache == "ring" else 0, min(n, T) if cache == "linear"
                      else n, dtype=np.int32)
        pos[b, p % T] = p
    qpos = np.array([n - 1 for n in fills], np.int32)
    j = [jnp.asarray(a).astype(JDT[dt]) for a in x] + [jnp.asarray(pos), jnp.asarray(qpos)]
    t = [torch.from_numpy(a).to(TDT[dt]) for a in x] + [torch.from_numpy(pos),
                                                        torch.from_numpy(qpos)]
    return j, t


def err(want, got):
    want = want.float() if isinstance(want, torch.Tensor) else np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(want) - got.float().numpy())))


@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["linear", "ring"])
@pytest.mark.parametrize("window", [None, 50])
def test_decode_rehearsal_matches_plain_and_pallas(D, dt, cache, window):
    """Lanes of 300, 130 and 40 written slots of a 300-slot cache (the ring
    wraps for the first): most tiles of the short lanes hold no visible slot,
    and the plan's last block owns none at all."""
    B, H, KVH, T = 3, 8, 2, 300
    fills = (700 if cache == "ring" else 300, 130, 40)
    j, t = _inputs(B, H, KVH, T, D, dt, fills, cache)
    plan = decode_plan(B, KVH, T, D, t[0].element_size(), n_sm=132)
    assert plan.cluster > 1
    o, read = rehearse(*t, window, plan)
    r = tref.flash_decode_ref(*t, window=window)
    jo = j_flash_decode(*j, window=window, block_k=20, interpret=True)
    assert o.dtype == TDT[dt] and o.shape == (B, H, D)
    assert err(r, o) < TOL[dt]
    assert err(jo, o) < TOL[dt]
    # every tile read holds a visible slot, and the short lanes skip most
    qpos = t[4]
    for (b, _, _), starts in read.items():
        vis = visible(t[3][b], int(qpos[b]), window)
        assert all(vis[s:s + plan.tile].any() for s in starts)
    if window is None and cache == "linear":    # lane 2: 40 of 300 slots
        assert sum(len(s) for (b, _, _), s in read.items() if b == 2) == \
            KVH * -(-40 // plan.tile)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("D", [16, 256])
def test_decode_rehearsal_lane_with_no_visible_slot(dt, D):
    """A lane with nothing visible (an empty cache: qpos = -1) gets the mean of
    V over all T slots, as the plain version's softmax over all-masked scores
    gives; the other lane is unaffected.  G = 16, the most a block takes."""
    B, H, KVH, T = 2, 16, 1, 200
    _, t = _inputs(B, H, KVH, T, D, dt, (150, 0), "linear")
    plan = decode_plan(B, KVH, T, D, t[0].element_size(), n_sm=132)
    o, read = rehearse(*t, None, plan)
    r = tref.flash_decode_ref(*t)
    assert all(not starts for (b, _, _), starts in read.items() if b == 1)
    assert err(r, o) < TOL[dt]
    np.testing.assert_allclose(o[1].float().numpy(),
                               t[2][1, 0].float().mean(0).expand(H, D).numpy(),
                               atol=TOL[dt])
