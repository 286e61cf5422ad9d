"""GQA/MQA/MHA attention with RoPE, optional QKV bias, sliding window, KV cache.

Execution paths (numerically equivalent where applicable):

* ``plain``    — materialises (Sq, Skv) scores.
* ``blocked``  — online-softmax loop over KV blocks, O(S) live memory; used
                 for long prefill without the kernels.
* ``local``    — chunked sliding-window attention (self + previous chunk),
                 for windowed archs when S > 2 * window.
* ``pallas``   — the flash-attention CUDA kernels, forward and backward,
                 through their autograd Function (the name of the RunPolicy
                 switch, ``use_pallas``, is kept from the JAX package).

Decode attends one query token against a (possibly ring-buffered) cache,
through the flash-decode CUDA kernel when the kernels are on.  Activations
keep the JAX package's layouts: q (B,S,KV,G,dh), k/v (B,S,KV,dh), cache
(B,T,KV,dh).
"""
from __future__ import annotations

import math

import torch
from torch.overrides import (handle_torch_function, has_torch_function,
                             has_torch_function_unary)

from ..kernels.decode_attention import flash_decode
from ..kernels.flash_attention import flash_attention
from ..launch.sharding import maybe_constrain
from .layers import apply_rope, proj_heads
from .module import ParamSpec

NEG_INF = -2.3819763e38  # large negative for masking (bf16-safe)


def attn_specs(d_model: int, n_heads: int, n_kv: int, d_head: int, bias: bool):
    s = {
        "wq": ParamSpec((d_model, n_heads, d_head), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d_model, n_kv, d_head), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d_model, n_kv, d_head), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((n_heads, d_head, d_model), ("heads", "head_dim", "embed")),
    }
    if bias:
        s["bq"] = ParamSpec((n_heads, d_head), ("heads", "head_dim"), "zeros")
        s["bk"] = ParamSpec((n_kv, d_head), ("kv_heads", "head_dim"), "zeros")
        s["bv"] = ParamSpec((n_kv, d_head), ("kv_heads", "head_dim"), "zeros")
    return s


def qkv_proj(p, x, n_heads, n_kv, d_head, positions, rope_theta, use_rope=True):
    """x: (B,S,D) -> q (B,S,KV,G,dh), k,v (B,S,KV,dh); bias, then RoPE."""
    q, k, v = proj_heads(x, p["wq"]), proj_heads(x, p["wk"]), proj_heads(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if use_rope:
        q = apply_rope(q, positions[:, :, None], rope_theta)
        k = apply_rope(k, positions[:, :, None], rope_theta)
    return group_heads(q, n_kv), k, v


def group_heads(q, n_kv):
    """(B,S,H,dh) query heads as (B,S,KV,G,dh): G heads for each KV head.

    While a cell is traced on a mesh that splits the H heads unevenly over
    the KV groups, the trace's forms (``launch/xlaforms.py``) give
    (B,S,H,1,dh) instead, one group a query head; ``kv_for`` then repeats
    each K/V head for its query heads."""
    if has_torch_function_unary(q):
        return handle_torch_function(group_heads, (q,), q, n_kv)
    B, S, H, dh = q.shape
    return q.reshape(B, S, n_kv, H // n_kv, dh)


def kv_for(q, k):
    """k or v (B,T,KV,dh) for the groups of q (B,S,KV',G,dh): ``k`` itself,
    or, where q has one group a query head (KV' = H, the trace's form of an
    uneven split), each KV head repeated for its G query heads.  The repeat
    is a view where no gradient flows, and a product with a 0/1 matrix where
    one does (the view's gradient would split the sharded heads unevenly).
    A traced decode token's heads read their own KV heads (``xlaforms``)."""
    if has_torch_function((q, k)):
        return handle_torch_function(kv_for, (q, k), q, k)
    return repeat_kv(q, k)


def repeat_kv(q, k):
    """``kv_for``'s repeat, as it runs outside a trace's forms."""
    B, T, n_kv, dh = k.shape
    n_q = q.shape[2]
    if n_q == n_kv:
        return k
    if not (torch.is_grad_enabled() and k.requires_grad):
        return k[:, :, :, None].expand(B, T, n_kv, n_q // n_kv, dh).reshape(B, T, n_q, dh)
    heads = torch.arange(n_q, device=k.device) // (n_q // n_kv)
    sel = (heads == torch.arange(n_kv, device=k.device)[:, None]).to(k.dtype)
    return torch.einsum("btkd,kh->bthd", k, sel)


def plain_attention(q, k, v, positions_q, positions_kv, window=None):
    """q: (B,Sq,KV,G,dh); k,v: (B,Skv,KV,dh). Causal (+ optional window).

    Scores are formed in the input dtype and softmaxed in f32; the
    probabilities are rounded to the value dtype before the PV product, as
    in the JAX package.
    """
    dh = q.shape[-1]
    scores = torch.einsum("bqkgd,btkd->bkgqt", q, k) / math.sqrt(dh)
    pq = positions_q[:, None, None, :, None]
    pt = positions_kv[:, None, None, None, :]
    mask = pt <= pq
    if window is not None:
        mask &= pt > pq - window
    scores = torch.where(mask, scores.float(), NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgqt,btkd->bqkgd", w.to(v.dtype), v)


def blocked_attention(q, k, v, positions_q, positions_kv, window=None, block=None):
    """Online-softmax over KV blocks (flash-attention algebra, plain torch)."""
    B, Sq, KV, G, dh = q.shape
    Skv = k.shape[1]
    if block is None:
        block = max(512, min(4096, Skv // 8))
    # the last block padded to the block's length, as the JAX package pads
    # it: the padded keys sit at position 2**30, which no query sees
    pad = -Skv % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        positions_kv = torch.nn.functional.pad(positions_kv, (0, pad), value=2**30)
        Skv += pad
    scale = 1.0 / math.sqrt(dh)
    pq = positions_q[:, None, None, :, None]                       # (B,1,1,Sq,1)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, dh), dtype=torch.float32, device=q.device)
    for t0 in range(0, Skv, block):
        kk, vv = k[:, t0:t0 + block], v[:, t0:t0 + block]
        pkv = positions_kv[:, t0:t0 + block]
        s = torch.einsum("bqkgd,btkd->bkgqt", q, kk).float() * scale
        pt = pkv[:, None, None, None, :]
        mask = pt <= pq
        if window is not None:
            mask &= pt > pq - window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqt,btkd->bkgqd", p, vv.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(v.dtype)                  # (B,Sq,KV,G,dh)


def local_chunk_attention(q, k, v, positions_q, positions_kv, window):
    """Exact sliding-window attention over each window-long chunk and the one
    before it: O(S * 2W * d) instead of O(S^2 * d)."""
    B, S, KV, G, dh = q.shape
    C = window
    nc = -(-S // C)
    pad = nc * C - S
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        positions_q = torch.nn.functional.pad(positions_q, (0, pad), value=-(2**30))
        positions_kv = torch.nn.functional.pad(positions_kv, (0, pad), value=2**30)
    qc, kk, vv, pqc, pk = chunk_view(q, k, v, positions_q, positions_kv, C)
    s = torch.einsum("bnqkgd,bntkd->bnkgqt", qc, kk).float() / math.sqrt(dh)
    pq = pqc[:, :, None, None, :, None]
    pt = pk[:, :, None, None, None, :]
    mask = (pt <= pq) & (pt > pq - window)
    w = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    out = chunk_unview(torch.einsum("bnkgqt,bntkd->bnqkgd", w.to(vv.dtype), vv))
    return out[:, :S] if pad else out


def chunk_view(q, k, v, positions_q, positions_kv, C):
    """(qc, kk, vv, pqc, pk): the queries (B, n*C, ...) and their positions
    as n chunks (B, n, C, ...), and the keys, the values and their positions
    as each chunk's window (B, n, 2C, ...), the chunk before it (zeros, at
    position 2**30, which no query sees, before the first) and the chunk.

    While a cell is traced, where the sequence is sharded, the trace's forms
    (``launch/xlaforms.py``) keep each rank's positions in place: its
    queries one block of the chunk view (a chunk, or the part of one that
    the rank holds), each block's window of keys and values gathered over
    the mesh dims within a chunk, the chunk before by a halo exchange."""
    if has_torch_function((q, k, v)):
        return handle_torch_function(chunk_view, (q, k, v), q, k, v, positions_q,
                                     positions_kv, C)
    B, S = q.shape[:2]

    def chunks(x):
        return x.reshape((B, S // C, C) + tuple(x.shape[2:]))

    def windows(x, fill):
        xc = chunks(x)
        prev = torch.cat([torch.full_like(xc[:, :1], fill), xc[:, :-1]], dim=1)
        return torch.cat([prev, xc], dim=2)

    return (chunks(q), windows(k, 0), windows(v, 0), chunks(positions_q),
            windows(positions_kv, 2**30))


def chunk_unview(y):
    """``chunk_view``'s chunks (B, n, C, ...) back as (B, n*C, ...)."""
    if has_torch_function_unary(y):
        return handle_torch_function(chunk_unview, (y,), y)
    return y.reshape((y.shape[0], y.shape[1] * y.shape[2]) + tuple(y.shape[3:]))


def cache_shapes(batch, cache_len, n_kv, d_head, dtype):
    return {"k": ((batch, cache_len, n_kv, d_head), dtype),
            "v": ((batch, cache_len, n_kv, d_head), dtype),
            "pos": ((batch, cache_len), torch.int32)}


CACHE_AXES = {"k": ("batch", "cache_seq", "kv_heads", "head_dim"),
              "v": ("batch", "cache_seq", "kv_heads", "head_dim"),
              "pos": ("batch", "cache_seq")}


def decode_attention(p, cache, x, position, *, n_heads, n_kv, d_head,
                     rope_theta, window=None, use_rope=True, use_kernel=False):
    """One-token decode. x: (B,1,D); position: (B,) int32 current index.

    The cache is a ring buffer when ``window`` is set (slot = pos % len), else
    a linear buffer (slot = min(pos, len-1)).  K is stored post-RoPE.  The
    new K/V/pos are written into ``cache`` in place (the JAX version returns
    a new cache); the same dict is returned.  With ``use_kernel`` the
    attention runs in the flash-decode kernel, reading the cache in place.
    Returns (attn_out (B,1,KV,G,dh), cache).
    """
    B = x.shape[0]
    T = cache["k"].shape[1]
    q, k, v = qkv_proj(p, x, n_heads, n_kv, d_head, position[:, None],
                       rope_theta, use_rope)
    slot = position % T if window is not None else torch.clamp(position, max=T - 1)
    bidx = torch.arange(B, device=x.device)
    cache["k"][bidx, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][bidx, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][bidx, slot] = position.to(torch.int32)
    pos_kv = cache["pos"]
    q = maybe_constrain(q, ("batch", None, "kv_heads", "heads", "head_dim"))
    kk, vv = kv_for(q, cache["k"]), kv_for(q, cache["v"])
    if use_kernel:
        o = flash_decode(q.reshape(B, n_heads, d_head),
                         kk.permute(0, 2, 1, 3), vv.permute(0, 2, 1, 3),
                         pos_kv, position.to(torch.int32), window=window)
        return o.reshape(q.shape), cache
    s = torch.einsum("bqkgd,btkd->bkgqt", q, kk).float() / math.sqrt(d_head)
    pq = position[:, None, None, None, None]
    pt = pos_kv[:, None, None, None, :]
    mask = (pt >= 0) & (pt <= pq)
    if window is not None:
        mask &= pt > pq - window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", w.to(vv.dtype), vv)
    return out, cache


def out_proj(p, attn_out):
    """attn_out: (B,S,KV,G,dh) -> (B,S,D)."""
    B, S, KV, G, dh = attn_out.shape
    w = p["wo"]
    return attn_out.reshape(B, S, KV * G * dh) @ w.reshape(-1, w.shape[-1])


def pallas_attention(q, k, v, window=None):
    """Send (B,S,KV,G,dh) GQA tensors through the flash-attention kernels.

    The kernels read transposed views, so nothing is copied on the way in,
    and the output (and, in backward, dq, dk and dv) comes back in
    (B,S,heads,dh) memory order.
    """
    B, S, KV, G, dh = q.shape
    qk = q.reshape(B, S, KV * G, dh).permute(0, 2, 1, 3)
    o = flash_attention(qk, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), window)
    return o.permute(0, 2, 1, 3).reshape(B, S, KV, G, dh)


def attend(q, k, v, positions, impl, window=None, block=None):
    """Causal self-attention of (B,S,KV,G,dh) q over (B,S,KV,dh) k/v by the
    path ``impl`` names; the one place that choice is made."""
    k, v = kv_for(q, k), kv_for(q, v)
    if impl == "pallas":
        return pallas_attention(q, k, v, window)
    if impl == "local" and window is not None and q.shape[1] > 2 * window:
        return local_chunk_attention(q, k, v, positions, positions, window)
    if impl == "blocked":
        return blocked_attention(q, k, v, positions, positions, window, block=block)
    return plain_attention(q, k, v, positions, positions, window)


def full_attention(p, x, positions, *, n_heads, n_kv, d_head, rope_theta,
                   window=None, impl="plain", use_rope=True, block=512):
    """Full-sequence self-attention (train / prefill). Returns (B,S,D)."""
    q, k, v = qkv_proj(p, x, n_heads, n_kv, d_head, positions, rope_theta, use_rope)
    q = maybe_constrain(q, ("batch", "seq_q", "kv_heads", "heads", "head_dim"))
    k = maybe_constrain(k, ("batch", None, "kv_heads", "head_dim"))
    o = attend(q, k, v, positions, impl, window, block=block)
    o = maybe_constrain(o, ("batch", "seq_q", "kv_heads", "heads", "head_dim"))
    return out_proj(p, o)
