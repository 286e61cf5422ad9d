"""Plain PyTorch versions of the kernels (the correctness ground truth).

They take the kernels' layouts: q (B,H,Sq,D) and k, v (B,KVH,Skv,D) for
attention; q (B,H,D), k, v (B,KVH,T,D), pos (B,T) and qpos (B,) for decode;
a, b (B,S,W) for the RG-LRU scan; r, k, v, w_log (B,H,S,hs) and u (H,hs) for
the RWKV-6 WKV.
Query head h reads KV head h // G (G = H // KVH).  Scores, softmax and the
PV product are computed in f32 from the inputs; the output is cast back to
the input dtype.  The attention backward is written out in the same layouts
(not taken from autograd), in f32, in the two parts the CUDA kernels split it
into: dq (with delta = rowsum(do * o)) and dk/dv.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def _mask(Sq, Skv, window, causal_shift, device):
    """(Sq, Skv) bool: query row i (absolute position i + causal_shift) sees
    key j."""
    q_pos = torch.arange(Sq, device=device)[:, None] + causal_shift
    k_pos = torch.arange(Skv, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def flash_attention_ref(q, k, v, window=None, causal_shift=0):
    """Materialised-score causal attention.  Returns (o, lse).

    Query row i sits at absolute position i + causal_shift; key column j at j.
    ``lse`` (B,H,Sq) f32 is the log-sum-exp of the scaled, masked scores.
    """
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    G = H // KVH
    qr = q.reshape(B, KVH, G, Sq, D).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qr, k.float()) / math.sqrt(D)
    s = torch.where(_mask(Sq, Skv, window, causal_shift, q.device), s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


def _grouped(x, KVH):
    """(B,H,S,D) -> (B,KVH,G,S,D) f32 (any strides)."""
    B, H, S = x.shape[:3]
    return x.reshape(B, KVH, H // KVH, S, *x.shape[3:]).float()


def _bwd_p_ds(q, k, v, lse, delta, do, window, causal_shift):
    """p = exp(s * scale - lse) on visible pairs, else 0, and
    ds = p * (do v^T - delta) * scale, both (B,KVH,G,Sq,Skv) f32."""
    D = q.shape[-1]
    KVH, Skv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    s = torch.einsum("bkgqd,bktd->bkgqt", _grouped(q, KVH), k.float()) * scale
    mask = _mask(q.shape[2], Skv, window, causal_shift, q.device)
    p = torch.where(mask, torch.exp(s - _grouped(lse, KVH)[..., None]), 0.0)
    dp = torch.einsum("bkgqd,bktd->bkgqt", _grouped(do, KVH), v.float())
    ds = p * (dp - _grouped(delta, KVH)[..., None]) * scale
    return p, ds


def flash_attention_bwd_dq_ref(q, k, v, o, lse, do, window=None, causal_shift=0):
    """dq = ds k.  Returns (dq (B,H,Sq,D) in q's dtype, delta (B,H,Sq) f32),
    delta = rowsum(do * o) as the backward's second part reads it."""
    delta = (do.float() * o.float()).sum(-1)
    _, ds = _bwd_p_ds(q, k, v, lse, delta, do, window, causal_shift)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype), delta


def flash_attention_bwd_dkv_ref(q, k, v, lse, delta, do, window=None, causal_shift=0):
    """dk = ds^T q and dv = p^T do, summed over the G query heads of each KV
    head.  Returns (dk, dv) (B,KVH,Skv,D) in k's and v's dtypes."""
    KVH = k.shape[1]
    p, ds = _bwd_p_ds(q, k, v, lse, delta, do, window, causal_shift)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, _grouped(q, KVH))
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, _grouped(do, KVH))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, o, lse, do, window=None, causal_shift=0):
    """Backward of ``flash_attention_ref`` given its output ``o``, its ``lse``
    and the output's gradient ``do``.  Returns (dq, dk, dv)."""
    dq, delta = flash_attention_bwd_dq_ref(q, k, v, o, lse, do, window, causal_shift)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, lse, delta, do, window, causal_shift)
    return dq, dk, dv


def flash_decode_ref(q, k, v, pos, qpos, window=None):
    """One query token per (b, h) against a cache.  Returns o (B,H,D).

    A cache slot is visible when pos >= 0 and pos <= qpos (and, with a
    window, pos > qpos - window).
    """
    B, H, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    qr = q.reshape(B, KVH, G, D).float()
    s = torch.einsum("bkgd,bktd->bkgt", qr, k.float()) / math.sqrt(D)
    qp = qpos[:, None]
    mask = (pos >= 0) & (pos <= qp)
    if window is not None:
        mask &= pos > qp - window
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def rglru_scan_ref(a, b):
    """Sequential linear recurrence h_t = a_t h_{t-1} + b_t from h_{-1} = 0.
    a, b: (B,S,W) f32 -> h (B,S,W) f32."""
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rwkv6_wkv_ref(r, k, v, w_log, u):
    """Exact sequential RWKV-6 WKV.  r, k, v, w_log: (B,H,S,hs); u: (H,hs).

    Per head, with the (hs, hs) state S (k-major) from zero:
    o_t = r_t (S + diag(u) k_t v_t^T),  S <- diag(exp(w_log_t)) S + k_t v_t^T.
    Returns (o (B,H,S,hs) f32, the state after the last token (B,H,hs,hs) f32).
    """
    B, H, S, hs = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(w_log.float())
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    o = torch.empty((B, H, S, hs), dtype=torch.float32, device=r.device)
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        o[:, :, t] = torch.einsum("bhk,bhkv->bhv", rf[:, :, t], state + uf * kv)
        state = wf[:, :, t, :, None] * state + kv
    return o, state
