"""Plain PyTorch versions of the attention kernels (the correctness ground truth).

They take the kernels' layouts: q (B,H,Sq,D) and k, v (B,KVH,Skv,D) for
attention; q (B,H,D), k, v (B,KVH,T,D), pos (B,T) and qpos (B,) for decode.
Query head h reads KV head h // G (G = H // KVH).  Scores, softmax and the
PV product are computed in f32 from the inputs; the output is cast back to
the input dtype.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


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
    q_pos = torch.arange(Sq, device=q.device)[:, None] + causal_shift
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    s = torch.where(mask, s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype), lse.reshape(B, H, Sq)


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
