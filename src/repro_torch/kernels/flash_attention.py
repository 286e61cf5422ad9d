"""Flash-attention forward: the CUDA kernel in ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py:_fwd_kernel``.
Layouts: q (B,H,Sq,D), k/v (B,KVH,Skv,D), H = KVH * G, query head h reads KV
head h // G.  The inputs may be strided views (the model passes transposed
views of its (B,S,H,D) activations, so nothing is copied); only the last dim
must be contiguous.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _bind():
    lib = build.load("flash_attention")
    fn = lib.fa_fwd
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 5 + [I] * 6 + [L] * 12 + [I, I, I, P]
        fn.restype = ctypes.c_int
    return fn


def _check_strided(name, t, align_elems):
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous, strides {t.stride()}")
    if any(s % align_elems for s in t.stride()[:-1]):
        raise ValueError(f"{name}: strides {t.stride()} must be multiples of {align_elems}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def flash_attention_fwd(q, k, v, *, window=None, causal_shift=0):
    """Causal GQA attention.  Returns (o (B,H,Sq,D), lse (B,H,Sq) f32).

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``flash_attention_fwd.launches``) or
    raises.  ``o`` is allocated as (B,Sq,H,D) and returned as a (B,H,Sq,D)
    view, the layout the model's output projection reads.
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, causal_shift=causal_shift)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KVH, Skv = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"flash_attention_fwd: H={H} not a multiple of KVH={KVH}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_fwd: dtypes {q.dtype} {k.dtype} {v.dtype}")
    if not (k.device == q.device == v.device):
        raise ValueError("flash_attention_fwd: q, k, v on different devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window {window} < 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_strided(name, t, 8)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    fn = _bind()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                 B, H, KVH, Sq, Skv, D,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
                 0 if window is None else int(window), int(causal_shift),
                 _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed (error {err})")
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0

