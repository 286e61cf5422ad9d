"""Flash-decode: the CUDA kernels in ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:_decode_kernel``.
Layouts: q (B,H,D); k, v (B,KVH,T,D), which may be strided views (the model
passes a transposed view of its (B,T,KVH,D) cache, read in place); pos (B,T)
int32 with -1 for an empty slot; qpos (B,) int32.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import flash_decode_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16      # query heads per KV head (MAXG in the source)
MAX_CHUNK = 128     # cache slots per split (CHUNK in the source)


def max_chunk(D, element_size):
    """Most cache slots per split whose K and V rows fit in shared memory:
    half of MAX_CHUNK for f32 at D = 256."""
    return MAX_CHUNK // 2 if D * element_size > 512 else MAX_CHUNK


def _bind():
    lib = build.load("decode_attention")
    fn = lib.flash_decode
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 9 + [I] * 7 + [L] * 9 + [I, I, P]
        fn.restype = ctypes.c_int
    return fn


def split_plan(B, KVH, T, n_sm, chunk_cap=MAX_CHUNK):
    """(chunk, nsplit): split the cache so that about two blocks run per SM,
    with at most ``chunk_cap`` slots a split."""
    target = max(1, -(-2 * n_sm // (B * KVH)))
    chunk = min(chunk_cap, max(32, -(-T // target)))
    return chunk, -(-T // chunk)


def flash_decode(q, k, v, pos, qpos, *, window=None):
    """Attention of one query token per (b, h) over the cache.  Returns (B,H,D).

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernels (and counts the launch in ``flash_decode.launches``) or raises.
    """
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, qpos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KVH, T = k.shape[1], k.shape[2]
    if H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"flash_decode: H={H}, KVH={KVH}: need KVH | H and "
                         f"H/KVH <= {MAX_GROUP}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype} {k.dtype} {v.dtype}")
    if pos.shape != (B, T) or pos.dtype != torch.int32 or pos.stride(-1) != 1:
        raise ValueError(f"flash_decode: pos must be (B,T) int32 with contiguous rows")
    if qpos.shape != (B,) or qpos.dtype != torch.int32 or not qpos.is_contiguous():
        raise ValueError("flash_decode: qpos must be a contiguous (B,) int32")
    if any(t.device != q.device for t in (k, v, pos, qpos)):
        raise ValueError("flash_decode: inputs on different devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window {window} < 1")
    if q.stride(-1) != 1:
        raise ValueError("flash_decode: q last dim must be contiguous")
    vec = 16 // q.element_size()          # K/V rows are read as 16-byte vectors
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must have a contiguous last dim, "
                             f"strides that are multiples of {vec} and 16-byte "
                             f"aligned data; strides {t.stride()}")
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nsplit = split_plan(B, KVH, T, n_sm, max_chunk(D, q.element_size()))
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    m_part = torch.empty((B * H * nsplit,), dtype=torch.float32, device=q.device)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B * H * nsplit * D,), dtype=torch.float32, device=q.device)
    fn = _bind()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 qpos.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
                 acc_part.data_ptr(), o.data_ptr(),
                 B, H, KVH, T, D, chunk, nsplit,
                 *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], pos.stride(0),
                 0 if window is None else int(window), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed (error {err})")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
