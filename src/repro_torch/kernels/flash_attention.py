"""Flash attention: the CUDA kernels in ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward: dq, then dk/dv), and the
autograd Function that joins them.

Replaces the TPU kernels of ``repro/kernels/flash_attention.py``:
``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel`` and their
``custom_vjp``.  Layouts: q (B,H,Sq,D), k/v (B,KVH,Skv,D), H = KVH * G, query
head h reads KV head h // G.  The inputs may be strided views (the model
passes transposed views of its (B,S,H,D) activations, so nothing is copied);
only the last dim must be contiguous.  Outputs are allocated in (B,S,heads,D)
memory and returned as (B,heads,S,D) views, the layout the model reads back.

Each kernel is a ``torch.library.custom_op`` (``repro_torch::...``) with a
fake implementation, a FLOP formula and a DTensor sharding rule
(``traceable.py``), so the measurement layer traces it on fake tensors and
DTensors; the wrappers below check what only the caller can (autograd) and
call the ops, or, on plain tensors, the ops' implementations directly.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .ref import (flash_attention_bwd_dkv_ref, flash_attention_bwd_dq_ref,
                  flash_attention_ref)
from .traceable import R, S, call, flops, mesh_divides, shardings, visible_pairs

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FWD_HEAD_DIMS = (16, 32, 64, 128, 256)
BWD_HEAD_DIMS = (16, 32, 64, 128)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _bind(lib_name, fn_name, n_ptrs, n_strided):
    fn = getattr(build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = [_P] * n_ptrs + [_I] * 6 + [_L] * (3 * n_strided) + [_I, _I, _I, _P]
        fn.restype = ctypes.c_int
    return fn


def _check_strided(name, t, align_elems):
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dim must be contiguous, strides {t.stride()}")
    if any(s % align_elems for s in t.stride()[:-1]):
        raise ValueError(f"{name}: strides {t.stride()} must be multiples of {align_elems}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _check_inputs(fn, q, k, v, window, head_dims, **same_as_q):
    """Validate what every kernel here takes; returns (B, H, KVH, Sq, Skv, D).
    ``head_dims`` are the head dims the kernel is built for; ``same_as_q``
    names further (B,H,Sq,D) tensors (o, do)."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    B, H, Sq, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{fn}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    KVH, Skv = k.shape[1], k.shape[2]
    if H % KVH:
        raise ValueError(f"{fn}: H={H} not a multiple of KVH={KVH}")
    if D not in head_dims:
        raise ValueError(f"{fn}: head dim {D} not in {head_dims}")
    tensors = {"q": q, "k": k, "v": v, **same_as_q}
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors.values()):
        raise ValueError(f"{fn}: dtypes {[str(t.dtype) for t in tensors.values()]}")
    if any(t.device != q.device for t in tensors.values()):
        raise ValueError(f"{fn}: tensors on different devices")
    for name, t in same_as_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"{fn}: window {window} < 1")
    for name, t in tensors.items():
        _check_strided(name, t, 8)
    return B, H, KVH, Sq, Skv, D


def _check_rowstat(fn, name, t, q):
    B, H, Sq = q.shape[:3]
    if t.shape != (B, H, Sq) or t.dtype != torch.float32 or not t.is_contiguous() \
            or t.device != q.device:
        raise ValueError(f"{fn}: {name} must be contiguous f32 {(B, H, Sq)} on "
                         f"{q.device}, got {tuple(t.shape)} {t.dtype} {t.device}")


def _heads_major(B, S, heads, D, like):
    """Empty (B,S,heads,D) memory viewed as (B,heads,S,D)."""
    return torch.empty((B, S, heads, D), dtype=like.dtype,
                       device=like.device).permute(0, 2, 1, 3)


def _run(fn, name, *args):
    with torch.cuda.device(args[-1]):
        err = fn(*args[:-1], torch.cuda.current_stream(args[-1]).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed (error {err})")


def flash_attention_fwd(q, k, v, *, window=None, causal_shift=0):
    """Causal GQA attention.  Returns (o (B,H,Sq,D), lse (B,H,Sq) f32).

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``flash_attention_fwd.launches``) or
    raises; a fake tensor gets the output shapes.  The kernel's output has
    no autograd history, so a call whose inputs require grad, with grad mode
    on, raises on every device (the CPU too, so that the CPU tests catch
    what would train wrongly on the card): differentiable callers use
    ``flash_attention``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention_fwd: the inputs require grad but the "
                           "kernel's output would carry none; call flash_attention")
    return tuple(call(_fwd_op, _fwd, q, k, v, window, int(causal_shift)))


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, window=None, causal_shift=0):
    """First part of the backward: (dq (B,H,Sq,D), delta (B,H,Sq) f32), with
    delta = rowsum(do * o), which ``flash_attention_bwd_dkv`` reads.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    (counted in ``flash_attention_bwd_dq.launches``) or raise.
    """
    return tuple(call(_dq_op, _dq, q, k, v, o, lse, do, window, int(causal_shift)))


def flash_attention_bwd_dkv(q, k, v, lse, delta, do, *, window=None, causal_shift=0):
    """Second part of the backward: (dk, dv) (B,KVH,Skv,D), summed over the G
    query heads of each KV head (in a fixed order: two calls give the same
    bits).

    CPU tensors go to the plain version; CUDA tensors launch the kernel and
    its reduction pass, one call counted once in
    ``flash_attention_bwd_dkv.launches``, or raise.
    """
    return tuple(call(_dkv_op, _dkv, q, k, v, lse, delta, do, window, int(causal_shift)))


def flash_attention_bwd(q, k, v, o, lse, do, *, window=None, causal_shift=0):
    """Backward of causal GQA attention given its output ``o``, its ``lse``
    and the output's gradient ``do``.  Returns (dq, dk, dv) in the inputs'
    dtypes.  CPU tensors go to the plain versions; CUDA tensors launch both
    kernels (dq first: it writes the delta that dk/dv reads) or raise."""
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, window=window,
                                       causal_shift=causal_shift)
    dk, dv = flash_attention_bwd_dkv(q, k, v, lse, delta, do, window=window,
                                     causal_shift=causal_shift)
    return dq, dk, dv


# ------------------------------------------------------------ the custom ops

def _fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
            causal_shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window=window, causal_shift=causal_shift)
    B, H, KVH, Sq, Skv, D = _check_inputs("flash_attention_fwd", q, k, v, window,
                                           FWD_HEAD_DIMS)
    o = _heads_major(B, Sq, H, D, q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _run(_bind("flash_attention", "fa_fwd", 5, 4), "flash_attention_fwd",
         q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
         B, H, KVH, Sq, Skv, D,
         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
         0 if window is None else int(window), int(causal_shift),
         _DTYPES[q.dtype], q.device)
    _COUNTS["fwd"].launches += 1
    return o, lse


_fwd_op = torch.library.custom_op("repro_torch::flash_attention_fwd", _fwd, mutates_args=())


@_fwd_op.register_fake
def _(q, k, v, window, causal_shift):
    B, H, Sq, D = q.shape
    return (_heads_major(B, Sq, H, D, q),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
           lse: torch.Tensor, do: torch.Tensor, window: Optional[int],
           causal_shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_ref(q, k, v, o, lse, do, window, causal_shift)
    fn = "flash_attention_bwd_dq"
    B, H, KVH, Sq, Skv, D = _check_inputs(fn, q, k, v, window, BWD_HEAD_DIMS, o=o, do=do)
    _check_rowstat(fn, "lse", lse, q)
    dq = _heads_major(B, Sq, H, D, q)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _run(_bind("flash_attention_bwd", "fa_bwd_dq", 8, 6), fn,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
         B, H, KVH, Sq, Skv, D,
         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
         *do.stride()[:3], *dq.stride()[:3],
         0 if window is None else int(window), int(causal_shift),
         _DTYPES[q.dtype], q.device)
    _COUNTS["dq"].launches += 1
    return dq, delta


_dq_op = torch.library.custom_op("repro_torch::flash_attention_bwd_dq", _dq, mutates_args=())


@_dq_op.register_fake
def _(q, k, v, o, lse, do, window, causal_shift):
    B, H, Sq, D = q.shape
    return (_heads_major(B, Sq, H, D, q),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
            delta: torch.Tensor, do: torch.Tensor, window: Optional[int],
            causal_shift: int) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_ref(q, k, v, lse, delta, do, window, causal_shift)
    fn = "flash_attention_bwd_dkv"
    B, H, KVH, Sq, Skv, D = _check_inputs(fn, q, k, v, window, BWD_HEAD_DIMS, do=do)
    _check_rowstat(fn, "lse", lse, q)
    _check_rowstat(fn, "delta", delta, q)
    dk, dv = _heads_major(B, Skv, KVH, D, k), _heads_major(B, Skv, KVH, D, v)
    # bf16: each query head's f32 partial dk and dv, which the kernel's second
    # pass adds up per KV head in a fixed order
    part = (torch.empty((2, B, H, Skv, D), dtype=torch.float32, device=q.device)
            if q.dtype == torch.bfloat16 else None)
    _run(_bind("flash_attention_bwd", "fa_bwd_dkv", 9, 6), fn,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
         lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
         None if part is None else part.data_ptr(),
         B, H, KVH, Sq, Skv, D,
         *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
         *dk.stride()[:3], *dv.stride()[:3],
         0 if window is None else int(window), int(causal_shift),
         _DTYPES[q.dtype], q.device)
    _COUNTS["dkv"].launches += 1
    return dk, dv


_dkv_op = torch.library.custom_op("repro_torch::flash_attention_bwd_dkv", _dkv,
                                  mutates_args=())


@_dkv_op.register_fake
def _(q, k, v, lse, delta, do, window, causal_shift):
    B, KVH, Skv, D = k.shape
    return _heads_major(B, Skv, KVH, D, k), _heads_major(B, Skv, KVH, D, v)


# FLOPs: 2 D per visible (query, key) pair and query head for each product:
# two in the forward (Q K^T, P V), three in dq (S, dP, dS K), four in dk/dv
# (S^T, dP^T, P^T dO, dS^T Q)
def _pairs(q_shape, k_shape, window, causal_shift):
    B, H, Sq, D = q_shape
    return B * H * D * visible_pairs(Sq, k_shape[2], window, causal_shift)


@flops(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, window, causal_shift, *args, out_shape=None, **kw):
    return 4 * _pairs(q_shape, k_shape, window, causal_shift)


@flops(torch.ops.repro_torch.flash_attention_bwd_dq)
def _(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, window, causal_shift,
      *args, out_shape=None, **kw):
    return 6 * _pairs(q_shape, k_shape, window, causal_shift)


@flops(torch.ops.repro_torch.flash_attention_bwd_dkv)
def _(q_shape, k_shape, v_shape, lse_shape, delta_shape, do_shape, window, causal_shift,
      *args, out_shape=None, **kw):
    return 8 * _pairs(q_shape, k_shape, window, causal_shift)


# Sharding: batch, or query and KV heads together (the same G on every
# shard, so only where each mesh dim divides both head counts); sequence and
# head dim are never split (each query row needs every key).
def _attention_shardings(q, k, n_in, n_out):
    """Placements of ``n_out`` outputs and ``n_in`` tensor inputs (all
    (B, heads, ...)), then the two int arguments."""
    out = [([R] * n_out, [R] * n_in + [None, None]),
           ([S(0)] * n_out, [S(0)] * n_in + [None, None])]
    if mesh_divides(q, q.shape[1], k.shape[1]):
        out.append(([S(1)] * n_out, [S(1)] * n_in + [None, None]))
    return out


@shardings(torch.ops.repro_torch.flash_attention_fwd.default)
def _(q, k, v, window, causal_shift):
    return _attention_shardings(q, k, 3, 2)


@shardings(torch.ops.repro_torch.flash_attention_bwd_dq.default)
def _(q, k, v, o, lse, do, window, causal_shift):
    return _attention_shardings(q, k, 6, 2)


@shardings(torch.ops.repro_torch.flash_attention_bwd_dkv.default)
def _(q, k, v, lse, delta, do, window, causal_shift):
    return _attention_shardings(q, k, 6, 2)


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, and the backward
    kernels in backward (the counterpart of the JAX package's custom_vjp).
    On the CPU the same wiring runs the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal_shift):
        o, lse = flash_attention_fwd(q, k, v, window=window, causal_shift=causal_shift)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.causal_shift = window, causal_shift
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:       # the kernels read rows; autograd may hand
            do = do.contiguous()     # any layout
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, window=ctx.window,
                                         causal_shift=ctx.causal_shift)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, window=None, causal_shift=0):
    """Causal GQA attention output (B,H,Sq,D), differentiable in q, k, v."""
    return FlashAttention.apply(q, k, v, window, causal_shift)


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
# the wrappers whose counts the ops' launches go to (looked up once, so that a
# caller who rebinds a module name for a check does not take the count)
_COUNTS = {"fwd": flash_attention_fwd, "dq": flash_attention_bwd_dq,
           "dkv": flash_attention_bwd_dkv}
