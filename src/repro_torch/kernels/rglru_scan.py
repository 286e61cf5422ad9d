"""RG-LRU scan: the CUDA kernel in ``csrc/rglru_scan.cu``.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py:_rglru_kernel``: the
linear recurrence h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over (B,S,W) f32.
Neither the TPU kernel nor this one has a gradient (the JAX package gives
``ops.rglru`` no VJP), so the wrapper refuses inputs that require grad.

A block walks one sequential chain per channel for CHANNELS channels of one
batch row, fed by a producer warp through a ring of STAGES tiles of STEPS
steps (TMA where W is a multiple of 4, else 4-byte cp.async; the source's
header says why); the constants mirror the source.  The kernel is the custom
op ``repro_torch::rglru_scan``, with a fake implementation, a FLOP formula and
a DTensor sharding rule (``traceable.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import rglru_scan_ref
from .traceable import R, S, call, flops, shardings

CHANNELS = 16     # channels per block (CW in the source)
STEPS = 64        # steps per ring stage
STAGES = 6


def _bind():
    fn = build.load("rglru_scan").rglru_scan
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 3 + [I] * 3 + [P]
        fn.restype = ctypes.c_int
    return fn


def rglru_scan(a, b):
    """h (B,S,W) f32 with h_t = a_t h_{t-1} + b_t, h_{-1} = 0.

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``rglru_scan.launches``) or raises.
    Inputs that require grad, with grad mode on, raise on every device: the
    kernel's output carries no gradient.
    """
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise RuntimeError("rglru_scan: the inputs require grad but the kernel has "
                           "no backward (nor has the TPU kernel it replaces)")
    return call(_scan_op, _scan, a, b)


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.device.type == "cpu":
        return rglru_scan_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {a.device}")
    if a.dim() != 3 or a.shape != b.shape or a.shape[1] == 0:
        raise ValueError(f"rglru_scan: shapes a {tuple(a.shape)} b {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rglru_scan: dtypes {a.dtype} {b.dtype}, need float32")
    if b.device != a.device:
        raise ValueError("rglru_scan: inputs on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan: a and b must be contiguous")
    B, S, W = a.shape
    h = torch.empty_like(a)
    fn = _bind()
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan: kernel launch failed (error {err})")
    _COUNTED.launches += 1
    return h


_scan_op = torch.library.custom_op("repro_torch::rglru_scan", _scan, mutates_args=())


@_scan_op.register_fake
def _(a, b):
    return torch.empty_like(a, memory_format=torch.contiguous_format)


@flops(torch.ops.repro_torch.rglru_scan)
def _(a_shape, b_shape, *args, out_shape=None, **kw):
    """One multiply and one add per step and channel."""
    B, S_, W = a_shape
    return 2 * B * S_ * W


@shardings(torch.ops.repro_torch.rglru_scan.default)
def _(a, b):
    """Batch or channels: each channel's chain is independent; never the
    sequence."""
    return [([R], [R, R]), ([S(0)], [S(0), S(0)]), ([S(2)], [S(2), S(2)])]


rglru_scan.launches = 0
_COUNTED = rglru_scan       # where the op's launches are counted
