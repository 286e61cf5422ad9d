"""RWKV-6 WKV: the CUDA kernel in ``csrc/rwkv6.cu``.

Replaces the TPU kernel ``repro/kernels/rwkv6_kernel.py:_rwkv6_kernel``: the
chunked time-mix recurrence with data-dependent decay ``w_log`` (<= 0) and
bonus ``u``.  Layouts: r, k, v, w_log (B,H,S,hs), which may be strided views
(the model passes transposed views of its (B,S,H,hs) activations, read in
place): the last dim contiguous, rows 16-byte aligned; u (H,hs).  The kernel returns
the output and also the state after the last token, which prefill keeps for
decode.  Neither the TPU kernel nor this one has a gradient (the JAX package
gives ``ops.rwkv6`` no VJP), so the wrapper refuses inputs that require grad.
The kernel is the custom op ``repro_torch::rwkv6_wkv``, with a fake
implementation, a FLOP formula and a DTensor sharding rule (``traceable.py``).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import rwkv6_wkv_ref
from .traceable import R, S, call, flops, shardings

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)
CHUNK = 64          # C in the source


def _bind():
    fn = build.load("rwkv6").rwkv6_wkv
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 8 + [I] * 4 + [L] * 15 + [I, P]
        fn.restype = ctypes.c_int
    return fn


def rwkv6_wkv(r, k, v, w_log, u):
    """(o (B,H,S,hs) f32, final state (B,H,hs,hs) f32).

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel's three passes, one call counted once in ``rwkv6_wkv.launches``,
    or raises.
    Inputs that require grad, with grad mode on, raise on every device.  The
    output is allocated in (B,S,H,hs) memory and returned as a (B,H,S,hs)
    view, the layout the model reads back.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w_log, u)):
        raise RuntimeError("rwkv6_wkv: the inputs require grad but the kernel has "
                           "no backward (nor has the TPU kernel it replaces)")
    return tuple(call(_wkv_op, _wkv, r, k, v, w_log, u))


def _wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w_log: torch.Tensor,
            u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    if r.device.type == "cpu":
        return rwkv6_wkv_ref(r, k, v, w_log, u)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w_log.shape):
        raise ValueError(f"rwkv6_wkv: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} w_log {tuple(w_log.shape)}")
    B, H, S, hs = r.shape
    if hs not in HEAD_SIZES:
        raise ValueError(f"rwkv6_wkv: head size {hs} not in {HEAD_SIZES}")
    if S == 0 or u.shape != (H, hs):
        raise ValueError(f"rwkv6_wkv: S={S}, u shape {tuple(u.shape)}")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype \
            or w_log.dtype != torch.float32 or u.dtype not in _DTYPES:
        raise ValueError(f"rwkv6_wkv: dtypes r {r.dtype} k {k.dtype} v {v.dtype} "
                         f"w_log {w_log.dtype} u {u.dtype}; need r, k, v all f32 or "
                         f"all bf16, w_log f32")
    if any(t.device != r.device for t in (k, v, w_log, u)):
        raise ValueError("rwkv6_wkv: inputs on different devices")
    for name, t in (("r", r), ("k", k), ("v", v), ("w_log", w_log)):
        vec = 16 // t.element_size()       # rows are read as 16-byte vectors
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"rwkv6_wkv: {name} must have a contiguous last dim, "
                             f"strides that are multiples of {vec} and 16-byte "
                             f"aligned data; strides {t.stride()}")
    uf = u.float().contiguous()
    o = torch.empty((B, S, H, hs), dtype=torch.float32, device=r.device).permute(0, 2, 1, 3)
    state = torch.empty((B, H, hs, hs), dtype=torch.float32, device=r.device)
    # each chunk's state increment and decay, which the kernel's second pass
    # turns into the state entering the chunk, in place
    nc = -(-S // CHUNK)
    scratch = torch.empty(B * H * nc * (hs * hs + hs), dtype=torch.float32, device=r.device)
    fn = _bind()
    with torch.cuda.device(r.device):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(), uf.data_ptr(),
                 o.data_ptr(), state.data_ptr(), scratch.data_ptr(), B, H, S, hs,
                 *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w_log.stride()[:3],
                 *o.stride()[:3], _DTYPES[r.dtype],
                 torch.cuda.current_stream(r.device).cuda_stream)
    if err:
        raise RuntimeError(f"rwkv6_wkv: kernel launch failed (error {err})")
    _COUNTED.launches += 1
    return o, state


_wkv_op = torch.library.custom_op("repro_torch::rwkv6_wkv", _wkv, mutates_args=())


@_wkv_op.register_fake
def _(r, k, v, w_log, u):
    B, H, S_, hs = r.shape
    return (r.new_empty((B, S_, H, hs), dtype=torch.float32).permute(0, 2, 1, 3),
            r.new_empty((B, H, hs, hs), dtype=torch.float32))


@flops(torch.ops.repro_torch.rwkv6_wkv)
def _(r_shape, k_shape, v_shape, w_shape, u_shape, *args, out_shape=None, **kw):
    """4 hs^2 per token and head (the state's decay and update, the readout
    and the bonus), as the analytic floor's recurrence term counts."""
    B, H, S_, hs = r_shape
    return 4 * B * H * S_ * hs * hs


@shardings(torch.ops.repro_torch.rwkv6_wkv.default)
def _(r, k, v, w_log, u):
    """Batch, or heads (u on its head dim); never the sequence."""
    return [([R, R], [R] * 5),
            ([S(0), S(0)], [S(0)] * 4 + [R]),
            ([S(1), S(1)], [S(1)] * 4 + [S(0)])]


rwkv6_wkv.launches = 0
_COUNTED = rwkv6_wkv        # where the op's launches are counted
