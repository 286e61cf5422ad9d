"""RecurrentGemma / Griffin recurrent block (RG-LRU + causal conv1d branch).

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * r_t),   r_t, i_t block-diagonal sigmoids.

The full-sequence path runs the recurrence in the RG-LRU CUDA kernel when the
kernels are on (``kernels/rglru_scan.py``), else as a log-depth associative
scan (the JAX package's ``jax.lax.associative_scan``); decode updates the
carried state in O(1), in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from ..kernels.rglru_scan import rglru_scan
from ..launch.sharding import maybe_constrain
from .layers import shift
from .module import ParamSpec

C_RGLRU = 8.0
CONV_K = 4


def rglru_specs(d: int, width: int, n_blocks: int):
    wb = width // n_blocks
    return {
        "wx": ParamSpec((d, width), ("embed", "rec_width")),
        "wy": ParamSpec((d, width), ("embed", "rec_width")),
        "conv_w": ParamSpec((CONV_K, width), (None, "rec_width"), "normal", 0.1),
        "conv_b": ParamSpec((width,), ("rec_width",), "zeros"),
        "gate_a": ParamSpec((n_blocks, wb, wb), ("heads", None, None)),
        "gate_a_b": ParamSpec((n_blocks, wb), ("heads", None), "zeros"),
        "gate_i": ParamSpec((n_blocks, wb, wb), ("heads", None, None)),
        "gate_i_b": ParamSpec((n_blocks, wb), ("heads", None), "zeros"),
        "lam": ParamSpec((width,), ("rec_width",), "uniform_scale", 1.0),
        "wo": ParamSpec((width, d), ("rec_width", "embed")),
    }


def block_view(xb, n_blocks: int):
    """(..., W) as (..., n_blocks, W / n_blocks): the gates' blocks.

    While a cell is traced on a mesh that splits W over more ranks than
    divide the blocks (recurrentgemma-2b's 10 blocks on a model axis of 16),
    the trace's forms (``launch/xlaforms.py``) gather W first."""
    if has_torch_function((xb,)):
        return handle_torch_function(block_view, (xb,), xb, n_blocks)
    return xb.reshape(xb.shape[:-1] + (n_blocks, xb.shape[-1] // n_blocks))


def block_unview(g, like):
    """The gates' (..., n_blocks, W / n_blocks) back to the (..., W) of
    ``like``; while traced, laid out as ``like`` is (see ``block_view``)."""
    if has_torch_function((g, like)):
        return handle_torch_function(block_unview, (g, like), g, like)
    return g.reshape(like.shape)


def _gates(p, xb, n_blocks):
    """xb: (...,W) -> (r, i) each (...,W) f32; block-diagonal sigmoid gates."""
    xg = block_view(xb, n_blocks).float()
    r = torch.sigmoid(torch.einsum("...nw,nwv->...nv", xg, p["gate_a"].float())
                      + p["gate_a_b"].float())
    i = torch.sigmoid(torch.einsum("...nw,nwv->...nv", xg, p["gate_i"].float())
                      + p["gate_i_b"].float())
    return block_unview(r, xb), block_unview(i, xb)


def _log_a(p, r):
    return -C_RGLRU * F.softplus(p["lam"].float()) * r


def _conv_full(p, xb):
    """Causal depthwise conv of width CONV_K over the seq axis 1."""
    out = p["conv_b"].to(xb.dtype) * torch.ones_like(xb)
    for j in range(CONV_K):
        out = out + shift(xb, j) * p["conv_w"][CONV_K - 1 - j].to(xb.dtype)
    return out


def _decay_and_input(p, xb_conv, n_blocks):
    """(a, gated) f32: the recurrence's decay and input from the conv output."""
    r, i = _gates(p, xb_conv, n_blocks)
    log_a = _log_a(p, r)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xb_conv.float())
    return a, gated


def _interleave(even, odd):
    """Merge along axis 1: even[0], odd[0], even[1], ... (len(even) - len(odd)
    is 0 or 1)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def _combine(x, y):
    (a1, b1), (a2, b2) = x, y
    return a1 * a2, a2 * b1 + b2


def associative_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0: a scan of the
    pairs (a, b) under (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), in the
    same odd/even recursion as ``jax.lax.associative_scan`` (so the two round
    alike).  The plain path of the model; differentiable."""
    def rec(a, b):
        n = a.shape[1]
        if n < 2:
            return a, b
        oa, ob = rec(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
        if n % 2 == 0:
            ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
        else:
            ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
        ea, eb = torch.cat([a[:, :1], ea], dim=1), torch.cat([b[:, :1], eb], dim=1)
        return _interleave(ea, oa), _interleave(eb, ob)
    return rec(a, b)[1]


def apply_rglru(p, x, *, n_blocks: int, use_pallas: bool = False):
    """Full-sequence recurrent block. x: (B,S,D) -> (B,S,D)."""
    out, _ = rglru_with_state(p, x, n_blocks, use_pallas)
    return out


def rglru_with_state(p, x, n_blocks, use_kernel):
    """Full-sequence recurrent block and its decode state
    {"h": h after the last token (B,W) f32, "conv": the last CONV_K - 1 raw
    (pre-conv) inputs (B,CONV_K-1,W)}."""
    xb = maybe_constrain(x @ p["wx"], ("batch", None, "rec_width"))
    xb_conv = _conv_full(p, xb)
    a, gated = _decay_and_input(p, xb_conv, n_blocks)
    hs = rglru_scan(a, gated) if use_kernel else associative_scan(a, gated)
    y = F.gelu(x @ p["wy"], approximate="tanh")
    out = (hs.to(x.dtype) * y) @ p["wo"]
    hist = F.pad(xb, (0, 0, CONV_K - 1, 0))[:, -(CONV_K - 1):]
    return out, {"h": hs[:, -1], "conv": hist}


def rglru_state_shapes(batch: int, width: int, dtype):
    return {"h": ((batch, width), torch.float32),
            "conv": ((batch, CONV_K - 1, width), dtype)}


RGLRU_STATE_AXES = {"h": ("batch", "rec_width"),
                    "conv": ("batch", None, "rec_width")}


def decode_rglru(p, state, x, *, n_blocks: int):
    """One-token decode. x: (B,1,D) -> out (B,1,D).  ``state`` is updated in
    place (the JAX version returns a new state)."""
    xb = (x @ p["wx"])[:, 0]                                  # (B,W)
    hist = torch.cat([state["conv"], xb[:, None]], dim=1)     # (B,K,W)
    conv = p["conv_b"].to(xb.dtype) + torch.einsum("bkw,kw->bw", hist,
                                                    p["conv_w"].to(xb.dtype))
    a, gated = _decay_and_input(p, conv, n_blocks)
    h = a * state["h"] + gated
    y = F.gelu(x @ p["wy"], approximate="tanh")[:, 0]
    out = (h.to(x.dtype) * y) @ p["wo"]
    state["h"].copy_(h)
    state["conv"].copy_(hist[:, 1:])
    return out[:, None]
