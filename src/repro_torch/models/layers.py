"""Shared layers: norms, activations, embeddings, RoPE, MLPs (GLU + plain)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function

from .module import ParamSpec

# ---------------------------------------------------------------- activations

_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "tanh": torch.tanh,
}


def act_fn(name: str):
    return _ACTS[name]


# ---------------------------------------------------------------------- norms

def norm_specs(d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones")}
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), "ones"),
                "bias": ParamSpec((d,), ("embed",), "zeros")}
    raise ValueError(kind)


def apply_norm(p, x, kind: str, eps: float = 1e-6):
    """Norm computed in f32, cast back to ``x.dtype``."""
    xf = x.float()
    if kind == "rmsnorm":
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------- RoPE

def rope_freqs(d_head: int, theta: float, device=None):
    """f32 inverse frequencies, computed in f32 as the JAX package does.

    Built on ``device`` directly: a host-to-device copy here would stall the
    stream on every layer.
    """
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, d_head) paired-halves rotary.  positions: (..., seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions[..., None].float() * freqs              # (..., seq, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- projections

def proj_heads(x, w):
    """(B,S,D) x (D,h,k) -> (B,S,h,k) as one matmul."""
    D, h, k = w.shape
    return (x @ w.reshape(D, h * k)).unflatten(-1, (h, k))


# ---------------------------------------------------------------------- shift

def shift(x, k: int):
    """x (B, S, D) shifted ``k`` steps along the sequence, axis 1: step t
    holds step t - k, zeros before the first.

    While a cell is traced on a mesh that shards the sequence, the trace's
    forms (``launch/xlaforms.py``) shift each shard and take its first ``k``
    steps from the previous rank, as GSPMD's halo exchange does."""
    if has_torch_function((x,)):
        return handle_torch_function(shift, (x,), x, k)
    return F.pad(x, (0, 0, k, 0))[:, :x.shape[1]]


# ---------------------------------------------------------------- scan steps

_SCANS: list = []          # (loop, run, step) of each enclosing scanned loop
_RUNS = [0]


def scan_steps(loop: str, n: int):
    """``range(n)``, the steps of a loop that the JAX package runs as a
    ``lax.scan`` (the layer units, the WKV's chunks).  While each step runs,
    ``scan_scope`` names it: the measurement counts the stacks XLA's loop
    keeps of each step's residuals."""
    _RUNS[0] += 1
    run = _RUNS[0]
    for i in range(n):
        _SCANS.append((loop, run, i))
        try:
            yield i
        finally:
            _SCANS.pop()


def scan_scope() -> tuple:
    """The (loop, run, step) of each scanned loop step running now,
    outermost first."""
    return tuple(_SCANS)


# ----------------------------------------------------------------- embeddings

def embed_lookup(p, tokens):
    return p["table"][tokens.long()]


# ----------------------------------------------------------------------- MLPs

def glu_mlp_specs(d: int, f: int):
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def apply_glu_mlp(p, x, act: str):
    g = x @ p["wi_gate"]
    u = x @ p["wi_up"]
    h = act_fn(act)(g) * u
    return h @ p["wo"]


def plain_mlp_specs(d: int, f: int):
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp")),
        "bi": ParamSpec((f,), ("mlp",), "zeros"),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
        "bo": ParamSpec((d,), ("embed",), "zeros"),
    }


def apply_plain_mlp(p, x, act: str):
    h = act_fn(act)(x @ p["wi"] + p["bi"])
    return h @ p["wo"] + p["bo"]

