"""RWKV-6 "Finch" block: time-mix (data-dependent decay WKV) + channel-mix.

Time-mix recurrence per head (state S in R^{hs x hs}, k-major):
    o_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel data-dependent decay w_t = exp(-exp(w0 + lora(x_w))) in (0,1)
and data-dependent token-shift interpolation (ddlerp) for the five streams
(w,k,v,r,g), as in arXiv:2404.05892.

Without the kernels the full-sequence path picks, as the JAX package does,
the sequential scan (S < 64), the chunked form (S >= 64) or the
sequence-parallel chunked form (S >= 4096, S % 256 == 0); with them, the WKV
CUDA kernel (``kernels/rwkv6_kernel.py``).  Decode updates the state in O(1),
in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ref import rwkv6_wkv_ref
from ..kernels.rwkv6_kernel import rwkv6_wkv
from ..launch.sharding import maybe_constrain
from .layers import proj_heads
from .module import ParamSpec

LORA_MIX = 32
LORA_DECAY = 64
FIVE = 5  # w,k,v,r,g


def timemix_specs(d: int, n_heads: int, head_size: int):
    return {
        "mu_x": ParamSpec((d,), ("embed",), "uniform_scale", 0.5),
        "mu": ParamSpec((FIVE, d), (None, "embed"), "uniform_scale", 0.5),
        "lora_A": ParamSpec((d, FIVE * LORA_MIX), ("embed", None)),
        "lora_B": ParamSpec((FIVE, LORA_MIX, d), (None, None, "embed"), "normal", 0.1),
        "w0": ParamSpec((d,), ("embed",), "uniform_scale", 2.0),
        "wA": ParamSpec((d, LORA_DECAY), ("embed", None)),
        "wB": ParamSpec((LORA_DECAY, d), (None, "embed"), "normal", 0.1),
        "u": ParamSpec((n_heads, head_size), ("rwkv_heads", "head_dim"),
                       "uniform_scale", 0.5),
        "wr": ParamSpec((d, n_heads, head_size), ("embed", "rwkv_heads", "head_dim")),
        "wk": ParamSpec((d, n_heads, head_size), ("embed", "rwkv_heads", "head_dim")),
        "wv": ParamSpec((d, n_heads, head_size), ("embed", "rwkv_heads", "head_dim")),
        "wg": ParamSpec((d, n_heads, head_size), ("embed", "rwkv_heads", "head_dim")),
        "ln_scale": ParamSpec((n_heads, head_size), ("rwkv_heads", "head_dim"), "ones"),
        "ln_bias": ParamSpec((n_heads, head_size), ("rwkv_heads", "head_dim"), "zeros"),
        "wo": ParamSpec((n_heads, head_size, d), ("rwkv_heads", "head_dim", "embed")),
    }


def channelmix_specs(d: int, f: int):
    return {
        "mu_k": ParamSpec((d,), ("embed",), "uniform_scale", 0.5),
        "mu_r": ParamSpec((d,), ("embed",), "uniform_scale", 0.5),
        "wk": ParamSpec((d, f), ("embed", "mlp")),
        "wv": ParamSpec((f, d), ("mlp", "embed")),
        "wr": ParamSpec((d, d), ("embed", None)),
    }


def _shift(x):
    """The previous token along axis 1 (zero before the first)."""
    return F.pad(x, (0, 0, 1, 0))[:, :x.shape[1]]


def _ddlerp(p, x, xx):
    """Data-dependent token-shift interpolation -> five mixed streams (B,S,5,D)."""
    dx = xx - x
    xmx = x + dx * p["mu_x"].to(x.dtype)
    lo = torch.tanh(xmx @ p["lora_A"])
    B, S = x.shape[:2]
    lo = lo.reshape(B, S, FIVE, LORA_MIX)
    adj = torch.einsum("bsfl,fld->bsfd", lo, p["lora_B"])      # (B,S,5,D)
    mix = p["mu"].to(x.dtype)[None, None] + adj
    return x[:, :, None, :] + dx[:, :, None, :] * mix


def _wkv_scan(r, k, v, w_log, u):
    """Exact sequential WKV. r,k,v,w_log: (B,S,H,hs); u: (H,hs).

    Returns (o (B,S,H,hs) f32, final state (B,H,hs,hs) f32): the kernel's
    plain version, in the model's layout."""
    tr = lambda t: t.transpose(1, 2)
    o, state = rwkv6_wkv_ref(tr(r), tr(k), tr(v), tr(w_log), u)
    return tr(o), state


def wkv_chunked(r, k, v, w_log, u, chunk: int = 16):
    """Chunk-parallel WKV with per-chunk exponent centring, the JAX package's
    ``wkv_chunked`` (the centred two-factor form is safe in f32 at chunk 16 at
    its decay scales; the CUDA kernel keeps the pairwise form instead).

    r,k,v,w_log: (B,S,H,hs); u: (H,hs) -> o (B,S,H,hs) f32 + final state.
    The streams stay in the compute dtype, as there.
    """
    B, S, H, hs = r.shape
    C = min(chunk, S)
    nc = -(-S // C)
    pad = nc * C - S
    dt = r.dtype

    def chunks(x):
        return F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(B, nc, C, H, hs)
    # pad the decay with log(1) = 0: padded steps must not decay the carried
    # state (k/v pads are zero, so they contribute nothing either)
    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w_log.float())
    uf = u.to(dt)
    t_idx = torch.arange(C, device=r.device)
    causal = (t_idx[None, :] < t_idx[:, None])[None, None]     # (1,1,C,C) s < t
    state = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    outs = []
    for ci in range(nc):
        rt, kt, vt, wt = rc[:, ci], kc[:, ci], vc[:, ci], wc[:, ci]   # (B,C,H,hs)
        lp = torch.cumsum(wt, dim=1)                                 # inclusive, f32
        lp_prev = lp - wt
        mid = lp[:, C // 2][:, None]                                 # centring
        q_dec = rt * torch.exp(lp_prev - mid).to(dt)
        k_dec = kt * torch.exp(mid - lp).to(dt)
        o = torch.einsum("bchk,bhkv->bchv", (rt * torch.exp(lp_prev).to(dt)).float(), state)
        A = torch.einsum("bthk,bshk->bhts", q_dec.float(), k_dec.float())
        A = torch.where(causal, A, 0.0)
        bonus = torch.einsum("bthk,bthk->bth", (rt * uf[None, None]).float(), kt.float())
        o = o + torch.einsum("bhts,bshv->bthv", A.to(dt).float(), vt.float()) \
            + bonus[..., None] * vt.float()
        lpC = lp[:, -1][:, None]                                     # (B,1,H,hs)
        k_hat = kt * torch.exp(lpC - lp).to(dt)
        state = torch.exp(lpC[:, 0])[..., None] * state \
            + torch.einsum("bchk,bchv->bhkv", k_hat.float(), vt.float())
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(B, nc * C, H, hs)[:, :S]
    return o, state


def wkv_seq_parallel(r, k, v, w_log, u, chunk: int = 16, n_shards: int = 16):
    """Sequence-parallel chunked WKV, the JAX package's ``wkv_seq_parallel``:
    each of ``n_shards`` sequence shards runs the chunked recurrence from a
    zero state (here as one batched call), the shard states are composed by
    an associative scan, and one correction adds each shard's incoming state.
    """
    B, S, H, hs = r.shape
    G = n_shards
    Sg = S // G

    def shards(x):
        return x.reshape(B, G, Sg, H, hs)
    rs, ks, vs, ws = shards(r), shards(k), shards(v), shards(w_log.float())
    rs = maybe_constrain(rs, ("batch", "seq_q", None, "rwkv_heads", "head_dim"))

    def fold(x):
        return x.reshape(B * G, Sg, H, hs)
    o_loc, T = wkv_chunked(fold(rs), fold(ks), fold(vs), fold(ws), u, chunk)
    o_loc = o_loc.reshape(B, G, Sg, H, hs)
    T = T.reshape(B, G, H, hs, hs)
    lp = torch.cumsum(ws, dim=2)                                   # within shard
    lp_prev = lp - ws
    Dk = torch.exp(lp[:, :, -1])                                   # (B,G,H,hs)
    # associative scan over shards of (decay, state) pairs, decay on the k dim
    d = 1
    while d < G:
        T = torch.cat([T[:, :d], Dk[:, d:, ..., None] * T[:, :-d] + T[:, d:]], dim=1)
        Dk = torch.cat([Dk[:, :d], Dk[:, d:] * Dk[:, :-d]], dim=1)
        d *= 2
    s_in = torch.cat([torch.zeros_like(T[:, :1]), T[:, :-1]], dim=1)
    corr = torch.einsum("bgshk,bghkv->bgshv",
                        (rs * torch.exp(lp_prev).to(rs.dtype)).float(), s_in)
    o = (o_loc + corr).reshape(B, S, H, hs)
    return o, T[:, -1]


def _group_norm(p, o):
    """Per-head LayerNorm of (B,S,H,hs) f32."""
    mu = o.mean(dim=-1, keepdim=True)
    var = o.var(dim=-1, keepdim=True, unbiased=False)
    y = (o - mu) * torch.rsqrt(var + 64e-5)
    return y * p["ln_scale"].to(y.dtype) + p["ln_bias"].to(y.dtype)


def _streams(p, x, xx, n_heads, head_size):
    """r, k, v (B,S,H,hs) and the gate g in the compute dtype; w_log f32."""
    mixed = _ddlerp(p, x, xx)                                 # (B,S,5,D)
    x_w, x_k, x_v, x_r, x_g = mixed.unbind(2)
    r, k, v = proj_heads(x_r, p["wr"]), proj_heads(x_k, p["wk"]), proj_heads(x_v, p["wv"])
    g = F.silu(proj_heads(x_g, p["wg"]))
    w_log = -torch.exp(p["w0"].float() + (x_w @ p["wA"]).float() @ p["wB"].float())
    B, S = x.shape[:2]
    return r, k, v, g, w_log.reshape(B, S, n_heads, head_size)


def wkv(r, k, v, w_log, u, use_kernel):
    """(o (B,S,H,hs) f32, final state): the WKV CUDA kernel when
    ``use_kernel``, else the JAX package's choice of plain form by length."""
    if use_kernel:
        tr = lambda t: t.transpose(1, 2)
        o, final = rwkv6_wkv(tr(r), tr(k), tr(v), tr(w_log), u)
        return tr(o), final
    S = r.shape[1]
    if S >= 4096 and S % 256 == 0:
        return wkv_seq_parallel(r, k, v, w_log, u)
    if S >= 64:
        return wkv_chunked(r, k, v, w_log, u)
    return _wkv_scan(r, k, v, w_log, u)


def timemix_with_state(p, x, *, n_heads, head_size, use_kernel):
    """Full-sequence time-mix. x: (B,S,D) -> (out (B,S,D), final WKV state)."""
    r, k, v, g, w_log = _streams(p, x, _shift(x), n_heads, head_size)
    r = maybe_constrain(r, ("batch", None, "rwkv_heads", "head_dim"))
    o, final = wkv(r, k, v, w_log, p["u"], use_kernel)
    o = _group_norm(p, o.float()).to(x.dtype) * g
    B, S, H, hs = o.shape
    return o.reshape(B, S, H * hs) @ p["wo"].reshape(H * hs, -1), final


def apply_timemix(p, x, *, n_heads, head_size, use_kernel=False):
    """Full-sequence time-mix. x: (B,S,D) -> (B,S,D)."""
    return timemix_with_state(p, x, n_heads=n_heads, head_size=head_size,
                              use_kernel=use_kernel)[0]


def apply_channelmix(p, x):
    xx = _shift(x)
    return _channelmix(p, x, xx)


def _channelmix(p, x, xx):
    x_k = x + (xx - x) * p["mu_k"].to(x.dtype)
    x_r = x + (xx - x) * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(x_k @ p["wk"]))
    return torch.sigmoid(x_r @ p["wr"]) * (k @ p["wv"])


# ----------------------------------------------------------------- decode

def rwkv_state_shapes(batch, d, n_heads, head_size, dtype):
    return {
        "tm_x": ((batch, d), dtype),           # prev token (time-mix)
        "cm_x": ((batch, d), dtype),           # prev token (channel-mix)
        "wkv": ((batch, n_heads, head_size, head_size), torch.float32),
    }


RWKV_STATE_AXES = {"tm_x": ("batch", "embed"), "cm_x": ("batch", "embed"),
                   "wkv": ("batch", "rwkv_heads", "head_dim", None)}


def decode_timemix(p, state, x, *, n_heads, head_size):
    """x: (B,1,D) -> out (B,1,D); ``state``'s tm_x and wkv are updated in
    place (the JAX version returns them)."""
    B = x.shape[0]
    r, k, v, g, w_log = _streams(p, x, state["tm_x"][:, None], n_heads, head_size)
    r, k, v, g = r[:, 0].float(), k[:, 0].float(), v[:, 0].float(), g[:, 0]
    w = torch.exp(w_log[:, 0])
    uf = p["u"].float()
    kv = k[..., :, None] * v[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r, state["wkv"] + uf[None, :, :, None] * kv)
    state["wkv"].copy_(w[..., :, None] * state["wkv"] + kv)
    state["tm_x"].copy_(x[:, 0])
    o = _group_norm(p, o[:, None].float())[:, 0].to(x.dtype) * g
    return (o.reshape(B, -1) @ p["wo"].reshape(-1, p["wo"].shape[-1]))[:, None]


def decode_channelmix(p, state, x):
    """x: (B,1,D) -> out (B,1,D); ``state["cm_x"]`` is updated in place."""
    out = _channelmix(p, x, state["cm_x"][:, None])
    state["cm_x"].copy_(x[:, 0])
    return out
