"""Top-k routed mixture-of-experts with grouped sort-based dispatch: the JAX
package's ``models/moe.py``.

GShard-style grouped dispatch: the T tokens are split into G groups, sharded
over the data axes, so each group's gather and scatter stay on its device.
The reference runs the dispatch of one group under ``jax.vmap``; here every
op is batched over a leading G dim.  The expert products sit outside the
dispatch, with the logical-axis constraints at the same four places, so a
mesh shards them over "expert" (EP) or per-expert "mlp" (TP within an
expert) as the rule set says.

Ties are broken as the reference breaks them: ``jax.lax.top_k`` puts the
lower expert index first among equal logits (a stable descending sort here;
``torch.topk`` promises no order), and ``jnp.argsort`` is stable.  A token
past an expert's capacity is dropped: it adds zeros into the expert's last
slot, as the reference's ``.at[].add`` does.
"""
from __future__ import annotations

import math

import torch

from .layers import act_fn
from .module import ParamSpec
from ..launch.sharding import maybe_constrain


def moe_specs(d: int, f: int, n_experts: int):
    return {
        "router": ParamSpec((d, n_experts), ("embed", "expert")),
        "wi_gate": ParamSpec((n_experts, d, f), ("expert", "embed", "mlp")),
        "wi_up": ParamSpec((n_experts, d, f), ("expert", "embed", "mlp")),
        "wo": ParamSpec((n_experts, f, d), ("expert", "mlp", "embed")),
    }


def groups_and_capacity(T: int, E: int, top_k: int, capacity_factor: float,
                        n_groups: int = 32):
    """(G, capacity) of T tokens over E experts, as the reference picks them:
    the first of (n_groups, 16, 8, 4, 2, 1) that divides T with at least E
    tokens a group, and ceil(Tg * k / E * cf) slots an expert, rounded up to
    a multiple of 4 above 4."""
    G = 1
    for g in (n_groups, 16, 8, 4, 2, 1):
        if T % g == 0 and T // g >= E:
            G = g
            break
    Tg = T // G
    cap = int(math.ceil(Tg * top_k / E * capacity_factor))
    cap = max(1, -(-cap // 4) * 4) if cap > 4 else max(1, cap)
    return G, cap


def _dispatch_indices(router, xf, *, top_k, cap, E):
    """Routing and slot assignment of every group.  xf: (G, Tg, D).

    Every gather and scatter runs along dim 1 with G leading all its
    operands, so a mesh that shards G keeps them on each device.  Returns
    (buf (G,E,cap,D), (slot, tok, keep, w_slot), each (G, Tg*k), lb (G,)),
    ``slot`` the flat (expert, capacity slot) index e*cap + c."""
    G, T, D = xf.shape
    Tk = T * top_k
    logits = torch.einsum("gtd,de->gte", xf, router).float()
    top, top_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_w = torch.softmax(top[..., :top_k], dim=-1)           # (G,T,k)
    flat_e = top_idx[..., :top_k].reshape(G, Tk)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, E), dtype=torch.int64, device=xf.device)
    counts = counts.scatter_add(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(Tk, device=xf.device) - torch.gather(starts, 1, sorted_e)
    keep = rank < cap
    slot = sorted_e * cap + torch.clamp(rank, max=cap - 1)
    tok = order // top_k

    rows = torch.gather(xf, 1, tok[..., None].expand(G, Tk, D))
    gathered = torch.where(keep[..., None], rows,
                           torch.zeros((), dtype=xf.dtype, device=xf.device))
    buf = torch.zeros((G, E * cap, D), dtype=xf.dtype, device=xf.device)
    buf = buf.scatter_add(1, slot[..., None].expand(G, Tk, D), gathered)

    probs = torch.softmax(logits, dim=-1)
    frac_tokens = counts.float() / Tk
    lb = E * torch.sum(frac_tokens * probs.mean(dim=1), dim=-1)
    w_slot = torch.gather(gate_w.reshape(G, Tk), 1, order).to(xf.dtype)
    return buf.reshape(G, E, cap, D), (slot, tok, keep, w_slot), lb


def _combine(out_e, idx, T):
    """Every group's expert outputs (G,E,cap,D) back to its T tokens,
    weighted by the gates; a dropped slot adds zeros."""
    slot, tok, keep, w_slot = idx
    G, E, cap, D = out_e.shape
    ix = slot[..., None].expand(G, slot.shape[1], D)
    y_slot = torch.gather(out_e.reshape(G, E * cap, D), 1, ix) * keep[..., None]
    y = torch.zeros((G, T, D), dtype=out_e.dtype, device=out_e.device)
    return y.scatter_add(1, tok[..., None].expand_as(ix), y_slot * w_slot[..., None])


def apply_moe(p, x, *, top_k: int, act: str, capacity_factor: float = 1.25,
              n_groups: int = 32):
    """x: (B,S,D) -> (out (B,S,D), aux dict with router stats)."""
    B, S, D = x.shape
    T = B * S
    E = p["router"].shape[-1]
    G, cap = groups_and_capacity(T, E, top_k, capacity_factor, n_groups)
    Tg = T // G
    xg = x.reshape(G, Tg, D)
    xg = maybe_constrain(xg, ("batch", None, "act_embed"))

    buf, idx, lb = _dispatch_indices(p["router"], xg, top_k=top_k, cap=cap, E=E)
    # (G, E, C, D): G over data axes, E over model if divisible (EP)
    buf = maybe_constrain(buf, ("batch", "expert", None, "act_embed"))

    g_ = torch.einsum("gecd,edf->gecf", buf, p["wi_gate"])
    u_ = torch.einsum("gecd,edf->gecf", buf, p["wi_up"])
    g_ = maybe_constrain(g_, ("batch", "expert", None, "mlp"))
    h = act_fn(act)(g_) * u_
    out_e = torch.einsum("gecf,efd->gecd", h, p["wo"])
    out_e = maybe_constrain(out_e, ("batch", "expert", None, "act_embed"))

    y = _combine(out_e, idx, Tg)
    y = maybe_constrain(y, ("batch", None, "act_embed"))
    aux = {"lb_loss": lb.mean(), "dropped_frac": 1.0 - idx[2].float().mean()}
    return y.reshape(B, S, D), aux
