"""Optimizers over the port's param dicts: AdamW, Adafactor (factored second
moment) and SGD with momentum, as plain functions.

The counterpart of the JAX package's ``train/optimizer.py``, with the same
state layout (``{"mom": ..., "step": int32}``), bias correction, decoupled
weight decay, global-norm clipping and schedule (linear warmup, cosine
decay), all in f32.  ``torch.optim`` is not used: its bias correction, decay
and clipping differ.  The functions are pure: they return new trees and
leave their inputs as they are.  ``opt_state_axes`` (sharding) waits for the
sharding slice (ROADMAP module queue 2).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.api import resolve_device
from ..models.module import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"               # adamw | adafactor | sgdm
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1


def _leaves(tree):
    return [leaf for _, leaf in flatten(tree)]


def _map_leaves(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure, returning a
    tuple; gives the tuple of trees of its results."""
    paths = [p for p, _ in flatten(trees[0])]
    outs = [fn(*leaves) for leaves in zip(*map(_leaves, trees))]
    return tuple(unflatten(zip(paths, col)) for col in zip(*outs))


def schedule(opt: OptConfig, step):
    """Learning rate at ``step`` (an int32 tensor), an f32 tensor."""
    step = step.float()
    warm = torch.clamp(step / max(opt.warmup, 1), max=1.0)
    prog = torch.clamp((step - opt.warmup) / max(opt.decay_steps - opt.warmup, 1), 0, 1)
    cos = opt.min_lr_frac + (1 - opt.min_lr_frac) * 0.5 * (1 + torch.cos(np.pi * prog))
    return opt.lr * warm * cos


def _factored(shape):
    return len(shape) >= 2


def init_opt_state(opt: OptConfig, params):
    zeros = lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    if opt.name == "adamw":
        mom = {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}
    elif opt.name == "sgdm":
        mom = {"m": tree_map(zeros, params)}
    elif opt.name == "adafactor":
        def vr(a):
            shape = a.shape[:-1] if _factored(a.shape) else a.shape
            return torch.zeros(shape, dtype=torch.float32, device=a.device)

        def vc(a):
            shape = a.shape[:-2] + a.shape[-1:] if _factored(a.shape) else ()
            return torch.zeros(shape, dtype=torch.float32, device=a.device)
        mom = {"vr": tree_map(vr, params), "vc": tree_map(vc, params)}
    else:
        raise ValueError(opt.name)
    device = _leaves(params)[0].device
    return {"mom": mom, "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in _leaves(tree)))


def _clip_scale(gnorm, max_norm):
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    n = global_norm(grads)
    scale = _clip_scale(n, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), n


def opt_update(opt: OptConfig, grads, state, params):
    """Returns (new_params, new_state, stats), as the JAX package's
    ``opt_update``.  The clipped gradient is formed leaf by leaf, so no second
    gradient tree is held at once."""
    gnorm = global_norm(grads)
    clip = _clip_scale(gnorm, opt.grad_clip)
    step = state["step"] + 1
    lr = schedule(opt, step)
    mom = state["mom"]

    def new_param(p, u):
        return (p.float() - lr * (u + opt.weight_decay * p.float())).to(p.dtype)

    if opt.name == "adamw":
        b1, b2 = opt.b1, opt.b2
        t = step.float()
        bc1, bc2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)

        def upd(p, g, m, v):
            g = g.float() * clip
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            u = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
            return new_param(p, u), m, v
        new_params, m, v = _map_leaves(upd, params, grads, mom["m"], mom["v"])
        new_mom = {"m": m, "v": v}
    elif opt.name == "sgdm":
        def upd(p, g, m):
            m = opt.b1 * m + g.float() * clip
            return (p.float() - lr * m).to(p.dtype), m
        new_params, m = _map_leaves(upd, params, grads, mom["m"])
        new_mom = {"m": m}
    elif opt.name == "adafactor":
        eps = 1e-30

        def upd(p, g, vr, vc):
            g = g.float() * clip
            g2 = torch.square(g) + eps
            if _factored(p.shape):
                nvr = opt.b2 * vr + (1 - opt.b2) * g2.mean(dim=-1)
                nvc = opt.b2 * vc + (1 - opt.b2) * g2.mean(dim=-2)
                denom = (nvr / torch.clamp(nvr.mean(dim=-1, keepdim=True), min=eps)
                         )[..., None] * nvc[..., None, :]
                u = g * torch.rsqrt(denom + eps)
            else:
                nvr = opt.b2 * vr + (1 - opt.b2) * g2
                nvc = vc
                u = g * torch.rsqrt(nvr + eps)
            # update clipping (Adafactor d=1.0)
            rms_u = torch.sqrt(torch.mean(torch.square(u)) + eps)
            u = u / torch.clamp(rms_u, min=1.0)
            return new_param(p, u), nvr, nvc
        new_params, vr, vc = _map_leaves(upd, params, grads, mom["vr"], mom["vc"])
        new_mom = {"vr": vr, "vc": vc}
    else:
        raise ValueError(opt.name)
    return new_params, {"mom": new_mom, "step": step}, {"grad_norm": gnorm, "lr": lr}


_MOMENTS = {"adamw": ("m", "v"), "sgdm": ("m",), "adafactor": ("vr", "vc")}


def from_numpy_opt_state(opt: OptConfig, tree, device="cuda"):
    """Carry an optimizer state across from the JAX package.

    ``tree`` is that package's ``init_opt_state``/``opt_update`` state as
    nested dicts of numpy arrays (``jax.tree.map(np.asarray, state)``): the
    step and, per moment, a tree parallel to the params.  Dtypes are kept.
    """
    dev = resolve_device(device)
    if set(tree) != {"mom", "step"} or set(tree["mom"]) != set(_MOMENTS[opt.name]):
        raise ValueError(f"{opt.name} state: keys {sorted(tree)}, moments "
                         f"{sorted(tree.get('mom', {}))} != {_MOMENTS[opt.name]}")
    to_torch = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return {"mom": {k: tree_map(to_torch, v) for k, v in tree["mom"].items()},
            "step": to_torch(np.asarray(tree["step"], np.int32))}
