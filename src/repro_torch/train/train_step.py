"""Train, prefill and decode step builders.

The train step composes microbatch gradient accumulation (a Python loop),
mixed precision (f32 params, bf16 compute), the remat policy (inside the
model), gradient clipping and the optimizer update.  Compressed cross-pod
gradient reduction (``grad_compress``) waits for ROADMAP module queue 1.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, RunPolicy
from ..models import api
from ..models.module import flatten, tree_map, unflatten
from .optimizer import OptConfig, init_opt_state, opt_update

MOE_AUX_COEF = 0.01
_GRAD_COMPRESS = ("grad_compress: compressed cross-pod gradient reduction "
                  "(train/compression.py) is not ported yet; ROADMAP module queue 1")


def make_loss_fn(cfg: ModelConfig, policy: RunPolicy):
    def loss_fn(params, mb):
        logits, aux = api.forward(params, mb, cfg, policy)
        loss = api.lm_loss(logits, mb["labels"])
        if cfg.n_experts:
            loss = loss + MOE_AUX_COEF * aux[0]
        return loss, aux
    return loss_fn


def _split_microbatches(batch, n):
    def r(a):
        b = a.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return a.reshape((n, b // n) + tuple(a.shape[1:]))
    return tree_map(r, batch)


def compute_grads(cfg, policy, params, batch):
    """Microbatched value and grad.  Returns (loss, aux, grads), the grads in
    f32, summed over the microbatches and divided by their number, as the JAX
    package's ``compute_grads``."""
    if "unembed_f32" in params:
        raise ValueError("params carry the serving cache 'unembed_f32' (from "
                         "cast_params); the unembedding's gradient would go to it. "
                         "Train the f32 params themselves.")
    loss_fn = make_loss_fn(cfg, policy)
    paths, leaves = zip(*flatten(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    live = unflatten(zip(paths, leaves))
    n = max(policy.n_microbatch, 1)
    mbs = _split_microbatches(batch, n) if n > 1 else tree_map(lambda a: a[None], batch)
    gsum = lsum = asum = None
    for i in range(n):
        loss, aux = loss_fn(live, tree_map(lambda a: a[i], mbs))
        grads = torch.autograd.grad(loss, leaves)
        if gsum is None:
            gsum = [g.float() for g in grads]
            lsum, asum = loss.detach(), aux.detach()
        else:
            for s, g in zip(gsum, grads):
                s.add_(g.float())
            lsum, asum = lsum + loss.detach(), asum + aux.detach()
        del grads, loss, aux
    return lsum / n, asum / n, unflatten(zip(paths, [g.div_(n) for g in gsum]))


def make_train_step(cfg: ModelConfig, policy: RunPolicy, opt: OptConfig, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    On a mesh the arguments are DTensors and DTensor owns every reduction
    (the SPMD partitioner does in the JAX package), so ``mesh`` changes
    nothing here."""
    if policy.grad_compress != "none":
        raise NotImplementedError(_GRAD_COMPRESS)

    def train_step(params, opt_state, batch):
        loss, aux, grads = compute_grads(cfg, policy, params, batch)
        new_params, new_opt, stats = opt_update(opt, grads, opt_state, params)
        metrics = {"loss": loss, "moe_lb": aux[0], "moe_drop": aux[1], **stats}
        return new_params, new_opt, metrics
    return train_step


def make_init_opt(cfg: ModelConfig, policy: RunPolicy, opt: OptConfig, mesh=None):
    if policy.grad_compress != "none":
        raise NotImplementedError(_GRAD_COMPRESS)

    def init(params):
        return init_opt_state(opt, params)
    return init


# ------------------------------------------------------------------- serving

def make_prefill_step(cfg: ModelConfig, policy: RunPolicy, cache_len: int):
    def prefill_step(params, batch):
        logits, aux, state = api.forward(params, batch, cfg, policy,
                                         return_cache=True, cache_len=cache_len)
        return logits, state
    return prefill_step


def make_decode_step(cfg: ModelConfig, policy: RunPolicy):
    def dstep(params, state, batch):
        return api.decode_step(params, state, batch, cfg, policy)
    return dstep
