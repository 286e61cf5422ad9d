"""Prefill and decode step builders (the train step is a later slice)."""
from __future__ import annotations

from ..configs.base import ModelConfig, RunPolicy
from ..models import api


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
