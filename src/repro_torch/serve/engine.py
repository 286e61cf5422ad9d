"""Batched serving engine: per-request prefill + slot-based continuous decode.

A fixed pool of ``n_slots`` decode lanes; each incoming request is prefilled
(cache built at its own length), inserted into a free lane of the batched
cache, and advanced by the shared batched decode step.  Lanes free up on EOS
or max_new_tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, RunPolicy
from ..models import api
from ..models.transformer import compute_dtype
from ..train.train_step import make_decode_step, make_prefill_step


def sample_logits(logits, generator: torch.Generator | None,
                  temperature: float = 0.0):
    """Argmax at temperature 0; otherwise a draw from softmax(logits / T)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0].to(torch.int32)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _update_slot(state, state1, slot: int):
    """Copy single-request state1 (batch 1) into lane ``slot`` of state.

    State trees are {"units": leaves (n_units, B, ...), "tail": leaves (B, ...)},
    whatever the leaves are (K/V caches, RG-LRU or RWKV states).
    The copy is in place: ``state``'s tensors are written and ``state`` is
    returned (the JAX version builds a new tree).
    """
    for blk, leaves in state["units"].items():
        for name, dst in leaves.items():
            dst[:, slot:slot + 1].copy_(state1["units"][blk][name])
    for blk, leaves in state.get("tail", {}).items():
        for name, dst in leaves.items():
            dst[slot:slot + 1].copy_(state1["tail"][blk][name])
    return state


class ServingEngine:
    def __init__(self, cfg: ModelConfig, policy: RunPolicy, params,
                 n_slots: int = 4, cache_len: int = 256, seed: int = 0,
                 temperature: float = 0.0, device="cuda"):
        if cfg.frontend == "encodec":
            raise NotImplementedError("serving engine drives token-stream archs")
        if cfg.window is not None and cache_len > cfg.window:
            # the decode state holds min(cache_len, window) slots while a
            # prefill shorter than cache_len pads its cache to cache_len; the
            # JAX package's engine fails on the first insert with a TypeError
            raise ValueError(f"{cfg.name}: cache_len {cache_len} > window {cfg.window}; "
                             f"a windowed arch serves with cache_len <= window")
        self.device = api.resolve_device(device)
        self.cfg, self.policy = cfg, policy
        # cast to the compute dtype once here, not on every step
        self.params = api.cast_params(params, compute_dtype(policy))
        self.n_slots, self.cache_len = n_slots, cache_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.prefill = make_prefill_step(cfg, policy, cache_len)
        self.decode = make_decode_step(cfg, policy)
        self.state = api.init_state(cfg, n_slots, cache_len, compute_dtype(policy),
                                    self.device)
        self.slot_req: list[Request | None] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int64)
        self.slot_last_tok = np.zeros(n_slots, np.int64)
        self.pending: list[Request] = []
        self.completed: list[Request] = []
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens_out": 0}

    # ------------------------------------------------------------------ admin
    def add_request(self, req: Request):
        self.pending.append(req)

    @torch.inference_mode()
    def _insert(self, slot: int, req: Request):
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int32),
                                 device=self.device)[None, :]
        logits, state1 = self.prefill(self.params, {"tokens": prompt})
        _update_slot(self.state, state1, slot)
        tok = int(sample_logits(logits, self.generator, self.temperature)[0])
        req.out.append(tok)
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.slot_last_tok[slot] = tok
        self.stats["prefills"] += 1

    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    # ------------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self):
        """Admit pending requests, run one batched decode step."""
        for slot in self._free_slots():
            if not self.pending:
                break
            self._insert(slot, self.pending.pop(0))
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return False
        toks = torch.as_tensor(self.slot_last_tok.astype(np.int32),
                               device=self.device)[:, None]
        pos = torch.as_tensor(self.slot_pos.astype(np.int32), device=self.device)
        logits, self.state = self.decode(self.params, self.state,
                                         {"tokens": toks, "position": pos})
        self.stats["decode_steps"] += 1
        nxt = sample_logits(logits, self.generator, self.temperature).cpu().numpy()
        for i in active:
            req = self.slot_req[i]
            tok = int(nxt[i])
            req.out.append(tok)
            self.stats["tokens_out"] += 1
            self.slot_pos[i] += 1
            self.slot_last_tok[i] = tok
            hit_eos = (req.eos_id >= 0 and tok == req.eos_id)
            if hit_eos or len(req.out) >= req.max_new_tokens \
                    or self.slot_pos[i] >= self.cache_len - 1:
                req.done = True
                self.completed.append(req)
                self.slot_req[i] = None
        return True

    def run(self, max_steps: int = 1000):
        steps = 0
        while (self.pending or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.completed
