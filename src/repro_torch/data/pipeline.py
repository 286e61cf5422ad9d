"""Deterministic synthetic LM data pipeline with host sharding + prefetch.

The port's own copy of the JAX package's ``data/pipeline.py`` (numpy and threads,
no JAX there either): the same seed and step give the same tokens.

Synthetic corpora are generated from a seeded Markov-ish token process (so a
model can actually *learn* it — quickstart/train examples show loss going
down), sharded by (host, shard) so multi-host loading is reproducible and
disjoint, with a background prefetch thread.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from ..configs.base import ModelConfig, ShapeSpec


class SyntheticLM:
    """Deterministic, host-shardable synthetic token stream.

    The process mixes (a) a periodic template and (b) bigram structure with
    noise, so cross-entropy has learnable signal well below ln(vocab).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                 host_index: int = 0, n_hosts: int = 1):
        self.cfg, self.shape = cfg, shape
        self.seed = seed
        self.host_index, self.n_hosts = host_index, n_hosts
        assert shape.global_batch % n_hosts == 0
        self.local_batch = shape.global_batch // n_hosts
        v = cfg.vocab_size
        rng = np.random.default_rng(seed)  # shared across hosts: same "corpus"
        self._next_tok = rng.integers(0, v, size=v)  # bigram successor table

    def batch(self, step: int):
        cfg, shape = self.cfg, self.shape
        rng = np.random.default_rng(
            (self.seed, self.host_index, step))
        B, S = self.local_batch, shape.seq_len
        s_text = S - cfg.n_prefix if cfg.frontend == "vit" else S
        k = (cfg.n_codebooks,) if cfg.frontend == "encodec" else ()
        v = cfg.vocab_size
        first = rng.integers(0, v, size=(B, 1) + k)
        toks = [first]
        for _ in range(s_text):
            nxt = self._next_tok[toks[-1]]
            flip = rng.random(first.shape) < 0.1
            rand = rng.integers(0, v, size=first.shape)
            toks.append(np.where(flip, rand, nxt))
        stream = np.concatenate(toks, axis=1).astype(np.int32)  # (B, s_text+1,...)
        tokens = stream[:, :-1]
        labels_text = stream[:, 1:]
        out = {"tokens": tokens}
        if cfg.frontend == "vit":
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.n_prefix, cfg.d_frontend)).astype(np.float32)
            pad = np.full((B, cfg.n_prefix) + k, -1, np.int32)
            out["labels"] = np.concatenate([pad, labels_text], axis=1)
        else:
            out["labels"] = labels_text
        return out


class Prefetcher:
    """Background-thread prefetch of pipeline batches."""

    def __init__(self, pipeline: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.pipeline = pipeline
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            b = self.pipeline.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._t.join(timeout=2)
