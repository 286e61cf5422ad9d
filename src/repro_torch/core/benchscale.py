"""Bench-scale reductions: same architecture *shape pathologies* (head/expert
counts, GQA ratios, patterns, windows), smaller dims + meshes, so search
benchmarks can afford hundreds of traces.  Anomalies found here are real —
sharding/replication/remat pathologies manifest identically on a 4x4 mesh.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, ShapeSpec, get_config, list_archs
from ..launch.mesh import make_mesh


def bench_config(name: str) -> ModelConfig:
    cfg = get_config(name)
    plen = len(cfg.block_pattern)
    n_layers = 2 * plen + (2 if plen > 1 else 0)   # keep tail path for hybrids
    upd = dict(
        n_layers=max(n_layers, 4) if plen == 1 else n_layers,
        d_model=256, d_ff=512, vocab_size=8192,
    )
    if not cfg.attn_free:
        upd.update(d_head=32)
    if cfg.rec_width:
        upd.update(rec_width=256, n_heads=8, n_kv_heads=1, d_head=64)
    if cfg.head_size:
        upd.update(head_size=32, n_heads=8)
    if cfg.window:
        upd.update(window=64)
    if cfg.frontend == "vit":
        upd.update(n_prefix=16, d_frontend=64)
    return dataclasses.replace(cfg, name=cfg.name + "-bench", **upd)


BENCH_SHAPES = {
    "train_s": ShapeSpec("train_s", "train", 256, 32),
    "prefill_s": ShapeSpec("prefill_s", "prefill", 1024, 8),
    "decode_s": ShapeSpec("decode_s", "decode", 1024, 16),
    "long_s": ShapeSpec("long_s", "decode", 8192, 1),
}


def bench_archs(subset=None) -> dict:
    names = subset or list_archs()
    return {n: bench_config(n) for n in names}


def bench_meshes():
    """(4,4) single over ranks 0-15 and (2,4,4) multi over ranks 0-31 of the
    fake process group (the JAX package's 32 host devices)."""
    return {"single": make_mesh((4, 4), ("data", "model")),
            "multi": make_mesh((2, 4, 4), ("pod", "data", "model"))}
