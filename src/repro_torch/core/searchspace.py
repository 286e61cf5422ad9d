"""The Collie-JAX workload search space (paper §4, adapted per DESIGN.md §3).

Four developer-perspective dimensions built from the narrow-waist JAX
distributed API (the analogue of verbs):

  D1 topology   — mesh choice (single-pod 16x16 / multi-pod 2x16x16)
  D2 memory     — remat policy, microbatching, dtype, ZeRO-1, optimizer,
                  gradient compression
  D3 transport  — sharding preset + per-axis rule overrides, scan vs unroll,
                  attention impl, MoE capacity factor
  D4 workload   — architecture x input-shape cell

A Point is a plain dict factor->value.  Mutation changes one factor (paper
Algorithm 1 line 4).  Points are normalized (factors inert for the cell's
kind are pinned) so the engine cache and the MFS never distinguish no-ops.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any

from ..configs.base import ModelConfig, RunPolicy, ShapeSpec

FACTORS: dict[str, tuple] = {
    # D1 — topology
    "mesh": ("single", "multi"),
    # D2 — memory policy
    "remat": ("none", "dots", "full"),
    "n_microbatch": (1, 2, 4, 8, 16, 32),
    "params_f32": (True, False),
    "zero1": (True, False),
    "optimizer": ("adamw", "adafactor", "sgdm"),
    "grad_compress": ("none", "bf16", "int8"),
    # D3 — sharding transport
    "preset": ("fsdp", "tp", "ep", "dp"),
    "seq_shard": (True, False),
    "cache_shard": (True, False),
    "vocab_shard": (True, False),
    "scan_layers": (True, False),
    "attn_impl": ("auto", "plain", "blocked", "local"),
    "capacity_factor": (1.0, 1.25, 2.0),
    # D4 — workload
    "arch": None,     # filled per-space
    "shape": None,
}

DIMENSION_OF = {
    "mesh": "D1",
    "remat": "D2", "n_microbatch": "D2", "params_f32": "D2", "zero1": "D2",
    "optimizer": "D2", "grad_compress": "D2",
    "preset": "D3", "seq_shard": "D3", "cache_shard": "D3",
    "vocab_shard": "D3", "scan_layers": "D3", "attn_impl": "D3",
    "capacity_factor": "D3",
    "arch": "D4", "shape": "D4",
}

# factors that have no effect on non-train cells (pinned by normalize)
_TRAIN_ONLY = ("remat", "n_microbatch", "zero1", "optimizer", "grad_compress",
               "params_f32")
_TRAIN_PIN = {"remat": "none", "n_microbatch": 1, "zero1": True,
              "optimizer": "adamw", "grad_compress": "none",
              "params_f32": True}

# factors whose effect is independent of normalization coupling (safe for
# conjunctive-rule property tests; the paper's MFS likewise assumes
# independent feature axes)
UNCOUPLED = ("mesh", "preset", "seq_shard", "cache_shard", "vocab_shard",
             "scan_layers")


@dataclasses.dataclass
class SearchSpace:
    archs: dict                      # name -> ModelConfig
    shapes: dict                     # name -> ShapeSpec
    factors: dict = None
    restrict: dict = None            # factor -> allowed values (paper §7.3)

    def __post_init__(self):
        f = dict(FACTORS)
        f["arch"] = tuple(sorted(self.archs))
        f["shape"] = tuple(sorted(self.shapes))
        if self.restrict:
            for k, v in self.restrict.items():
                f[k] = tuple(x for x in f[k] if x in v) or f[k]
        self.factors = f

    # ------------------------------------------------------------------ size
    def size(self) -> int:
        n = 1
        for v in self.factors.values():
            n *= len(v)
        return n

    # ------------------------------------------------------------ validity
    def valid(self, p: dict) -> bool:
        cfg = self.archs[p["arch"]]
        shape = self.shapes[p["shape"]]
        if shape.name.startswith("long") and not cfg.subquadratic:
            return False
        if shape.kind == "train":
            # batch must split into microbatches
            if shape.global_batch % p["n_microbatch"] != 0:
                return False
            if p["grad_compress"] != "none" and p["mesh"] != "multi":
                return False
        return True

    # ----------------------------------------------------------- normalize
    def normalize(self, p: dict) -> dict:
        p = dict(p)
        shape = self.shapes[p["shape"]]
        if shape.kind != "train":
            for k in _TRAIN_ONLY:
                p[k] = _TRAIN_PIN[k]
        cfg = self.archs[p["arch"]]
        if not cfg.n_experts:
            p["capacity_factor"] = 1.25
        if cfg.attn_free:
            p["attn_impl"] = "auto"
        return p

    # ------------------------------------------------------------- sampling
    def random_point(self, rng: random.Random) -> dict:
        for _ in range(1000):
            p = {k: rng.choice(v) for k, v in self.factors.items()}
            if self.valid(p):
                return self.normalize(p)
        raise RuntimeError("no valid point found")

    def mutate(self, p: dict, rng: random.Random) -> dict:
        """Change one factor to a different valid value (Algorithm 1 l.4)."""
        for _ in range(1000):
            f = rng.choice(list(self.factors))
            alts = [v for v in self.factors[f] if v != p.get(f)]
            if not alts:
                continue
            q = dict(p)
            q[f] = rng.choice(alts)
            if self.valid(q):
                return self.normalize(q)
        return dict(p)

    # ------------------------------------------------------- policy mapping
    def to_run(self, p: dict):
        """Point -> (cfg, shape, RunPolicy, mesh_kind)."""
        cfg = self.archs[p["arch"]]
        shape = self.shapes[p["shape"]]
        overrides = []
        if not p["seq_shard"]:
            overrides.append(("seq_q", ()))
        if not p["cache_shard"]:
            overrides.append(("cache_seq", ()))
        if not p["vocab_shard"]:
            overrides.append(("vocab", ()))
        policy = RunPolicy(
            sharding_preset=p["preset"],
            rule_overrides=tuple(overrides),
            remat=p["remat"] if shape.kind == "train" else "none",
            n_microbatch=p["n_microbatch"] if shape.kind == "train" else 1,
            scan_layers=p["scan_layers"],
            attn_impl=p["attn_impl"],
            params_f32=p["params_f32"] if shape.kind == "train" else False,
            zero1=p["zero1"],
            optimizer=p["optimizer"],
            grad_compress=p["grad_compress"] if shape.kind == "train" else "none",
            capacity_factor=p["capacity_factor"],
        )
        return cfg, shape, policy, p["mesh"]

    def point_key(self, p: dict) -> tuple:
        p = self.normalize(p)
        return tuple(sorted(p.items()))
