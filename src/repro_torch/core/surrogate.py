"""Fidelity-0 measurement: a trace-free analytic surrogate.

Collie's search cost is dominated by measuring each candidate.  This module
predicts the anomaly-indicative counters of a search-space point *without*
touching a mesh entry or tracing anything: it reuses the first-principles
floors in ``analytic.py`` and layers a static sharding-aware traffic model
on top — the known ways a ``RunPolicy`` makes a compiled program *exceed*
its floor (replication under ``dp``, unsharded vocab/sequence/cache gathers,
remat recompute, full-square ``plain`` attention, MoE capacity padding).
Search drivers use it to screen wide and measure narrow
(``Engine.predict_batch`` / ``measure_batch(prescreen=k)``).

It is the JAX package's surrogate, constant for constant and in the same
order of operations, so its predictions, calibrated or not, are the
reference's bit for bit.  Its penalty factors describe XLA's compiled
programs; in the port the residual calibrator corrects them toward the
traced counters.

Predictions are *estimates*; an online residual :class:`Calibrator` fits a
per-counter scale/offset correction from every real measurement the engine
completes, so the ranking sharpens as a campaign runs.  Mesh information is
reduced to static axis-shape descriptors at construction, so a Surrogate
works anywhere — including processes that start no process group.
"""
from __future__ import annotations

import json
import math
import os
import threading

import numpy as np

from .. import hw
from . import analytic
from . import anomaly as anomaly_mod

# counters the surrogate screens (predicts well enough to rank by)
SCREENED = (
    "perf.roofline_efficiency",
    "perf.useful_flops_ratio",
    "diag.collective_blowup",
    "diag.memory_overshoot",
    "diag.hbm_oversubscribed",
    "diag.collective_wire_bytes",
    "diag.peak_bytes",
    "diag.transpose_bytes",
    "diag.n_allgather",
    "diag.n_allreduce",
    "diag.n_alltoall",
    "diag.n_permute",
)

# the counter that drives each anomaly kind (used by MFS probe ordering)
KIND_COUNTER = {
    "A1": ("perf.roofline_efficiency", "min"),
    "A2": ("diag.collective_blowup", "max"),
    "A3": ("perf.useful_flops_ratio", "min"),
    "A4": ("diag.hbm_oversubscribed", "max"),
}

# counters the fidelity-1 "lowered" tier derives from the pre-XLA module
# (see counters.lowered_counters); they calibrate through their own channel
LOWERED_KEYS = (
    "perf.roofline_efficiency",
    "perf.useful_flops_ratio",
    "diag.transpose_bytes",
)


class _MeshDesc:
    """Static stand-in for a Mesh: just axis sizes (what analytic.py reads)."""

    def __init__(self, shape: dict):
        self.shape = dict(shape)
        n = 1
        for v in self.shape.values():
            n *= int(v)
        self.size = n


def mesh_descs(meshes: dict) -> dict:
    """Extract {kind: _MeshDesc} from real Meshes, shape dicts, or stubs."""
    descs = {}
    for kind, m in (meshes or {}).items():
        if m is None:
            continue
        if isinstance(m, _MeshDesc):
            descs[kind] = m
        elif isinstance(m, dict):
            descs[kind] = _MeshDesc(m)
        else:
            try:
                descs[kind] = _MeshDesc(dict(m.shape))
            except Exception:      # test stubs without .shape: 1-device mesh
                descs[kind] = _MeshDesc({})
    return descs


# --------------------------------------------------------------- calibrator

class Calibrator:
    """Online per-counter scale/offset residual fit, in log1p space:
    log1p(y) ≈ a·log1p(x) + b, i.e. a power-law scale + offset correction.

    Screened counters are non-negative and heavy-tailed (collective counts
    span four orders of magnitude); a linear-space least-squares fit lets a
    few large points ruin the median correction, while the log-space fit is
    robust and keeps corrected values non-negative.  Keeps running
    least-squares sums per counter; corrections kick in after ``min_obs``
    observations and are refreshed on every observation.  Updates are
    commutative sums folded in driver-thread list order by the engine, so
    calibrated predictions — and any prescreen ranking derived from them —
    are deterministic for any ``n_workers``.
    """

    def __init__(self, min_obs: int = 8):
        self.min_obs = min_obs
        self._lock = threading.Lock()
        self._sums: dict = {}    # counter -> [n, sx, sy, sxx, sxy] (log1p)

    @staticmethod
    def _t(v: float) -> float:
        return math.log1p(max(float(v), 0.0))

    def observe(self, pred: dict, actual: dict):
        if not pred or not actual:
            return
        with self._lock:
            for c in SCREENED:
                x, y = pred.get(c), actual.get(c)
                if x is None or y is None:
                    continue
                x, y = float(x), float(y)
                if not (math.isfinite(x) and math.isfinite(y)):
                    continue
                x, y = self._t(x), self._t(y)
                s = self._sums.setdefault(c, [0, 0.0, 0.0, 0.0, 0.0])
                s[0] += 1
                s[1] += x
                s[2] += y
                s[3] += x * x
                s[4] += x * y

    def coeffs(self, counter: str):
        """-> log-space (a, b) or None while under-observed / degenerate."""
        with self._lock:
            s = self._sums.get(counter)
            if s is None or s[0] < self.min_obs:
                return None
            n, sx, sy, sxx, sxy = s
        var = sxx - sx * sx / n
        if var <= 1e-12 * max(sxx, 1.0):
            return (1.0, (sy - sx) / n)          # offset-only correction
        a = (sxy - sx * sy / n) / var
        return (a, (sy - a * sx) / n)

    def apply(self, pred: dict) -> dict:
        if pred is None:
            return None
        out = dict(pred)
        for c in SCREENED:
            if c not in out:
                continue
            ab = self.coeffs(c)
            if ab is not None:
                t = ab[0] * self._t(out[c]) + ab[1]
                out[c] = math.expm1(min(max(t, 0.0), 700.0))
        return out

    @property
    def n_observed(self) -> int:
        with self._lock:
            return max((s[0] for s in self._sums.values()), default=0)

    # ----------------------------------------------------------- persistence
    def state(self) -> dict:
        with self._lock:
            return {"min_obs": self.min_obs,
                    "sums": {c: list(s) for c, s in self._sums.items()}}

    def load_state(self, state: dict):
        with self._lock:
            self.min_obs = int(state.get("min_obs", self.min_obs))
            self._sums = {c: list(s) for c, s in state.get("sums", {}).items()}

    def save(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state(), f)
        os.replace(tmp, path)

    def load(self, path: str) -> bool:
        try:
            with open(path) as f:
                self.load_state(json.load(f))
            return True
        except (OSError, ValueError):
            return False


# ---------------------------------------------------------------- surrogate

class Surrogate:
    """Point -> estimated flat counter dict, no compile (fidelity 0)."""

    def __init__(self, space, meshes: dict, chip: hw.ChipSpec = hw.V5E,
                 calibrator: Calibrator | None = None):
        self.space = space
        self.descs = mesh_descs(meshes)
        self.chip = chip
        self.calibrator = calibrator or Calibrator()
        # second observation channel: fidelity-1 (lowered-module) estimates
        # -> real measured values, fit independently of the fidelity-0 one
        self.lowered_calibrator = Calibrator()
        self._cache: dict = {}
        self._base_cache: dict = {}     # cell-level analytic inputs (memo)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- predict
    def predict(self, point: dict, calibrated: bool = True):
        """Estimated counters (or None if the engine would reject it)."""
        key = self.space.point_key(point)
        with self._lock:
            raw = self._cache.get(key, False)
        if raw is False:
            raw = self._estimate(point)
            with self._lock:
                if len(self._cache) > 65536:    # campaign-scale bound
                    self._cache.clear()
                self._cache[key] = raw
        if raw is None:
            return None
        return self.calibrator.apply(raw) if calibrated else dict(raw)

    def predict_batch(self, points: list, calibrated: bool = True) -> list:
        """Estimates aligned with ``points`` — the fidelity-0 hot path.

        Cached points are served from the raw-estimate cache; the uncached
        remainder goes through ONE numpy-vectorized sweep of the factor
        model (``_estimate_many``), bit-identical to the scalar
        ``_estimate`` (pinned by tests/test_surrogate.py), instead of one
        Python ``_estimate`` per point.
        """
        keys = [self.space.point_key(p) for p in points]
        out: list = [None] * len(points)
        miss: dict = {}                 # key -> [positions]
        with self._lock:
            for i, k in enumerate(keys):
                raw = self._cache.get(k, False)
                if raw is False:
                    miss.setdefault(k, []).append(i)
                else:
                    out[i] = raw
        if miss:
            uniq = [points[idxs[0]] for idxs in miss.values()]
            raws = self._estimate_many(uniq)
            with self._lock:
                if len(self._cache) > 65536:
                    self._cache.clear()
                for (k, idxs), raw in zip(miss.items(), raws):
                    self._cache[k] = raw
                    for i in idxs:
                        out[i] = raw
        return [None if r is None else
                (self.calibrator.apply(r) if calibrated else dict(r))
                for r in out]

    def observe(self, point: dict, actual: dict):
        """Feed one completed real measurement into the residual fit."""
        if actual is None:
            return
        raw = self.predict(point, calibrated=False)
        if raw is not None:
            self.calibrator.observe(raw, actual)

    # ----------------------------------------------------------- persistence
    def save_calibration(self, path: str):
        """Persist BOTH calibrator channels (fidelity-0 + lowered) as one
        JSON doc; old single-channel files load transparently."""
        doc = self.calibrator.state()
        doc["lowered"] = self.lowered_calibrator.state()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def load_calibration(self, path: str) -> bool:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return False
        self.calibrator.load_state(doc)
        if isinstance(doc.get("lowered"), dict):
            self.lowered_calibrator.load_state(doc["lowered"])
        return True

    def anomaly_score(self, pred: dict, remat: str = "none") -> float:
        """How far past the nearest anomaly threshold this point is predicted
        to land (>1: predicted anomalous).  The engine's default prescreen
        rank."""
        if pred is None:
            return -1.0
        eps = 1e-9
        a3 = anomaly_mod.A3_USEFUL_MIN.get(remat, 0.55)
        return max(
            anomaly_mod.A1_EFFICIENCY_MIN
            / max(pred.get("perf.roofline_efficiency", 1.0), eps),
            pred.get("diag.collective_blowup", 0.0)
            / anomaly_mod.A2_COLLECTIVE_MAX,
            a3 / max(pred.get("perf.useful_flops_ratio", 1.0), eps),
            pred.get("diag.hbm_oversubscribed", 0.0) / anomaly_mod.A4_HBM_MAX,
        )

    # ------------------------------------------------- the traffic model
    def _estimate(self, point: dict):
        """The static sharding-aware model.

        Structure over precision: each counter is the analytic floor scaled
        by multiplicative penalty factors for the policy pathologies XLA is
        known to compile in (microbatch loop unrolling, remat recompute,
        unsharded optimizer state, f32 master-copy traffic, capacity
        padding, replication under ``dp``, per-rule gathers).  The residual
        calibrator owns absolute scale; what must be right here is the
        *direction and relative size* of each factor's effect — that is what
        prescreen ranking consumes.
        """
        space = self.space
        if not space.valid(point):
            return None
        cfg, shape, policy, mesh_kind = space.to_run(point)
        mesh = self.descs.get(mesh_kind)
        if mesh is None:
            return None
        chip = self.chip
        floors = analytic.step_floor_seconds(cfg, shape, policy, mesh, chip)

        n_m = mesh.shape.get("model", 1)
        n_d = analytic._axis_size(mesh, ("pod", "data"))
        multi = mesh.shape.get("pod", 1) > 1
        train = shape.kind == "train"
        adtype = 2 if policy.dtype == "bf16" else 4
        passes = 3.0 if train else 1.0
        tokens = (shape.global_batch if shape.kind == "decode"
                  else shape.global_batch * shape.seq_len)
        tokens_local = max(tokens / max(n_d, 1), 1.0)
        layers = cfg.n_layers
        preset = policy.sharding_preset
        unsharded = {a for a, rules in policy.rule_overrides if rules == ()}
        n_micro = max(policy.n_microbatch, 1) if train else 1
        moe = bool(cfg.n_experts)

        # shared train-pathology intensity: how much extra program XLA emits
        # around each layer (microbatch unrolling, remat recompute, optimizer
        # update traffic, f32 master-copy round-trips)
        intensity = 1.0
        if train:
            intensity *= n_micro
            intensity *= {"none": 1.0, "dots": 2.8, "full": 2.4}[policy.remat]
            intensity *= {"adamw": 1.0, "adafactor": 2.2,
                          "sgdm": 2.4}[policy.optimizer]
            if not policy.zero1:
                intensity *= 2.2
            if not policy.params_f32:
                intensity *= 2.4

        # ---- perf.roofline_efficiency: direct factor model of measured
        # step-bound / analytic-floor (low = anomalous); coefficients from a
        # log-space regression over measured bench points
        eff = 0.8
        if train:
            eff *= 0.15
            eff /= 1.0 + 0.08 * (n_micro - 1)
            eff *= {"none": 1.0, "dots": 0.74, "full": 0.59}[policy.remat]
            eff *= {"adamw": 1.0, "adafactor": 0.75, "sgdm": 0.9}[
                policy.optimizer]
            if not policy.zero1:
                eff *= 0.42
            if not policy.params_f32:
                eff *= 0.7
        elif shape.kind == "decode":
            eff *= 1.6 if shape.seq_len >= 4096 else 1.0
        else:
            eff *= 0.5
        eff *= {"fsdp": 1.0, "tp": 0.55, "ep": 0.4, "dp": 0.4}[preset]
        if not cfg.attn_free:
            eff *= {"auto": 1.0, "plain": 0.45, "blocked": 0.55,
                    "local": 1.0}.get(policy.attn_impl, 1.0)
        if moe:
            eff *= 0.35
            eff *= {1.0: 0.55, 1.25: 0.65, 2.0: 1.0}.get(
                policy.capacity_factor, 1.0)
        if multi:
            eff *= 0.85
        if "vocab" in unsharded:
            eff *= 0.7
        eff *= 0.9 ** len(unsharded - {"vocab"})
        eff = min(max(eff, 1e-4), 1.0)

        # ---- perf.useful_flops_ratio: model flops / estimated compiled
        # flops (waste factors; low = anomalous)
        attn_fl = analytic.attention_flops(cfg, shape)
        mf_useful = (floors["matmul_model_flops"] + attn_fl
                     + analytic.recurrence_flops(cfg, shape))
        waste = 1.15
        if train:
            waste *= 1.25 * n_micro ** 0.3 \
                * {"none": 1.0, "dots": 1.25, "full": 1.45}[policy.remat] \
                * {"adamw": 1.0, "adafactor": 1.15, "sgdm": 1.2}[
                    policy.optimizer]
            if not policy.zero1:
                waste *= 1.15
            if not policy.params_f32:
                waste *= 1.25
        elif shape.kind == "decode":
            # decode-loop overhead grows superlinearly with context length
            waste *= 1.0 + (shape.seq_len / 1000.0) ** 1.3
        else:
            waste *= 1.45
        if moe:
            waste *= 1.35                           # router/dispatch glue
        if preset == "dp" and n_m > 1:
            waste *= math.sqrt(n_m)                 # partial replication
        total_flops = floors["model_flops"] * waste
        if policy.attn_impl == "plain" and not cfg.attn_free \
                and shape.kind != "decode" and not cfg.window:
            total_flops += attn_fl                  # full square vs causal
        if moe and policy.capacity_factor > 1.0:
            total_flops += floors["model_flops"] * 0.55 \
                * (policy.capacity_factor - 1.0)    # capacity-padded slots

        # ---- wire bytes: parallelism floor + gathers the floor excludes
        wire = floors["collective_floor"]
        if n_m > 1:
            gather = (n_m - 1) / n_m
            if "vocab" in unsharded and preset != "dp":
                wire += passes * tokens_local * cfg.vocab_size * adtype \
                    * gather * 0.5
            if "seq_q" in unsharded and preset in ("tp", "ep"):
                wire += passes * layers * tokens_local * cfg.d_model \
                    * adtype * gather
            if "cache_seq" in unsharded and shape.kind in ("decode",
                                                           "prefill"):
                clen = min(shape.seq_len, cfg.window) if cfg.window \
                    else shape.seq_len
                cache = 2 * layers * max(shape.global_batch // max(n_d, 1), 1) \
                    * clen * max(cfg.n_kv_heads, 1) * cfg.d_head * adtype
                wire += cache * gather
        if moe and preset == "ep":
            wire *= min(policy.capacity_factor, 2.0)
        wire += 0.02 * floors["bytes_floor"]        # resharding noise

        # ---- peak memory: floor × allocator/layout overhead factors
        act = analytic.activation_bytes_floor(cfg, shape, policy, mesh)
        peak = floors["memory_floor"] * 1.45
        peak *= {"fsdp": 1.45, "tp": 1.7, "ep": 1.35, "dp": 1.0}[preset]
        if shape.kind == "prefill":
            peak *= 2.0                             # logits + cache-write bufs
        if train:
            peak *= 0.85                            # floor's act term is wide
            if preset == "fsdp":
                peak *= 1.15                        # gather buffers
            elif preset == "tp":
                peak *= 0.85
            # the floor scales activations by 1/n_micro but XLA keeps
            # per-microbatch loop buffers at small counts; at large counts
            # the loop reuses one buffer and the floor overestimates
            if n_micro > 1:
                peak *= 1.4 if n_micro <= 4 else (1.0 if n_micro <= 8
                                                  else 0.75)
            peak *= {"adamw": 1.0, "adafactor": 1.0,
                     "sgdm": 0.7}[policy.optimizer]
            if not policy.params_f32:
                peak *= 0.85                        # bf16 param residency
        if policy.attn_impl == "plain" and not cfg.attn_free:
            peak *= 1.4                             # unfused score matrices
        elif policy.attn_impl == "local" and not cfg.attn_free:
            peak *= 1.15
        if "rwkv" in cfg.block_pattern:
            peak *= 0.8                             # floor over-counts state
        if train and "seq_q" in unsharded and n_m > 1:
            peak += act / passes * (n_m - 1) * 0.5  # replicated activations

        # transpose/layout thrash: relayouts scale with activation traffic
        # and bite hardest under tp/ep (column<->row flips per block)
        thrash = {"tp": 0.30, "ep": 0.25, "fsdp": 0.10, "dp": 0.05}
        transpose = act * thrash.get(preset, 0.1) \
            + (0.15 * act if policy.attn_impl == "blocked" else 0.0)

        # ---- collective counts: per-layer schedule × per-counter factor
        # models (each collective type responds to a different slice of the
        # policy — a shared "intensity" scalar misranks them)
        if train:
            ag = (2 + layers * {"fsdp": 1.5, "ep": 0.8, "tp": 0.4,
                                "dp": 0.1}[preset]) * intensity
            for a in ("vocab", "seq_q", "cache_seq"):
                if a in unsharded and n_m > 1:
                    ag += 0.3 * layers * intensity
            # all-reduces follow the full train-intensity stack (every extra
            # program copy re-reduces its gradients); dp's unsharded
            # full-gradient reduce makes it the heaviest preset
            ar = (2 + 0.5 * layers) * intensity \
                * {"fsdp": 1.0, "tp": 0.9, "ep": 0.8, "dp": 1.3}[preset]
            # all-to-alls: gradient scatter/transpose lowering (fsdp-heavy,
            # adafactor-heavy), plus the wkv/rg-lru backward scatter-adds
            # which regroup token shards under every preset
            a2a_f = n_micro ** 1.1 \
                * {"none": 1.0, "dots": 0.7, "full": 0.7}[policy.remat] \
                * {"adamw": 1.0, "adafactor": 1.2, "sgdm": 0.8}[
                    policy.optimizer]
            a2a = 0.3 * layers * a2a_f \
                * {"fsdp": 1.0, "tp": 0.1, "ep": 0.1, "dp": 0.02}[preset]
            if moe:
                # expert routing all-to-alls survive under every preset; the
                # fsdp gather schedule multiplies them
                a2a += layers * a2a_f * {"fsdp": 2.5, "tp": 0.08,
                                         "ep": 0.05, "dp": 0.12}[preset]
            # the wkv/rg-lru backward scatter-adds regroup token shards, but
            # only fsdp's gather schedule keeps them as all-to-alls
            if preset in ("fsdp", "tp") and not moe:
                if "rwkv" in cfg.block_pattern:
                    a2a += 0.5 * layers * a2a_f
                elif "rec" in cfg.block_pattern:
                    a2a += 0.15 * layers * a2a_f
            # permutes ride the zero1 reduce-scatter/all-gather rings and the
            # unrolled microbatch loop (superlinear in n_micro)
            perm = (1 + 0.3 * layers) * n_micro ** 1.6 \
                * {"none": 1.0, "dots": 1.9, "full": 1.0}[policy.remat] \
                * {"adamw": 1.0, "adafactor": 1.6, "sgdm": 1.5}[
                    policy.optimizer] \
                * (1.0 if policy.params_f32 else 1.3) \
                * {"fsdp": 1.0, "tp": 0.37, "ep": 0.39, "dp": 1.0}[preset] \
                * (1.8 if multi else 1.0)
        else:
            ag = 3.0
            # dp needs no inference collectives at all (pure batch shard)
            nt_pf = {"fsdp": 1.2, "tp": 1.0, "ep": 1.0, "dp": 0.03}[preset]
            ar = (20.0 if shape.kind == "decode" else 9.0) * nt_pf
            # inference MoE routes via gather; only fsdp's cache regroup
            # emits a single all-to-all
            a2a = 1.0 if preset == "fsdp" and shape.kind == "decode" else 0.0
            if shape.kind == "decode" and shape.seq_len >= 4096:
                # long-context decode loops rotate cache shards
                perm = {"fsdp": 2.0, "tp": 4.0, "ep": 8.0, "dp": 0.05}[preset]
            elif shape.kind == "decode":
                perm = {"fsdp": 1.0, "tp": 0.1, "ep": 0.1, "dp": 0.05}[preset]
            else:
                perm = 0.05

        return {
            "perf.roofline_efficiency": eff,
            "perf.useful_flops_ratio":
                mf_useful / max(total_flops, 1.0),
            "diag.collective_blowup":
                wire / max(floors["collective_floor"], 16e6),
            "diag.collective_wire_bytes": wire,
            "diag.transpose_bytes": transpose,
            "diag.memory_overshoot": peak / max(floors["memory_floor"], 1.0),
            "diag.peak_bytes": peak,
            "diag.hbm_oversubscribed": peak / chip.hbm_bytes,
            "diag.n_allgather": ag,
            "diag.n_allreduce": ar,
            "diag.n_alltoall": a2a,
            "diag.n_permute": perm,
        }

    # ------------------------------------------- vectorized batch estimate
    def _cell_base(self, cfg, shape, policy, mesh, mesh_kind):
        """Memoized per-cell analytic inputs (floors, attention/recurrence
        flops, activation floor) — point batches draw heavily overlapping
        cells, so the python-bound analytic layer runs once per cell.  The
        key covers exactly the policy fields analytic.py reads (sharding
        preset, remat, microbatching, dtypes, optimizer, zero1,
        grad_compress): rule-override / attn-impl / capacity variations
        share a base entry."""
        key = (cfg.name, shape.name, mesh_kind, policy.sharding_preset,
               policy.remat, policy.n_microbatch, policy.params_f32,
               policy.zero1, policy.optimizer, policy.grad_compress,
               policy.dtype)
        b = self._base_cache.get(key)
        if b is None:
            floors = analytic.step_floor_seconds(cfg, shape, policy, mesh,
                                                 self.chip)
            b = {
                "collective_floor": floors["collective_floor"],
                "bytes_floor": floors["bytes_floor"],
                "memory_floor": floors["memory_floor"],
                "model_flops": floors["model_flops"],
                "matmul_model_flops": floors["matmul_model_flops"],
                "attn_fl": analytic.attention_flops(cfg, shape),
                "rec_fl": analytic.recurrence_flops(cfg, shape),
                "act": analytic.activation_bytes_floor(cfg, shape, policy,
                                                       mesh),
            }
            with self._lock:
                if len(self._base_cache) > 8192:
                    self._base_cache.clear()
                self._base_cache[key] = b
        return b

    _REMAT = ("none", "dots", "full")
    _OPT = ("adamw", "adafactor", "sgdm")
    _PRESET = ("fsdp", "tp", "ep", "dp")
    _ATTN = ("auto", "plain", "blocked", "local")

    def _estimate_many(self, points: list) -> list:
        """Vectorized mirror of ``_estimate`` over a batch of points.

        Every arithmetic step applies the same literal constants in the
        same left-associative order as the scalar path (unselected
        ``np.where`` branches multiply by exact no-ops), so results are
        bit-identical — the parity test compares with ``==``.
        """
        out: list = [None] * len(points)
        rows, cols = [], []
        for i, point in enumerate(points):
            if not self.space.valid(point):
                continue
            cfg, shape, policy, mesh_kind = self.space.to_run(point)
            mesh = self.descs.get(mesh_kind)
            if mesh is None:
                continue
            b = self._cell_base(cfg, shape, policy, mesh, mesh_kind)
            train_k = shape.kind == "train"
            nm = max(policy.n_microbatch, 1) if train_k else 1
            unsh = {a for a, r in policy.rule_overrides if r == ()}
            rows.append(i)
            # ONE extraction pass per point: everything below is pure
            # columnar arithmetic (the pow() columns stay scalar-python —
            # numpy's SIMD pow is 1 ulp off libm, which would break
            # bit-parity with _estimate)
            cols.append((
                mesh.shape.get("model", 1),                    # 0 n_m
                analytic._axis_size(mesh, ("pod", "data")),    # 1 n_d
                mesh.shape.get("pod", 1) > 1,                  # 2 multi
                train_k,                                       # 3
                shape.kind == "decode",                        # 4
                shape.kind == "prefill",                       # 5
                2 if policy.dtype == "bf16" else 4,            # 6 adtype
                (shape.global_batch if shape.kind == "decode"
                 else shape.global_batch * shape.seq_len),     # 7 tokens
                cfg.n_layers,                                  # 8
                shape.seq_len,                                 # 9
                shape.global_batch,                            # 10
                cfg.vocab_size,                                # 11
                cfg.d_model,                                   # 12
                max(cfg.n_kv_heads, 1),                        # 13
                cfg.d_head,                                    # 14
                bool(cfg.window),                              # 15
                cfg.window or 0,                               # 16
                bool(cfg.n_experts),                           # 17 moe
                policy.capacity_factor,                        # 18
                {1.0: 0.55, 1.25: 0.65, 2.0: 1.0}.get(
                    policy.capacity_factor, 1.0),              # 19 cap_eff
                policy.params_f32,                             # 20
                policy.zero1,                                  # 21
                cfg.attn_free,                                 # 22
                "rwkv" in cfg.block_pattern,                   # 23
                "rec" in cfg.block_pattern,                    # 24
                nm,                                            # 25 n_micro
                self._REMAT.index(policy.remat),               # 26
                self._OPT.index(policy.optimizer),             # 27
                self._PRESET.index(policy.sharding_preset),    # 28
                (self._ATTN.index(policy.attn_impl)
                 if policy.attn_impl in self._ATTN else 0),    # 29
                {"auto": 1.0, "plain": 0.45, "blocked": 0.55,
                 "local": 1.0}.get(policy.attn_impl, 1.0),     # 30
                "vocab" in unsh,                               # 31
                "seq_q" in unsh,                               # 32
                "cache_seq" in unsh,                           # 33
                0.9 ** len(unsh - {"vocab"}),                  # 34
                b["collective_floor"],                         # 35
                b["bytes_floor"],                              # 36
                b["memory_floor"],                             # 37
                b["model_flops"],                              # 38
                b["attn_fl"],                                  # 39
                b["matmul_model_flops"] + b["attn_fl"]
                + b["rec_fl"],                                 # 40 mf_useful
                b["act"],                                      # 41
                nm ** 0.3,                                     # 42
                nm ** 1.1,                                     # 43
                nm ** 1.6,                                     # 44
                1.0 + (shape.seq_len / 1000.0) ** 1.3,         # 45
            ))
        if not rows:
            return out
        nr = len(rows)
        C = list(zip(*cols))

        def fcol(j):
            return np.array(C[j], dtype=float)

        def bcol(j):
            return np.array(C[j], dtype=bool)

        def icol(j):
            return np.array(C[j], dtype=int)

        n_m, n_d, multi = fcol(0), fcol(1), bcol(2)
        train, decode, prefill = bcol(3), bcol(4), bcol(5)
        adtype, tokens, layers = fcol(6), fcol(7), fcol(8)
        seq_len, global_batch = fcol(9), fcol(10)
        vocab, d_model, n_kv, d_head = fcol(11), fcol(12), fcol(13), fcol(14)
        win_flag, win_sz = bcol(15), fcol(16)
        moe, cap, cap_eff = bcol(17), fcol(18), fcol(19)
        params_f32, zero1, attn_free = bcol(20), bcol(21), bcol(22)
        blk_rwkv, blk_rec, n_micro = bcol(23), bcol(24), fcol(25)
        remat_i, opt_i, pre_i, attn_i = icol(26), icol(27), icol(28), icol(29)
        attn_eff_f = fcol(30)
        u_vocab, u_seq, u_cache = bcol(31), bcol(32), bcol(33)
        unsh_pow = fcol(34)
        coll_floor, bytes_floor, mem_floor = fcol(35), fcol(36), fcol(37)
        model_fl, attn_fl, mf_useful, act = (fcol(38), fcol(39), fcol(40),
                                             fcol(41))
        micro_pow03, micro_pow11, micro_pow16 = fcol(42), fcol(43), fcol(44)
        dec_waste = fcol(45)
        passes = np.where(train, 3.0, 1.0)
        tokens_local = np.maximum(tokens / np.maximum(n_d, 1), 1.0)

        A = np.array      # per-code constant tables (order: class tuples)
        REMAT_INT, REMAT_EFF = A([1.0, 2.8, 2.4]), A([1.0, 0.74, 0.59])
        REMAT_W = A([1.0, 1.25, 1.45])
        REMAT_A2A, REMAT_PERM = A([1.0, 0.7, 0.7]), A([1.0, 1.9, 1.0])
        OPT_INT, OPT_EFF = A([1.0, 2.2, 2.4]), A([1.0, 0.75, 0.9])
        OPT_W, OPT_A2A = A([1.0, 1.15, 1.2]), A([1.0, 1.2, 0.8])
        OPT_PERM, OPT_PEAK = A([1.0, 1.6, 1.5]), A([1.0, 1.0, 0.7])
        PRE_EFF = A([1.0, 0.55, 0.4, 0.4])
        PRE_AG = A([1.5, 0.4, 0.8, 0.1])
        PRE_AR = A([1.0, 0.9, 0.8, 1.3])
        PRE_A2A = A([1.0, 0.1, 0.1, 0.02])
        MOE_A2A = A([2.5, 0.08, 0.05, 0.12])
        PRE_PERM = A([1.0, 0.37, 0.39, 1.0])
        PRE_PEAK = A([1.45, 1.7, 1.35, 1.0])
        PRE_NT = A([1.2, 1.0, 1.0, 0.03])
        PERM_LONG = A([2.0, 4.0, 8.0, 0.05])
        PERM_DEC = A([1.0, 0.1, 0.1, 0.05])
        THRASH = A([0.10, 0.30, 0.25, 0.05])

        # ---- shared train-pathology intensity
        intensity = np.ones(nr)
        intensity = np.where(train, intensity * n_micro, intensity)
        intensity = np.where(train, intensity * REMAT_INT[remat_i], intensity)
        intensity = np.where(train, intensity * OPT_INT[opt_i], intensity)
        intensity = np.where(train & ~zero1, intensity * 2.2, intensity)
        intensity = np.where(train & ~params_f32, intensity * 2.4, intensity)

        # ---- perf.roofline_efficiency
        eff = np.full(nr, 0.8)
        eff = np.where(train, eff * 0.15, eff)
        eff = np.where(train, eff / (1.0 + 0.08 * (n_micro - 1)), eff)
        eff = np.where(train, eff * REMAT_EFF[remat_i], eff)
        eff = np.where(train, eff * OPT_EFF[opt_i], eff)
        eff = np.where(train & ~zero1, eff * 0.42, eff)
        eff = np.where(train & ~params_f32, eff * 0.7, eff)
        eff = np.where(~train & decode & (seq_len >= 4096), eff * 1.6, eff)
        eff = np.where(~train & ~decode, eff * 0.5, eff)
        eff = eff * PRE_EFF[pre_i]
        eff = np.where(~attn_free, eff * attn_eff_f, eff)
        eff = np.where(moe, eff * 0.35, eff)
        eff = np.where(moe, eff * cap_eff, eff)
        eff = np.where(multi, eff * 0.85, eff)
        eff = np.where(u_vocab, eff * 0.7, eff)
        eff = eff * unsh_pow
        eff = np.minimum(np.maximum(eff, 1e-4), 1.0)

        # ---- perf.useful_flops_ratio
        waste = np.full(nr, 1.15)
        tmp = 1.25 * micro_pow03
        tmp = tmp * REMAT_W[remat_i]
        tmp = tmp * OPT_W[opt_i]
        waste = np.where(train, waste * tmp, waste)
        waste = np.where(train & ~zero1, waste * 1.15, waste)
        waste = np.where(train & ~params_f32, waste * 1.25, waste)
        waste = np.where(~train & decode,
                         waste * dec_waste, waste)
        waste = np.where(~train & ~decode, waste * 1.45, waste)
        waste = np.where(moe, waste * 1.35, waste)
        waste = np.where((pre_i == 3) & (n_m > 1), waste * np.sqrt(n_m),
                         waste)
        total_flops = model_fl * waste
        plain_sq = (attn_i == 1) & ~attn_free & ~decode & ~win_flag
        total_flops = np.where(plain_sq, total_flops + attn_fl, total_flops)
        total_flops = np.where(
            moe & (cap > 1.0),
            total_flops + model_fl * 0.55 * (cap - 1.0), total_flops)

        # ---- wire bytes
        wire = coll_floor.copy()
        gather = (n_m - 1) / n_m
        wire = np.where((n_m > 1) & u_vocab & (pre_i != 3),
                        wire + passes * tokens_local * vocab * adtype
                        * gather * 0.5, wire)
        wire = np.where((n_m > 1) & u_seq & ((pre_i == 1) | (pre_i == 2)),
                        wire + passes * layers * tokens_local * d_model
                        * adtype * gather, wire)
        clen = np.where(win_flag, np.minimum(seq_len, win_sz), seq_len)
        cache = 2 * layers * np.maximum(
            global_batch // np.maximum(n_d, 1), 1) * clen * n_kv * d_head \
            * adtype
        wire = np.where((n_m > 1) & u_cache & (decode | prefill),
                        wire + cache * gather, wire)
        wire = np.where(moe & (pre_i == 2), wire * np.minimum(cap, 2.0),
                        wire)
        wire = wire + 0.02 * bytes_floor

        # ---- peak memory
        peak = mem_floor * 1.45
        peak = peak * PRE_PEAK[pre_i]
        peak = np.where(prefill, peak * 2.0, peak)
        peak = np.where(train, peak * 0.85, peak)
        peak = np.where(train & (pre_i == 0), peak * 1.15, peak)
        peak = np.where(train & (pre_i == 1), peak * 0.85, peak)
        micro_f = np.where(n_micro <= 4, 1.4,
                           np.where(n_micro <= 8, 1.0, 0.75))
        peak = np.where(train & (n_micro > 1), peak * micro_f, peak)
        peak = np.where(train, peak * OPT_PEAK[opt_i], peak)
        peak = np.where(train & ~params_f32, peak * 0.85, peak)
        peak = np.where((attn_i == 1) & ~attn_free, peak * 1.4, peak)
        peak = np.where((attn_i == 3) & ~attn_free, peak * 1.15, peak)
        peak = np.where(blk_rwkv, peak * 0.8, peak)
        peak = np.where(train & u_seq & (n_m > 1),
                        peak + act / passes * (n_m - 1) * 0.5, peak)

        # ---- transpose/layout thrash
        transpose = act * THRASH[pre_i] \
            + np.where(attn_i == 2, 0.15 * act, 0.0)

        # ---- collective counts (train branch)
        ag = (2 + layers * PRE_AG[pre_i]) * intensity
        for flag in (u_vocab, u_seq, u_cache):
            ag = np.where(flag & (n_m > 1), ag + 0.3 * layers * intensity,
                          ag)
        ar = (2 + 0.5 * layers) * intensity * PRE_AR[pre_i]
        a2a_f = micro_pow11
        a2a_f = a2a_f * REMAT_A2A[remat_i]
        a2a_f = a2a_f * OPT_A2A[opt_i]
        a2a = 0.3 * layers * a2a_f * PRE_A2A[pre_i]
        a2a = np.where(moe, a2a + layers * a2a_f * MOE_A2A[pre_i], a2a)
        fsdp_tp = (pre_i == 0) | (pre_i == 1)
        a2a = np.where(fsdp_tp & ~moe & blk_rwkv,
                       a2a + 0.5 * layers * a2a_f, a2a)
        a2a = np.where(fsdp_tp & ~moe & ~blk_rwkv & blk_rec,
                       a2a + 0.15 * layers * a2a_f, a2a)
        perm = (1 + 0.3 * layers) * micro_pow16
        perm = perm * REMAT_PERM[remat_i]
        perm = perm * OPT_PERM[opt_i]
        perm = perm * np.where(params_f32, 1.0, 1.3)
        perm = perm * PRE_PERM[pre_i]
        perm = perm * np.where(multi, 1.8, 1.0)
        # non-train branch
        ag = np.where(train, ag, 3.0)
        ar = np.where(train, ar,
                      np.where(decode, 20.0, 9.0) * PRE_NT[pre_i])
        a2a = np.where(train, a2a,
                       np.where((pre_i == 0) & decode, 1.0, 0.0))
        perm = np.where(train, perm,
                        np.where(decode & (seq_len >= 4096),
                                 PERM_LONG[pre_i],
                                 np.where(decode, PERM_DEC[pre_i], 0.05)))

        ufr = mf_useful / np.maximum(total_flops, 1.0)
        blowup = wire / np.maximum(coll_floor, 16e6)
        overshoot = peak / np.maximum(mem_floor, 1.0)
        hbm = peak / self.chip.hbm_bytes
        for j, i in enumerate(rows):
            out[i] = {
                "perf.roofline_efficiency": float(eff[j]),
                "perf.useful_flops_ratio": float(ufr[j]),
                "diag.collective_blowup": float(blowup[j]),
                "diag.collective_wire_bytes": float(wire[j]),
                "diag.transpose_bytes": float(transpose[j]),
                "diag.memory_overshoot": float(overshoot[j]),
                "diag.peak_bytes": float(peak[j]),
                "diag.hbm_oversubscribed": float(hbm[j]),
                "diag.n_allgather": float(ag[j]),
                "diag.n_allreduce": float(ar[j]),
                "diag.n_alltoall": float(a2a[j]),
                "diag.n_permute": float(perm[j]),
            }
        return out
