"""Anomaly monitor (paper §5.2 "Anomaly Detection Condition", DESIGN.md §4).

Precise, workload-independent conditions against the chip "spec":

  A1 step-bound      roofline bound > 4x the analytic floor
                     (paper: throughput 20% below spec — our floors are
                     first-order models, so the headroom is wider)
  A2 collective      per-device wire bytes > 4x the parallelism cost model
                     (paper: PFC pause storm — excess network traffic)
  A3 compute-waste   HLO FLOPs > budget x MODEL_FLOPS for the remat policy
  A4 memory          peak per-device bytes > HBM capacity
"""
from __future__ import annotations

import dataclasses

A1_EFFICIENCY_MIN = 0.25
A2_COLLECTIVE_MAX = 4.0
A3_USEFUL_MIN = {"none": 0.55, "dots": 0.40, "full": 0.28}
A4_HBM_MAX = 1.0


@dataclasses.dataclass(frozen=True)
class Anomaly:
    kind: str          # A1 | A2 | A3 | A4
    value: float
    threshold: float
    note: str = ""


def detect(counters: dict, remat: str = "none") -> list:
    """Counter dict (engine.measure output) -> list of Anomaly."""
    if counters is None:
        return []
    out = []
    eff = counters.get("perf.roofline_efficiency", 1.0)
    if eff < A1_EFFICIENCY_MIN:
        out.append(Anomaly("A1", eff, A1_EFFICIENCY_MIN,
                           "step bound far above analytic floor"))
    blow = counters.get("diag.collective_blowup", 0.0)
    if blow > A2_COLLECTIVE_MAX:
        out.append(Anomaly("A2", blow, A2_COLLECTIVE_MAX,
                           "collective traffic >> parallelism cost model"))
    useful = counters.get("perf.useful_flops_ratio", 1.0)
    thr = A3_USEFUL_MIN.get(remat, 0.55)
    if useful < thr:
        out.append(Anomaly("A3", useful, thr,
                           "compiled FLOPs >> model FLOPs (replication/waste)"))
    hbm = counters.get("diag.hbm_oversubscribed", 0.0)
    if hbm > A4_HBM_MAX:
        out.append(Anomaly("A4", hbm, A4_HBM_MAX,
                           "per-device peak bytes exceed HBM"))
    return out


def kinds(counters: dict, remat: str = "none") -> frozenset:
    return frozenset(a.kind for a in detect(counters, remat))
