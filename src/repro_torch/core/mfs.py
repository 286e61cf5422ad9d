"""Minimal Feature Set (paper §5.2).

After detecting an anomalous workload, test each factor with the others held
fixed: a factor belongs to the MFS iff some alternative value un-triggers the
anomaly; its MFS condition is the set of values that keep it triggered.
Matching a point against an MFS (paper Algorithm 1 line 5) skips redundant
tests; reading an MFS tells a developer which condition to break (§7.3).
"""
from __future__ import annotations

import dataclasses
from typing import Any

from . import anomaly as anomaly_mod
from .searchspace import SearchSpace


@dataclasses.dataclass
class MFS:
    kind: str                    # anomaly kind (A1..A4)
    conditions: dict             # factor -> tuple of triggering values
    witness: dict                # the anomalous point that seeded this MFS
    counters: dict | None = None # witness counters snapshot (light)
    n_tests: int = 0             # compiles spent constructing

    def matches(self, point: dict) -> bool:
        return all(point.get(f) in vals for f, vals in self.conditions.items())

    def describe(self) -> str:
        conds = ", ".join(
            f"{f}={'|'.join(map(str, v))}" for f, v in
            sorted(self.conditions.items()))
        return f"[{self.kind}] {conds}"


def match_any(anomaly_set, point) -> bool:
    return any(m.matches(point) for m in anomaly_set)


def _light(counters: dict) -> dict:
    return {k: v for k, v in (counters or {}).items()
            if k.startswith(("perf.", "diag."))}


def construct_mfs(engine, space: SearchSpace, point: dict, kind: str,
                  counters: dict | None = None,
                  fidelity: str = "full",
                  max_probes: int | None = None) -> MFS:
    """Paper §5.2: per-factor necessity testing with others held fixed.

    All per-factor probes are independent (each varies one factor against
    the fixed witness), so they are submitted as a single concurrent
    ``measure_batch``; the triggering sets are then assembled from the
    results in deterministic factor/value order.  Necessity probes must all
    be measured at full fidelity — the batch pins ``prescreen=0`` so an
    engine-wide ``COLLIE_PRESCREEN`` default can never silently drop probes
    and corrupt triggering sets.

    ``fidelity="prescreen"`` spends fewer compiles: probe values
    whose ``to_run`` mapping is *identical* to the witness's are provably
    inert (same policy, same mesh, same compiled program) and short-circuit
    to triggering without a measurement, and the remaining probes are
    ranked by surrogate-predicted informativeness on the kind's driving
    counter.  When the caller passes its remaining budget as ``max_probes``,
    only the most-informative probes are measured (unmeasured values are
    conservatively left out of the triggering sets) — budget-exhausted
    constructions lose the least information.

    ``fidelity="lowered"`` strengthens both steps with the
    fidelity-1 tier: probes are lowered (cheap, no compile) and any probe
    whose **structural fingerprint** equals the witness's — identical
    program AND identical counter inputs — provably carries the witness's
    counters, so it short-circuits to triggering without charging budget
    (the fp shortcut additionally requires an equal ``remat`` value, since
    the A3 threshold reads it from the point).  Remaining probes are
    ordered by *measured lowered-module* informativeness instead of the
    fidelity-0 estimate.
    """
    from . import batching

    point = space.normalize(point)
    triggering = {f: {point[f]} for f in space.factors}
    probes = []                                  # (factor, value, probe point)
    screen = fidelity in ("prescreen", "lowered")
    witness_run = space.to_run(point) if screen else None
    for f, dom in space.factors.items():
        if len(dom) < 2:
            continue
        for v in dom:
            if v == point[f]:
                continue
            q = space.normalize({**point, f: v})
            if q == point:                       # inert factor for this cell
                triggering[f].add(v)
                continue
            if not space.valid(q):
                continue                         # untestable: not claimed
            if witness_run is not None and space.to_run(q) == witness_run:
                triggering[f].add(v)             # proven inert: same program
                batching.note_prescreen(engine, 0, 1)
                continue
            probes.append((f, v, q))
    preds = None
    if fidelity == "lowered" and probes:
        # lower all probes concurrently (also warms the fingerprint cache),
        # then drop the structurally-identical ones: same fp ⇒ same counters
        preds = batching.measure_lowered_batch(engine,
                                               [q for _, _, q in probes])
        wfp = batching.lowered_key(engine, point)
        if wfp is not None:
            kept, kept_preds = [], []
            for (f, v, q), pr in zip(probes, preds):
                if q.get("remat") == point.get("remat") \
                        and batching.lowered_key(engine, q) == wfp:
                    triggering[f].add(v)         # proven: identical counters
                    batching.note_prescreen(engine, 0, 1)
                else:
                    kept.append((f, v, q))
                    kept_preds.append(pr)
            probes, preds = kept, kept_preds
    if screen and len(probes) > 1:
        from .surrogate import KIND_COUNTER
        drv, drv_mode = KIND_COUNTER.get(kind, (None, "max"))
        if drv is not None:
            if preds is None:
                preds = batching.predict_batch(engine,
                                               [q for _, _, q in probes])
                ref = batching.predict_batch(engine, [point])[0]
            else:
                ref = batching.measure_lowered_batch(engine, [point])[0]
            ref_v = (ref or {}).get(drv)

            def info(i):
                v = (preds[i] or {}).get(drv)
                if v is None or ref_v is None:
                    return 0.0
                return abs(float(v) - float(ref_v))
            probes = [probes[i] for i in
                      sorted(range(len(probes)), key=lambda i: (-info(i), i))]
        if max_probes is not None and len(probes) > max(int(max_probes), 1):
            kept = max(int(max_probes), 1)
            batching.note_prescreen(engine, kept, len(probes) - kept)
            probes = probes[:kept]
    results = batching.measure_batch(engine, [q for _, _, q in probes],
                                     prescreen=0)
    for (f, v, q), m in zip(probes, results):
        if m is not None and kind in anomaly_mod.kinds(m, q.get("remat",
                                                                "none")):
            triggering[f].add(v)
    conditions = {}
    for f, dom in space.factors.items():
        if len(dom) < 2:
            continue
        if set(triggering[f]) != set(dom):
            conditions[f] = tuple(sorted(triggering[f], key=str))
    return MFS(kind, conditions, dict(point), _light(counters), len(probes))
