"""Adapters between search drivers and measurement engines.

Search algorithms produce *proposal batches*; a real `engine.Engine`
measures them concurrently with dedup + caching, while lightweight synthetic
engines (tests, oracles) may only implement serial ``measure``.  These
helpers keep the drivers agnostic:

* ``measure_batch(engine, points)`` — concurrent when the engine supports
  it, serial loop otherwise; results align with ``points``.
* ``spent(engine)`` — the budget counter: ``n_attempts`` (unique points
  requested, counting failed compiles) when available, else the legacy
  ``n_compiles``.
* ``engine_stats(engine)`` — SearchResult-adjacent stats snapshot, {} for
  engines that don't track any.
"""
from __future__ import annotations


def _kwargs_of(fn) -> frozenset:
    import inspect
    try:
        return frozenset(inspect.signature(fn).parameters)
    except (TypeError, ValueError):        # uninspectable callable
        return frozenset()


def measure_batch(engine, points: list, **kw) -> list:
    mb = getattr(engine, "measure_batch", None)
    if mb is not None:
        accepted = _kwargs_of(mb)
        return mb(points, **{k: v for k, v in kw.items() if k in accepted})
    return [engine.measure(p) for p in points]


def measure_batch_spent(engine, points: list, **kw) -> tuple:
    """-> (results, budget-spent as of each point's submission).

    The per-point spent values keep event crediting ("anomaly found after N
    attempts") exact under batching — a hit on the first proposal of an
    8-wide batch is credited at its own submission count, not the batch's.

    Extra kwargs (``prescreen``, ``score``) are forwarded when the engine's
    measure_batch accepts them and silently dropped otherwise, so synthetic
    single-fidelity engines keep working.
    """
    mb = getattr(engine, "measure_batch", None)
    if mb is not None:
        accepted = _kwargs_of(mb)
        kw = {k: v for k, v in kw.items() if k in accepted}
        if "with_spent" in accepted:
            return mb(points, with_spent=True, **kw)
        return mb(points, **kw), [spent(engine)] * len(points)
    results, spents = [], []
    for p in points:
        results.append(engine.measure(p))
        spents.append(spent(engine))
    return results, spents


def predict_batch(engine, points: list) -> list:
    """Fidelity-0 estimates aligned with ``points`` — [None]*n for engines
    without a surrogate (prediction-free engines degrade to full fidelity)."""
    pb = getattr(engine, "predict_batch", None)
    if pb is not None:
        return pb(points)
    return [None] * len(points)


def measure_lowered_batch(engine, points: list) -> list:
    """Fidelity-1 "lowered" estimates aligned with ``points`` — [None]*n
    for engines without the tier (they degrade to full fidelity)."""
    mlb = getattr(engine, "measure_lowered_batch", None)
    if mlb is not None:
        return mlb(points)
    ml = getattr(engine, "measure_lowered", None)
    if ml is not None:
        return [ml(p) for p in points]
    return [None] * len(points)


def lowered_key(engine, point) -> str | None:
    """The point's structural fingerprint, or None when the engine can't
    produce one.  Fingerprint equality PROVES two points share counters, so
    drivers may treat fp-identical probes as already-measured."""
    lk = getattr(engine, "lowered_key", None)
    return lk(point) if lk is not None else None


def note_prescreen(engine, n_promoted: int, n_screened: int):
    """Report a driver-side prescreen decision to the engine's stats (no-op
    for engines without the hook)."""
    hook = getattr(engine, "note_prescreen", None)
    if hook is not None:
        hook(n_promoted, n_screened)


def prediction_value(pred, counter: str, mode: str):
    """Sort key for ranking proposals by a predicted counter: lower is
    more-promising.  None predictions rank last."""
    if pred is None:
        return (1, 0.0)
    v = pred.get(counter)
    if v is None:
        return (1, 0.0)
    return (0, float(v) if mode == "min" else -float(v))


def spent(engine) -> int:
    n = getattr(engine, "n_attempts", None)
    return engine.n_compiles if n is None else n


def engine_stats(engine) -> dict:
    s = getattr(engine, "stats", None)
    return s() if callable(s) else {}
