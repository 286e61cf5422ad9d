"""Witness minimization + MFS condition tightening.

A raw anomaly witness out of SA/random/BO carries every factor the walk
happened to set on the way in — most of them irrelevant to the pathology.
Before a witness becomes a regression-corpus entry it is *minimized*: each
non-workload factor is walked toward a canonical baseline point (the sane
fully-sharded production default) while the anomaly kind stays triggered.
The result is the delta-debugging 1-minimal "keep set" — the smallest set of
factors that must stay at their witness values for the anomaly to fire —
which is both cheaper to replay and directly readable as a repro recipe.

Two passes, both driven through ``Engine.measure_batch`` at full fidelity
(``prescreen=0`` — a screened-out minimization probe would silently accept
an unverified reduction).  With ``fidelity="lowered"`` each
batch first consults the engine's fidelity-1 tier: candidates whose
structural fingerprint equals the current witness's provably share its
counters and are accepted without a measurement — the only probes that
still compile are the ones that could actually change the verdict:

* :func:`minimize_witness` — ddmin over the keep set.  Chunk/complement
  probes of one granularity are independent, so each round is a single
  concurrent batch; acceptance is resolved sequentially in deterministic
  chunk order, so results are identical for any ``n_workers``.
* :func:`tighten_conditions` — ``construct_mfs`` tests each factor alone
  against the fixed witness, so its conjunctive conditions can over-claim:
  values v (of f) and w (of g) may each keep the anomaly triggered alone yet
  un-trigger it together.  Pairwise probes find such pairs and drop the
  offending values, making the committed conditions strictly sounder.

The workload cell (``arch`` × ``shape``) is never minimized: it names the
anomaly's home workload; resetting it would change which pathology is being
witnessed, not simplify the witness.
"""
from __future__ import annotations

import dataclasses

from . import anomaly as anomaly_mod
from . import batching
from .mfs import MFS
from .searchspace import SearchSpace

# The canonical baseline: the fully-sharded, un-exotic production default a
# developer would reach for first.  Witness "size" = how many factors sit
# off this baseline.
BASELINE_PIN = {
    "mesh": "single",
    "remat": "none",
    "n_microbatch": 1,
    "params_f32": True,
    "zero1": True,
    "optimizer": "adamw",
    "grad_compress": "none",
    "preset": "fsdp",
    "seq_shard": True,
    "cache_shard": True,
    "vocab_shard": True,
    "scan_layers": True,
    "attn_impl": "auto",
    "capacity_factor": 1.25,
}

# D4: the anomaly's home cell — held fixed, never walked toward baseline
WORKLOAD_FACTORS = ("arch", "shape")


def baseline_point(space: SearchSpace, arch: str, shape: str) -> dict:
    """The canonical baseline point for a workload cell, normalized."""
    p = {}
    for f, dom in space.factors.items():
        if f == "arch":
            p[f] = arch
        elif f == "shape":
            p[f] = shape
        else:
            pin = BASELINE_PIN.get(f)
            p[f] = pin if pin in dom else dom[0]
    return space.normalize(p)


def witness_size(point: dict) -> int:
    """Factor distance-to-baseline (space-free, so corpus merge can compare
    witnesses without rebuilding the search space)."""
    return sum(1 for f, pin in BASELINE_PIN.items()
               if f in point and point[f] != pin)


def distance_to_baseline(space: SearchSpace, point: dict) -> int:
    """Like :func:`witness_size` but against the space's own baseline (which
    respects domain restrictions)."""
    point = space.normalize(point)
    base = baseline_point(space, point["arch"], point["shape"])
    return sum(1 for f in space.factors
               if f not in WORKLOAD_FACTORS and point[f] != base[f])


@dataclasses.dataclass
class MinimizeResult:
    point: dict              # minimized witness (normalized, still triggers)
    kept: tuple              # factors held at witness values
    distance: int            # witness_size(point)
    raw_distance: int        # witness_size(raw witness)
    n_probes: int            # measurements spent
    near_misses: list        # untriggered probes one kept-factor from point
    triggered: bool          # False: raw witness no longer triggers at all


def _note_minimize(engine, n: int):
    hook = getattr(engine, "note_minimize", None)
    if hook is not None:
        hook(n)


def minimize_witness(engine, space: SearchSpace, witness: dict, kind: str,
                     max_probes: int = 64, within: MFS | None = None,
                     fidelity: str = "full") -> MinimizeResult:
    """ddmin the witness's off-baseline factors down to a 1-minimal keep set.

    Every probe is a real full-fidelity measurement; a reduction is accepted
    only when the probe still triggers ``kind``.  The search is monotone on
    the keep set, so the returned point's distance-to-baseline is <= the raw
    witness's, and strictly < whenever any off-baseline factor is
    irrelevant to the anomaly (the common case for stochastic-search
    witnesses).  ``max_probes`` caps spend: on exhaustion the best verified
    keep set so far is returned.

    ``within``: restrict the walk to points matching this MFS's conditions,
    so the minimized witness still exemplifies the catalog entry it came
    from (candidates outside are rejected without a measurement).

    ``fidelity="lowered"`` consults the fidelity-1 tier: every
    probe batch is lowered first (cheap, uncharged), and a candidate whose
    structural fingerprint equals the current witness's — with an equal
    ``remat`` value, which the A3 threshold reads — is accepted as
    triggering WITHOUT a measurement: identical fingerprints prove
    identical counters.  The greedy 1-minimality pass additionally orders
    its candidates by lowered-module closeness to the witness on the
    kind's driving counter, so structurally-conservative reductions are
    tried (and accepted) first.
    """
    witness = space.normalize(witness)
    use_lowered = fidelity == "lowered"
    base = baseline_point(space, witness["arch"], witness["shape"])
    diffs = tuple(f for f in sorted(space.factors)
                  if f not in WORKLOAD_FACTORS and witness[f] != base[f])
    trace: list = []                       # (point, triggered) per probe
    wfp = batching.lowered_key(engine, witness) if use_lowered else None

    def build(keep) -> dict | None:
        p = dict(base)
        for f in keep:
            p[f] = witness[f]
        p = space.normalize(p)
        if not space.valid(p):
            return None
        if within is not None and not within.matches(p):
            return None
        return p

    def test_batch(keeps: list) -> list:
        """keep sets -> triggered flags (None: infeasible/untestable)."""
        pts, idx = [], []
        out = [None] * len(keeps)
        for i, keep in enumerate(keeps):
            p = build(keep)
            if p is None:
                continue
            idx.append(i)
            pts.append(p)
        if not pts:
            return out
        if wfp is not None:
            # fp shortcut: lower the batch (no compiles), accept candidates
            # that provably share the witness's counters without measuring.
            # The witness point itself is never short-circuited — its own
            # measurement is what establishes that the anomaly still fires.
            batching.measure_lowered_batch(engine, pts)   # warm fp cache
            m_idx, m_pts = [], []
            for i, p in zip(idx, pts):
                if p != witness \
                        and p.get("remat") == witness.get("remat") \
                        and batching.lowered_key(engine, p) == wfp:
                    out[i] = True
                else:
                    m_idx.append(i)
                    m_pts.append(p)
            idx, pts = m_idx, m_pts
            if not pts:
                return out
        results = batching.measure_batch(engine, pts, prescreen=0)
        _note_minimize(engine, len(pts))
        for i, p, m in zip(idx, pts, results):
            if m is None:          # failed compile: proves nothing — keep it
                continue           # out of the trace so it can't become a
                                   # "verified non-triggering" near-miss
            trig = kind in anomaly_mod.kinds(m, p.get("remat", "none"))
            trace.append((p, trig))
            out[i] = trig
        return out

    def done(kept, triggered=True):
        point = build(kept) or witness
        near = {}
        for p, trig in trace:
            if trig:
                continue
            if sum(1 for f in kept if p[f] != point[f]) == 1 \
                    and all(p[f] == point[f] for f in space.factors
                            if f not in kept):
                near[space.point_key(p)] = p
        near = [near[k] for k in sorted(near)]
        return MinimizeResult(point, tuple(sorted(kept)),
                              witness_size(point), witness_size(witness),
                              len(trace), near, triggered)

    # the raw witness must still trigger, or there is nothing to minimize
    if test_batch([diffs])[0] is not True:
        return done(diffs, triggered=False)
    if not diffs:
        return done(diffs)
    # phase 1: the pure baseline — anomalies intrinsic to the workload cell
    # minimize to distance 0 in one probe
    if test_batch([()])[0] is True:
        return done(())

    K = list(diffs)
    n = 2
    while len(K) >= 2 and len(trace) < max_probes:
        step = max(len(K) // n, 1)
        chunks = [K[i:i + step] for i in range(0, len(K), step)][:n]
        cands = list(chunks)
        if n > 2:
            cands += [[f for f in K if f not in c] for c in chunks]
        flags = test_batch(cands)
        for cand, flag in zip(cands, flags):     # deterministic first hit
            if flag is True and len(cand) < len(K):
                K = cand
                n = 2
                break
        else:
            if n < len(K):
                n = min(2 * n, len(K))
                continue
            break

    # final greedy pass: 1-minimality (and near-miss controls for replay)
    def order_greedy(cands: list) -> list:
        """Lowered fidelity: try structurally-closest reductions first
        (smallest fidelity-1 delta on the kind's driving counter)."""
        if not use_lowered or len(cands) < 2:
            return cands
        from .surrogate import KIND_COUNTER
        drv, _ = KIND_COUNTER.get(kind, (None, None))
        if drv is None:
            return cands
        pts = [build(c) for c in cands]
        lows = batching.measure_lowered_batch(
            engine, [p if p is not None else witness for p in pts])
        ref = batching.measure_lowered_batch(engine, [witness])[0]
        ref_v = (ref or {}).get(drv)

        def delta(i):
            v = (lows[i] or {}).get(drv) if pts[i] is not None else None
            if v is None or ref_v is None:
                return float("inf")
            return abs(float(v) - float(ref_v))
        return [cands[i] for i in
                sorted(range(len(cands)), key=lambda i: (delta(i), i))]

    improved = True
    while improved and K and len(trace) < max_probes:
        cands = order_greedy([[g for g in K if g != f] for f in K])
        flags = test_batch(cands)
        improved = False
        for cand, flag in zip(cands, flags):
            if flag is True:
                K = cand
                improved = True
                break
    return done(K)


def boundary_controls(engine, space: SearchSpace, point: dict, kind: str,
                      conditions: dict, max_controls: int = 2) -> list:
    """Verified non-triggering neighbours of a minimized witness.

    For each conditioned non-workload factor, flip the witness to the first
    out-of-condition value and measure: probes that do NOT trigger ``kind``
    become replay *controls* — if a later code change makes one fire, the
    anomaly region widened.  One batch, deterministic order.
    """
    point = space.normalize(point)
    cands = []
    for f in sorted(conditions):
        if f in WORKLOAD_FACTORS:
            continue
        outside = [v for v in space.factors.get(f, ()) if
                   v not in conditions[f]]
        for v in sorted(outside, key=str):
            q = space.normalize({**point, f: v})
            if space.valid(q) and q != point:
                cands.append(q)
                break
    results = batching.measure_batch(engine, cands, prescreen=0)
    if cands:
        _note_minimize(engine, len(cands))
    controls = []
    for q, m in zip(cands, results):
        if m is not None and kind not in anomaly_mod.kinds(
                m, q.get("remat", "none")):
            controls.append(q)
        if len(controls) >= max_controls:
            break
    return controls


def tighten_conditions(engine, space: SearchSpace, mfs: MFS,
                       max_probes: int = 32,
                       fidelity: str = "full") -> MFS:
    """Upgrade single-factor MFS conditions with pairwise probes.

    For every pair of non-witness condition values (v of f, w of g), probe
    the witness with both applied: if the anomaly un-triggers, the
    conjunctive claim was unsound — drop the first pair member (smallest
    factor name, deterministic) from its triggering set.  Witness values are
    never dropped, so the tightened MFS still matches its own witness.
    Probes run as one full-fidelity batch, budget-capped at ``max_probes``
    (cheapest-first in sorted factor/value order).

    ``fidelity="lowered"``: pair probes whose structural fingerprint (and
    ``remat``) equal the witness's provably still trigger — the pair's
    conjunctive claim is sound by construction — and skip measurement.
    The fp filter runs BEFORE the budget cap (over a 4x-wider candidate
    pool, bounding the lowering spend), so free resolutions never consume
    measurement slots; the full-fidelity path is unchanged.
    """
    w = space.normalize(mfs.witness)
    conds = {f: list(vals) for f, vals in mfs.conditions.items()}
    pairs = []
    fs = sorted(f for f in conds if f not in WORKLOAD_FACTORS)
    for i, f in enumerate(fs):
        for g in fs[i + 1:]:
            for v in sorted((x for x in conds[f] if x != w.get(f)), key=str):
                for u in sorted((x for x in conds[g] if x != w.get(g)),
                                key=str):
                    pairs.append((f, v, g, u))
    cap = max(int(max_probes), 0)
    pairs = pairs[:4 * cap] if fidelity == "lowered" else pairs[:cap]
    probes, idx = [], []
    for i, (f, v, g, u) in enumerate(pairs):
        q = space.normalize({**w, f: v, g: u})
        if space.valid(q) and q != w:
            probes.append(q)
            idx.append(i)
    if fidelity == "lowered" and probes:
        wfp = batching.lowered_key(engine, w)
        if wfp is not None:
            batching.measure_lowered_batch(engine, probes)  # warm fp cache
            kept_p, kept_i = [], []
            for q, i in zip(probes, idx):
                if not (q.get("remat") == w.get("remat")
                        and batching.lowered_key(engine, q) == wfp):
                    kept_p.append(q)
                    kept_i.append(i)
            probes, idx = kept_p, kept_i      # fp-equal pairs: claim sound
        probes, idx = probes[:cap], idx[:cap]  # cap MEASURED probes only
    results = batching.measure_batch(engine, probes, prescreen=0)
    if probes:
        _note_minimize(engine, len(probes))
    removed: set = set()
    for i, q, m in zip(idx, probes, results):
        f, v, g, u = pairs[i]
        if (f, v) in removed or (g, u) in removed:
            continue                       # pair already repaired
        if m is None:
            continue                       # untestable: leave the claim
        if mfs.kind not in anomaly_mod.kinds(m, q.get("remat", "none")):
            removed.add((f, v))
    new_conds = {}
    for f, vals in mfs.conditions.items():
        kept = tuple(x for x in vals if (f, x) not in removed)
        new_conds[f] = kept or (w[f],)
    return MFS(mfs.kind, new_conds, dict(mfs.witness), mfs.counters,
               mfs.n_tests + len(probes))
