"""Algorithm 1: simulated-annealing counter-guided anomaly search (batched).

Faithful to the paper: energy deltas (B-A)/A for performance counters
(minimized) and (A-B)/B for diagnostic counters (maximized); relaxed
temperature schedule; MFS-match skipping (line 5); random restart after each
new anomaly (line 17).  ``mfs_skip``/``mfs_construct`` toggles give the
paper's Fig.5 ablations (SA-without-MFS); the events list lets benchmarks
credit ground-truth anomalies by timestamp (the paper's Fig.4 metric).

Batching: each temperature step generates its ``n_per_t`` mutation proposals
up front, measures them as one ``Engine.measure_batch`` (concurrent compile,
deduplicated), then applies acceptance/anomaly handling *sequentially in
proposal order*.  All RNG draws happen in the single driver thread, and the
engine charges budget at submission in list order, so the trajectory —
events, anomalies, accounting — is identical for any ``n_workers``.
Proposals that fall inside an MFS constructed earlier in the same batch are
dropped at processing time, preserving the paper's line-5 skip invariant.

Budget is counted in engine *attempts* (unique points requested, including
failed compiles — see engine.py), so infeasible-heavy regions can no longer
inflate the effective budget.

Multi-fidelity: ``fidelity="prescreen"`` over-provisions each
temperature step with ``overprovision``× more mutation chains, ranks them by
the *surrogate-predicted* target counter (compile-free; see surrogate.py)
and promotes only the best chains to full measurement — budget is charged
only for promoted points, so one budget unit now screens ``overprovision``
candidates.  All predictions and promotion decisions happen in the driver
thread on deterministic calibrator state, so prescreened trajectories remain
identical for any ``n_workers``.  ``fidelity="full"`` (the default) takes
the exact unscreened code path, byte-for-byte — the paper-faithful ablations
survive unchanged.

``fidelity="lowered"`` keeps proposal measurement at full
fidelity but constructs MFSes through the fidelity-1 tier
(``construct_mfs(..., fidelity="lowered")``): necessity probes that lower
to the witness's structural fingerprint short-circuit without compiling or
charging, and the rest are ordered by lowered-module informativeness.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Any

from . import anomaly as anomaly_mod
from . import batching
from .mfs import MFS, construct_mfs, match_any
from .searchspace import SearchSpace


@dataclasses.dataclass
class Event:
    t: float
    n_spent: int                 # budget (engine attempts) at event time
    point: dict
    kinds: frozenset
    counter_value: float | None
    new_mfs: MFS | None = None


@dataclasses.dataclass
class SearchResult:
    algorithm: str
    counter: str
    events: list
    anomalies: list
    n_attempts: int              # budget spent (unique points requested)
    wall_s: float
    stats: dict | None = None    # engine counter snapshot (cache hits, ...)


def _counter_value(m, counter):
    if m is None:
        return None
    return m.get(counter)


def _delta_e(a, b, mode):
    """Paper's energy delta. mode 'min' for perf, 'max' for diag."""
    if a is None or b is None:
        return 0.0
    if mode == "min":
        return (b - a) / (abs(a) + 1e-12)
    return (a - b) / (abs(b) + 1e-12)


def simulated_annealing(engine, space: SearchSpace, counter: str,
                        mode: str, seed: int = 0, budget_compiles: int = 200,
                        budget_s: float = 1e9, t0: float = 1.0,
                        t_min: float = 0.02, alpha: float = 0.85,
                        n_per_t: int = 8, mfs_skip: bool = True,
                        mfs_construct: bool = True,
                        anomaly_set: list | None = None,
                        fidelity: str = "full",
                        overprovision: int = 4,
                        corpus=None) -> SearchResult:
    rng = random.Random(seed)
    prescreen = fidelity == "prescreen"
    over = max(int(overprovision), 1) if prescreen else 1
    S: list[MFS] = anomaly_set if anomaly_set is not None else []
    events: list[Event] = []
    start = time.time()
    start_spent = batching.spent(engine)

    def spent():
        return batching.spent(engine) - start_spent

    def result(label="collie-sa"):
        return SearchResult(label, counter, events, S, spent(),
                            time.time() - start,
                            batching.engine_stats(engine))

    def record(point, m, new_mfs=None, at=None):
        k = anomaly_mod.kinds(m, point.get("remat", "none")) if m else frozenset()
        events.append(Event(time.time() - start,
                            spent() if at is None else at - start_spent,
                            dict(point), k, _counter_value(m, counter),
                            new_mfs))
        return k

    def random_measured():
        """First feasible random point (serial: restarts are rare and a
        wider speculative batch here just burns budget).  Prescreen fidelity
        draws ``overprovision`` candidates per try and measures the
        surrogate-most-anomalous first — restarts land in predicted-hot
        regions without extra budget."""
        for _ in range(50):
            cands = []
            for _ in range(over):
                p = space.random_point(rng)
                if mfs_skip and match_any(S, p):
                    continue
                cands.append(p)
            if not cands:
                continue
            if prescreen and len(cands) > 1:
                preds = batching.predict_batch(engine, cands)
                order = sorted(
                    range(len(cands)),
                    key=lambda i: batching.prediction_value(
                        preds[i], counter, mode))
                batching.note_prescreen(engine, 1, len(cands) - 1)
                cands = [cands[order[0]]]
            m = batching.measure_batch(engine, [cands[0]], prescreen=0)[0]
            if m is not None:
                return cands[0], m
        return None, None

    def handle_anomaly(p, m, kinds):
        """New-anomaly bookkeeping; returns True if genuinely new."""
        if not kinds:
            return False
        if match_any(S, p):
            return False
        new = False
        for kind in sorted(kinds):
            if any(mf.kind == kind and mf.matches(p) for mf in S):
                continue
            if mfs_construct:
                mf = construct_mfs(
                    engine, space, p, kind, m, fidelity=fidelity,
                    max_probes=(max(budget_compiles - spent(), 1)
                                if prescreen else None))
            else:
                mf = MFS(kind, {f: (p[f],) for f in space.factors}, dict(p))
            S.append(mf)
            if corpus is not None:       # pure bookkeeping: no measurements
                corpus.add(mf, source=f"sa:{counter}")
            events.append(Event(time.time() - start, spent(), dict(p),
                                frozenset([kind]), None, mf))
            new = True
        return new

    p_old, m_old = random_measured()
    if p_old is None:
        return result()
    k = record(p_old, m_old)
    handle_anomaly(p_old, m_old, k)

    t = t0
    stall = 0
    exhausted = False
    reject_hist: list[int] = []    # recent Metropolis outcomes (1 = reject)
    while not exhausted and spent() < budget_compiles \
            and time.time() - start < budget_s:
        # ---- propose this temperature step's batch as speculative mutation
        # chains (p1 = mutate(base), p2 = mutate(p1), ...), all rooted at the
        # incumbent.  Chain DEPTH adapts to the recent reject rate: while SA
        # accepts nearly everything (hot phase, plateau laterals) one deep
        # chain reproduces the serial algorithm's compounded walk; when cold
        # phases reject most moves, depth shrinks toward 1 and the batch
        # becomes independent retries from the incumbent — the serial
        # algorithm's reject-and-retry patience.  All RNG draws stay in the
        # driver thread, so trajectories are identical for any n_workers.
        recent = reject_hist[-32:]
        rej = sum(recent) / max(len(recent), 1)
        depth = max(1, min(n_per_t, round(0.5 / max(rej, 0.0625))))
        n_prop = min(n_per_t, max(budget_compiles - spent(), 1))
        n_gen = n_prop * over          # overprovisioned in prescreen fidelity
        flat: list = []            # all proposals, measured as one batch
        chains: list = []          # chains of indices into flat
        guard = 0
        while len(flat) < n_gen and guard < 4 * n_per_t * over:
            base = p_old
            chain = []
            while len(chain) < depth and len(flat) < n_gen:
                q = None
                while guard < 4 * n_per_t * over:
                    guard += 1
                    cand = space.mutate(base, rng)
                    if mfs_skip and match_any(S, cand):
                        continue
                    q = cand
                    break
                if q is None:
                    break
                chain.append(len(flat))
                flat.append(q)
                base = q
            if not chain:
                break
            chains.append(chain)
        if not flat:                   # neighborhood fully inside known MFSes
            p_old, m_old = random_measured()
            if p_old is None:
                break
            continue
        if prescreen and len(flat) > n_prop:
            # ---- fidelity-0 prescreen (driver thread, deterministic): rank
            # whole chains by their best-predicted element on the target
            # counter and promote chains until n_prop proposals are funded.
            # Chain granularity keeps the speculative-acceptance semantics —
            # a promoted proposal's prefix is always promoted with it.
            preds = batching.predict_batch(engine, flat)
            ranked = sorted(
                range(len(chains)),
                key=lambda ci: (min(batching.prediction_value(
                    preds[i], counter, mode) for i in chains[ci]), ci))
            new_flat, new_chains = [], []
            for ci in ranked:
                if len(new_flat) >= n_prop:
                    break
                chain = []
                for i in chains[ci]:
                    if len(new_flat) >= n_prop:
                        break
                    chain.append(len(new_flat))
                    new_flat.append(flat[i])
                if chain:
                    new_chains.append(chain)
            batching.note_prescreen(engine, len(new_flat),
                                    len(flat) - len(new_flat))
            flat, chains = new_flat, new_chains
        # promoted proposals are always measured in full — prescreen=0 keeps
        # an engine-wide COLLIE_PRESCREEN default from double-screening
        results, spents = batching.measure_batch_spent(engine, flat,
                                                       prescreen=0)
        # ---- deterministic sequential acceptance.  Every measured proposal
        # is recorded and anomaly-checked; acceptance follows each chain only
        # while its speculation holds — a reject / infeasible point kills the
        # rest of that chain as move candidates, and a RESTART (hard stall or
        # new anomaly) kills every remaining chain in the batch: they were
        # all rooted at a base the serial algorithm would no longer be at.
        restarted = False
        for chain in chains:
            if exhausted:
                break
            chain_live = not restarted
            for i in chain:
                p_new, m_new = flat[i], results[i]
                if mfs_skip and match_any(S, p_new):
                    chain_live = False  # MFS constructed earlier in this batch
                    continue
                if m_new is None:
                    chain_live = False
                    continue
                stall += 1
                if stall > 4 * n_per_t / alpha:      # hard stall: jump out
                    stall = 0
                    p_r, m_r = random_measured()
                    if p_r is not None:
                        p_old, m_old = p_r, m_r
                        chain_live = False
                        restarted = True
                kinds = record(p_new, m_new, at=spents[i])
                if chain_live:
                    de = _delta_e(_counter_value(m_old, counter),
                                  _counter_value(m_new, counter), mode)
                    accepted = de < 0 or rng.random() < math.exp(
                        -de / max(t, 1e-9))
                    reject_hist.append(0 if accepted else 1)
                    if len(reject_hist) > 256:
                        del reject_hist[:224]
                    if accepted:
                        p_old, m_old = p_new, m_new
                        if de < 0:
                            stall = 0
                    else:
                        chain_live = False
                if handle_anomaly(p_new, m_new, kinds):
                    p_old, m_old = random_measured()
                    if p_old is None:
                        exhausted = True
                        break
                    chain_live = False
                    restarted = True
        t *= alpha
        if t < t_min:
            # paper §5.1: "a more relaxed temperature ... enables the
            # algorithm to jump out of a certain stage even when it has
            # already run lots of iterations" -> re-anneal instead of stop
            t = t0
    return result()


def rank_counters(engine, space: SearchSpace, names: list, seed: int = 0,
                  n_probe: int = 10) -> list:
    """Paper §7.2: rank counters by sigma/mu over random probe points."""
    rng = random.Random(seed)
    vals = {c: [] for c in names}
    probes = [space.random_point(rng) for _ in range(n_probe)]
    for m in batching.measure_batch(engine, probes, prescreen=0):
        if m is None:
            continue
        for c in names:
            v = m.get(c)
            if v is not None:
                vals[c].append(float(v))
    def cv(c):
        xs = vals[c]
        if len(xs) < 2:
            return 0.0
        mu = sum(xs) / len(xs)
        var = sum((x - mu) ** 2 for x in xs) / len(xs)
        return (var ** 0.5) / (abs(mu) + 1e-12)
    return sorted(names, key=cv, reverse=True)


def campaign(engine, space: SearchSpace, counters_cfg: list, seed: int = 0,
             budget_compiles: int = 300, mfs_skip=True, mfs_construct=True,
             label: str = "collie", fidelity: str = "full",
             overprovision: int = 4, corpus=None) -> SearchResult:
    """Optimize each (counter, mode) in ranked order, sharing the anomaly set
    and budget — the paper's end-to-end Collie run."""
    S: list[MFS] = []
    all_events = []
    start = time.time()
    start_c = batching.spent(engine)
    share = max(budget_compiles // max(len(counters_cfg), 1), 1)
    for counter, mode in counters_cfg:
        left = budget_compiles - (batching.spent(engine) - start_c)
        if left <= 0:
            break
        c_off = batching.spent(engine) - start_c
        t_off = time.time() - start
        r = simulated_annealing(
            engine, space, counter, mode, seed=seed,
            budget_compiles=min(share, left), mfs_skip=mfs_skip,
            mfs_construct=mfs_construct, anomaly_set=S,
            fidelity=fidelity, overprovision=overprovision, corpus=corpus)
        for e in r.events:
            e.n_spent += c_off
            e.t += t_off
            all_events.append(e)
        seed += 1
    return SearchResult(label, "campaign", all_events, S,
                        batching.spent(engine) - start_c,
                        time.time() - start, batching.engine_stats(engine))
