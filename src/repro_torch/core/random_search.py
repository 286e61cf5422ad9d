"""Random-input fuzzing baseline (paper §5, §7.2 "random input generation").

Candidates are drawn in fixed-size pools and measured as one concurrent
batch; events/anomalies are then processed sequentially in draw order, so
results are independent of the engine's ``n_workers``.

``fidelity="prescreen"`` draws an ``overprovision``× larger pool
and lets the engine's fidelity-0 prescreen promote only the
surrogate-most-anomalous ``pool`` candidates to a full compile — the same
budget now fuzzes a much wider slice of the space.  ``fidelity="full"`` is
the unscreened baseline, byte-for-byte.  ``fidelity="lowered"``
measures candidates in full but builds MFSes through the fidelity-1 tier
(structural-fingerprint short-circuits + lowered-counter probe ordering).
"""
from __future__ import annotations

import random
import time

from . import anomaly as anomaly_mod
from . import batching
from .mfs import MFS, construct_mfs, match_any
from .sa import Event, SearchResult
from .searchspace import SearchSpace


def random_search(engine, space: SearchSpace, seed: int = 0,
                  budget_compiles: int = 200, budget_s: float = 1e9,
                  mfs_skip: bool = False, mfs_construct: bool = False,
                  pool: int = 8, label: str = "random",
                  fidelity: str = "full",
                  overprovision: int = 4, corpus=None) -> SearchResult:
    rng = random.Random(seed)
    prescreen = fidelity == "prescreen"
    over = max(int(overprovision), 1) if prescreen else 1
    S: list[MFS] = []
    events: list[Event] = []
    start = time.time()
    start_c = batching.spent(engine)

    def spent():
        return batching.spent(engine) - start_c

    empty_rounds = 0
    while spent() < budget_compiles and time.time() - start < budget_s:
        n_cand = min(pool, max(budget_compiles - spent(), 1))
        cands = []
        for _ in range(8 * pool * over):
            if len(cands) >= n_cand * over:
                break
            p = space.random_point(rng)
            if mfs_skip and match_any(S, p):
                continue
            cands.append(p)
        if not cands:
            # heavily MFS-covered space: keep sampling (the serial loop
            # drew until budget_s), with a generous spin guard
            empty_rounds += 1
            if empty_rounds > 200:
                break
            continue
        empty_rounds = 0
        results, spents = batching.measure_batch_spent(
            engine, cands, prescreen=n_cand if prescreen else 0)
        for p, m, sp in zip(cands, results, spents):
            if mfs_skip and match_any(S, p):
                continue                   # MFS added earlier in this batch
            if m is None:
                continue
            kinds = anomaly_mod.kinds(m, p.get("remat", "none"))
            events.append(Event(time.time() - start, sp - start_c, dict(p),
                                kinds, None))
            if kinds and not match_any(S, p):
                for kind in sorted(kinds):
                    if any(mf.kind == kind and mf.matches(p) for mf in S):
                        continue
                    if mfs_construct:
                        mf = construct_mfs(
                            engine, space, p, kind, m, fidelity=fidelity,
                            max_probes=(max(budget_compiles - spent(), 1)
                                        if prescreen else None))
                    else:
                        mf = MFS(kind, {f: (p[f],) for f in space.factors},
                                 dict(p))
                    S.append(mf)
                    if corpus is not None:   # bookkeeping: no measurements
                        corpus.add(mf, source=label)
                    events.append(Event(time.time() - start, spent(), dict(p),
                                        frozenset([kind]), None, mf))
    return SearchResult(label, "-", events, S, spent(),
                        time.time() - start, batching.engine_stats(engine))
