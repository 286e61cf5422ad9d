"""Bayesian-optimization baseline (paper §7.2, built after [31] fmfn/BO).

Gaussian-process surrogate (RBF kernel, median-heuristic lengthscale) over a
one-hot/ordinal encoding of the search space; Expected-Improvement
acquisition maximized over a random candidate pool + mutations of the
incumbent.  MFS-enhanced like the paper's BO baseline ("for a fair
comparison, we use MFS to enhance BO as well").

Batched: the ``n_init`` seeding pool and, per GP iteration, the top-``q``
acquisition candidates are measured as one concurrent batch, then processed
sequentially in acquisition order — results are independent of the engine's
``n_workers``.

GP refit cost: observations only ever *append*, so
:class:`_GPState` caches the pairwise-distance matrix and the Cholesky
factor between ``observe_batch`` calls — appending m points is an O(n²·m)
block update instead of the from-scratch O(n³) factorization, and a
lengthscale change refactors from the cached distance matrix (numerical
parity with the from-scratch path is pinned by a test).

Multi-fidelity: ``fidelity="prescreen"`` additionally (1) seeds
the GP with compile-free fidelity-0 observations from the engine's analytic
surrogate at a distinct (higher) noise level, so the acquisition starts with
a sketch of the whole landscape before the first compile, and (2) prescreens
the per-iteration candidate pool down to the surrogate-most-promising slice
before ranking by EI.  ``fidelity="full"`` is the unscreened baseline.
``fidelity="lowered"`` keeps EI/measurement at full fidelity and
builds MFSes through the fidelity-1 tier (structural-fingerprint
short-circuits + lowered-counter probe ordering).
"""
from __future__ import annotations

import math
import random
import time

import numpy as np

try:
    from scipy.linalg import solve_triangular as _solve_tri
except Exception:                                 # pragma: no cover
    def _solve_tri(L, B, lower=True, trans=0):
        M = L.T if trans in (1, "T") else L
        return np.linalg.solve(M, B)

from . import anomaly as anomaly_mod
from . import batching
from .mfs import MFS, construct_mfs, match_any
from .sa import Event, SearchResult
from .searchspace import SearchSpace

_NOISE_REAL = 1e-3     # observation noise of a full measurement
_NOISE_F0 = 0.25       # fidelity-0 (surrogate estimate) observation noise


def _encoder(space: SearchSpace):
    cols = []
    for f, dom in sorted(space.factors.items()):
        for v in dom:
            cols.append((f, v))

    def enc(p):
        x = np.zeros(len(cols))
        for i, (f, v) in enumerate(cols):
            if p.get(f) == v:
                x[i] = 1.0
        return x
    return enc


def _cross_d2(A, B):
    return ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)


def _gp_posterior(X, y, Xs, ls, noise=1e-3):
    """From-scratch reference posterior (kept for parity testing; accepts a
    scalar noise or a per-observation noise vector)."""
    def k(a, b):
        d2 = _cross_d2(a, b)
        return np.exp(-d2 / (2 * ls ** 2))
    noise = np.asarray(noise)
    nd = np.diag(np.full(len(X), noise)) if noise.ndim == 0 else np.diag(noise)
    K = k(X, X) + nd
    Ks = k(X, Xs)
    L = np.linalg.cholesky(K + 1e-8 * np.eye(len(X)))
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    mu = Ks.T @ alpha
    v = np.linalg.solve(L, Ks)
    var = np.maximum(1.0 - (v ** 2).sum(0), 1e-9)
    return mu, np.sqrt(var)


class _GPState:
    """Incremental GP factorization cache (observations only append)."""

    def __init__(self):
        self.X = None          # (n, d) observed inputs
        self.D2 = None         # (n, n) pairwise squared distances
        self.noise = None      # (n,) per-observation noise
        self.ls = None         # lengthscale of the cached factor
        self.L = None          # Cholesky of K + diag(noise) + jitter
        self.n_factored = 0    # rows covered by self.L

    def __len__(self):
        return 0 if self.X is None else len(self.X)

    def extend(self, rows, noise):
        """Append observations: extends X and the distance matrix in O(n·m)."""
        if not rows:
            return
        Xn = np.asarray(rows, dtype=float)
        nv = np.full(len(rows), noise, dtype=float)
        if self.X is None:
            self.X = Xn
            self.D2 = _cross_d2(Xn, Xn)
            self.noise = nv
            return
        C = _cross_d2(self.X, Xn)
        self.D2 = np.block([[self.D2, C], [C.T, _cross_d2(Xn, Xn)]])
        self.X = np.vstack([self.X, Xn])
        self.noise = np.concatenate([self.noise, nv])

    def median_ls(self) -> float:
        """Median-heuristic lengthscale from the cached distance matrix."""
        if self.D2 is None or not (self.D2 > 0).any():
            return 1.0
        return math.sqrt(np.median(self.D2[self.D2 > 0]))

    def _kernel(self, ls):
        return np.exp(-self.D2 / (2 * ls ** 2)) + np.diag(self.noise) \
            + 1e-8 * np.eye(len(self.X))

    def _factor(self, ls):
        n = len(self.X)
        if self.L is not None and ls == self.ls and self.n_factored == n:
            return
        if self.L is None or ls != self.ls or self.n_factored > n:
            # lengthscale changed (the median over one-hot distances is a
            # discrete statistic, so this settles after the early
            # iterations): refactor in full, but from the cached distance
            # matrix — the median-ls policy itself stays exactly as it was
            self.L = np.linalg.cholesky(self._kernel(ls))
        else:
            # block update: K = [[K11, B], [B.T, C]] with K11 = L11 L11.T
            nf, m = self.n_factored, n - self.n_factored
            K = self._kernel(ls)
            B, C = K[:nf, nf:], K[nf:, nf:]
            L21 = _solve_tri(self.L, B, lower=True).T
            L22 = np.linalg.cholesky(C - L21 @ L21.T)
            self.L = np.block([[self.L, np.zeros((nf, m))], [L21, L22]])
        self.ls = ls
        self.n_factored = n

    def posterior(self, yn, Xs, ls):
        """Posterior mean/std at Xs given normalized targets yn (len == n)."""
        self._factor(ls)
        Ks = np.exp(-_cross_d2(self.X, np.asarray(Xs)) / (2 * ls ** 2))
        z = _solve_tri(self.L, yn, lower=True)
        alpha = _solve_tri(self.L, z, lower=True, trans=1)
        mu = Ks.T @ alpha
        v = _solve_tri(self.L, Ks, lower=True)
        var = np.maximum(1.0 - (v ** 2).sum(0), 1e-9)
        return mu, np.sqrt(var)


def _ei(mu, sigma, best, minimize=True):
    z = (best - mu) / sigma if minimize else (mu - best) / sigma
    phi = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
    Phi = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
    return sigma * (z * Phi + phi)


def bo_search(engine, space: SearchSpace, counter: str, mode: str,
              seed: int = 0, budget_compiles: int = 200, budget_s: float = 1e9,
              n_init: int = 8, pool: int = 128, q: int = 4,
              mfs_skip: bool = True, mfs_construct: bool = True,
              anomaly_set: list | None = None,
              label: str = "bo", fidelity: str = "full",
              overprovision: int = 4, corpus=None) -> SearchResult:
    rng = random.Random(seed)
    enc = _encoder(space)
    prescreen = fidelity == "prescreen"
    over = max(int(overprovision), 1)
    S: list[MFS] = anomaly_set if anomaly_set is not None else []
    events: list[Event] = []
    X, y, pts = [], [], []           # full-fidelity observations
    n_f0 = 0                         # fidelity-0 seed count (GP prefix rows)
    gp = _GPState()
    start = time.time()
    start_c = batching.spent(engine)
    minimize = (mode == "min")

    def spent():
        return batching.spent(engine) - start_c

    def observe_batch(cands):
        """Measure candidates concurrently, fold into the GP sequentially.

        Candidates were already selected (by EI over the prescreened pool),
        so they are measured in full — prescreen=0 keeps an engine-wide
        COLLIE_PRESCREEN default from double-screening them."""
        results, spents = batching.measure_batch_spent(engine, cands,
                                                       prescreen=0)
        rows = []
        for p, m, sp in zip(cands, results, spents):
            if m is None:
                continue
            v = m.get(counter)
            kinds = anomaly_mod.kinds(m, p.get("remat", "none"))
            events.append(Event(time.time() - start, sp - start_c, dict(p),
                                kinds, v))
            if v is not None:
                X.append(enc(p))
                y.append(float(v))
                pts.append(p)
                rows.append(X[-1])
            if kinds and not match_any(S, p):
                for kind in sorted(kinds):
                    if any(mf.kind == kind and mf.matches(p) for mf in S):
                        continue
                    mf = construct_mfs(
                        engine, space, p, kind, m, fidelity=fidelity,
                        max_probes=(max(budget_compiles - spent(), 1)
                                    if prescreen else None)) \
                        if mfs_construct \
                        else MFS(kind, {f: (p[f],) for f in space.factors},
                                 dict(p))
                    S.append(mf)
                    if corpus is not None:   # bookkeeping: no measurements
                        corpus.add(mf, source=label)
                    events.append(Event(time.time() - start, spent(), dict(p),
                                        frozenset([kind]), None, mf))
        gp.extend(rows, _NOISE_REAL)

    y0: list[float] = []
    if prescreen:
        # seed the GP with compile-free fidelity-0 observations at their own
        # (higher) noise level — a whole-landscape sketch for zero budget
        seeds = [space.random_point(rng) for _ in range(pool)]
        preds = batching.predict_batch(engine, seeds)
        rows = []
        for p, pr in zip(seeds, preds):
            v = None if pr is None else pr.get(counter)
            if v is not None and math.isfinite(float(v)):
                rows.append(enc(p))
                y0.append(float(v))
        gp.extend(rows, _NOISE_F0)
        n_f0 = len(rows)

    n_seed = min(n_init, max(budget_compiles - spent(), 0))
    if n_seed:
        observe_batch([space.random_point(rng) for _ in range(n_seed)])

    while spent() < budget_compiles and time.time() - start < budget_s:
        if len(X) < 2:
            observe_batch([space.random_point(rng)])
            continue
        ya = np.array(y)
        mu_, sd_ = ya.mean(), ya.std() + 1e-12
        yn = (np.concatenate([np.array(y0), ya]) - mu_) / sd_ \
            if n_f0 else (ya - mu_) / sd_
        cands = [space.random_point(rng) for _ in range(pool)]
        best_p = pts[int(np.argmin(ya) if minimize else np.argmax(ya))]
        cands += [space.mutate(best_p, rng) for _ in range(pool // 4)]
        if mfs_skip:
            cands = [c for c in cands if not match_any(S, c)] or cands
        if prescreen and len(cands) > 4 * q:
            # fidelity-0 pool prescreen: EI only ranks the surrogate-best
            # slice, so acquisition never wastes compiles on points the
            # analytic model already rules out
            preds = batching.predict_batch(engine, cands)
            keep = max(4 * q, len(cands) // over)
            order = sorted(range(len(cands)),
                           key=lambda i: (batching.prediction_value(
                               preds[i], counter, mode), i))
            batching.note_prescreen(engine, keep, len(cands) - keep)
            cands = [cands[i] for i in order[:keep]]
        Xc = np.array([enc(c) for c in cands])
        ls = gp.median_ls()
        mun, sigma = gp.posterior(yn, Xc, ls)
        yreal = (ya - mu_) / sd_
        best = yreal.min() if minimize else yreal.max()
        acq = _ei(mun, sigma, best, minimize)
        n_q = min(q, max(budget_compiles - spent(), 1), len(cands))
        top = np.argsort(-acq, kind="stable")[:n_q]
        observe_batch([cands[int(i)] for i in top])
    return SearchResult(label, counter, events, S, spent(),
                        time.time() - start, batching.engine_stats(engine))
