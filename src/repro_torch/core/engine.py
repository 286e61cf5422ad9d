"""The workload engine (paper §4 "Workload engine" + §6), multi-fidelity.

Translates a search-space point into a traced workload on its bench mesh
and returns its counters: the JAX package's engine, with the same
constructor, methods, budget accounting, ``stats()`` keys and ``COLLIE_*``
environment variables.  Trace failures / invalid settings are reported as
None (the search skips them), mirroring the paper's engine rejecting
unsatisfiable verb combinations.

The two phases of a cold measurement are the port's measurement layer
(``core/counters.py``):

* **lower** is ``counters.lower_cell``: the step traced once on global fake
  tensors (no mesh), whose op log, resolved specs and floors give the
  point's **structural fingerprint**;
* **compile** is ``counters.compile_lowered``: the step traced on DTensors
  of fake tensors over the mesh's ranks, the per-device program with its
  collectives, analysed into the flat counters.

Both run on fake tensors of ``device`` (``"cuda"`` by default; the CPU tests
pass ``"cpu"``).  Nothing is allocated or launched, and no kernel runs: a
search point never sets ``use_pallas``.

Throughput layers (this is the search hot path):

* ``measure_batch(points)`` measures a proposal batch on a persistent thread
  pool; duplicate points within a batch or already in flight are measured
  once, with waiters sharing the result.  Traces do **not** overlap: every
  lower and compile holds ``counters.TRACE_LOCK`` (DTensor's hooks are
  process-global, and a trace is Python under the GIL), so the pool's
  workers share the dedup, the caches and the disk I/O, and the traces run
  one at a time.  Results never depend on ``n_workers``.
* A thread-safe in-memory cache keyed by the *normalized* point serves
  repeats for free, and an optional persistent cross-campaign cache
  (``measure_cache.MeasureCache``; ``COLLIE_CACHE`` env var) warm-starts
  whole runs — previously measured points (including known trace
  failures) are never retraced.  Batch writes flush as one transaction.
* **Structural dedup**: the compile phase is keyed by the structural
  fingerprint, so two points whose global traces and specs are identical
  (inert factor combinations ``normalize`` can't see, rule overrides that
  don't change the chosen specs) are traced on the mesh ONCE, within a
  batch, across a campaign, and across campaigns via the persistent
  cache's ``structs`` table.  Charging is untouched: both aliasing points
  consume budget, so ``fidelity="full"`` trajectories are byte-identical
  with dedup on or off while ``n_compiles`` and ``compile_time`` drop.
  ``COLLIE_STRUCT=0`` (or ``struct_dedup=False``) disables dedup.
* **Fidelity tiers**: ``predict_batch(points)`` returns trace-free
  fidelity-0 counter estimates (``surrogate.Surrogate``; uncharged,
  numpy-vectorized over the batch), and
  ``measure_batch(..., prescreen=k)`` ranks a proposal batch by predicted
  anomaly score and promotes only the top-k to a full measurement — budget
  is charged only for promoted points; screened-out positions return None.
  ``COLLIE_PRESCREEN`` sets a process-wide default k.  Every completed real
  measurement feeds the surrogate's residual calibrator (in submission list
  order, so calibrated predictions are deterministic for any n_workers).
  Between the surrogate and a full measurement sits **fidelity-1
  "lowered"** (``measure_lowered`` / ``measure_lowered_batch``; uncharged):
  the global trace's structural counters (FLOPs incl. remat recompute,
  layout-thrash bytes, roofline bound) overlaid on the surrogate's
  estimates for quantities that exist only on the mesh (collective counts,
  peak memory).  Lowered-tier estimates feed a second residual-calibrator
  channel whenever the same point is later measured for real.

Budget accounting: ``n_attempts`` is the budget currency — it charges once
per *unique promoted* point, whether the trace succeeds, fails, or is
served from cache.  Failed traces therefore consume search budget, and
warm-cache runs follow byte-identical search trajectories to cold runs.
``n_compiles`` counts only successful mesh traces.  ``lower_time`` and
``compile_time`` are host seconds summed over the worker threads, waits
for the trace lock included.

Engine-returned counter dicts are always flat ``perf.*``/``diag.*`` maps —
identical whether served cold, from memory, or from disk; callers that need
the full :class:`~repro_torch.core.counters.Measurement` use
``measure_full``.

Every arch of the zoo is measured, the vit and encodec frontends and the
MoE archs as every other, and every ``grad_compress`` value (a compressed
multi-mesh train point traces its pod reduction's collectives).
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

from ..launch.steps import build_cell
from ..train.optimizer import OptConfig
from . import counters as counters_mod
from .measure_cache import MeasureCache, point_key_str, space_fingerprint
from .searchspace import SearchSpace
from .surrogate import Calibrator, Surrogate


class _WriteBuf:
    """Per-batch buffered persistent-cache writes.

    Point rows, structural-fingerprint rows, and point->fp rows each flush
    as ONE transaction at batch end (list.append is GIL-atomic, so workers
    append without further locking)."""

    def __init__(self):
        self.points: list = []
        self.structs: list = []
        self.fps: list = []

    def __bool__(self):
        return bool(self.points or self.structs or self.fps)

    def flush(self, cache: "MeasureCache", space_fp: str):
        if self.points:
            cache.put_many(space_fp, self.points)
        if self.structs:
            cache.put_structs(space_fp, self.structs)
        if self.fps:
            cache.put_fps(space_fp, self.fps)


def _point_class(cell):
    """(arch, preset, shape kind, n_microbatch) of a traced cell, or None for
    a stand-in without them (the stubbed tests)."""
    policy, shape, cfg = (getattr(cell, k, None) for k in ("policy", "shape", "cfg"))
    if policy is None or shape is None or cfg is None:
        return None
    return (cfg.name, policy.sharding_preset, shape.kind, policy.n_microbatch)


class Engine:
    def __init__(self, space: SearchSpace, meshes: dict, cache: bool = True,
                 verbose: bool = False, n_workers: int | None = None,
                 persistent_cache=None, surrogate=None,
                 prescreen: int | None = None, calibrator_path=None,
                 struct_dedup: bool | None = None, device: str = "cuda"):
        """meshes: {"single": Mesh, "multi": Mesh} (multi optional).

        n_workers: thread-pool width for measure_batch (default: the
        COLLIE_WORKERS env var, else 1 — serial).
        persistent_cache: a MeasureCache, a path, or None (default: the
        COLLIE_CACHE env var if set).  Pass False to force-disable.
        surrogate: a Surrogate, None (build one from space+meshes), or False
        to disable fidelity-0 prediction/prescreening.
        prescreen: default top-k for measure_batch prescreening (None: the
        COLLIE_PRESCREEN env var, else 0 — off).
        calibrator_path: JSON file persisting the surrogate's residual
        calibrator across engines (None: COLLIE_CALIB env var — "1" rides
        alongside the persistent cache as <cache>.calib.json; a path uses
        that path; unset/"0" keeps calibration in-memory only).
        struct_dedup: key the compile phase by the structural fingerprint
        of the lowered module, so aliasing points compile once (None: the
        COLLIE_STRUCT env var, default on; trajectories are byte-identical
        either way — only n_compiles/compile_time change).  Without it a
        measurement skips the global trace, which only fingerprints the
        point.
        device: the device type of the fake tensors every trace runs on
        (also part of the persistent cache's space fingerprint).
        """
        self.space = space
        self.device = device
        self.meshes = meshes
        self.cache = {} if cache else None
        self.verbose = verbose
        if n_workers is None:
            raw = os.environ.get("COLLIE_WORKERS", "1") or "1"
            try:
                n_workers = int(raw)
            except ValueError:
                raise ValueError(
                    f"COLLIE_WORKERS must be an integer, got {raw!r}")
        self.n_workers = max(int(n_workers), 1)
        if persistent_cache is None:
            env = os.environ.get("COLLIE_CACHE")
            persistent_cache = env if env and env != "0" else None
        if persistent_cache is False:
            persistent_cache = None
        if isinstance(persistent_cache, (str, os.PathLike)):
            persistent_cache = MeasureCache(os.fspath(persistent_cache))
        self.persistent = persistent_cache
        self.space_fp = (space_fingerprint(space, meshes, device)
                         if self.persistent is not None else None)
        if prescreen is None:
            raw = os.environ.get("COLLIE_PRESCREEN", "0") or "0"
            try:
                prescreen = int(raw)
            except ValueError:
                raise ValueError(
                    f"COLLIE_PRESCREEN must be an integer, got {raw!r}")
        self.prescreen = max(int(prescreen), 0)
        if surrogate is None:
            surrogate = Surrogate(space, meshes)
        self.surrogate = surrogate or None
        self._calib_path = self._resolve_calib_path(calibrator_path)
        if self.surrogate is not None and self._calib_path:
            self.surrogate.load_calibration(self._calib_path)
        if struct_dedup is None:
            struct_dedup = os.environ.get("COLLIE_STRUCT", "1") \
                not in ("0", "false", "")
        self.struct_dedup = bool(struct_dedup)
        self._lock = threading.RLock()
        self._pool = None              # persistent executor (lazy; close())
        self._inflight: dict = {}      # point key -> Future
        self._charged: set = set()     # unique keys that consumed budget
        self._observed: set = set()    # unique keys fed to the calibrator
        self._meas: dict = {}          # key -> Measurement (measure_full)
        self._struct: dict = {}        # fp -> flat counters (or None)
        self._fp_inflight: dict = {}   # fp -> Future (compile owner)
        self._fp_of_key: dict = {}     # point key -> fp
        self._lowered: dict = {}       # key -> (fp, fid-1 raw counters)
        self.n_attempts = 0        # budget: unique points requested
        self.n_compiles = 0        # successful compiles
        self.n_failures = 0        # failed compile attempts
        self.n_cache_hits = 0      # in-memory / in-flight hits (incl. repeats)
        self.n_disk_hits = 0       # persistent-cache hits
        self.n_cache_misses = 0    # requests that had to compile
        self.n_predictions = 0     # fidelity-0 predictions served
        self.n_promoted = 0        # prescreened points promoted to compile
        self.n_screened_out = 0    # prescreened points never compiled
        self.n_minimize_probes = 0  # spent by witness minimize/tighten passes
        self.n_lowerings = 0       # lower-phase runs (full path + fid-1 tier)
        self.n_struct_hits = 0     # compiles avoided by structural dedup
        self.n_lowered_served = 0  # fidelity-1 estimates served
        self.compile_time = 0.0
        self.lower_time = 0.0
        # not in stats(): op -> times a mesh trace ran it replicated
        # (``Trace.replicated``); the same by the traced point's (preset,
        # shape kind, n_microbatch), what ``parity.unlisted_replications``
        # reads; and the message of every failed trace
        self.replicated_ops: dict = {}
        self.replicated_at: dict = {}
        self.errors: list = []

    def _resolve_calib_path(self, calibrator_path):
        if calibrator_path is None:
            calibrator_path = os.environ.get("COLLIE_CALIB")
        if not calibrator_path or calibrator_path == "0":
            return None
        if calibrator_path == "1":
            if self.persistent is None:
                return None
            return self.persistent.path + ".calib.json"
        return os.fspath(calibrator_path)

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Shut down the persistent thread pool, flush calibrator state."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if self.surrogate is not None and self._calib_path:
            try:
                self.surrogate.save_calibration(self._calib_path)
            except OSError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _executor(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self.n_workers,
                    thread_name_prefix="collie-engine")
            return self._pool

    # ------------------------------------------------------------- fidelity 0
    def predict(self, point: dict):
        """Fidelity-0 estimate of a point's counters — no compile, no budget.

        Returns a calibrated flat ``perf.*``/``diag.*`` dict (estimates, not
        measurements) or None where the full engine would reject the point.
        """
        if self.surrogate is None:
            return None
        with self._lock:
            self.n_predictions += 1
        return self.surrogate.predict(point)

    def predict_batch(self, points: list) -> list:
        """Fidelity-0 estimates aligned with ``points`` (uncharged).

        Routes through the surrogate's numpy-vectorized batch path: cached
        points are served individually, the uncached remainder is estimated
        in one vectorized sweep (bit-identical to the scalar path)."""
        if self.surrogate is None:
            return [None] * len(points)
        with self._lock:
            self.n_predictions += len(points)
        return self.surrogate.predict_batch(points)

    # ------------------------------------------------------------ fidelity 1
    def measure_lowered(self, point: dict):
        """Fidelity-1 "lowered" estimate: trace the point once on global
        fake tensors (no mesh trace, no budget) and analyse that trace.
        Structure-derived counters (FLOPs incl.
        remat recompute, layout-thrash bytes, roofline bound) are real; the
        rest of the flat dict is the surrogate's fidelity-0 estimate.
        Returns None where the engine would reject the point."""
        key = self.space.point_key(point)
        fp, raw = self._lowered_entry(key, point)
        if raw is None:
            return None
        base = (self.surrogate.predict(point)
                if self.surrogate is not None else None)
        out = dict(base) if base else {}
        out.update(raw)
        if self.surrogate is not None:
            out = self.surrogate.lowered_calibrator.apply(out)
        with self._lock:
            self.n_lowered_served += 1
        return out

    def measure_lowered_batch(self, points: list) -> list:
        """Fidelity-1 estimates aligned with ``points``; unique points are
        lowered on the engine pool (one at a time: each holds the trace
        lock)."""
        keys = [self.space.point_key(p) for p in points]
        uniq: dict = {}
        for k, p in zip(keys, points):
            uniq.setdefault(k, p)
        items = list(uniq.items())
        if self.n_workers > 1 and len(items) > 1:
            list(self._executor().map(
                lambda kp: self._lowered_entry(kp[0], kp[1]), items))
        served = {k: self.measure_lowered(p) for k, p in items}
        return [served[k] for k in keys]

    def lowered_key(self, point: dict) -> str | None:
        """The point's structural fingerprint (lowers once, cached across
        the full path, the lowered tier, and the persistent ``point_fps``
        table; None if infeasible).  Uncharged — drivers use fingerprint
        equality to prove two points share counters without measuring."""
        key = self.space.point_key(point)
        with self._lock:
            fp = self._fp_of_key.get(key)
        if fp is not None:
            return fp
        if self.persistent is not None:
            fp = self.persistent.get_fp(self.space_fp, key)
            if fp is not None:
                with self._lock:
                    self._fp_of_key[key] = fp
                return fp
        fp, _ = self._lowered_entry(key, point)
        return fp

    def _lowered_entry(self, key, point):
        """-> cached (fingerprint, raw fidelity-1 counters) for a point,
        lowering it once on first request ((None, None) if infeasible)."""
        with self._lock:
            ent = self._lowered.get(key)
        if ent is not None:
            return ent
        ent = (None, None)
        if self.space.valid(point):
            cfg, shape, policy, mesh_kind = self.space.to_run(point)
            mesh = self.meshes.get(mesh_kind)
            if mesh is not None:
                try:
                    t0 = time.time()
                    cell = build_cell(cfg, shape, policy, mesh,
                                      OptConfig(name=policy.optimizer))
                    lc = counters_mod.lower_cell(cell, device=self.device)
                    raw = counters_mod.lowered_counters(lc)
                    with self._lock:
                        self.n_lowerings += 1
                        self.lower_time += time.time() - t0
                    ent = (lc.fingerprint, raw)
                except Exception as e:   # infeasible at trace/lower time
                    self._note_error("lowering", e)
        with self._lock:
            self._lowered[key] = ent
            if ent[0] is not None:
                self._fp_of_key.setdefault(key, ent[0])
        return ent

    def note_prescreen(self, n_promoted: int, n_screened: int):
        """Fold a *driver-side* prescreen decision (SA chain selection, BO
        pool trimming, MFS short-circuits) into the promotion stats, so
        ``stats()`` reflects every fidelity-0 screening regardless of where
        the decision was made."""
        with self._lock:
            self.n_promoted += int(n_promoted)
            self.n_screened_out += int(n_screened)

    def note_minimize(self, n_probes: int):
        """Attribute ``n_probes`` of the budget to corpus minimization /
        condition tightening (minimize.py), so ``stats()`` can split search
        spend from regression-corpus upkeep."""
        with self._lock:
            self.n_minimize_probes += int(n_probes)

    def _observe(self, key, point, result):
        """Fold a completed real measurement into the residual calibrator —
        called in submission list order from the driver thread, once per
        unique key, so calibration state is n_workers-independent."""
        if self.surrogate is None or result is None:
            return
        with self._lock:
            if key in self._observed:
                return
            self._observed.add(key)
            low = self._lowered.get(key)
        self.surrogate.observe(point, result)
        if low is not None and low[1] is not None:
            # second observation channel: fidelity-1 estimate -> real value
            self.surrogate.lowered_calibrator.observe(low[1], result)

    # ------------------------------------------------------------- measure
    def measure(self, point: dict):
        """Point -> flat counter dict (perf + diag) or None if infeasible."""
        key = self.space.point_key(point)
        result = self._measure_key(key, point)
        self._observe(key, point, result)
        return result

    def measure_full(self, point: dict):
        """Point -> full :class:`Measurement` (or None if infeasible).

        ``measure``/``measure_batch`` return flat counter dicts only; this
        keeps the trace's analysis for callers that need the op histogram,
        memory analysis, etc.  Served from the in-memory store when the point
        was compiled by this engine; a disk-cache hit or structural-dedup
        hit has no Measurement, so this recompiles once (counted in
        n_compiles) to rebuild it — structural dedup is bypassed because
        only a real compile can produce the artifact handle.
        """
        key = self.space.point_key(point)
        if self.measure(point) is None:
            return None
        with self._lock:
            m = self._meas.get(key)
        if m is None:
            _, m = self._realize(point, force_compile=True)
            if m is not None:
                with self._lock:
                    self._meas[key] = m
        return m

    def measure_batch(self, points: list, n_workers: int | None = None,
                      with_spent: bool = False, prescreen: int | None = None,
                      score=None):
        """Measure a batch of points, deduplicated, on the thread pool.

        Returns counter dicts (or None) aligned with ``points``.  Budget is
        charged for every unique promoted point at submission, in list order,
        so accounting — and therefore any search driven by it — is identical
        for any n_workers (including 1).

        prescreen=k (None: the engine default; 0: off): rank the batch's
        unique points by fidelity-0 ``score`` (default: predicted anomaly
        score) and promote only the top-k to a full measurement.  Screened
        positions return None and are NOT charged.  ``score`` is called as
        ``score(pred, point) -> float`` with the calibrated prediction.

        with_spent=True additionally returns the n_attempts total as of each
        point's submission, so event crediting ("found after N attempts")
        stays per-point exact instead of rounding up to the batch width.
        """
        nw = self.n_workers if n_workers is None else max(int(n_workers), 1)
        keys = [self.space.point_key(p) for p in points]
        k = self.prescreen if prescreen is None else max(int(prescreen), 0)
        promoted_keys = self._prescreen_keys(keys, points, k, score)
        promoted = [i for i, kk in enumerate(keys) if kk in promoted_keys] \
            if promoted_keys is not None else range(len(points))
        spents = []
        with self._lock:
            pset = set(promoted)
            for i, kk in enumerate(keys):
                if i in pset:
                    self._charge(kk)
                spents.append(self.n_attempts)
        results: list = [None] * len(points)
        todo = [(keys[i], points[i], i) for i in promoted]
        write_buf = _WriteBuf() if self.persistent is not None else None
        # batched disk read: resolve the whole batch's persistent hits in
        # one sqlite query instead of one SELECT per point
        prefetch = None
        if self.persistent is not None and len(todo) > 1:
            prefetch = self.persistent.get_many(
                self.space_fp, [t[0] for t in todo])
        try:
            if nw <= 1 or len(todo) <= 1:
                for kk, p, i in todo:
                    results[i] = self._measure_key(kk, p, write_buf,
                                                   prefetch=prefetch)
            elif nw != self.n_workers:
                # one-off width override: a temporary pool preserves
                # semantics
                with ThreadPoolExecutor(max_workers=nw) as ex:
                    outs = list(ex.map(lambda t: self._measure_key(
                        t[0], t[1], write_buf, prefetch=prefetch), todo))
                for (_, _, i), r in zip(todo, outs):
                    results[i] = r
            else:
                outs = list(self._executor().map(
                    lambda t: self._measure_key(t[0], t[1], write_buf,
                                                prefetch=prefetch),
                    todo))
                for (_, _, i), r in zip(todo, outs):
                    results[i] = r
        finally:
            # flush even when a worker raised mid-batch — completed traces
            # are seconds of work each and must reach the disk cache
            if write_buf:
                write_buf.flush(self.persistent, self.space_fp)
        for kk, p, i in todo:        # calibrate in list order (deterministic)
            self._observe(kk, p, results[i])
        return (results, spents) if with_spent else results

    def _prescreen_keys(self, keys, points, k, score):
        """-> set of promoted keys, or None for 'promote everything'."""
        if k <= 0 or self.surrogate is None:
            return None
        uniq: dict = {}                       # key -> (first index, point)
        for i, (kk, p) in enumerate(zip(keys, points)):
            if kk not in uniq:
                uniq[kk] = (i, p)
        if len(uniq) <= k:
            return None
        items = list(uniq.items())
        preds = self.predict_batch([p for _, (_, p) in items])
        scored = []
        for (kk, (i, p)), pred in zip(items, preds):
            if score is not None:
                s = score(pred, p)
            else:
                s = self.surrogate.anomaly_score(
                    pred, p.get("remat", "none"))
            scored.append((-float(s), i, kk))
        scored.sort()
        keep = {kk for _, _, kk in scored[:k]}
        with self._lock:
            self.n_promoted += len(keep)
            self.n_screened_out += len(uniq) - len(keep)
        return keep

    # ------------------------------------------------------------ internals
    def _charge(self, key):
        if key not in self._charged:
            self._charged.add(key)
            self.n_attempts += 1

    def _measure_key(self, key, point, write_buf=None, charge=True,
                     prefetch=None):
        with self._lock:
            if charge:
                self._charge(key)
            if self.cache is not None and key in self.cache:
                self.n_cache_hits += 1
                return self.cache[key]
            fut = self._inflight.get(key)
            if fut is None:
                mine = Future()
                self._inflight[key] = mine
            else:
                self.n_cache_hits += 1     # another thread is resolving it
        if fut is not None:
            return fut.result()
        # owner path: disk lookup and lower/compile both happen OUTSIDE the
        # engine lock (MeasureCache has its own lock) so concurrent threads
        # are never serialized behind sqlite I/O or a trace
        try:
            if prefetch is not None:       # batch-prefetched disk state
                kstr = point_key_str(key)
                found = kstr in prefetch
                result = prefetch.get(kstr)
            else:
                found, result = (self.persistent.get(self.space_fp, key)
                                 if self.persistent is not None
                                 else (False, None))
            if not found:
                result, meas = self._realize(point, write_buf=write_buf)
        except BaseException as e:         # never strand waiters
            with self._lock:
                self._inflight.pop(key, None)
            mine.set_exception(e)
            raise
        if not found and self.persistent is not None:
            if write_buf is not None:      # batched: one txn per batch
                write_buf.points.append((key, result))
            else:
                self.persistent.put(self.space_fp, key, result)
        with self._lock:
            if found:
                self.n_disk_hits += 1
            else:
                self.n_cache_misses += 1
                if self.cache is not None and meas is not None:
                    self._meas[key] = meas
            if self.cache is not None:
                self.cache[key] = result
            self._inflight.pop(key, None)
        mine.set_result(result)
        return result

    def _realize(self, point, force_compile=False, write_buf=None):
        """Split-phase realization: lower, fingerprint, dedup, compile.

        -> (flat counter dict or None, Measurement or None).  The compile
        phase runs only on a structural miss (or ``force_compile``, used by
        measure_full to rebuild the artifact handle); a structural hit
        serves the fingerprint's counters — byte-identical by construction
        — and returns no Measurement, mirroring disk-hit semantics.
        """
        if not self.space.valid(point):
            return None, None
        cfg, shape, policy, mesh_kind = self.space.to_run(point)
        mesh = self.meshes.get(mesh_kind)
        if mesh is None:
            return None, None
        # ---- phase 1: trace + lower (cheap, Python-bound)
        try:
            t0 = time.time()
            cell = build_cell(cfg, shape, policy, mesh,
                              OptConfig(name=policy.optimizer))
            # the global trace only fingerprints the point, for the dedup
            lc = counters_mod.lower_cell(cell, device=self.device,
                                         fingerprint=self.struct_dedup or force_compile)
            with self._lock:
                self.n_lowerings += 1
                self.lower_time += time.time() - t0
        except Exception as e:              # sharding/trace failure
            with self._lock:
                self.n_failures += 1
            self._note_error("lowering", e)
            return None, None
        fp = lc.fingerprint
        key = self.space.point_key(point)
        if fp:
            with self._lock:
                self._fp_of_key[key] = fp
        if force_compile or not self.struct_dedup:
            return self._compile_lowered(lc)
        # ---- structural dedup: in-memory table, in-flight owners, disk
        def record_fp():                   # persist key -> fp on every path
            if write_buf is not None:      # (buffered per batch, or direct
                write_buf.fps.append((key, fp))   # for single-point calls)
            elif self.persistent is not None:
                self.persistent.put_fps(self.space_fp, [(key, fp)])
        hit = False
        with self._lock:
            if fp in self._struct:
                self.n_struct_hits += 1
                hit, cached = True, self._struct[fp]
            else:
                owner_fut = self._fp_inflight.get(fp)
                if owner_fut is None:
                    mine = Future()
                    self._fp_inflight[fp] = mine
        if hit:
            record_fp()                    # put_fps takes the cache's lock
            return cached, None
        if owner_fut is not None:          # another thread compiles this fp
            result = owner_fut.result()
            with self._lock:
                self.n_struct_hits += 1
            record_fp()
            return result, None
        try:
            found, result = (self.persistent.get_struct(self.space_fp, fp)
                             if self.persistent is not None
                             else (False, None))
            if found:
                with self._lock:
                    self.n_struct_hits += 1
                meas = None
            else:
                result, meas = self._compile_lowered(lc)
                if self.persistent is not None:
                    if write_buf is not None:
                        write_buf.structs.append((fp, result))
                    else:
                        self.persistent.put_structs(self.space_fp,
                                                    [(fp, result)])
        except BaseException as e:         # never strand fp waiters
            with self._lock:
                self._fp_inflight.pop(fp, None)
            mine.set_exception(e)
            raise
        with self._lock:
            self._struct[fp] = result
            self._fp_inflight.pop(fp, None)
        mine.set_result(result)
        if write_buf is not None:
            write_buf.fps.append((key, fp))
        elif self.persistent is not None:
            self.persistent.put_fps(self.space_fp, [(key, fp)])
        return result, meas

    def _compile_lowered(self, lc):
        """Phase 2: the mesh trace + analysis of a lowered cell."""
        try:
            t0 = time.time()
            m = counters_mod.compile_lowered(lc)
            with self._lock:
                self.n_compiles += 1
                self.compile_time += time.time() - t0
            result = {**{f"perf.{k}": v for k, v in m.perf.items()},
                      **{f"diag.{k}": v for k, v in m.diag.items()}}
            ops = (getattr(m, "hlo", None) or {}).get("replicated_ops", {})
            if ops:
                cls = _point_class(lc.cell)
                with self._lock:
                    at = self.replicated_at.setdefault(cls, {})
                    for op, n in ops.items():
                        self.replicated_ops[op] = self.replicated_ops.get(op, 0) + n
                        at[op] = at.get(op, 0) + n
            return result, m
        except Exception as e:              # trace failure on the mesh
            with self._lock:
                self.n_failures += 1
            self._note_error("compile", e)
            return None, None

    def _note_error(self, phase, e):
        msg = f"{phase} failed: {type(e).__name__}: {e}"
        with self._lock:
            self.errors.append(msg)
        if self.verbose:
            print(f"[engine] {msg}")

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Counter snapshot (SearchResult-adjacent; cheap to copy)."""
        with self._lock:
            hits = self.n_cache_hits + self.n_disk_hits
            total = hits + self.n_cache_misses
            return {
                "n_attempts": self.n_attempts,
                "n_compiles": self.n_compiles,
                "n_failures": self.n_failures,
                "n_cache_hits": self.n_cache_hits,
                "n_disk_hits": self.n_disk_hits,
                "n_cache_misses": self.n_cache_misses,
                "cache_hit_rate": hits / total if total else 0.0,
                "compile_time": self.compile_time,
                "n_workers": self.n_workers,
                "n_predictions": self.n_predictions,
                "n_promoted": self.n_promoted,
                "n_screened_out": self.n_screened_out,
                "n_minimize_probes": self.n_minimize_probes,
                "n_lowerings": self.n_lowerings,
                "n_struct_hits": self.n_struct_hits,
                "n_lowered_served": self.n_lowered_served,
                "lower_time": self.lower_time,
                "n_calibrated":
                    (self.surrogate.calibrator.n_observed
                     if self.surrogate is not None else 0),
            }

    def counter_names(self, sample_point) -> dict:
        """Discover the flat counter names from one probe measurement.

        The probe is UNCHARGED: counter discovery is setup, not
        search, so it must not consume ``n_attempts`` budget — if a search
        later measures the same point, the budget is charged then.  The
        probe still rides the normal measure path (cache, dedup,
        persistence) and feeds the calibrator.
        """
        key = self.space.point_key(sample_point)
        m = self._measure_key(key, sample_point, charge=False)
        self._observe(key, sample_point, m)
        if m is None:
            raise RuntimeError("sample point infeasible")
        return {"perf": [k for k in m if k.startswith("perf.")],
                "diag": [k for k in m if k.startswith("diag.")]}
