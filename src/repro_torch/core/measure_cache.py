"""Persistent cross-campaign measurement cache.

The engine's dominant cost is tracing candidate workloads; bench campaigns
(ground-truth phase + per-variant runs + per-factor MFS probes) re-measure
heavily overlapping point sets from *fresh* engines, and repeat runs would
retrace everything.  This sqlite-backed store is keyed by
``(space fingerprint, canonical point key)`` and holds the flat
``perf.*``/``diag.*`` counter dict of each measured point — trace
*failures* are stored as null so warm runs skip known-infeasible points
without retrying them.  The schema is the JAX package's.

The space fingerprint covers everything that could change a measurement:
factor domains, full arch/shape configs, mesh shapes, the torch version
(DTensor's propagation differs between releases), the device type the
trace runs on (a ``cpu`` mesh all-gathers where a ``cuda`` mesh
all-to-alls), the marker ``"repro_torch"``, so a cache file shared
with the JAX package can never serve XLA's counters to the port or the
trace's to it, and a digest of the port package's Python sources: the
counters are decided by the port's own code (its models, sharding rules,
trace forms and analysis), so a cache filled by another version of it,
failed traces included, is never served to this one.  A stale cache is
therefore impossible to hit silently — any config, toolchain or code
change changes the fingerprint and cold-starts that slice.

Structural-dedup tables: the split-phase engine additionally stores
counters keyed by the **structural fingerprint** of the global trace
(``structs``: ``(space, fp) -> counters``) and the mapping from each
measured point to its fingerprint (``point_fps``: ``(space, key) -> fp``).
A *new* point whose global trace some earlier point — this campaign or any
previous one — already traced on the mesh is served from ``structs``
without tracing.  Both tables ride the same space fingerprint, so the
invalidation story is unchanged: any config/toolchain change cold-starts
all three tables together.

Enable per-engine via ``Engine(..., persistent_cache=path)`` or process-wide
with the ``COLLIE_CACHE`` env var.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import pathlib
import sqlite3
import threading
import time

import torch


def _jsonable(x):
    try:
        json.dumps(x)
        return x
    except TypeError:
        return float(x) if hasattr(x, "__float__") else str(x)


@functools.lru_cache(maxsize=None)
def source_digest() -> str:
    """sha256 of the port package's Python sources (each file's path and
    bytes, in path order)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    h = hashlib.sha256()
    for path in sorted(root.rglob("*.py")):
        h.update(path.relative_to(root).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()


def space_fingerprint(space, meshes: dict | None = None,
                      device: str = "cuda") -> str:
    """Hash of every measurement-relevant input (see module docstring);
    ``device`` is the device type the engine traces on."""
    desc = {
        "factors": {k: [repr(v) for v in vs]
                    for k, vs in sorted(space.factors.items())},
        "archs": {n: dataclasses.asdict(c)
                  for n, c in sorted(space.archs.items())},
        "shapes": {n: dataclasses.asdict(s)
                   for n, s in sorted(space.shapes.items())},
    }
    if meshes:
        def mesh_desc(m):
            try:
                return {"axes": list(m.axis_names),
                        "shape": [int(m.shape[a]) for a in m.axis_names]}
            except Exception:          # non-Mesh stand-ins (tests, stubs)
                return {"type": type(m).__name__}
        desc["meshes"] = {kind: mesh_desc(m)
                          for kind, m in sorted(meshes.items())
                          if m is not None}
    desc["package"] = "repro_torch"
    desc["torch"] = torch.__version__
    desc["device"] = torch.device(device).type
    desc["source"] = source_digest()
    blob = json.dumps(desc, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def point_key_str(key) -> str:
    """Canonical text form of a SearchSpace.point_key tuple."""
    return json.dumps([[k, _jsonable(v)] for k, v in key])


class MeasureCache:
    """Thread-safe on-disk measurement store (sqlite, WAL)."""

    def __init__(self, path: str):
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, "collie_measure_cache.sqlite")
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False,
                                     timeout=30.0)
        with self._lock:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS measurements ("
                " space TEXT NOT NULL, key TEXT NOT NULL, value TEXT,"
                " created REAL NOT NULL, PRIMARY KEY (space, key))")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS structs ("
                " space TEXT NOT NULL, fp TEXT NOT NULL, value TEXT,"
                " created REAL NOT NULL, PRIMARY KEY (space, fp))")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS point_fps ("
                " space TEXT NOT NULL, key TEXT NOT NULL,"
                " fp TEXT NOT NULL, created REAL NOT NULL,"
                " PRIMARY KEY (space, key))")
            self._conn.commit()

    def get(self, space_fp: str, key) -> tuple:
        """-> (found, counters-dict-or-None).  found=True with a None value
        means the point was measured before and failed to compile."""
        k = point_key_str(key)
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM measurements WHERE space=? AND key=?",
                (space_fp, k)).fetchone()
        if row is None:
            return False, None
        return True, (None if row[0] is None else json.loads(row[0]))

    def get_many(self, space_fp: str, keys) -> dict:
        """Resolve a whole batch of point keys in one query.

        -> {point_key_str: counters-or-None} for the keys present (absent
        keys are simply missing from the dict).  ``measure_batch`` uses this
        to prefetch a proposal batch's disk hits in one sqlite round-trip
        instead of one SELECT per point.
        """
        ks = [point_key_str(k) for k in keys]
        out: dict = {}
        CHUNK = 400                   # stay under SQLITE_MAX_VARIABLE_NUMBER
        with self._lock:
            for i in range(0, len(ks), CHUNK):
                chunk = ks[i:i + CHUNK]
                q = ("SELECT key, value FROM measurements WHERE space=? "
                     f"AND key IN ({','.join('?' * len(chunk))})")
                for k, v in self._conn.execute(q, (space_fp, *chunk)):
                    out[k] = None if v is None else json.loads(v)
        return out

    # ------------------------------------------------- structural fingerprints
    def get_struct(self, space_fp: str, fp: str) -> tuple:
        """-> (found, counters-or-None) for a structural fingerprint."""
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM structs WHERE space=? AND fp=?",
                (space_fp, fp)).fetchone()
        if row is None:
            return False, None
        return True, (None if row[0] is None else json.loads(row[0]))

    def put_structs(self, space_fp: str, items):
        """Write many (fp, counters-or-None) rows in one transaction."""
        rows = []
        for fp, counters in items:
            if counters is not None:
                counters = {k: _jsonable(v) for k, v in counters.items()
                            if not k.startswith("_")}
            rows.append((space_fp, fp,
                         None if counters is None else json.dumps(counters),
                         time.time()))
        if not rows:
            return
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO structs VALUES (?,?,?,?)", rows)
            self._conn.commit()

    def get_fp(self, space_fp: str, key) -> str | None:
        """The structural fingerprint a point lowered to, if recorded."""
        with self._lock:
            row = self._conn.execute(
                "SELECT fp FROM point_fps WHERE space=? AND key=?",
                (space_fp, point_key_str(key))).fetchone()
        return row[0] if row else None

    def put_fps(self, space_fp: str, items):
        """Write many (point key, fp) rows in one transaction."""
        rows = [(space_fp, point_key_str(key), fp, time.time())
                for key, fp in items]
        if not rows:
            return
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO point_fps VALUES (?,?,?,?)", rows)
            self._conn.commit()

    def struct_size(self, space_fp: str | None = None) -> int:
        q = "SELECT COUNT(*) FROM structs"
        args = ()
        if space_fp is not None:
            q += " WHERE space=?"
            args = (space_fp,)
        with self._lock:
            return int(self._conn.execute(q, args).fetchone()[0])

    @staticmethod
    def _encode(key, counters):
        if counters is not None:
            counters = {k: _jsonable(v) for k, v in counters.items()
                        if not k.startswith("_")}
        val = None if counters is None else json.dumps(counters)
        return point_key_str(key), val

    def put(self, space_fp: str, key, counters: dict | None):
        self.put_many(space_fp, [(key, counters)])

    def put_many(self, space_fp: str, items):
        """Write many (key, counters-or-None) pairs in ONE transaction.

        The engine buffers a whole ``measure_batch`` and flushes it here, so
        a 64-point batch costs one commit instead of 64 (per-point
        ``put`` opened and committed a transaction each call)."""
        rows = [(space_fp, *self._encode(key, counters), time.time())
                for key, counters in items]
        if not rows:
            return
        with self._lock:
            self._conn.executemany(
                "INSERT OR REPLACE INTO measurements VALUES (?,?,?,?)", rows)
            self._conn.commit()

    def size(self, space_fp: str | None = None) -> int:
        q = "SELECT COUNT(*) FROM measurements"
        args = ()
        if space_fp is not None:
            q += " WHERE space=?"
            args = (space_fp,)
        with self._lock:
            return int(self._conn.execute(q, args).fetchone()[0])

    def clear(self, space_fp: str | None = None):
        with self._lock:
            for table in ("measurements", "structs", "point_fps"):
                if space_fp is None:
                    self._conn.execute(f"DELETE FROM {table}")
                else:
                    self._conn.execute(
                        f"DELETE FROM {table} WHERE space=?", (space_fp,))
            self._conn.commit()

    def close(self):
        with self._lock:
            self._conn.close()
