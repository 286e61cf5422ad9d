"""Anomaly regression corpus: dedup, persistence and replay, as the JAX
package's ``core/corpus.py``.

Every driver find is folded in under its *signature*: the anomaly kind plus
its MFS conditions projected onto the ``searchspace.UNCOUPLED`` factors.
Re-discovering a known signature bumps its hit count and keeps whichever
witness sits closer to the canonical baseline (``minimize.py``), so the
corpus converges on the simplest known repro per pathology.  Corpora from
separate campaigns ``merge()`` by the same rule.  The on-disk form is the
reference's schema-versioned JSON (``SCHEMA_VERSION = 1``, sorted keys,
deterministic entry order), so the committed corpus
(``benchmarks/results/anomaly_corpus.json``) loads and saves byte for byte.

:func:`replay` re-measures each live entry's witness and controls with the
port's engine (its traces on fake tensors) and reports whether the kind
still fires at the witness and not at the controls.

``python -m repro_torch.core.corpus replay <corpus.json> [--device cpu]``
runs the replay; ``--parity`` also holds each verdict to the reference's
today (``core/parity.py``, ``REPLAY_REFERENCE``) and exits non-zero only
where an unlisted one differs.  ``merge`` folds corpora as the reference's
CLI does.
"""
from __future__ import annotations

import dataclasses
import json
import os

from . import anomaly as anomaly_mod
from . import batching
from .mfs import MFS
from .minimize import witness_size
from .searchspace import UNCOUPLED

SCHEMA_VERSION = 1


def signature(kind: str, conditions: dict) -> str:
    """Canonical anomaly identity: kind + conditions projected onto the
    UNCOUPLED factors.  Coupled-factor conditions (arch/shape scope,
    normalization-entangled knobs) vary run to run for the same underlying
    pathology; the uncoupled projection is what re-identifies it."""
    parts = [kind]
    for f in sorted(set(conditions) & set(UNCOUPLED)):
        vals = "|".join(sorted(map(str, conditions[f])))
        parts.append(f"{f}={vals}")
    return ";".join(parts)


@dataclasses.dataclass
class CorpusEntry:
    signature: str
    kind: str
    conditions: dict             # factor -> tuple of triggering values
    witness: dict                # minimized witness when minimized=True
    raw_witness: dict            # the driver's original anomalous point
    distance: int = 0            # witness_size(witness)
    raw_distance: int = 0        # witness_size(raw_witness)
    minimized: bool = False
    hits: int = 1                # times (re)discovered across campaigns
    sources: list = dataclasses.field(default_factory=list)
    controls: list = dataclasses.field(default_factory=list)
    # ^ near-boundary points expected NOT to trigger (minimizer near-misses)
    counters: dict | None = None
    n_probes: int = 0            # spend on minimization + tightening
    retired: bool = False        # --corpus-update: no longer triggers

    def to_mfs(self) -> MFS:
        return MFS(self.kind, {k: tuple(v) for k, v in
                               self.conditions.items()},
                   dict(self.witness), self.counters)

    def _rank(self) -> tuple:
        """Merge preference: minimized beats raw, then smaller witness,
        then a stable point tiebreak."""
        return (not self.minimized, self.distance,
                json.dumps(self.witness, sort_keys=True, default=str))


def _entry_from_mfs(mfs: MFS, source: str) -> CorpusEntry:
    return CorpusEntry(
        signature=signature(mfs.kind, mfs.conditions),
        kind=mfs.kind,
        conditions={k: tuple(v) for k, v in sorted(mfs.conditions.items())},
        witness=dict(mfs.witness),
        raw_witness=dict(mfs.witness),
        distance=witness_size(mfs.witness),
        raw_distance=witness_size(mfs.witness),
        sources=[source] if source else [],
        counters=dict(mfs.counters) if mfs.counters else None,
    )


class Corpus:
    """Signature-keyed anomaly set.  ``add``/``merge`` never measure
    anything — folding finds into a corpus cannot perturb a search
    trajectory (driver parity stays byte-identical)."""

    def __init__(self, meta: dict | None = None):
        self.meta = dict(meta or {})
        self.entries: dict = {}          # signature -> CorpusEntry

    def __len__(self):
        return len(self.entries)

    def add(self, mfs: MFS, source: str = "") -> CorpusEntry:
        """Fold one driver find into the corpus (dedup by signature)."""
        return self._fold(_entry_from_mfs(mfs, source))

    def add_entry(self, entry: CorpusEntry) -> CorpusEntry:
        return self._fold(entry)

    def _fold(self, e: CorpusEntry) -> CorpusEntry:
        cur = self.entries.get(e.signature)
        if cur is None:
            self.entries[e.signature] = e
            return e
        cur.hits += e.hits
        if not e.retired:
            cur.retired = False      # rediscovered: the anomaly is back
        for s in e.sources:
            if s not in cur.sources:
                cur.sources.append(s)
        if e._rank() < cur._rank():      # incoming witness is simpler
            cur.witness = dict(e.witness)
            cur.distance = e.distance
            cur.conditions = dict(e.conditions)
            cur.counters = e.counters
            cur.minimized = e.minimized
            cur.controls = list(e.controls)
            cur.retired = e.retired
        if witness_size(e.raw_witness) > cur.raw_distance:
            # keep the WORST raw witness ever seen: the strict-reduction
            # regression test compares against the hardest starting point
            cur.raw_witness = dict(e.raw_witness)
            cur.raw_distance = witness_size(e.raw_witness)
        cur.n_probes += e.n_probes
        return cur

    def merge(self, other: "Corpus") -> "Corpus":
        for e in other.ordered():
            self._fold(dataclasses.replace(
                e, witness=dict(e.witness), raw_witness=dict(e.raw_witness),
                conditions=dict(e.conditions), sources=list(e.sources),
                controls=[dict(c) for c in e.controls]))
        return self

    def ordered(self) -> list:
        return [self.entries[s] for s in sorted(self.entries)]

    # ---------------------------------------------------------- persistence
    def save(self, path: str):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        data = {
            "schema": SCHEMA_VERSION,
            "meta": self.meta,
            "entries": [
                {**dataclasses.asdict(e),
                 "conditions": {k: list(v) for k, v in
                                sorted(e.conditions.items())}}
                for e in self.ordered()],
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True, default=str)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "Corpus":
        with open(path) as f:
            data = json.load(f)
        ver = data.get("schema")
        if ver != SCHEMA_VERSION:
            raise ValueError(
                f"corpus schema {ver!r} unsupported (expected "
                f"{SCHEMA_VERSION}); regenerate with benchmarks/make_corpus.py")
        c = cls(meta=data.get("meta"))
        for raw in data.get("entries", []):
            raw = dict(raw)
            raw["conditions"] = {k: tuple(v) for k, v in
                                 raw["conditions"].items()}
            c.entries[raw["signature"]] = CorpusEntry(**raw)
        return c


# ------------------------------------------------------------------- replay
def replay(corpus: Corpus, engine, space) -> list:
    """Re-measure every live entry's witness + controls at full fidelity.

    All points across all entries go through one concurrent
    ``measure_batch`` (prescreen pinned to 0 — a screened-out replay would
    vacuously pass).  Returns one report dict per non-retired entry:
    ``kind_ok`` (the anomaly still fires at the witness), ``controls_ok``
    (every near-boundary control still does not), ``ok`` = both.
    """
    entries = [e for e in corpus.ordered() if not e.retired]
    pts, owners = [], []                   # owners: (entry idx, role)
    for i, e in enumerate(entries):
        pts.append(space.normalize(e.witness))
        owners.append((i, "witness"))
        for c in e.controls:
            pts.append(space.normalize(dict(c)))
            owners.append((i, "control"))
    results = batching.measure_batch(engine, pts, prescreen=0)
    reports = [{"signature": e.signature, "kind": e.kind,
                "kind_ok": False, "controls_ok": True, "controls": [],
                "observed_kinds": [], "counters": None}
               for e in entries]
    for (i, role), p, m in zip(owners, pts, results):
        kinds = sorted(anomaly_mod.kinds(m, p.get("remat", "none"))) \
            if m is not None else None
        if role == "witness":
            reports[i]["observed_kinds"] = kinds or []
            reports[i]["kind_ok"] = bool(kinds) and entries[i].kind in kinds
            reports[i]["counters"] = m
        else:
            fired = kinds is not None and entries[i].kind in kinds
            reports[i]["controls"].append(
                {"point": p, "triggered": fired})
            if fired:
                reports[i]["controls_ok"] = False
    for r in reports:
        r["ok"] = r["kind_ok"] and r["controls_ok"]
    return reports


def apply_update(corpus: Corpus, reports: list) -> Corpus:
    """--corpus-update: accept observed drift into the corpus.

    Entries whose witness no longer triggers are retired (kept for history,
    excluded from replay); controls that now trigger are dropped; fresh
    witness counters replace stale ones.
    """
    by_sig = {r["signature"]: r for r in reports}
    for e in corpus.ordered():
        r = by_sig.get(e.signature)
        if r is None:
            continue
        if r["counters"] is not None:
            light = {k: v for k, v in r["counters"].items()
                     if k.startswith(("perf.", "diag."))}
            e.counters = light
        if not r["kind_ok"]:
            e.retired = True
            continue
        e.retired = False
        if not r["controls_ok"]:
            fired = {json.dumps(c["point"], sort_keys=True, default=str)
                     for c in r["controls"] if c["triggered"]}
            e.controls = [
                c for c in e.controls
                if json.dumps(c, sort_keys=True, default=str) not in fired]
    return corpus


def bench_space_and_engine(meta: dict, n_workers: int | None = None,
                           persistent_cache=False, device: str = "cuda"):
    """Rebuild the bench-scale space and engine a corpus was generated under
    (its meta records the archs and the domain restrictions)."""
    from .benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from .engine import Engine
    from .searchspace import SearchSpace
    restrict = {k: tuple(v) for k, v in (meta.get("restrict") or {}).items()}
    space = SearchSpace(bench_archs(meta["archs"]), BENCH_SHAPES,
                        restrict=restrict or None)
    engine = Engine(space, bench_meshes(), n_workers=n_workers,
                    persistent_cache=persistent_cache, device=device)
    return space, engine


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="replay an anomaly regression corpus at full fidelity")
    ap.add_argument("cmd", choices=["replay", "merge"])
    ap.add_argument("paths", nargs="+", help="corpus JSON file(s)")
    ap.add_argument("--json", default=None,
                    help="write the replay report (or merged corpus) here")
    ap.add_argument("--update", action="store_true",
                    help="replay: rewrite the corpus accepting drift")
    ap.add_argument("--device", default="cuda",
                    help="device type of the traces' fake tensors")
    ap.add_argument("--parity", action="store_true",
                    help="replay: hold each verdict to the reference's today "
                         "(core/parity.py) instead of to the corpus")
    args = ap.parse_args(argv)
    if args.cmd == "merge":
        out = Corpus.load(args.paths[0])
        for p in args.paths[1:]:
            out.merge(Corpus.load(p))
        out.save(args.json or args.paths[0])
        print(f"merged {len(args.paths)} corpora -> "
              f"{args.json or args.paths[0]} ({len(out)} entries)")
        return 0
    from . import parity
    corpus = Corpus.load(args.paths[0])
    space, engine = bench_space_and_engine(corpus.meta, device=args.device)
    reports = replay(corpus, engine, space)
    engine.close()
    n_bad = sum(1 for r in reports if not r["ok"])
    unlisted = parity.unlisted_replay_differences(reports)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"reports": reports,
                       "stats": batching.engine_stats(engine),
                       "errors": engine.errors,
                       "unlisted_replay_differences": unlisted}, f,
                      indent=1, default=str)
    for r in reports:
        status = "ok" if r["ok"] else \
            ("KIND-DRIFT" if not r["kind_ok"] else "CONTROL-DRIFT")
        ref = parity.REPLAY_REFERENCE.get(r["signature"])
        ref = "not kept" if ref is None else ("ok" if all(ref) else
                                              ("KIND-DRIFT" if not ref[0] else "CONTROL-DRIFT"))
        print(f"replay,{status},{r['signature']},"
              f"observed={'+'.join(r['observed_kinds']) or '-'},reference={ref}")
    if args.update:
        # always rewrite: fresh witness counters land even on a green
        # replay, drifted entries are retired / controls dropped otherwise
        apply_update(corpus, reports)
        corpus.save(args.paths[0])
        print(f"replay,updated,{args.paths[0]} ({n_bad} drifted entries)")
        return 0
    if args.parity:
        print(json.dumps({"entries": len(reports), "failed_traces": engine.n_failures,
                          "unlisted_replay_differences": unlisted}))
        return 1 if unlisted or engine.n_failures else 0
    return 1 if n_bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
