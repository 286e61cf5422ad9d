"""The port's anomaly corpus (``repro_torch.core.corpus``).

* The unit cases of ``tests/test_corpus_unit.py`` on the port's corpus,
  minimizer and drivers, against a synthetic engine that plants a hidden
  rule (no trace): dedup and merge rules, ddmin reduction, condition
  tightening, driver wiring and replay drift detection.
* The static invariants of ``tests/test_corpus_regression.py`` on the
  committed corpus (``benchmarks/results/anomaly_corpus.json``), loaded and
  saved by the port.
* The port's replay of the committed corpus (its engine's traces on fake
  cpu tensors), every one of the 8 entries held to the reference's verdict
  today, ``parity.REPLAY_REFERENCE`` (the committed verdicts of the two
  mixtral-8x7b A1 entries fail in the reference too), except the listed
  ``parity.REPLAY_DIFFERENCES``; a fresh replay by the reference, in a
  subprocess with 32 host devices, is held to that table.
"""
import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import anomaly as anomaly_mod
from repro_torch.core import parity
from repro_torch.core.corpus import (Corpus, CorpusEntry, apply_update, replay,
                                     signature)
from repro_torch.core.mfs import MFS, construct_mfs
from repro_torch.core.minimize import (baseline_point, boundary_controls,
                                       minimize_witness, tighten_conditions,
                                       witness_size)
from repro_torch.core.random_search import random_search
from repro_torch.core.sa import simulated_annealing
from repro_torch.core.searchspace import UNCOUPLED, SearchSpace

ROOT = pathlib.Path(__file__).resolve().parents[1]
CORPUS_PATH = ROOT / "benchmarks" / "results" / "anomaly_corpus.json"
CORPUS = Corpus.load(str(CORPUS_PATH))
LIVE = [e for e in CORPUS.ordered() if not e.retired]

ARCHS = {n: smoke_config(n) for n in ["qwen2-1.5b", "rwkv6-7b"]}
SHAPES = {"train_s": ShapeSpec("train_s", "train", 64, 8),
          "decode_s": ShapeSpec("decode_s", "decode", 256, 8)}


def make_space():
    return SearchSpace(ARCHS, SHAPES)


class FakeEngine:
    """Synthetic subsystem (``tests/test_mfs_search.py``'s, on the port's
    space): a hidden rule raises the anomaly, and a counter moves with the
    share of the rule a point matches."""

    def __init__(self, space, rule: dict, kind="A2"):
        self.space = space
        self.rule = rule          # factor -> triggering value set
        self.kind = kind
        self.n_compiles = 0
        self.compile_time = 0.0
        self.measured = []

    def measure(self, p):
        p = self.space.normalize(p)
        if not self.space.valid(p):
            return None
        self.n_compiles += 1
        self.measured.append(dict(p))
        frac = sum(p.get(f) in vs for f, vs in self.rule.items()) / max(len(self.rule), 1)
        trig = frac == 1.0
        out = {"perf.roofline_efficiency": 0.1 if trig else 0.6 - 0.2 * frac,
               "perf.useful_flops_ratio": 0.9,
               "diag.collective_blowup": 1.0 + 2.5 * frac,
               "diag.hbm_oversubscribed": 0.5}
        if trig and self.kind == "A2":
            out["diag.collective_blowup"] = 20.0
        if trig and self.kind == "A4":
            out["diag.hbm_oversubscribed"] = 2.0
        return out


def find_witness(eng, space, seed=0, kind="A2"):
    rng = random.Random(seed)
    for _ in range(4000):
        p = space.random_point(rng)
        m = eng.measure(p)
        if m and kind in anomaly_mod.kinds(m, p["remat"]):
            return p
    raise AssertionError("planted rule unreachable")


# ---------------------------------------------------------------- signature
def test_signature_projects_onto_uncoupled_factors():
    conds = {"preset": ("dp",), "arch": ("a", "b"), "shape": ("s",),
             "n_microbatch": (2, 4), "mesh": ("multi",)}
    sig = signature("A2", conds)
    assert sig == "A2;mesh=multi;preset=dp"
    # coupled/workload conditions don't contribute to identity
    assert signature("A2", {k: conds[k] for k in ("preset", "mesh")}) == sig
    assert signature("A1", conds) != sig
    for f in sig.split(";")[1:]:
        assert f.split("=")[0] in UNCOUPLED


# ------------------------------------------------------------- dedup/merge
def test_add_dedups_updates_hits_and_keeps_smaller_witness():
    space = make_space()
    big = space.normalize({**baseline_point(space, "qwen2-1.5b", "train_s"),
                           "preset": "dp", "mesh": "multi",
                           "optimizer": "sgdm", "params_f32": False})
    small = space.normalize({**baseline_point(space, "qwen2-1.5b", "train_s"),
                             "preset": "dp"})
    conds = {"preset": ("dp",)}
    c = Corpus()
    e = c.add(MFS("A2", conds, big), source="sa:diag.collective_blowup")
    assert e.hits == 1 and witness_size(e.witness) == witness_size(big)
    e2 = c.add(MFS("A2", conds, small), source="random")
    assert len(c) == 1 and e2 is e
    assert e.hits == 2
    assert e.witness == small                  # smaller witness won
    assert e.raw_witness == big                # hardest raw witness retained
    assert e.sources == ["sa:diag.collective_blowup", "random"]
    # a bigger re-discovery does not displace the smaller witness
    c.add(MFS("A2", conds, big), source="random")
    assert e.hits == 3 and e.witness == small


def test_minimized_entry_outranks_raw_regardless_of_size():
    conds = {"preset": ("dp",)}
    c = Corpus()
    c.add_entry(CorpusEntry(signature("A2", conds), "A2", conds,
                            {"preset": "dp"}, {"preset": "dp"},
                            distance=1, raw_distance=1, minimized=True))
    raw = CorpusEntry(signature("A2", conds), "A2", conds,
                      {"preset": "dp", "mesh": "multi"},
                      {"preset": "dp", "mesh": "multi"},
                      distance=0, raw_distance=0)  # claims smaller, not minimized
    e = c.add_entry(raw)
    assert e.minimized and e.witness == {"preset": "dp"}


def test_rediscovery_unretires_a_retired_entry():
    """A retired entry that a later campaign rediscovers is live again —
    otherwise a regressed anomaly would stay silently excluded from replay."""
    conds = {"preset": ("dp",)}
    c = Corpus()
    e = c.add_entry(CorpusEntry(
        signature("A2", conds), "A2", conds, {"preset": "dp"},
        {"preset": "dp"}, distance=1, raw_distance=1, minimized=True,
        retired=True))
    c.add(MFS("A2", conds, {"preset": "dp", "mesh": "multi"}), source="rerun")
    assert not e.retired
    assert e.minimized and e.witness == {"preset": "dp"}  # witness kept
    # merging in a corpus that itself retired the entry does NOT retire ours
    other = Corpus()
    other.add_entry(CorpusEntry(
        signature("A2", conds), "A2", conds, {"preset": "dp"},
        {"preset": "dp"}, distance=1, raw_distance=1, retired=True))
    c.merge(other)
    assert not e.retired


def test_merge_combines_corpora():
    conds_a = {"preset": ("dp",)}
    conds_b = {"seq_shard": (False,)}
    a, b = Corpus(), Corpus()
    a.add(MFS("A2", conds_a, {"preset": "dp"}), source="run-a")
    b.add(MFS("A2", conds_a, {"preset": "dp"}), source="run-b")
    b.add(MFS("A4", conds_b, {"seq_shard": False}), source="run-b")
    a.merge(b)
    assert len(a) == 2
    merged = a.entries[signature("A2", conds_a)]
    assert merged.hits == 2 and merged.sources == ["run-a", "run-b"]
    # merge copied, not aliased: mutating b later cannot corrupt a
    b.entries[signature("A4", conds_b)].witness["seq_shard"] = True
    assert a.entries[signature("A4", conds_b)].witness["seq_shard"] is False


def test_corpus_save_load_round_trip(tmp_path):
    space = make_space()
    eng = FakeEngine(space, {"preset": frozenset(["dp"])})
    w = find_witness(eng, space)
    c = Corpus(meta={"scale": "bench", "archs": ["qwen2-1.5b"]})
    c.add(construct_mfs(eng, space, w, "A2", eng.measure(w)), source="t")
    p = str(tmp_path / "c.json")
    c.save(p)
    back = Corpus.load(p)
    assert back.meta == c.meta
    (e,), (e2,) = c.ordered(), back.ordered()
    assert e2 == e


# -------------------------------------------------------------- minimizer
def test_minimize_reaches_planted_rule_exactly():
    space = make_space()
    rule = {"preset": frozenset(["dp"]), "seq_shard": frozenset([False])}
    eng = FakeEngine(space, rule)
    w = find_witness(eng, space)
    mr = minimize_witness(eng, space, w, "A2")
    assert mr.triggered
    assert mr.distance < mr.raw_distance       # strict reduction
    assert mr.point["preset"] == "dp" and mr.point["seq_shard"] is False
    # 1-minimal: everything else sits at the canonical baseline
    base = baseline_point(space, mr.point["arch"], mr.point["shape"])
    off = [f for f in space.factors
           if f not in ("arch", "shape") and mr.point[f] != base[f]]
    assert sorted(off) == ["preset", "seq_shard"] == list(mr.kept)
    assert mr.distance == witness_size(mr.point) == 2


def test_minimize_workload_intrinsic_anomaly_hits_distance_zero():
    space = make_space()
    # the rule covers the baseline itself (scan_layers defaults True):
    # the anomaly is intrinsic to the cell, so ddmin reaches distance 0
    eng = FakeEngine(space, {"scan_layers": frozenset([True])})
    w = space.normalize({**baseline_point(space, "qwen2-1.5b", "train_s"),
                         "preset": "tp", "optimizer": "sgdm",
                         "mesh": "multi"})
    mr = minimize_witness(eng, space, w, "A2")
    assert mr.triggered and mr.distance == 0 and mr.kept == ()
    assert mr.n_probes == 2                    # verify + baseline, nothing else


def test_minimize_untriggered_witness_reports_not_triggered():
    space = make_space()
    eng = FakeEngine(space, {"preset": frozenset(["dp"])})
    w = space.normalize({**baseline_point(space, "qwen2-1.5b", "train_s"),
                         "preset": "tp"})
    mr = minimize_witness(eng, space, w, "A2")
    assert not mr.triggered
    assert mr.point == w                       # untouched


def test_minimize_within_mfs_never_leaves_conditions():
    space = make_space()
    rule = {"preset": frozenset(["dp"])}
    eng = FakeEngine(space, rule)
    w = find_witness(eng, space)
    fence = MFS("A2", {"preset": ("dp",), "mesh": (w["mesh"],)}, dict(w))
    mr = minimize_witness(eng, space, w, "A2", within=fence)
    assert mr.triggered and fence.matches(mr.point)
    assert mr.point["mesh"] == w["mesh"]       # fenced factor kept


def test_minimize_respects_probe_budget():
    space = make_space()
    rule = {"preset": frozenset(["dp"]), "seq_shard": frozenset([False]),
            "mesh": frozenset(["multi"])}
    eng = FakeEngine(space, rule)
    w = find_witness(eng, space)
    mr = minimize_witness(eng, space, w, "A2", max_probes=3)
    assert mr.n_probes <= 3 + 2                # one in-flight round may finish
    assert mr.triggered
    # budget exhaustion still returns a verified-triggering point
    m = eng.measure(mr.point)
    assert "A2" in anomaly_mod.kinds(m, mr.point["remat"])


# ------------------------------------------------------------- tightening
def test_tighten_drops_unsound_pairwise_claims():
    space = make_space()

    class XorEngine(FakeEngine):
        """Anomaly iff preset=dp OR seq_shard=False — each single-factor
        probe from a (dp, False) witness stays triggered, so construct_mfs
        over-claims the conjunction; pairwise probes must repair it."""

        def measure(self, p):
            p = self.space.normalize(p)
            if not self.space.valid(p):
                return None
            self.n_compiles += 1
            trig = p["preset"] == "dp" or p["seq_shard"] is False
            return {"perf.roofline_efficiency": 0.6,
                    "perf.useful_flops_ratio": 0.9,
                    "diag.collective_blowup": 20.0 if trig else 1.0,
                    "diag.hbm_oversubscribed": 0.5}

    eng = XorEngine(space, {})
    w = space.normalize({**baseline_point(space, "qwen2-1.5b", "train_s"),
                         "preset": "dp", "seq_shard": False})
    mfs = construct_mfs(eng, space, w, "A2", eng.measure(w))
    # construct_mfs saw every alternative stay triggered -> no conditions on
    # preset/seq_shard at all, or over-wide ones; plant an over-claimed MFS
    over = MFS("A2", {"preset": ("dp", "tp"), "seq_shard": (False, True)},
               dict(w))
    assert over.matches({**w, "preset": "tp", "seq_shard": True})  # unsound
    tight = tighten_conditions(eng, space, over)
    assert not tight.matches({**w, "preset": "tp", "seq_shard": True})
    assert tight.matches(w)                    # witness always survives
    assert tight.n_tests > over.n_tests


def test_boundary_controls_verified_not_triggering():
    space = make_space()
    rule = {"preset": frozenset(["dp"])}
    eng = FakeEngine(space, rule)
    w = find_witness(eng, space)
    mfs = construct_mfs(eng, space, w, "A2", eng.measure(w))
    mr = minimize_witness(eng, space, w, "A2", within=mfs)
    ctls = boundary_controls(eng, space, mr.point, "A2", mfs.conditions)
    assert ctls, "no controls found for a single-factor rule"
    for c in ctls:
        m = eng.measure(c)
        assert "A2" not in anomaly_mod.kinds(m, c["remat"])


# ------------------------------------------------------- driver wiring
def test_drivers_emit_finds_into_corpus_without_perturbing_trajectory():
    space = make_space()
    rule = {"preset": frozenset(["dp"])}

    def run(corpus):
        eng = FakeEngine(space, rule)
        r = simulated_annealing(eng, space, "diag.collective_blowup", "max",
                                seed=0, budget_compiles=150, corpus=corpus)
        return r, eng.measured

    corpus = Corpus()
    r_with, measured_with = run(corpus)
    r_without, measured_without = run(None)
    assert r_with.anomalies and len(corpus) >= 1
    assert measured_with == measured_without   # corpus is pure bookkeeping
    for e in corpus.ordered():
        assert any(s.startswith("sa:") for s in e.sources)

    eng = FakeEngine(space, rule)
    r = random_search(eng, space, seed=3, budget_compiles=200,
                      mfs_skip=True, mfs_construct=True, corpus=corpus)
    if r.anomalies:                            # re-discovery merges, not dups
        sig = signature(r.anomalies[0].kind, r.anomalies[0].conditions)
        if sig in corpus.entries:
            assert corpus.entries[sig].hits >= 2


# ------------------------------------------------------------------ replay
def test_replay_detects_untriggering_and_widening_and_update_accepts():
    space = make_space()
    rule = {"preset": frozenset(["dp"])}
    eng = FakeEngine(space, rule)
    w = find_witness(eng, space)
    mfs = construct_mfs(eng, space, w, "A2", eng.measure(w))
    mr = minimize_witness(eng, space, w, "A2", within=mfs)
    ctls = boundary_controls(eng, space, mr.point, "A2", mfs.conditions)
    corpus = Corpus()
    corpus.add_entry(CorpusEntry(
        signature("A2", mfs.conditions), "A2",
        {k: tuple(v) for k, v in mfs.conditions.items()},
        mr.point, space.normalize(w), distance=mr.distance,
        raw_distance=mr.raw_distance, minimized=True, controls=ctls))

    ok = replay(corpus, FakeEngine(space, rule), space)
    assert len(ok) == 1 and ok[0]["ok"]

    # the anomaly un-triggers (rule moved): kind_ok flips
    gone = replay(corpus, FakeEngine(space, {"preset": frozenset(["ep"])}),
                  space)
    assert not gone[0]["kind_ok"] and not gone[0]["ok"]

    # the anomaly widens (rule relaxed to every preset): controls fire
    any_preset = {"preset": frozenset(space.factors["preset"])}
    wide = replay(corpus, FakeEngine(space, any_preset), space)
    assert wide[0]["kind_ok"] and not wide[0]["controls_ok"]

    # --corpus-update accepts both drifts
    e = corpus.ordered()[0]
    apply_update(corpus, gone)
    assert e.retired
    e.retired = False
    apply_update(corpus, wide)
    assert not e.retired and e.controls == []  # flipped controls dropped
    again = replay(corpus, FakeEngine(space, any_preset), space)
    assert again[0]["ok"]


# ------------------------------------------------ the committed corpus, static

def _recorded_space():
    from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs
    meta = CORPUS.meta
    restrict = {k: tuple(v) for k, v in (meta.get("restrict") or {}).items()}
    return SearchSpace(bench_archs(meta["archs"]), BENCH_SHAPES, restrict=restrict or None)


def test_corpus_nonempty_and_signatures_unique():
    assert len(LIVE) == 8
    sigs = [e.signature for e in CORPUS.ordered()]
    assert len(sigs) == len(set(sigs))
    for e in CORPUS.ordered():
        assert e.signature == signature(e.kind, e.conditions), e.signature


def test_corpus_schema_version_rejects_unknown(tmp_path):
    data = json.loads(CORPUS_PATH.read_text())
    data["schema"] = 999
    p = tmp_path / "bad.json"
    p.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="schema"):
        Corpus.load(str(p))


def test_witnesses_valid_and_normalized_in_recorded_space():
    space = _recorded_space()
    for e in LIVE:
        for name, p in [("witness", e.witness), ("raw", e.raw_witness)]:
            assert space.valid(p), (e.signature, name)
            assert p == space.normalize(p), (e.signature, name)
        for c in e.controls:
            assert space.valid(c), (e.signature, "control")


def test_minimizer_strictly_reduced_every_witness():
    for e in LIVE:
        assert e.minimized, e.signature
        assert e.distance == witness_size(e.witness), e.signature
        assert e.raw_distance == witness_size(e.raw_witness), e.signature
        assert e.distance < e.raw_distance, e.signature


def test_minimized_witness_still_matches_conditions():
    for e in LIVE:
        assert e.to_mfs().matches(e.witness), e.signature
        for c in e.controls:
            assert c != e.witness, e.signature


def test_corpus_roundtrip_is_stable(tmp_path):
    """save(load(x)) == x byte for byte, as in the reference."""
    p = tmp_path / "roundtrip.json"
    CORPUS.save(str(p))
    assert p.read_text() == CORPUS_PATH.read_text()


# ------------------------------------------------ the replay, against today's reference

_REF_REPLAY = r"""
import json, sys
from repro.core.corpus import Corpus, bench_space_and_engine, replay
corpus = Corpus.load(sys.argv[1])
space, engine = bench_space_and_engine(corpus.meta, n_workers=4)
reports = replay(corpus, engine, space)
engine.close()
print(json.dumps({r["signature"]: [r["kind_ok"], r["controls_ok"]] for r in reports}))
"""


@pytest.fixture(scope="module")
def replays(tmp_path_factory):
    """The port's replay of the committed corpus (fake cpu tensors) and the
    reference's, run at once: -> (port reports by signature, reference
    verdicts by signature, the port's engine)."""
    from repro_torch.core.corpus import bench_space_and_engine
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _REF_REPLAY, str(CORPUS_PATH)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    space, engine = bench_space_and_engine(CORPUS.meta, device="cpu")
    reports = {r["signature"]: r for r in replay(CORPUS, engine, space)}
    engine.close()
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-3000:]
    ref = {k: tuple(v) for k, v in json.loads(out.strip().splitlines()[-1]).items()}
    return reports, ref, engine


@pytest.mark.parametrize("sig", [e.signature for e in LIVE])
def test_port_replay_gives_the_reference_verdict(replays, sig):
    reports, ref, engine = replays
    assert engine.n_failures == 0, engine.errors
    assert not parity.unlisted_at(engine.replicated_at)
    # the verdict the port keeps is the reference's today
    assert parity.REPLAY_REFERENCE[sig] == ref[sig]
    rep = reports[sig]
    got = (rep["kind_ok"], rep["controls_ok"])
    listed = parity.REPLAY_DIFFERENCES.get(sig)
    if listed is None:
        assert got == ref[sig], (sig, rep["observed_kinds"], rep["controls"])
    else:
        assert (got, ref[sig]) == listed[:2]
    assert sig not in parity.unlisted_replay_differences([rep])


def test_replay_cli_holds_the_port_to_the_reference(tmp_path, monkeypatch):
    """``python -m repro_torch.core.corpus replay --parity``, here with its
    engine's traces replaced by the verdict-giving counters of a planted
    rule: the CLI reports every entry and exits 0 only when no verdict
    differs from the kept ones unlisted."""
    from repro_torch.core import corpus as corpus_mod
    from repro_torch.core import engine as engine_mod
    seen = []

    def fake_measure_batch(self, points, **kw):
        seen.extend(points)
        return [None if p["arch"] == "never" else
                {"perf.roofline_efficiency": 0.6, "perf.useful_flops_ratio": 0.9,
                 "diag.collective_blowup": 1.0, "diag.hbm_oversubscribed": 0.5}
                for p in points]
    monkeypatch.setattr(engine_mod.Engine, "measure_batch", fake_measure_batch)
    out = tmp_path / "report.json"
    rc = corpus_mod.main(["replay", str(CORPUS_PATH), "--device", "cpu", "--parity",
                          "--json", str(out)])
    report = json.loads(out.read_text())
    assert len(report["reports"]) == 8 and len(seen) == 16
    # no anomaly anywhere: every witness drifts, which the reference does not
    assert rc == 1
    assert sorted(report["unlisted_replay_differences"]) == sorted(
        s for s, v in parity.REPLAY_REFERENCE.items() if v[0])
