"""The port's engine on stubbed traces: the invariants of the JAX package's
``test_engine_concurrency.py``, ``test_split_phase.py`` and
``test_fidelity_parity.py``, and the same stub fed to both packages' engines.

The trace layer is replaced by instant deterministic stubs, as those tests
replace the compile layer: ``repro_torch.core.engine.build_cell`` and
``counters_mod.lower_cell`` / ``compile_lowered`` / ``lowered_counters``.

* accounting, dedup, persistence, structural dedup, ``measure_full``,
  ``counter_names``, the fidelity-1 tier, prescreening, calibration and the
  ``COLLIE_*`` variables behave as in the reference;
* over one fixed sequence of batches (prescreen on and off, struct dedup on
  and off) both packages' engines give equal results and equal ``stats()``
  (host times aside), and equal SA trajectories;
* ``space_fingerprint`` differs between the packages and between trace
  device types;
* an engine is built over every arch of the zoo and every ``grad_compress``
  value, and over a space whose ``restrict`` narrows its ``arch`` factor.
"""
import json
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest

import repro.core.engine as ref_engine_mod
import repro_torch.core.engine as engine_mod
from repro.configs.all_archs import smoke_config as ref_smoke_config
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.core import measure_cache as ref_measure_cache
from repro.core.sa import simulated_annealing as ref_simulated_annealing
from repro.core.searchspace import SearchSpace as RefSpace
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core import batching, parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs
from repro_torch.core.bo import _gp_posterior, _GPState
from repro_torch.core.engine import Engine
from repro_torch.core.measure_cache import MeasureCache, point_key_str, space_fingerprint
from repro_torch.core.mfs import construct_mfs
from repro_torch.core.minimize import minimize_witness
from repro_torch.core.sa import simulated_annealing
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.surrogate import Surrogate

_RESTRICT = {"optimizer": ("adamw",), "grad_compress": ("none",),
             "n_microbatch": (1, 2), "capacity_factor": (1.25,),
             "attn_impl": ("auto", "plain"), "remat": ("none", "dots")}


def _shapes(cls):
    return {"train_s": cls("train_s", "train", 64, 8),
            "decode_s": cls("decode_s", "decode", 256, 8)}


def small_space():
    return SearchSpace({"qwen2-1.5b": smoke_config("qwen2-1.5b")}, _shapes(ShapeSpec),
                       restrict=_RESTRICT)


def ref_small_space():
    return RefSpace({"qwen2-1.5b": ref_smoke_config("qwen2-1.5b")}, _shapes(RefShapeSpec),
                    restrict=_RESTRICT)


# --------------------------------------------------------- stubbed traces
def _h(cell):
    return sum(map(ord, "".join(map(str, cell))))


class _StubMeasurement:
    def __init__(self, h, blowup=None):
        self.perf = {"roofline_efficiency": 0.2 + (h % 7) * 0.1,
                     "useful_flops_ratio": 0.3 + (h % 5) * 0.1}
        self.diag = {"collective_blowup": 1.0 + (h % 9) if blowup is None else blowup,
                     "memory_overshoot": 1.0 + (h % 3),
                     "hbm_oversubscribed": 0.4}
        self.hlo = {"replicated_ops": {"aten.view.default": 1}} if h % 2 == 0 else {}


class _FakeLowered:
    def __init__(self, cell, fp):
        self.cell = cell
        self.fingerprint = fp


def _stub(monkeypatch, mod=engine_mod, fp_of=None, fail_on=(), blowup=None):
    """Instant split-phase stubs on ``mod`` (either package's engine module);
    ``fp_of(cell)`` controls aliasing (default: fp-equal iff to_run-equal).
    -> the list of cells the compile phase ran on."""
    calls = []

    def fake_build_cell(cfg, shape, policy, mesh, opt):
        return (cfg.name, shape.name, str(policy))

    def fake_lower_cell(cell, chip=None, device=None, fingerprint=True):
        return _FakeLowered(cell, "fp:" + (repr(cell) if fp_of is None else fp_of(cell)))

    def fake_compile_lowered(lc, chip=None):
        calls.append(lc.cell)
        if lc.cell[1] in fail_on:
            raise RuntimeError("planted trace failure")
        return _StubMeasurement(_h(lc.cell), blowup)

    def fake_lowered_counters(lc, chip=None):
        h = _h(lc.cell)
        return {"perf.roofline_efficiency": 0.1 + (h % 11) * 0.05,
                "perf.useful_flops_ratio": 0.2 + (h % 7) * 0.05,
                "diag.transpose_bytes": float(h % 13) * 1e5}

    monkeypatch.setattr(mod, "build_cell", fake_build_cell)
    monkeypatch.setattr(mod.counters_mod, "lower_cell", fake_lower_cell)
    monkeypatch.setattr(mod.counters_mod, "compile_lowered", fake_compile_lowered)
    monkeypatch.setattr(mod.counters_mod, "lowered_counters", fake_lowered_counters)
    return calls


def _meshes():
    return {"single": object(), "multi": object()}


def _engine(space=None, **kw):
    kw.setdefault("persistent_cache", False)
    return Engine(space or small_space(), _meshes(), device="cpu", **kw)


def _distinct_points(space, n, seed):
    rng = random.Random(seed)
    pts, keys = [], set()
    while len(pts) < n:
        p = {**space.random_point(rng), "mesh": "single"}
        if space.point_key(p) not in keys:
            keys.add(space.point_key(p))
            pts.append(p)
    return pts


def _aliasing_pair(space):
    """Distinct keys, identical stub cells: the stub ignores the mesh kind."""
    p = space.normalize({**space.random_point(random.Random(0)), "mesh": "single"})
    q = space.normalize({**p, "mesh": "multi"})
    assert space.point_key(p) != space.point_key(q)
    return p, q


def _sa_fingerprint(r):
    return ([(tuple(sorted(e.point.items())), tuple(sorted(e.kinds)), e.counter_value,
              e.n_spent, e.new_mfs is None) for e in r.events],
            [(m.kind, tuple(sorted(m.conditions.items()))) for m in r.anomalies],
            r.n_attempts)


def _run_sa(space, fidelity, n_workers, **kw):
    eng = _engine(space, n_workers=n_workers, **kw)
    r = simulated_annealing(eng, space, "diag.collective_blowup", "max", seed=5,
                            budget_compiles=30, fidelity=fidelity)
    eng.close()
    return _sa_fingerprint(r)


# ------------------------------------------------------------- accounting
def test_unique_point_charges_once(monkeypatch):
    calls = _stub(monkeypatch)
    space = small_space()
    eng = _engine(space)
    p = {**space.random_point(random.Random(0)), "mesh": "single"}
    assert eng.measure(p) is eng.measure(p)
    assert eng.n_attempts == 1 and eng.n_compiles == 1 and len(calls) == 1
    assert eng.n_cache_hits == 1


def test_failed_trace_counts_as_attempt_and_is_kept(monkeypatch):
    _stub(monkeypatch, fail_on=("train_s", "decode_s"))
    space = small_space()
    eng = _engine(space)
    p = {**space.random_point(random.Random(0)), "mesh": "single"}
    assert eng.measure(p) is None
    assert eng.measure(p) is None            # cached failure, no recharge
    s = eng.stats()
    assert s["n_attempts"] == 1 and s["n_failures"] == 1 and s["n_compiles"] == 0
    assert s["n_cache_hits"] == 1
    assert eng.errors == ["compile failed: RuntimeError: planted trace failure"]


def test_measure_batch_dedups_and_aligns(monkeypatch):
    calls = _stub(monkeypatch)
    space = small_space()
    eng = _engine(space, n_workers=4)
    a, b, c = _distinct_points(space, 3, 1)
    results = eng.measure_batch([a, b, a, c, b])
    assert len(results) == 5
    assert results[0] is results[2] and results[1] is results[4]
    assert len(calls) == 3 and eng.n_attempts == 3


@pytest.mark.parametrize("var", ["COLLIE_WORKERS", "COLLIE_PRESCREEN"])
def test_env_integers_reject_garbage(monkeypatch, var):
    _stub(monkeypatch)
    monkeypatch.setenv(var, "nope")
    with pytest.raises(ValueError, match=var):
        _engine()


def test_replicated_ops_are_summed(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    eng = _engine(space)
    pts = _distinct_points(space, 8, 11)
    eng.measure_batch(pts)
    cells = {(space.archs[p["arch"]].name, p["shape"], str(space.to_run(p)[2])) for p in pts}
    want = sum(1 for c in cells if _h(c) % 2 == 0)
    assert want > 0 and eng.replicated_ops == {"aten.view.default": want}
    # a stand-in cell has no point class: every op it ran replicated is unlisted
    assert eng.replicated_at == {None: {"aten.view.default": want}}
    assert parity.unlisted_at(eng.replicated_at) == [(None, "aten.view.default")]


# ------------------------------------------------------------- persistence
def test_persistent_cache_warm_start(monkeypatch, tmp_path):
    calls = _stub(monkeypatch, fail_on=("decode_s",))
    space = small_space()
    path = str(tmp_path / "cache.sqlite")
    rng = random.Random(2)
    pts = [{**space.random_point(rng), "mesh": "single"} for _ in range(6)]
    cold = _engine(space, persistent_cache=path)
    cold_results = cold.measure_batch(pts)
    n_cold = len(calls)
    assert n_cold > 0
    warm = _engine(space, persistent_cache=path)
    warm_results = warm.measure_batch(pts)
    assert len(calls) == n_cold              # no retrace, failures included
    assert warm.n_compiles == 0 and warm.n_failures == 0 and warm.n_disk_hits > 0
    assert warm_results == cold_results
    assert warm.n_attempts == cold.n_attempts


def test_collie_cache_env_var(monkeypatch, tmp_path):
    _stub(monkeypatch)
    monkeypatch.setenv("COLLIE_CACHE", str(tmp_path / "envcache.sqlite"))
    eng = _engine(persistent_cache=None)
    assert eng.persistent is not None
    eng.measure({**eng.space.random_point(random.Random(3)), "mesh": "single"})
    assert eng.persistent.size(eng.space_fp) == 1


def test_space_fingerprint_sensitivity():
    fp = space_fingerprint(small_space())
    other = SearchSpace({"qwen2-1.5b": smoke_config("qwen2-1.5b")},
                        {"train_s": ShapeSpec("train_s", "train", 128, 8)})
    assert fp != space_fingerprint(other)
    assert fp == space_fingerprint(small_space())


def test_space_fingerprint_differs_by_package_and_device():
    """A cache shared with the JAX package never serves its counters to the
    port, nor a cpu trace's to a cuda engine."""
    meshes = {"single": None}
    port = {d: space_fingerprint(small_space(), meshes, d) for d in ("cpu", "cuda")}
    ref = ref_measure_cache.space_fingerprint(ref_small_space(), meshes)
    assert len({port["cpu"], port["cuda"], ref}) == 3
    assert space_fingerprint(small_space(), meshes) == port["cuda"]   # the default
    assert space_fingerprint(small_space(), meshes, "cuda:0") == port["cuda"]


def test_space_fingerprint_follows_the_port_sources(monkeypatch, tmp_path):
    """The port's own code decides its counters: a cache filled by another
    version of the package (failed traces included) is not served to this
    one.  The digest reads every source file of the package."""
    from repro_torch.core import measure_cache
    fp = space_fingerprint(small_space())
    monkeypatch.setattr(measure_cache, "source_digest", lambda: "another version")
    assert space_fingerprint(small_space()) != fp
    monkeypatch.undo()
    assert space_fingerprint(small_space()) == fp
    digest = measure_cache.source_digest()
    assert len(digest) == 64
    root = pathlib.Path(measure_cache.__file__).resolve().parents[1]
    copy = tmp_path / "repro_torch"
    for p in root.rglob("*.py"):
        (copy / p.relative_to(root)).parent.mkdir(parents=True, exist_ok=True)
        (copy / p.relative_to(root)).write_bytes(p.read_bytes())
    edited = copy / "launch" / "traceanalysis.py"
    edited.write_bytes(edited.read_bytes() + b"\n")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.core.measure_cache import source_digest; print(source_digest())")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out != digest


def test_engine_fingerprint_follows_its_device(monkeypatch, tmp_path):
    _stub(monkeypatch)
    path = str(tmp_path / "c.sqlite")
    fps = {d: Engine(small_space(), _meshes(), persistent_cache=path, device=d).space_fp
           for d in ("cpu", "cuda")}
    assert fps["cpu"] != fps["cuda"]


def test_measure_cache_roundtrip(tmp_path):
    mc = MeasureCache(str(tmp_path / "mc.sqlite"))
    key = (("arch", "a"), ("shape", "s"), ("flag", True), ("n", 4))
    assert mc.get("fp", key) == (False, None)
    mc.put("fp", key, {"perf.x": 1.5, "diag.n": 2, "_measurement": object()})
    assert mc.get("fp", key) == (True, {"perf.x": 1.5, "diag.n": 2})
    mc.put("fp", key, None)                  # failures are remembered
    assert mc.get("fp", key) == (True, None)
    assert mc.size() == 1
    mc.clear()
    assert mc.size() == 0
    mc.close()


def test_get_many_and_put_many(tmp_path):
    mc = MeasureCache(str(tmp_path / "mc.sqlite"))
    keys = [(("arch", "a"), ("n", i)) for i in range(950)]
    mc.put_many("fp", [(k, {"perf.x": float(i)} if i % 5 else None)
                       for i, k in enumerate(keys)])
    got = mc.get_many("fp", keys + [(("arch", "a"), ("n", -1))])
    assert len(got) == 950                   # an absent key is absent
    for i, k in enumerate(keys):
        assert got[point_key_str(k)] == ({"perf.x": float(i)} if i % 5 else None)
    assert mc.get_many("fp", []) == {}
    mc.put_many("fp", [])
    assert mc.size("fp") == 950
    mc.close()


def test_struct_tables_roundtrip_and_clear(tmp_path):
    mc = MeasureCache(str(tmp_path / "mc.sqlite"))
    mc.put_structs("fp", [("aaa", {"perf.x": 1.0}), ("bbb", None)])
    mc.put_fps("fp", [((("arch", "a"),), "aaa")])
    assert mc.get_struct("fp", "aaa") == (True, {"perf.x": 1.0})
    assert mc.get_struct("fp", "bbb") == (True, None)
    assert mc.get_struct("fp", "ccc") == (False, None)
    assert mc.get_fp("fp", (("arch", "a"),)) == "aaa"
    assert mc.get_fp("fp", (("arch", "z"),)) is None
    assert mc.struct_size("fp") == 2
    mc.clear("other")
    assert mc.struct_size("fp") == 2
    mc.clear()
    assert mc.struct_size() == 0 and mc.get_fp("fp", (("arch", "a"),)) is None
    mc.close()


@pytest.mark.parametrize("table", ["put_many", "put_structs", "put_fps"])
def test_engine_flushes_a_batch_in_one_transaction(monkeypatch, tmp_path, table):
    _stub(monkeypatch)
    space = small_space()
    eng = _engine(space, n_workers=4, persistent_cache=str(tmp_path / "c.sqlite"))
    calls = []
    orig = getattr(eng.persistent, table)

    def spy(space_fp, items):
        calls.append(len(list(items)))
        return orig(space_fp, items)

    monkeypatch.setattr(eng.persistent, table, spy)
    eng.measure_batch(_distinct_points(space, 6, 7))
    assert len(calls) == 1 and calls[0] > 0
    eng.close()


# --------------------------------------------------------- structural dedup
def test_struct_dedup_one_trace_identical_dicts_independent_charge(monkeypatch):
    calls = _stub(monkeypatch)
    space = small_space()
    eng = _engine(space)
    p, q = _aliasing_pair(space)
    rp, rq = eng.measure_batch([p, q])
    assert rp is not None and rp == rq and len(calls) == 1
    s = eng.stats()
    assert (s["n_compiles"], s["n_struct_hits"], s["n_lowerings"], s["n_attempts"]) \
        == (1, 1, 2, 2)
    eng.close()


def test_struct_dedup_across_engines_via_persistent_cache(monkeypatch, tmp_path):
    calls = _stub(monkeypatch)
    space = small_space()
    path = str(tmp_path / "c.sqlite")
    p, q = _aliasing_pair(space)
    e1 = _engine(space, persistent_cache=path)
    assert e1.measure(p) is not None
    assert e1.persistent.struct_size(e1.space_fp) == 1
    e1.close()
    e2 = _engine(space, persistent_cache=path)
    assert e2.measure(q) is not None and len(calls) == 1
    assert e2.n_compiles == 0 and e2.n_struct_hits == 1 and e2.n_disk_hits == 0
    e2.close()


def test_struct_dedup_disabled_traces_both(monkeypatch):
    calls = _stub(monkeypatch)
    eng = _engine(struct_dedup=False)
    p, q = _aliasing_pair(eng.space)
    rp, rq = eng.measure_batch([p, q])
    assert rp == rq and len(calls) == 2 and eng.n_struct_hits == 0
    monkeypatch.setenv("COLLIE_STRUCT", "0")
    assert not _engine().struct_dedup
    monkeypatch.delenv("COLLIE_STRUCT")
    assert _engine().struct_dedup


def test_struct_dedup_shares_planted_failures(monkeypatch):
    calls = _stub(monkeypatch, fail_on=("train_s", "decode_s"))
    eng = _engine()
    p, q = _aliasing_pair(eng.space)
    assert eng.measure(p) is None and eng.measure(q) is None
    assert len(calls) == 1 and eng.n_failures == 1
    assert eng.n_struct_hits == 1 and eng.n_attempts == 2


# ------------------------------------------------------------ measure_full
def test_measure_full_rebuilds_from_disk_hit(monkeypatch, tmp_path):
    calls = _stub(monkeypatch)
    space = small_space()
    path = str(tmp_path / "c.sqlite")
    p = {**space.random_point(random.Random(1)), "mesh": "single"}
    cold = _engine(space, persistent_cache=path)
    flat = cold.measure(p)
    cold.close()
    warm = _engine(space, persistent_cache=path)
    assert warm.measure(p) == flat and warm.n_disk_hits == 1 and warm.n_compiles == 0
    m = warm.measure_full(p)
    assert isinstance(m, _StubMeasurement) and warm.n_compiles == 1 and len(calls) == 2
    assert warm.measure_full(p) is m and warm.n_compiles == 1 and warm.n_attempts == 1
    assert warm.measure_full({**p, "mesh": "missing"}) is None


def test_measure_full_bypasses_struct_dedup(monkeypatch):
    calls = _stub(monkeypatch)
    eng = _engine()
    p, q = _aliasing_pair(eng.space)
    eng.measure(p)
    assert eng.measure(q) is not None and len(calls) == 1
    assert isinstance(eng.measure_full(q), _StubMeasurement) and len(calls) == 2


def test_counter_names_uncharged(monkeypatch):
    _stub(monkeypatch)
    eng = _engine()
    p = {**eng.space.random_point(random.Random(2)), "mesh": "single"}
    names = eng.counter_names(p)
    assert "perf.roofline_efficiency" in names["perf"]
    assert eng.n_attempts == 0 and eng.n_compiles == 1
    assert eng.measure(p) is not None
    assert eng.n_attempts == 1 and eng.n_compiles == 1


# ------------------------------------------------------------- fidelity 1
def test_measure_lowered_uncharged_and_cached(monkeypatch):
    calls = _stub(monkeypatch)
    eng = _engine()
    p = {**eng.space.random_point(random.Random(4)), "mesh": "single"}
    lo = eng.measure_lowered(p)
    assert lo is not None and "perf.useful_flops_ratio" in lo
    assert "diag.collective_blowup" in lo    # the surrogate's overlay
    assert eng.n_attempts == 0 and eng.n_compiles == 0 and not calls
    eng.measure_lowered(p)
    assert eng.n_lowerings == 1 and eng.stats()["n_lowered_served"] == 2
    bad = {**p, "mesh": "missing"}
    outs = eng.measure_lowered_batch([p, bad, p])
    assert outs[0] == outs[2] is not None and outs[1] is None


def test_lowered_key_persisted_across_engines(monkeypatch, tmp_path):
    _stub(monkeypatch)
    path = str(tmp_path / "c.sqlite")
    eng = _engine(persistent_cache=path)
    p, q = _aliasing_pair(eng.space)
    assert eng.lowered_key(p) == eng.lowered_key(q) and eng.n_lowerings == 2
    fp = eng.lowered_key(p)
    eng.measure(p)
    eng.close()
    eng2 = _engine(persistent_cache=path)
    assert eng2.lowered_key(p) == fp and eng2.n_lowerings == 0


def test_lowered_feeds_second_calibrator_channel(monkeypatch):
    _stub(monkeypatch)
    eng = _engine()
    p = {**eng.space.random_point(random.Random(5)), "mesh": "single"}
    eng.measure_lowered(p)
    assert eng.surrogate.lowered_calibrator.n_observed == 0
    eng.measure(p)
    assert eng.surrogate.lowered_calibrator.n_observed == 1


def _scan_alias(cell):
    return repr(cell).replace("scan_layers=False", "scan_layers=True")


def test_construct_mfs_lowered_fp_short_circuit(monkeypatch):
    space = small_space()
    p = space.normalize({**space.random_point(random.Random(6)), "mesh": "single"})
    _stub(monkeypatch, fp_of=_scan_alias, blowup=9.0)
    e_full, e_low = _engine(space), _engine(space)
    full = construct_mfs(e_full, space, p, "A2", fidelity="full")
    low = construct_mfs(e_low, space, p, "A2", fidelity="lowered")
    assert low.n_tests < full.n_tests and e_low.n_attempts < e_full.n_attempts
    assert low.conditions == full.conditions


def test_minimize_lowered_fp_short_circuit(monkeypatch):
    space = small_space()
    base = space.normalize({
        "mesh": "single", "remat": "none", "n_microbatch": 1, "params_f32": True,
        "zero1": True, "optimizer": "adamw", "grad_compress": "none", "preset": "fsdp",
        "seq_shard": True, "cache_shard": True, "vocab_shard": True,
        "scan_layers": False, "attn_impl": "auto", "capacity_factor": 1.25,
        "arch": "qwen2-1.5b", "shape": "train_s"})
    _stub(monkeypatch, fp_of=_scan_alias, blowup=9.0)
    e_full, e_low = _engine(space), _engine(space)
    r_full = minimize_witness(e_full, space, base, "A2", fidelity="full")
    r_low = minimize_witness(e_low, space, base, "A2", fidelity="lowered")
    assert r_low.triggered and r_full.triggered and r_low.point == r_full.point
    assert r_low.n_probes <= r_full.n_probes and e_low.n_attempts < e_full.n_attempts


# ------------------------------------------------------------- calibration
def test_two_channel_calibration_roundtrip(monkeypatch, tmp_path):
    _stub(monkeypatch)
    space = small_space()
    path = str(tmp_path / "calib.json")
    eng = _engine(space, calibrator_path=path)
    pts = [{**space.random_point(random.Random(7)), "mesh": "single"} for _ in range(10)]
    for p in pts:
        eng.measure_lowered(p)
    eng.measure_batch(pts)
    n0, n1 = eng.surrogate.calibrator.n_observed, eng.surrogate.lowered_calibrator.n_observed
    assert n0 > 0 and n1 > 0
    eng.close()
    eng2 = _engine(space, calibrator_path=path)
    assert eng2.surrogate.calibrator.n_observed == n0
    assert eng2.surrogate.lowered_calibrator.n_observed == n1
    legacy = str(tmp_path / "legacy.json")       # a single-channel file loads
    with open(path) as f:
        doc = json.load(f)
    doc.pop("lowered")
    with open(legacy, "w") as f:
        json.dump(doc, f)
    sur = Surrogate(space, {"single": {}})
    assert sur.load_calibration(legacy)
    assert sur.calibrator.n_observed == n0 and sur.lowered_calibrator.n_observed == 0


def test_calibrator_persistence_alongside_cache(monkeypatch, tmp_path):
    _stub(monkeypatch)
    space = small_space()
    path = str(tmp_path / "c.sqlite")
    monkeypatch.setenv("COLLIE_CALIB", "1")
    eng = _engine(space, persistent_cache=path)
    assert eng._calib_path == path + ".calib.json"
    eng.measure_batch([{**space.random_point(random.Random(8)), "mesh": "single"}
                       for _ in range(12)])
    n_obs = eng.surrogate.calibrator.n_observed
    assert n_obs > 0
    eng.close()
    assert _engine(space, persistent_cache=path).surrogate.calibrator.n_observed == n_obs


# ---------------------------------------------------------- multi-fidelity
@pytest.mark.parametrize("fidelity", ["full", "prescreen"])
def test_sa_trajectory_independent_of_workers_surrogate_and_dedup(monkeypatch, fidelity):
    _stub(monkeypatch)
    space = small_space()
    base = _run_sa(space, fidelity, 1, struct_dedup=False)
    assert _run_sa(space, fidelity, 4) == base
    assert _run_sa(space, fidelity, 1, struct_dedup=True) == base
    if fidelity == "full":
        assert _run_sa(space, fidelity, 4, surrogate=False) == base
        monkeypatch.setenv("COLLIE_PRESCREEN", "2")   # never leaks into drivers
        assert _run_sa(space, fidelity, 4) == base


def test_engine_default_prescreen_never_screens_mfs_probes(monkeypatch):
    _stub(monkeypatch)
    monkeypatch.setenv("COLLIE_PRESCREEN", "2")
    space = small_space()
    eng = _engine(space)
    assert eng.prescreen == 2
    p = space.normalize({**space.random_point(random.Random(9)), "mesh": "single",
                         "shape": "decode_s"})
    mf = construct_mfs(eng, space, p, "A2", fidelity="full")
    assert eng.n_attempts == mf.n_tests


def test_mfs_max_probes_truncates(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    p = space.normalize({**space.random_point(random.Random(10)), "mesh": "single"})
    full = construct_mfs(_engine(space), space, p, "A2", fidelity="prescreen")
    eng2 = _engine(space)
    capped = construct_mfs(eng2, space, p, "A2", fidelity="prescreen", max_probes=3)
    assert capped.n_tests == 3 < full.n_tests and eng2.n_attempts == 3
    for f, vals in capped.conditions.items():
        assert p[f] in vals


def test_mfs_prescreen_short_circuits_to_run_identical(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    p = space.normalize({**space.random_point(random.Random(9)), "mesh": "single",
                         "shape": "decode_s"})
    e_full, e_pre = _engine(space), _engine(space)
    full = construct_mfs(e_full, space, p, "A2", fidelity="full")
    pre = construct_mfs(e_pre, space, p, "A2", fidelity="prescreen")
    assert pre.n_tests <= full.n_tests and e_pre.n_attempts <= e_full.n_attempts
    assert pre.conditions == full.conditions


def test_prescreen_screens_within_budget(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    eng = _engine(space)
    r = simulated_annealing(eng, space, "diag.collective_blowup", "max", seed=5,
                            budget_compiles=30, fidelity="prescreen")
    s = eng.stats()
    assert s["n_screened_out"] > 0 and s["n_predictions"] > 0 and r.n_attempts >= 1


def test_measure_batch_prescreen_budget_and_alignment(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    eng = _engine(space)
    pts = _distinct_points(space, 8, 1)
    results, spents = eng.measure_batch(pts, with_spent=True, prescreen=3)
    assert len(results) == len(spents) == 8
    assert sum(m is not None for m in results) == 3 and eng.n_attempts == 3
    s = eng.stats()
    assert s["n_promoted"] == 3 and s["n_screened_out"] == 5
    assert all(m is not None for m in eng.measure_batch(pts, prescreen=100))
    assert eng.n_attempts == 8


def test_collie_prescreen_env_default(monkeypatch):
    _stub(monkeypatch)
    monkeypatch.setenv("COLLIE_PRESCREEN", "2")
    space = small_space()
    eng = _engine(space)
    assert sum(m is not None for m in eng.measure_batch(_distinct_points(space, 6, 2))) == 2


def test_predict_batch_uncharged(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    eng = _engine(space)
    preds = eng.predict_batch([{**space.random_point(random.Random(3)), "mesh": "single"}
                               for _ in range(4)])
    assert len(preds) == 4 and all("perf.roofline_efficiency" in p for p in preds)
    assert eng.n_attempts == 0 and eng.n_compiles == 0
    assert eng.stats()["n_predictions"] == 4


def test_engine_returns_flat_dicts_cold_memory_and_warm(monkeypatch, tmp_path):
    _stub(monkeypatch, fail_on=("decode_s",))
    space = small_space()
    path = str(tmp_path / "cache.sqlite")
    rng = random.Random(4)
    pts = [{**space.random_point(rng), "mesh": "single"} for _ in range(6)]
    cold = _engine(space, persistent_cache=path)
    cold_results = cold.measure_batch(pts)
    memory = cold.measure_batch(pts)
    warm = _engine(space, persistent_cache=path).measure_batch(pts)
    for c, m, w in zip(cold_results, memory, warm):
        if c is None:
            assert m is None and w is None
            continue
        assert all(k.startswith(("perf.", "diag.")) for k in c)
        assert m == c and w == c


def test_persistent_pool_reused_and_closed(monkeypatch):
    _stub(monkeypatch)
    space = small_space()
    eng = _engine(space, n_workers=4)
    rng = random.Random(6)
    eng.measure_batch([{**space.random_point(rng), "mesh": "single"} for _ in range(5)])
    pool = eng._pool
    assert pool is not None
    eng.measure_batch([{**space.random_point(rng), "mesh": "single"} for _ in range(5)])
    eng.measure_batch([{**space.random_point(rng), "mesh": "single"} for _ in range(5)],
                      n_workers=2)
    assert eng._pool is pool
    eng.close()
    assert eng._pool is None
    eng.close()


def test_batching_helpers_degrade_for_minimal_engines():
    class Minimal:
        n_compiles = 0

        def measure(self, p):
            self.n_compiles += 1
            return {"perf.x": 1.0}

    res, spents = batching.measure_batch_spent(Minimal(), [{"a": 1}, {"a": 2}], prescreen=4)
    assert res == [{"perf.x": 1.0}] * 2 and len(spents) == 2
    assert batching.predict_batch(Minimal(), [{"a": 1}]) == [None]
    assert batching.prediction_value(None, "perf.x", "min") == (1, 0.0)
    assert batching.prediction_value({"perf.x": 2.0}, "perf.x", "min") \
        < batching.prediction_value({"perf.x": 3.0}, "perf.x", "min")
    assert batching.prediction_value({"perf.x": 3.0}, "perf.x", "max") \
        < batching.prediction_value({"perf.x": 2.0}, "perf.x", "max")


# ---------------------------------------------------------------- BO's GP
@pytest.mark.parametrize("case", ["scratch", "block_update", "mixed_noise"])
def test_gp_state_matches_from_scratch_posterior(case):
    rng = np.random.default_rng(["scratch", "block_update", "mixed_noise"].index(case))
    gp = _GPState()
    if case == "mixed_noise":
        X0, X1 = (rng.integers(0, 2, (n, 5)).astype(float) for n in (6, 7))
        gp.extend(list(X0), 0.25)
        gp.extend(list(X1), 1e-3)
        X, Xs = np.vstack([X0, X1]), X1[:3]
        noise = np.concatenate([np.full(6, 0.25), np.full(7, 1e-3)])
    else:
        X = rng.integers(0, 2, (14, 9)).astype(float)
        Xs = rng.integers(0, 2, (6, 9)).astype(float)
        gp.extend(list(X[:5]), 1e-3)
        if case == "block_update":           # factorize, then append rows
            gp.posterior(rng.normal(size=5), Xs, gp.median_ls())
        gp.extend(list(X[5:]), 1e-3)
        noise = 1e-3
    y = rng.normal(size=len(X))
    ls = gp.median_ls()
    for scale in (1.0, 1.7):                 # a lengthscale change refactors
        mu, sd = gp.posterior(y, Xs, ls * scale)
        mu_ref, sd_ref = _gp_posterior(X, y, Xs, ls * scale, noise=noise)
        np.testing.assert_allclose(mu, mu_ref, atol=1e-8)
        np.testing.assert_allclose(sd, sd_ref, atol=1e-8)


# ------------------------------------------------- against the reference
def _both(monkeypatch, **kw):
    """(port engine, reference engine) over equal spaces, on the same stub."""
    _stub(monkeypatch, engine_mod)
    _stub(monkeypatch, ref_engine_mod)
    return (Engine(small_space(), _meshes(), persistent_cache=False, device="cpu", **kw),
            ref_engine_mod.Engine(ref_small_space(), _meshes(), persistent_cache=False, **kw))


def _batches(space):
    rng = random.Random(21)
    pts = [{**space.random_point(rng), "mesh": rng.choice(["single", "multi"])}
           for _ in range(24)]
    return [pts[:8], pts[4:14] + pts[:2], pts[14:], pts[::3]]


_TIMES = ("compile_time", "lower_time")


@pytest.mark.parametrize("struct_dedup", [True, False], ids=["dedup", "no_dedup"])
@pytest.mark.parametrize("prescreen", [0, 3], ids=["full", "prescreen3"])
def test_engine_matches_reference_on_a_fixed_batch_sequence(monkeypatch, prescreen,
                                                            struct_dedup):
    port, ref = _both(monkeypatch, prescreen=prescreen, struct_dedup=struct_dedup,
                      n_workers=3)
    for batch in _batches(port.space):
        got = port.measure_batch(batch, with_spent=True)
        want = ref.measure_batch(batch, with_spent=True)
        assert got == want
        assert port.predict_batch(batch) == ref.predict_batch(batch)
        assert port.measure_lowered_batch(batch[:3]) == ref.measure_lowered_batch(batch[:3])
    ps = {k: v for k, v in port.stats().items() if k not in _TIMES}
    rs = {k: v for k, v in ref.stats().items() if k not in _TIMES}
    assert ps == rs and set(port.stats()) == set(ref.stats())
    assert port.surrogate.calibrator.state() == ref.surrogate.calibrator.state()
    port.close()
    ref.close()


@pytest.mark.parametrize("fidelity", ["full", "prescreen", "lowered"])
def test_sa_on_stub_matches_reference(monkeypatch, fidelity):
    port, ref = _both(monkeypatch)
    a = simulated_annealing(port, port.space, "diag.collective_blowup", "max", seed=5,
                            budget_compiles=30, fidelity=fidelity)
    b = ref_simulated_annealing(ref, ref.space, "diag.collective_blowup", "max", seed=5,
                                budget_compiles=30, fidelity=fidelity)
    assert _sa_fingerprint(a) == _sa_fingerprint(b)


# ------------------------------------------------------------ the whole zoo
def test_every_arch_and_grad_compress_value_is_taken(monkeypatch):
    """All 10 archs (the vit and encodec frontends and the MoE archs among
    them) and every grad_compress value, with no restrict."""
    _stub(monkeypatch)
    space = SearchSpace(bench_archs(), BENCH_SHAPES)
    eng = Engine(space, _meshes(), persistent_cache=False, device="cpu")
    assert len(eng.space.factors["arch"]) == 10
    assert {"internvl2-1b", "musicgen-medium"} <= set(eng.space.factors["arch"])
    assert eng.space.factors["grad_compress"] == ("none", "bf16", "int8")


def test_unported_arch_excluded_by_restrict_is_accepted(monkeypatch):
    """An arch in ``archs``, out of the ``arch`` factor (a frontend arch,
    which the port now runs too)."""
    _stub(monkeypatch)
    space = SearchSpace(bench_archs(["qwen2-1.5b", "tinyllama-1.1b", "internvl2-1b"]),
                        BENCH_SHAPES, restrict={"arch": ("qwen2-1.5b", "tinyllama-1.1b")})
    eng = Engine(space, _meshes(), persistent_cache=False, device="cpu")
    assert eng.space.factors["arch"] == ("qwen2-1.5b", "tinyllama-1.1b")
