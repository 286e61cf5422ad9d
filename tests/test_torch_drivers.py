"""The port's search drivers against the JAX package's, byte for byte.

A synthetic engine plants a hidden conjunctive trigger rule, as
``FakeEngine`` in ``tests/test_mfs_search.py`` does (no trace, no compile),
and gives each package's drivers the same counters.  Each package runs on
its own ``SearchSpace`` over the same bench archs.  For every driver entry
point (``simulated_annealing``, ``campaign``, ``rank_counters``,
``random_search``, ``bo_search``, ``construct_mfs``, ``minimize_witness``,
``boundary_controls``, ``tighten_conditions``), several rules and seeds,
the trajectories are equal: the events (point, kinds, counter value,
``n_spent``, MFS or none), the anomalies (kind, conditions, witness) and
the attempts spent.  Only ``t`` and ``wall_s`` are left out.
"""
import json
import random

import pytest

import repro.core as ref_core
import repro_torch.core as port_core
from repro.core import (anomaly as ref_anomaly, benchscale as ref_bench, bo as ref_bo,
                        catalog as ref_catalog, mfs as ref_mfs, minimize as ref_min,
                        random_search as ref_rs, sa as ref_sa, searchspace as ref_ss)
from repro_torch.core import (anomaly, benchscale, bo, catalog, mfs, minimize,
                              random_search, sa, searchspace)

PKGS = {
    "ref": dict(space=ref_ss.SearchSpace, archs=ref_bench.bench_archs,
                shapes=ref_bench.BENCH_SHAPES, sa=ref_sa, rs=ref_rs, bo=ref_bo,
                mfs=ref_mfs, min=ref_min, kinds=ref_anomaly.kinds, catalog=ref_catalog),
    "port": dict(space=searchspace.SearchSpace, archs=benchscale.bench_archs,
                 shapes=benchscale.BENCH_SHAPES, sa=sa, rs=random_search, bo=bo,
                 mfs=mfs, min=minimize, kinds=anomaly.kinds, catalog=catalog),
}
ARCHS = ["qwen2-1.5b", "rwkv6-7b"]

# planted rules: factor -> triggering values, and the kind they raise
RULES = {
    "dp_nocache": ({"preset": ("dp",), "cache_shard": (False,)}, "A2"),
    "multi_tp": ({"mesh": ("multi",), "preset": ("tp", "ep")}, "A1"),
    "unscanned_noseq": ({"scan_layers": (False,), "seq_shard": (False,),
                         "vocab_shard": (True,)}, "A4"),
}


class FakeEngine:
    """Synthetic subsystem: a hidden rule raises one anomaly kind, and the
    counters move with the share of the rule a point matches.  It charges
    one attempt per unique valid point, and serves a fidelity-0 estimate
    (the same counters, damped) so that the prescreen paths run."""

    def __init__(self, space, rule: dict, kind: str):
        self.space, self.rule, self.kind = space, rule, kind
        self.n_attempts = self.n_compiles = 0
        self._seen = {}

    def _counters(self, p, damp=1.0):
        frac = sum(p.get(f) in vs for f, vs in self.rule.items()) / len(self.rule)
        trig = frac == 1.0 and damp == 1.0
        return {
            "perf.roofline_efficiency": 0.1 if trig and self.kind == "A1"
            else 0.6 - 0.2 * frac * damp,
            "perf.useful_flops_ratio": 0.9,
            "diag.collective_blowup": 20.0 if trig and self.kind == "A2"
            else 1.0 + 2.5 * frac * damp,
            "diag.memory_overshoot": 1.0 + frac,
            "diag.hbm_oversubscribed": 2.0 if trig and self.kind == "A4" else 0.5,
        }

    def measure(self, p):
        p = self.space.normalize(p)
        if not self.space.valid(p):
            return None
        key = self.space.point_key(p)
        if key not in self._seen:
            self.n_attempts += 1
            self.n_compiles += 1
            self._seen[key] = self._counters(p)
        return self._seen[key]

    def predict_batch(self, points):
        return [self._counters(self.space.normalize(p), damp=0.5)
                if self.space.valid(self.space.normalize(p)) else None for p in points]


def _setup(pkg, rule_name):
    P = PKGS[pkg]
    space = P["space"](P["archs"](ARCHS), P["shapes"])
    rule, kind = RULES[rule_name]
    return P, space, FakeEngine(space, rule, kind), kind


def _mfs(m):
    if m is None:
        return None
    return {"kind": m.kind, "conditions": m.conditions, "witness": m.witness,
            "counters": m.counters, "n_tests": m.n_tests}


def _result(r):
    return {"algorithm": r.algorithm, "counter": r.counter,
            "events": [{"n_spent": e.n_spent, "point": e.point, "kinds": sorted(e.kinds),
                        "counter_value": e.counter_value, "mfs": _mfs(e.new_mfs)}
                       for e in r.events],
            "anomalies": [_mfs(a) for a in r.anomalies], "n_attempts": r.n_attempts}


def _dump(x) -> str:
    return json.dumps(x, sort_keys=True, default=repr)


def _witness(P, space, eng, kind, seed):
    rng = random.Random(seed)
    for _ in range(5000):
        p = space.random_point(rng)
        m = eng.measure(p)
        if m and kind in P["kinds"](m, p["remat"]):
            return p, m
    raise AssertionError("planted rule unreachable")


def _run(driver, pkg, rule_name, seed):
    P, space, eng, kind = _setup(pkg, rule_name)
    fid = "prescreen" if seed % 2 else "full"
    if driver == "simulated_annealing":
        r = P["sa"].simulated_annealing(eng, space, "diag.collective_blowup", "max",
                                        seed=seed, budget_compiles=60, fidelity=fid)
        out = _result(r)
    elif driver == "campaign":
        r = P["sa"].campaign(eng, space, [("perf.roofline_efficiency", "min"),
                                          ("diag.hbm_oversubscribed", "max")],
                             seed=seed, budget_compiles=80, fidelity=fid)
        out = _result(r)
    elif driver == "rank_counters":
        out = P["sa"].rank_counters(eng, space, ["diag.collective_blowup",
                                                 "diag.memory_overshoot",
                                                 "perf.roofline_efficiency"], seed=seed)
    elif driver == "random_search":
        r = P["rs"].random_search(eng, space, seed=seed, budget_compiles=60,
                                  mfs_skip=True, mfs_construct=True, fidelity=fid)
        out = _result(r)
    elif driver == "bo_search":
        r = P["bo"].bo_search(eng, space, "perf.roofline_efficiency", "min", seed=seed,
                              budget_compiles=40, pool=48, fidelity=fid)
        out = _result(r)
    else:
        p, m = _witness(P, space, eng, kind, seed)
        mf = P["mfs"].construct_mfs(eng, space, p, kind, m, fidelity=fid)
        if driver == "construct_mfs":
            out = _mfs(mf)
        elif driver == "minimize_witness":
            res = P["min"].minimize_witness(eng, space, p, kind, within=mf)
            out = {"point": res.point, "kept": res.kept, "distance": res.distance,
                   "raw_distance": res.raw_distance, "n_probes": res.n_probes,
                   "near_misses": res.near_misses, "triggered": res.triggered,
                   "baseline": P["min"].baseline_point(space, p["arch"], p["shape"])}
        elif driver == "boundary_controls":
            out = P["min"].boundary_controls(eng, space, p, kind, mf.conditions,
                                             max_controls=3)
        else:
            out = _mfs(P["min"].tighten_conditions(eng, space, mf))
        out = {"out": out, "catalog": P["catalog"].render_markdown([mf])}
    return _dump({"out": out, "n_attempts": eng.n_attempts})


DRIVERS = ["simulated_annealing", "campaign", "rank_counters", "random_search",
           "bo_search", "construct_mfs", "minimize_witness", "boundary_controls",
           "tighten_conditions"]


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("rule_name", sorted(RULES))
@pytest.mark.parametrize("driver", DRIVERS)
def test_driver_trajectory_matches_reference(driver, rule_name, seed):
    port = _run(driver, "port", rule_name, seed)
    assert port == _run(driver, "ref", rule_name, seed)
    if driver in ("simulated_annealing", "random_search", "campaign"):
        assert json.loads(port)["out"]["anomalies"], "the planted rule was not found"


def test_catalog_roundtrip_matches_reference(tmp_path):
    P, space, eng, kind = _setup("port", "dp_nocache")
    p, m = _witness(P, space, eng, kind, 0)
    port_mf = mfs.construct_mfs(eng, space, p, kind, m)
    catalog.save_catalog([port_mf], str(tmp_path / "port.json"), meta={"seed": 0})
    ref_catalog.save_catalog([port_mf], str(tmp_path / "ref.json"), meta={"seed": 0})
    assert (tmp_path / "port.json").read_text() == (tmp_path / "ref.json").read_text()
    back = catalog.load_catalog(str(tmp_path / "port.json"))
    assert back == [port_mf]
    assert catalog.render_markdown(back) == ref_catalog.render_markdown(
        ref_catalog.load_catalog(str(tmp_path / "ref.json")))


def test_packages_are_distinct():
    assert port_core.__name__ == "repro_torch.core" and ref_core.__name__ == "repro.core"
    assert mfs.MFS is not ref_mfs.MFS
