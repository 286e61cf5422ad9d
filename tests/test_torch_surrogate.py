"""The port's surrogate and calibrator against the JAX package's, bit for bit.

On every point of ``benchmarks/results/bench_fidelity_pairs.json`` (237
measured points, MoE archs included: the surrogate builds no cell), the
port's ``predict`` and ``predict_batch`` (uncalibrated, and calibrated after
both calibrators observe the file's counters in file order),
``anomaly_score`` and the calibrator's ``state()`` equal the reference's
with ``==``.  The invariants of ``tests/test_surrogate.py`` are mirrored
for the port: ``predict_batch`` equals ``predict``, the calibrator round
trip and its degenerate-fit guard.
"""
import json
import math
import os
import random

import pytest

from repro.core.benchscale import BENCH_SHAPES as REF_SHAPES, bench_archs as ref_archs
from repro.core.searchspace import SearchSpace as RefSpace
from repro.core.surrogate import Surrogate as RefSurrogate
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs
from repro_torch.core.searchspace import SearchSpace
from repro_torch.core.surrogate import (KIND_COUNTER, LOWERED_KEYS, SCREENED, Calibrator,
                                        Surrogate)

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "results",
                       "bench_fidelity_pairs.json")


@pytest.fixture(scope="module")
def fixture():
    with open(FIXTURE) as f:
        data = json.load(f)
    restrict = {k: tuple(v) for k, v in data["restrict"].items()}
    port = SearchSpace(bench_archs(data["archs"]), BENCH_SHAPES, restrict=restrict)
    ref = RefSpace(ref_archs(data["archs"]), REF_SHAPES, restrict=restrict)
    return port, ref, data["mesh_shapes"], data["pairs"]


def _points(space, pairs, n_random=60):
    rng = random.Random(0)
    pts = [p for p, _ in pairs] + [space.random_point(rng) for _ in range(n_random)]
    bad = dict(pts[1])
    bad["mesh"] = "nonexistent"
    pts.insert(5, bad)                       # an infeasible row
    pts.append(dict(pts[0]))                 # a duplicate key
    return pts


def test_fixture_has_237_points(fixture):
    *_, pairs = fixture
    assert len(pairs) == 237


@pytest.mark.parametrize("calibrated", [False, True], ids=["raw", "calibrated"])
@pytest.mark.parametrize("path", ["predict", "predict_batch"])
def test_predictions_bit_identical_to_reference(fixture, path, calibrated):
    port_space, ref_space, meshes, pairs = fixture
    port, ref = Surrogate(port_space, meshes), RefSurrogate(ref_space, meshes)
    if calibrated:
        for p, m in pairs:                   # file order, both channels
            if m:
                port.observe(p, m)
                ref.observe(p, m)
                low = {k: m[k] for k in LOWERED_KEYS if k in m}
                port.lowered_calibrator.observe(low, m)
                ref.lowered_calibrator.observe(low, m)
        assert port.calibrator.state() == ref.calibrator.state()
        assert port.lowered_calibrator.state() == ref.lowered_calibrator.state()
        assert port.calibrator.n_observed == sum(1 for _, m in pairs if m)
    pts = _points(port_space, pairs)
    if path == "predict":
        got = [port.predict(p, calibrated=calibrated) for p in pts]
        want = [ref.predict(p, calibrated=calibrated) for p in pts]
    else:
        got = port.predict_batch(pts, calibrated=calibrated)
        want = ref.predict_batch(pts, calibrated=calibrated)
    assert got == want
    assert sum(g is None for g in got) == 1
    scores = [port.anomaly_score(g, p.get("remat", "none")) for g, p in zip(got, pts)]
    assert scores == [ref.anomaly_score(w, p.get("remat", "none")) for w, p in zip(want, pts)]


def test_predict_batch_equals_predict(fixture):
    port_space, _, meshes, pairs = fixture
    pts = _points(port_space, pairs, n_random=100)
    scalar, vector = Surrogate(port_space, meshes), Surrogate(port_space, meshes)
    want = [scalar.predict(p, calibrated=False) for p in pts]
    assert vector.predict_batch(pts, calibrated=False) == want
    for p, m in pairs[:40]:
        scalar.observe(p, m)
        vector.observe(p, m)
    assert [scalar.predict(p) for p in pts[:50]] == vector.predict_batch(pts[:50])
    assert vector.predict(pts[0], calibrated=False) == want[0]
    for c in SCREENED:
        assert c in want[0] and math.isfinite(float(want[0][c])), c


def test_kind_counter_map_covers_anomaly_kinds():
    assert set(KIND_COUNTER) == {"A1", "A2", "A3", "A4"}
    for c, mode in KIND_COUNTER.values():
        assert c in SCREENED and mode in ("min", "max")


def test_calibrator_roundtrip_and_degenerate_guard(tmp_path):
    cal = Calibrator(min_obs=4)
    for _ in range(6):                       # zero variance: offset only
        cal.observe({"perf.roofline_efficiency": 0.5}, {"perf.roofline_efficiency": 0.7})
    a, b = cal.coeffs("perf.roofline_efficiency")
    assert a == 1.0 and b > 0
    assert abs(cal.apply({"perf.roofline_efficiency": 0.5})["perf.roofline_efficiency"]
               - 0.7) < 1e-9
    path = str(tmp_path / "calib.json")
    cal.save(path)
    cal2 = Calibrator()
    assert cal2.load(path)
    assert cal2.coeffs("perf.roofline_efficiency") == (a, b)
    assert cal2.state() == cal.state()
    assert not Calibrator().load(str(tmp_path / "missing.json"))
