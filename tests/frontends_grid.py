"""The port's engine measures a frontend arch's bench points with no failed
trace, to the reference's kinds (shared by ``test_torch_frontends_grid_vit.py``
and ``test_torch_frontends_grid_encodec.py``, one arch each, so that the two
run on separate workers).

``internvl2-1b-bench`` (vit: 16 patch positions, 14 query heads over 2 KV
heads, which the 4-way model axis does not divide) and
``musicgen-medium-bench`` (encodec: 4 codebooks, the (4, V, D) tables
sharded on the vocab) at train_s, prefill_s and decode_s under dp, fsdp, tp
and ep on both bench meshes (long_s is for subquadratic archs only): every
trace succeeds, only ops ``parity.REPLICATED_OPS`` admits at a point's class
run replicated, the counters are finite, the kinds are the reference's
(``parity.POINT_REFERENCE``, held to a fresh reference run in
``test_torch_frontends_measure.py``) or a listed difference
(``parity.POINT_KIND_DIFFERENCES``), and the useful-FLOP ratio is within
``parity.USEFUL_RATIO_REL_BOUND`` of the reference's.
"""
import math

from repro_torch.core import anomaly, parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.engine import Engine
from repro_torch.core.minimize import baseline_point
from repro_torch.core.searchspace import SearchSpace


def points(arch):
    """The arch's 24 bench points: 3 shapes x 4 presets x 2 meshes."""
    space = SearchSpace(bench_archs([arch]), BENCH_SHAPES)
    return space, [space.normalize({**baseline_point(space, arch, sh), "preset": pr,
                                    "mesh": mk})
                   for sh in ("train_s", "prefill_s", "decode_s")
                   for pr in ("dp", "fsdp", "tp", "ep") for mk in ("single", "multi")]


def ids(pts):
    return [f"{p['shape']}-{p['preset']}-{p['mesh']}" for p in pts]


def measure(arch):
    """(the engine's counters at the arch's points, the engine)."""
    space, pts = points(arch)
    eng = Engine(space, bench_meshes(), persistent_cache=False, device="cpu")
    got = eng.measure_batch(pts)
    eng.close()
    return got, eng


def check_table(arch):
    """The points are exactly the table's points of this arch, and no long_s
    point is valid for it (a quadratic arch)."""
    space, pts = points(arch)
    assert len(pts) == 24 == len({parity.grid_key(p) for p in pts})
    assert {parity.grid_key(p) for p in pts} == \
        {k for k in parity.POINT_REFERENCE if k[0] == arch and k[5] == "none"}
    assert not space.valid(baseline_point(space, arch, "long_s"))


def check_point(arch, measured, i):
    got, eng = measured
    assert eng.n_failures == 0, eng.errors
    assert not parity.unlisted_at(eng.replicated_at), eng.replicated_at
    p, c = points(arch)[1][i], got[i]
    assert c is not None and all(math.isfinite(v) for v in c.values()), c
    key = parity.grid_key(p)
    kinds = tuple(sorted(anomaly.kinds(c, p["remat"])))
    assert kinds == parity.expected_point_kinds(key), (kinds, parity.POINT_REFERENCE[key])
    listed = parity.POINT_KIND_DIFFERENCES.get(key)
    if listed is not None:
        assert f"{c[listed[2]]:.4g}" == f"{listed[3]:.4g}", (c[listed[2]], listed)
    want = parity.POINT_REFERENCE[key][1]
    assert abs(c["perf.useful_flops_ratio"] / want - 1) <= parity.USEFUL_RATIO_REL_BOUND
