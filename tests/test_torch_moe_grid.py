"""The port's engine measures MoE bench points with no failed trace.

``mixtral-8x7b-bench`` (8 experts, window 64) at train_s, prefill_s,
decode_s and long_s under dp, fsdp, tp and ep on both bench meshes, train_s
under ep with 4 microbatches, and ``phi3.5-moe-42b-a6.6b-bench`` (16
experts) at train_s and decode_s under the four presets: every trace
succeeds, only ops ``parity.REPLICATED_OPS`` admits at a point's class run
replicated, and the counters are finite, the useful-FLOP ratio in (0, 1.2]
(kinds are held to the reference at the points of
``test_torch_moe_measure.py``).  Under ep the expert dim is sharded on the
model axis where E divides it (both archs on the 4-way axis).
"""
import math

import pytest

from repro_torch.core import parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.engine import Engine
from repro_torch.core.minimize import baseline_point
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch.sharding import spec_for

ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]
SPACE = SearchSpace(bench_archs(ARCHS), BENCH_SHAPES)


def _point(arch, shape, preset, mesh, n_microbatch=1):
    return SPACE.normalize({**baseline_point(SPACE, arch, shape), "preset": preset,
                            "mesh": mesh, "n_microbatch": n_microbatch})


POINTS = [_point("mixtral-8x7b", sh, pr, mk) for sh in BENCH_SHAPES
          for pr in ("dp", "fsdp", "tp", "ep") for mk in ("single", "multi")]
POINTS += [_point("mixtral-8x7b", "train_s", "ep", "single", 4)]
POINTS += [_point("phi3.5-moe-42b-a6.6b", sh, pr, "single") for sh in ("train_s", "decode_s")
           for pr in ("dp", "fsdp", "tp", "ep")]


@pytest.fixture(scope="module")
def measured():
    eng = Engine(SPACE, bench_meshes(), persistent_cache=False, device="cpu")
    got = eng.measure_batch(POINTS)
    eng.close()
    return got, eng


@pytest.mark.parametrize("i", range(len(POINTS)),
                         ids=[f"{p['arch'].split('-')[0]}-{p['shape']}-{p['preset']}-"
                              f"{p['mesh']}-mb{p['n_microbatch']}" for p in POINTS])
def test_moe_point_traces(measured, i):
    got, eng = measured
    assert eng.n_failures == 0, eng.errors
    assert not parity.unlisted_at(eng.replicated_at), eng.replicated_at
    c = got[i]
    assert c is not None
    assert all(math.isfinite(v) for v in c.values()), c
    assert 0 < c["perf.useful_flops_ratio"] <= 1.2, c


@pytest.mark.parametrize("arch,E", [("mixtral-8x7b", 8), ("phi3.5-moe-42b-a6.6b", 16)])
def test_expert_axis_resolves_as_the_reference(arch, E):
    """EP on the model axis under ep (E divides 4), replicated under the
    other presets, where the experts' mlp dim takes the model axis (tp)."""
    from repro_torch.configs.base import RunPolicy
    mesh = bench_meshes()["single"]
    for preset, want in (("ep", ("model", None, None)), ("tp", (None, None, "model")),
                         ("fsdp", (None, "model", None)), ("dp", (None, None, None))):
        rules = RunPolicy(sharding_preset=preset).rules_dict()
        assert spec_for((E, 256, 512), ("expert", "embed", "mlp"), rules, mesh) == want
    # a 16-way model axis: mixtral's 8 experts do not divide it, and ep falls
    # back to TP within each expert (the reference's sharding.py:53-59)
    wide = type("Mesh", (), {"shape": {"data": 16, "model": 16}})()
    rules = RunPolicy(sharding_preset="ep").rules_dict()
    want = ("model", None, None) if E % 16 == 0 else (None, None, "model")
    assert spec_for((E, 4096, 6400), ("expert", "embed", "mlp"), rules, wide) == want
