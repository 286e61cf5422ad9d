"""Port vs reference, exact: sharding-rule resolution and fallbacks, the
analytic floors, the search-space logic and the anomaly monitor.

The reference's pure functions read a mesh only through ``mesh.shape`` and
``mesh.size``, so both packages run here in-process on the same mesh shapes
(the reference on a device-free jax ``AbstractMesh``); the port's
``build_cell`` is also checked against the per-leaf resolution, with DTensor
placements on the fake process group.
"""
import dataclasses
import json
import pathlib
import random

import pytest
import torch

from repro.configs import base as rbase
from repro.core import analytic as ranalytic
from repro.core import anomaly as ranomaly
from repro.core import benchscale as rbench
from repro.core import searchspace as rspace
from repro.launch import sharding as rsharding
from repro.models import api as rapi
from repro.train import optimizer as ropt
from repro_torch.configs import base as pbase
from repro_torch.core import analytic as panalytic
from repro_torch.core import anomaly as panomaly
from repro_torch.core import benchscale as pbench
from repro_torch.core import searchspace as pspace
from repro_torch.launch import sharding as psharding
from repro_torch.launch import steps as psteps
from repro_torch.models import api as papi
from repro_torch.train import optimizer as popt

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the non-MoE archs, the vit (internvl2-1b) and encodec (musicgen-medium)
# frontends included
ARCHS = ("deepseek-67b", "internlm2-20b", "internvl2-1b", "musicgen-medium", "qwen2-1.5b",
         "recurrentgemma-2b", "rwkv6-7b", "tinyllama-1.1b")
PRESETS = ("fsdp", "tp", "ep", "dp")
SHAPES = ("train_s", "prefill_s", "decode_s")


def _ref_mesh(shape: dict):
    """A device-free jax mesh of these axes (the reference's functions read
    only its shape and size)."""
    from repro.launch.mesh import make_abstract_mesh
    return make_abstract_mesh(tuple(shape.values()), tuple(shape))


MESHES = {"single": {"data": 4, "model": 4}, "multi": {"pod": 2, "data": 4, "model": 4}}


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _ref_spec(p):
    """A reference PartitionSpec as the port's tuple of entries."""
    return tuple("UNCONSTRAINED" if e is rsharding.UNCONSTRAINED else e for e in p)


def _port_spec(s):
    return tuple("UNCONSTRAINED" if e is psharding.UNCONSTRAINED else e for e in s)


def _ref_trees(cfg, shape):
    """(name, shapes leaves, axes tree, zero1) of every tree the reference's
    build_cell resolves, in its order."""
    import jax
    import jax.numpy as jnp
    policy = rbase.RunPolicy()
    cd = jnp.bfloat16
    pshapes = rapi.abstract_params(cfg, jnp.float32)
    paxes = rapi.axes(cfg)
    trees = [("params", pshapes, paxes, False)]
    bshapes, baxes = rapi.input_specs(cfg, shape, cd)
    trees.append(("batch", bshapes, baxes, False))
    if shape.kind == "train":
        opt = ropt.OptConfig(name=policy.optimizer)
        oshapes = jax.eval_shape(lambda p: ropt.init_opt_state(opt, p), pshapes)
        trees.append(("mom", oshapes["mom"], ropt.opt_state_axes(opt, paxes)["mom"], True))
    if shape.kind == "decode":
        sshapes, saxes = rapi.state_specs(cfg, shape, cd)
        trees.append(("state", sshapes, saxes, False))
    return trees


def _port_trees(cfg, shape):
    policy = pbase.RunPolicy()
    pshapes = psteps._shape_tree(papi.abstract_params(cfg, torch.float32))
    paxes = papi.axes(cfg)
    trees = [("params", pshapes, paxes, False)]
    bshapes, baxes = papi.input_specs(cfg, shape, torch.bfloat16)
    trees.append(("batch", psteps._shape_tree(bshapes), baxes, False))
    if shape.kind == "train":
        opt = popt.OptConfig(name=policy.optimizer)
        meta = papi.abstract_params(cfg, torch.float32)
        oshapes = psteps._shape_tree(popt.init_opt_state(opt, meta))
        trees.append(("mom", oshapes["mom"], popt.opt_state_axes(opt, paxes)["mom"], True))
    if shape.kind == "decode":
        sshapes, saxes = papi.state_specs(cfg, shape, torch.bfloat16)
        trees.append(("state", psteps._shape_tree(sshapes), saxes, False))
    return trees


def _resolve_ref(trees, rules, mesh):
    from repro.launch.steps import _zero1_shardings
    out = {}
    for name, shapes, axes, zero1 in trees:
        ax = dict(_flat(axes)) if isinstance(axes, dict) else {(): axes}
        for path, s in _flat(shapes):
            st = rsharding.FallbackStats()
            if zero1:
                spec = _zero1_shardings(mesh, {"x": s}, {"x": ax[path]}, rules, st)["x"].spec
            else:
                spec = rsharding.spec_for(s.shape, ax[path], rules, mesh, stats=st)
            parts = _ref_spec(spec)
            parts += (None,) * (len(s.shape) - len(parts))
            out[(name,) + path] = (parts, st.fallbacks, st.resolved)
    return out


def _resolve_port(trees, rules, mesh):
    out = {}
    for name, shapes, axes, zero1 in trees:
        ax = dict(_flat(axes)) if isinstance(axes, dict) else {(): axes}
        for path, (shape, _) in _flat(shapes):
            st = psharding.FallbackStats()
            if zero1:
                spec = psteps._zero1_specs(mesh, (shape, None), ax[path], rules, st)
            else:
                spec = psharding.spec_for(shape, ax[path], rules, mesh, stats=st)
            out[(name,) + path] = (_port_spec(spec), st.fallbacks, st.resolved)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_resolution_and_fallbacks_match_reference_per_leaf(arch):
    """Every param, optimizer-state, batch and state leaf of a bench arch,
    under 4 presets x 2 meshes x 3 bench shapes: the same mesh axes per dim
    and the same fallbacks and resolved dims, leaf by leaf."""
    rcfg, pcfg = rbench.bench_config(arch), pbench.bench_config(arch)
    n_leaves = 0
    for preset in PRESETS:
        rrules = dict(rbase.RunPolicy(sharding_preset=preset).rules_dict())
        prules = dict(pbase.RunPolicy(sharding_preset=preset).rules_dict())
        rrules.setdefault("pod_stack", (("pod",),))
        prules.setdefault("pod_stack", (("pod",),))
        assert prules == rrules
        for mname, mshape in MESHES.items():
            rmesh = _ref_mesh(mshape)
            pmesh = pbench.bench_meshes()[mname]
            assert pmesh.shape == mshape and pmesh.size == rmesh.size
            for sname in SHAPES:
                ref = _resolve_ref(_ref_trees(rcfg, rbench.BENCH_SHAPES[sname]), rrules, rmesh)
                port = _resolve_port(_port_trees(pcfg, pbench.BENCH_SHAPES[sname]),
                                     prules, pmesh)
                assert port == ref, (arch, preset, mname, sname)
                n_leaves += len(ref)
    assert n_leaves > 24 * 20


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-2b", "rwkv6-7b",
                                  "internvl2-1b", "musicgen-medium"])
def test_build_cell_specs_and_stats_are_the_per_leaf_resolution(arch):
    """The port's build_cell resolves exactly the per-leaf specs (zero-1 on
    the moments) and counts the same fallbacks over the same trees; its
    placements are Shard(d) on every mesh axis a dim names, in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    pcfg = pbench.bench_config(arch)
    for preset in PRESETS:
        for mname in MESHES:
            mesh = pbench.bench_meshes()[mname]
            for sname in SHAPES:
                shape = pbench.BENCH_SHAPES[sname]
                policy = pbase.RunPolicy(sharding_preset=preset)
                cell = psteps.build_cell(pcfg, shape, policy, mesh)
                rules = dict(policy.rules_dict())
                rules.setdefault("pod_stack", (("pod",),))
                want = _resolve_port(_port_trees(pcfg, shape), rules, mesh)
                got_specs = {}
                names = ["params", "mom", "batch"] if shape.kind == "train" else \
                    (["params", "batch"] if shape.kind == "prefill" else ["params", "state", "batch"])
                trees = list(cell.in_specs)
                if shape.kind == "train":
                    trees = [trees[0], trees[1]["mom"], trees[2]]
                for name, tree in zip(names, trees):
                    for path, spec in _flat(tree):
                        got_specs[(name,) + path] = _port_spec(spec)
                assert got_specs == {k: v[0] for k, v in want.items()}
                assert cell.stats.fallbacks == sum(v[1] for v in want.values())
                assert cell.stats.resolved == sum(v[2] for v in want.values())
    # a dim over two mesh axes is Shard(d) on both, in mesh order
    multi = pbench.bench_meshes()["multi"]
    assert psharding.placements_for((("pod", "data"), None, "model"), multi) == \
        (Shard(0), Shard(0), Shard(2))
    assert psharding.placements_for((None, None), multi) == (Replicate(),) * 3


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_floors_match_reference_exactly(arch):
    rcfg, pcfg = rbench.bench_config(arch), pbench.bench_config(arch)
    from repro import hw as rhw
    from repro_torch import hw as phw
    assert dataclasses.asdict(phw.V5E) == dataclasses.asdict(rhw.V5E)
    rng = random.Random(7)
    for sname, rshape in rbench.BENCH_SHAPES.items():
        pshape = pbench.BENCH_SHAPES[sname]
        assert dataclasses.asdict(pshape) == dataclasses.asdict(rshape)
        for mname, mshape in MESHES.items():
            for _ in range(6):
                kw = dict(sharding_preset=rng.choice(PRESETS), remat=rng.choice(("none", "dots", "full")),
                          n_microbatch=rng.choice((1, 2, 4)), params_f32=rng.random() < 0.5,
                          zero1=rng.random() < 0.5, optimizer=rng.choice(("adamw", "adafactor", "sgdm")),
                          grad_compress=rng.choice(("none", "bf16", "int8")))
                rpol, ppol = rbase.RunPolicy(**kw), pbase.RunPolicy(**kw)
                rf = ranalytic.step_floor_seconds(rcfg, rshape, rpol, _ref_mesh(mshape))
                pf = panalytic.step_floor_seconds(pcfg, pshape, ppol,
                                                  pbench.bench_meshes()[mname])
                assert pf == rf, (sname, mname, kw)
            useful = [m.matmul_model_flops(c, s) + m.attention_flops(c, s) + m.recurrence_flops(c, s)
                      for m, c, s in ((ranalytic, rcfg, rshape), (panalytic, pcfg, pshape))]
            assert useful[0] == useful[1]
    assert papi.n_params(pcfg) == rapi.n_params(rcfg)
    assert papi.matmul_active_params(pcfg) == rapi.matmul_active_params(rcfg)
    assert papi.n_active_params(pcfg) == rapi.n_active_params(rcfg)


def _spaces():
    archs = ["qwen2-1.5b", "recurrentgemma-2b", "rwkv6-7b", "mixtral-8x7b", "internvl2-1b",
             "musicgen-medium"]
    return (rspace.SearchSpace(rbench.bench_archs(archs), rbench.BENCH_SHAPES),
            pspace.SearchSpace(pbench.bench_archs(archs), pbench.BENCH_SHAPES))


@pytest.mark.parametrize("seed", range(4))
def test_search_space_logic_matches_reference_on_seeded_points(seed):
    rs, ps = _spaces()
    assert ps.factors == rs.factors and ps.size() == rs.size()
    rr, pr = random.Random(seed), random.Random(seed)
    for _ in range(60):
        p, q = rs.random_point(rr), ps.random_point(pr)
        assert p == q
        assert ps.valid(p) == rs.valid(p)
        assert ps.normalize(p) == rs.normalize(p)
        assert ps.point_key(p) == rs.point_key(p)
        rcfg, rshape, rpol, rmesh = rs.to_run(p)
        pcfg, pshape, ppol, pmesh = ps.to_run(p)
        assert (pcfg.name, dataclasses.asdict(pshape), pmesh) == \
            (rcfg.name, dataclasses.asdict(rshape), rmesh)
        assert dataclasses.asdict(ppol) == dataclasses.asdict(rpol)
        assert ppol.rules_dict() == rpol.rules_dict()
        m1, m2 = rs.mutate(p, rr), ps.mutate(p, pr)
        assert m1 == m2
    # invalid points are invalid in both
    bad = dict(p, shape="train_s", n_microbatch=32, grad_compress="int8", mesh="single")
    assert ps.valid(bad) == rs.valid(bad) is False


def test_anomaly_detect_matches_reference_on_counter_dicts():
    corpus = json.loads((ROOT / "benchmarks" / "results" / "anomaly_corpus.json").read_text())
    dicts = [e["counters"] for e in corpus["entries"]]
    rng = random.Random(3)
    keys = ("perf.roofline_efficiency", "diag.collective_blowup", "perf.useful_flops_ratio",
            "diag.hbm_oversubscribed")
    for _ in range(300):
        dicts.append({k: rng.choice((0.0, 0.1, 0.25, 0.3, 0.4, 0.55, 1.0, 4.0, 5.0,
                                     rng.random() * 6)) for k in keys if rng.random() < 0.8})
    dicts.append(None)
    for c in dicts:
        for remat in ("none", "dots", "full"):
            assert panomaly.detect(c, remat) == [
                panomaly.Anomaly(a.kind, a.value, a.threshold, a.note)
                for a in ranomaly.detect(c, remat)]
            assert panomaly.kinds(c, remat) == ranomaly.kinds(c, remat)
