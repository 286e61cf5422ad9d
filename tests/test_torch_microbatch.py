"""The train step's microbatch split, as the trace runs it on a mesh
(``xlaforms._microbatches``) and on plain tensors.

On plain tensors microbatch i is rows i*B/n .. (i+1)*B/n, the JAX package's
reshape and scan.  On a mesh each microbatch stays sharded as XLA keeps it:
its rows over the batch axes that divide them, the batch's other ranks
replicated (a dense step) or, where the MoE groups' axes begin with the
rows', moved onto the sequence; nothing runs replicated.  A microbatched dp
point traced whole on the bench mesh runs no op replicated."""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.configs.base import RunPolicy
from repro_torch.core import parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.engine import Engine
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch import traceanalysis, xlaforms
from repro_torch.launch.sharding import use_rules
from repro_torch.train.train_step import microbatches

ROOT = Path(__file__).resolve().parents[1]


def test_plain_microbatches_are_the_references_rows():
    a = torch.arange(32 * 3).reshape(32, 3)
    for n in (1, 2, 8, 32):
        parts = microbatches(a, n)
        assert torch.equal(torch.cat(parts), a)
        assert all(torch.equal(p, a.reshape(n, 32 // n, 3)[i]) for i, p in enumerate(parts))


@pytest.mark.parametrize("moe_groups,placements,local,collective", [
    (0, ("shard 0", "replicate"), (1, 256), "all-gather"),   # dense: model replicated
    (32, ("shard 0", "shard 1"), (1, 64), "all-to-all"),     # MoE: model on the sequence
])
def test_the_traced_split_keeps_each_microbatch_sharded(moe_groups, placements, local,
                                                        collective):
    """A batch of 32 rows on the single bench mesh's 16 dp ranks, split in 8
    microbatches of 4 rows: the rows on data (4 divides 4), the model axis
    replicated, or carrying the sequence when 32 MoE groups shard over
    (data, model); the batch is redistributed once for all 8, and nothing
    is replicated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    mesh = bench_meshes()["single"]
    dm = mesh.device_mesh("cpu")
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    with fake:
        a = DTensor.from_local(torch.empty(2, 256, dtype=torch.int32), dm,
                               [Shard(0), Shard(0)], run_check=False,
                               shape=torch.Size((32, 256)), stride=(256, 1))
    rules = RunPolicy(sharding_preset="dp").rules_dict()
    with fake, use_rules(mesh, rules), rec, traceanalysis.dtensor_hooks(rec), \
            xlaforms.XlaForms():
        mbs = microbatches(a, 8, moe_groups)
    for mb in mbs:
        assert tuple(mb.shape) == (4, 256)
        assert tuple(f"shard {p.dim}" if p.is_shard() else "replicate"
                     for p in mb.placements) == placements
        assert tuple(mb.to_local().shape) == local
    assert rec.replicated == {}
    assert [r["coll"] for r in rec.records if r["kind"] == "collective"] == [collective]


def test_a_microbatched_dp_point_runs_nothing_replicated():
    """qwen2-1.5b-bench train_s under dp on the single mesh, 8 microbatches
    of 4 rows on 16 ranks: no op of the trace runs replicated (the split ran
    replicated before ``xlaforms._microbatches``), and each microbatch is
    computed on 4 ranks' rows, as XLA does: the useful-FLOP ratio is the
    reference's 0.2570 within the bound."""
    with open(ROOT / "benchmarks" / "results" / "bench_fidelity_pairs.json") as f:
        data = json.load(f)
    p = dict(data["pairs"][30][0])
    assert (p["arch"], p["preset"], p["mesh"], p["n_microbatch"]) == \
        ("qwen2-1.5b", "dp", "single", 8)
    archs, restrict, _ = parity.pair_points(ROOT / "benchmarks" / "results"
                                            / "bench_fidelity_pairs.json")
    space = SearchSpace(bench_archs(archs), BENCH_SHAPES, restrict=restrict)
    eng = Engine(space, bench_meshes(), persistent_cache=False, device="cpu")
    c = eng.measure(p)
    eng.close()
    assert eng.n_failures == 0, eng.errors
    assert eng.replicated_ops == {}
    assert abs(c["perf.useful_flops_ratio"] - 0.2570) <= \
        parity.USEFUL_RATIO_REL_BOUND * 0.2570


@pytest.mark.parametrize("mesh_kind,x_placements,collectives", [
    ("single", ("S0", "S1"), set()),                       # rows on data, sequence on model
    ("multi", ("R", "S0", "R"), {"all-gather"}),          # rows on data only
])
def test_moe_groups_go_back_to_the_microbatchs_layout(mesh_kind, x_placements, collectives):
    """MoE's 32 groups of a 4-row microbatch, sharded over every batch
    rank, viewed back to (B, S, D) in the microbatch's own layout: on the
    single mesh each rank's groups are its rows' sequence block (a local
    view, and the tokens' view as groups is local too); on the multi mesh
    the groups are gathered on pod and model first.  Nothing runs
    replicated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.models.moe import group_tokens, ungroup
    pl = {"S0": Shard(0), "S1": Shard(1), "R": Replicate()}
    mesh = bench_meshes()[mesh_kind]
    dm = mesh.device_mesh("cpu")
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    xp = [pl[p] for p in x_placements]
    x_local = [4, 256, 64]
    for size, p in zip(mesh.sizes, xp):
        if p.is_shard():
            x_local[p.dim] //= size
    with fake:
        x = DTensor.from_local(torch.empty(x_local), dm, xp, run_check=False,
                               shape=torch.Size((4, 256, 64)), stride=(256 * 64, 64, 1))
        y = DTensor.from_local(torch.empty(32 // mesh.size, 32, 64), dm,
                               [Shard(0)] * len(mesh.sizes), run_check=False,
                               shape=torch.Size((32, 32, 64)), stride=(32 * 64, 64, 1))
    with fake, rec, traceanalysis.dtensor_hooks(rec), xlaforms.XlaForms():
        out = ungroup(y, x)
        if mesh_kind == "single":
            g = group_tokens(x, 32)
            assert tuple(g.shape) == (32, 32, 64) and list(g.placements) == [Shard(0)] * 2
            assert tuple(g.to_local().shape) == (2, 32, 64)
    assert tuple(out.shape) == (4, 256, 64) and list(out.placements) == xp
    assert tuple(out.to_local().shape) == tuple(x_local)
    assert rec.replicated == {}
    assert {r["coll"] for r in rec.records if r["kind"] == "collective"} == collectives
    plain = torch.arange(4 * 256 * 2.0).reshape(4, 256, 2)
    assert torch.equal(group_tokens(plain, 32), plain.reshape(32, 32, 2))
    assert torch.equal(ungroup(group_tokens(plain, 32), plain), plain)
