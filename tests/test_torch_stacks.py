"""What the trace counts for XLA's scanned loops and its collectives
(``repro_torch.launch.traceanalysis``, ``repro_torch.launch.xlaforms``).

* The residual stacks of the layer loop: on a 2-layer qwen2 at bench width
  (the train step traced on global fake tensors), the "stack" groups count
  each residual once written into its stack and once read from the update
  (``hloanalysis._fusion_io_bytes`` on a dynamic-update-slice), at the CPU
  module's width, and the residuals are what autograd saves of the units'
  tensors under the remat policy: under "none" the tensors a unit makes that
  ``saved_tensors_hooks`` sees saved, under "full" and "dots" what the
  units' checkpoint keeps (its inputs, the carries, and under "dots" the
  outputs its selective policy saves: q, k, v, the attention's output and
  the MLP's input projections).
* The WKV's loop over its chunks: the chunk steps' residuals are what
  autograd saves of the tensors the steps make (and of the state carried
  into the first step).
* A partial sum over both mesh dims of the single bench mesh, which DTensor
  all-reduces one dim at a time, is one all-reduce over the joint group of
  16 at f32 width; a bf16 collective counts at f32 width.  A bf16 weight's
  gradient reduced over part of the mesh in a model with MoE layers has
  the group of 2 that the reference's analyzer reads from the list XLA
  writes its replica groups as.
* DTensor's concatenation after an all-gather along a dim other than the
  first is part of the gather: it moves no bytes.
* The unembedding table's gradient under ZeRO-1, with the table whole and
  the rows on the data axis: each rank's block of the table's rows from
  the idle model axis, all-reduced over data and moved onto it by one
  collective-permute; the gradient comes back sharded on data.
* A decode token whose heads the mesh splits unevenly over the KV heads,
  against a cache that is whole on those ranks: the heads stay sharded and
  each rank reads its own KV head, a view, with no gather.
* A vocab-sharded table's lookup scatters its gradient into each rank's
  own rows, a sum partial over the indices' mesh dims; a ZeRO-1 update made
  on the data shards of a whole parameter is gathered back whole.
"""
import dataclasses
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.base import RunPolicy, ShapeSpec
from repro_torch.core.benchscale import bench_config, bench_meshes
from repro_torch.launch import traceanalysis as ta
from repro_torch.launch import xlaforms
from repro_torch.launch.steps import build_cell
from repro_torch.models import layers
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tfm

SHAPE = ShapeSpec("stacks", "train", 64, 4)
CFG = dataclasses.replace(bench_config("qwen2-1.5b"), n_layers=2)


def _f32_bytes(t) -> int:
    n = t.untyped_storage().nbytes()
    return 2 * n if t.dtype in (torch.bfloat16, torch.float16) else n


def _stack_bytes(trace) -> float:
    groups = ta.fusion_groups(trace.records, trace.out_ids, trace.arg_ids)
    return sum(g[2] + g[3] for g in groups if g[0] == "stack")


class _Made(TorchDispatchMode):
    """Notes the scanned loop step in which each storage is made, the steps
    that read it, and the storages the backward reads."""

    def __init__(self):
        super().__init__()
        self.made, self.read, self.keep, self.back_read = {}, {}, [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        scope = layers.scan_scope()
        backward = torch._C._current_graph_task_id() != -1
        for a in tree_flatten((args, kwargs))[0]:
            if isinstance(a, torch.Tensor):
                self.read.setdefault(a.untyped_storage()._cdata, set()).update(scope)
                if backward:
                    self.back_read.add(a.untyped_storage()._cdata)
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                key = o.untyped_storage()._cdata
                if key not in self.made:
                    self.made[key] = scope
                    self.keep.append(o)
        return out


def _saved_in_steps(run, loop, kept=()):
    """{storage: f32-width bytes} of the tensors that autograd saves while
    ``run()`` runs its forward and backward (and of those a checkpoint
    keeps, which ``run()`` adds to ``kept``, that the backward reads: JAX
    keeps no residual its backward does not use) and that a step of
    ``loop`` makes, or that one step of it alone reads, made before it (the
    carry into the first step)."""
    made, saved = _Made(), {}

    def pack(t):
        saved[t.untyped_storage()._cdata] = t
        return t
    with made, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        run()
    for t in kept:
        if t.untyped_storage()._cdata in made.back_read:
            saved[t.untyped_storage()._cdata] = t

    def stepped(k):
        if any(s[0] == loop for s in made.made.get(k, ())):
            return True
        return k in made.made and len({s for s in made.read.get(k, ()) if s[0] == loop}) == 1
    return {k: _f32_bytes(t) for k, t in saved.items() if stepped(k)}


def _cell(remat):
    policy = RunPolicy(sharding_preset="fsdp", remat=remat, attn_impl="plain")
    return build_cell(CFG, SHAPE, policy, bench_meshes()["single"])


def _keeping(monkeypatch) -> list:
    """Patches the units' checkpoint to note in the list it returns what it
    keeps for the backward: its inputs, on which the recompute reruns the
    unit, and under "dots" the outputs that the selective policy
    (``transformer._save_dots_policy``) saves."""
    from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                        create_selective_checkpoint_contexts)
    kept = []

    def tensors(tree):
        return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]

    def policy(ctx, op, *args, **kwargs):
        out = tfm._save_dots_policy(ctx, op, *args, **kwargs)
        if out == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            kept.extend(tensors(ctx.op_output))
        return out

    def keeping_checkpoint(fn, *args, **kwargs):
        kept.extend(tensors(args))
        return checkpoint(fn, *args, **kwargs)
    monkeypatch.setattr(tfm, "_SAVE_DOTS",
                        functools.partial(create_selective_checkpoint_contexts, policy))
    monkeypatch.setattr(tfm, "checkpoint", keeping_checkpoint)
    return kept


def _saved_by_units(cell, kept=()):
    """``_saved_in_steps`` of the layer loop in ``cell``'s forward and
    backward, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    pshapes, _, bshapes = cell.arg_shapes
    fake = FakeTensorMode()

    def leaves(tree):
        if isinstance(tree, dict):
            return {k: leaves(v) for k, v in tree.items()}
        return torch.empty(tree[0], dtype=tree[1])
    with fake:
        params = tfm.tree_map(lambda p: p.requires_grad_(), leaves(pshapes))
        batch = leaves(bshapes)

    def run():
        logits, _ = tfm.forward(params, batch, CFG, cell.policy)
        tfm.lm_loss(logits, batch["labels"]).backward()
    with fake:
        return _saved_in_steps(run, "units", kept)


def test_the_layer_stacks_without_remat_are_what_autograd_saves():
    cell = _cell("none")
    counted = _stack_bytes(cell.lower("cpu"))
    saved = _saved_by_units(cell)
    assert saved and counted == pytest.approx(2 * sum(saved.values()))


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_the_layer_stacks_under_remat_are_the_kept_tensors(remat, monkeypatch):
    """What the units' checkpoint keeps that the backward reads: each
    unit's carry (B, S, D), and under "dots" the outputs of q, k, v (H, KV
    and KV heads), of the attention's output projection (D) and of the
    MLP's two input projections (F) each (not the MLP's output projection,
    which the recompute, stopping early, never reaches): bf16, counted at
    f32 width, read and written once."""
    cell = _cell(remat)
    counted = _stack_bytes(cell.lower("cpu"))
    kept = _keeping(monkeypatch)
    saved = _saved_by_units(cell, kept)
    assert saved and counted == pytest.approx(2 * sum(saved.values()))
    B, S, D, F = SHAPE.global_batch, SHAPE.seq_len, CFG.d_model, CFG.d_ff
    widths = [D]
    if remat == "dots":
        widths += [CFG.n_heads * CFG.d_head, 2 * CFG.n_kv_heads * CFG.d_head, D, 2 * F]
    assert counted == 2 * CFG.n_layers * B * S * sum(widths) * 4


def test_the_wkv_chunk_stacks_are_what_autograd_saves():
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake = FakeTensorMode()
    B, S, H, hs = 2, 64, 4, 16
    with fake:
        r, k, v = (torch.empty(B, S, H, hs, dtype=torch.bfloat16, requires_grad=True)
                   for _ in range(3))
        w = torch.empty(B, S, H, hs, requires_grad=True)
        u = torch.empty(H, hs, requires_grad=True)
    rec = ta.Recorder(fake, scope=layers.scan_scope)

    def run():
        o, state = rwkv6.wkv_chunked(r, k, v, w, u)
        (o.sum() + state.sum()).backward()
    with fake, rec, xlaforms.XlaForms():
        run()
    groups = ta.fusion_groups(rec.records)
    counted = sum(g[2] + g[3] for g in groups if g[0] == "stack")
    with fake:
        saved = _saved_in_steps(run, "chunks")
    assert saved and counted == pytest.approx(2 * sum(saved.values()))


def _partial(dm, dtype, shape=(8, 64)):
    from torch.distributed.tensor import DTensor, Partial
    return DTensor.from_local(torch.empty(shape, dtype=dtype), dm, [Partial(), Partial()],
                              run_check=False, shape=torch.Size(shape),
                              stride=(shape[1], 1))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_partial_sum_over_both_mesh_dims_is_one_joint_all_reduce(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    with fake:
        x = _partial(dm, dtype)
    with fake, rec, ta.dtensor_hooks(rec):
        x.redistribute(dm, [Replicate(), Replicate()])
    assert [r["coll"] for r in rec.records if r["kind"] == "collective"] == ["all-reduce"] * 2
    nb = 8 * 64 * 4                       # at f32 width, bf16 or not
    assert ta.xla_collectives(rec.records) == [("all-reduce", nb, 16)]
    out = ta.analyze(rec.records)
    assert out["collective_count"] == {"all-reduce": 1}
    assert out["collective_wire"]["all-reduce"] == pytest.approx(nb * 2 * 15 / 16)


@pytest.mark.parametrize("moe_ranks,placements,group", [
    (0, ("R", "P"), 4), (16, ("R", "P"), 2), (16, ("P", "P"), 16)])
def test_a_moe_weight_gradient_over_part_of_the_mesh_has_the_analyzers_group_of_2(
        moe_ranks, placements, group):
    """A bf16 weight's gradient (a product summing over the rows), each
    rank's product of its rows, all-reduced, beside an activation's partial
    sum.  In a model with MoE layers on 16 ranks, XLA writes as a list the
    replica groups of the gradient's all-reduce over part of the mesh (the
    model axis, 4 ranks), which the reference's analyzer reads as a group
    of 2; over the whole mesh, in the iota form; an activation's keeps its
    group."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    with fake:
        x = torch.empty(2, 16, 16, dtype=torch.bfloat16)
        w = torch.empty(16, 32, dtype=torch.bfloat16)
    where = [Partial() if c == "P" else Replicate() for c in placements]
    with fake, rec, ta.dtensor_hooks(rec):
        for a, b, eqn in ((x, w, "aby,yz->abz"), (x, x, "aby,abz->yz")):
            y = xlaforms.dot_general_op(a, b, 3 if eqn.endswith("abz") else 2, eqn)
            DTensor.from_local(y, dm, where, run_check=False).redistribute(
                dm, [Replicate(), Replicate()])
    joint = 16 if placements == ("P", "P") else 4
    assert ta.xla_collectives(rec.records, moe_ranks) == [
        ("all-reduce", 2 * 16 * 32 * 4, joint), ("all-reduce", 16 * 16 * 4, group)]


def test_an_all_gather_along_a_later_dim_moves_no_more_bytes():
    """DTensor gathers (8, 64) sharded on dim 1 over model along dim 0 and
    concatenates the chunks; the concatenation is the gather's, not a copy,
    so the gathered tensor is read once by the op after it."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    with fake:
        x = DTensor.from_local(torch.empty(8, 16), dm, [Replicate(), Shard(1)],
                               run_check=False, shape=torch.Size((8, 64)), stride=(64, 1))
    with fake, rec, ta.dtensor_hooks(rec):
        y = x.redistribute(dm, [Replicate(), Replicate()]).to_local() * 2.0
    assert any(r["op"] == "aten.cat.default" for r in rec.records)
    groups = ta.fusion_groups(rec.records, {rec.id_of(y)})
    assert [(g[0], g[2], g[3]) for g in groups] == [("fuse", 8 * 64 * 4, 8 * 64 * 4)]


def test_the_unembedding_gradient_under_zero1_is_split_over_the_idle_axis():
    """x (B, S, D) with its rows on data, the (V, D) table whole, the rules
    naming data as ZeRO-1's axis: the table's gradient is each rank's
    (V/4, D) block from the model axis, all-reduced over data (f32) and
    moved by one collective-permute; it comes back sharded on data, and
    the product computes a quarter of the whole gradient's FLOPs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import sharding
    mesh = bench_meshes()["single"]
    dm = mesh.device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    V, D = 512, 64
    with fake:
        x = DTensor.from_local(torch.empty(2, 16, D, requires_grad=True), dm,
                               [Shard(0), Replicate()], run_check=False,
                               shape=torch.Size((8, 16, D)), stride=(16 * D, D, 1))
        table = DTensor.from_local(torch.empty(V, D, requires_grad=True), dm,
                                   [Replicate(), Replicate()], run_check=False,
                                   shape=torch.Size((V, D)), stride=(D, 1))
    rules = {**sharding.make_rules("ep"), sharding.ZERO1: (("data",),)}
    with fake, rec, ta.dtensor_hooks(rec), sharding.use_rules(mesh, rules), \
            xlaforms.XlaForms():
        xlaforms.register_strategies()
        logits = tfm.unembed(x, table)
        gx, gt = torch.autograd.grad(logits.sum(), (x, table))
    assert list(gt.placements) == [Shard(0), Replicate()]
    assert tuple(gt.to_local().shape) == (V // 4, D)
    colls = ta.xla_collectives(rec.records)
    assert ("all-reduce", V // 4 * D * 4, 4) in colls
    assert ("collective-permute", V // 4 * D * 4, 4) in colls
    grads = [r for r in rec.records if r.get("eqn") == "abz,aby->zy"]
    assert [r["flops"] for r in grads] == [2 * 2 * 16 * (V // 4) * D]


@pytest.mark.parametrize("cache_sharded", [False, True])
def test_a_decode_token_keeps_its_heads_sharded_against_a_whole_cache(cache_sharded):
    """qwen2's 12 query heads over 2 KV heads on the 4 model ranks: against a
    cache whole on them, the token's heads stay sharded (3 a rank), and
    each rank's K and V are a view of its KV head (stride 0 on the heads);
    where the rules shard the cache's sequence on model the token is
    gathered and grouped as (KV, G)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import sharding
    from repro_torch.models import attention
    mesh = bench_meshes()["single"]
    dm = mesh.device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    with fake:
        q = DTensor.from_local(torch.empty(4, 1, 3, 32), dm, [Shard(0), Shard(2)],
                               run_check=False, shape=torch.Size((16, 1, 12, 32)),
                               stride=(384, 384, 32, 1))
        k = DTensor.from_local(torch.empty(4, 128, 2, 32), dm, [Shard(0), Replicate()],
                               run_check=False, shape=torch.Size((16, 128, 2, 32)),
                               stride=(8192, 64, 32, 1))
    rules = sharding.make_rules("tp", **({} if cache_sharded else {"cache_seq": []}))
    with fake, rec, ta.dtensor_hooks(rec), sharding.use_rules(mesh, rules), \
            xlaforms.XlaForms():
        g = attention.group_heads(q, 2)
        kk = attention.kv_for(g, k)
    if cache_sharded:
        assert tuple(g.shape) == (16, 1, 2, 6, 32) and kk is k
        assert [r["coll"] for r in rec.records if r["kind"] == "collective"] == ["all-gather"]
        return
    assert tuple(g.shape) == (16, 1, 12, 1, 32) and list(g.placements) == list(q.placements)
    assert tuple(kk.shape) == (16, 128, 12, 32) and list(kk.placements) == [Shard(0), Shard(2)]
    assert tuple(kk.to_local().shape) == (4, 128, 3, 32) and kk.to_local().stride(2) == 0
    assert not [r for r in rec.records if r["kind"] == "collective"]


def test_a_vocab_sharded_lookup_scatters_its_gradient_into_its_own_rows():
    """A (512, 64) table sharded on its rows over model, looked up by (8, 16)
    token ids sharded over data: the table's gradient is each model rank's
    (128, 64) block, a sum partial over data, and no whole-table gradient is
    made or reduced."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    with fake:
        table = DTensor.from_local(torch.empty(128, 64, requires_grad=True), dm,
                                   [Replicate(), Shard(0)], run_check=False,
                                   shape=torch.Size((512, 64)), stride=(64, 1))
        idx = DTensor.from_local(torch.empty(2, 16, dtype=torch.int64), dm,
                                 [Shard(0), Replicate()], run_check=False,
                                 shape=torch.Size((8, 16)), stride=(16, 1))
    with fake, rec, ta.dtensor_hooks(rec), xlaforms.XlaForms():
        rows = table[idx]
        (gt,) = torch.autograd.grad(rows.sum(), (table,))
    assert list(gt.placements) == [Partial(), Shard(0)]
    assert tuple(gt.to_local().shape) == (128, 64)
    backward = [r for r in rec.records if r["op"].startswith("aten.embedding_dense_backward")]
    # its own 128 rows, and one that the other ranks' ids go to, dropped
    assert [r["out"][0][0] for r in backward] == [(129, 64)]
    assert all(r["in"][0][0] != (512, 64) for r in rec.records if r["kind"] == "collective")


def test_a_zero1_update_is_gathered_as_its_parameter():
    """An update made on the data shards of a parameter whole on every rank
    comes back whole, by one all-gather over data (the donated output keeps
    its argument's sharding); a parameter sharded alike is left as it is."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.train.train_step import _gathered_as
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = ta.Recorder(fake)
    with fake:
        param = DTensor.from_local(torch.empty(64, 32), dm, [Replicate(), Replicate()],
                                   run_check=False, shape=torch.Size((64, 32)), stride=(32, 1))
        new = DTensor.from_local(torch.empty(16, 32), dm, [Shard(0), Replicate()],
                                 run_check=False, shape=torch.Size((64, 32)), stride=(32, 1))
    with fake, rec, ta.dtensor_hooks(rec):
        out = _gathered_as(new, param)
        same = _gathered_as(new, new)
    assert list(out.placements) == [Replicate(), Replicate()] and same is new
    assert [(r["coll"], r["group"]) for r in rec.records if r["kind"] == "collective"] == \
        [("all-gather", 4)]
