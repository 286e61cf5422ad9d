"""Port vs reference: MoE train points in microbatches of 1-2 rows, and the
trace's forms that keep them sharded (``repro_torch.launch.xlaforms``).

mixtral-8x7b-bench's ``train_s`` in 16 or 32 microbatches has 1-2 rows a
microbatch, which no whole mesh axis of the batch rules divides, so the
sequence carries the batch's ranks (``xlaforms._microbatches``).  Local
attention's view of that sequence as window-long chunks would split one
mesh dim's shards between the chunk and the step dims, which DTensor cannot
place: the trace's form (``_chunk_view``) keeps each rank's positions as a
block of queries and cuts each block's window of keys and values from
their gather over the mesh dims within a chunk, the chunk before by a halo
exchange.  Under fsdp, MoE's groups come back with the embedding dim
sharded, which ``_ungroup`` takes.

* The chunk view at pair 215's layout (the single bench mesh, 2 rows, the
  256 positions on 16 ranks, window 64) runs nothing replicated, and each
  rank's score product has XLA's per-device FLOPs (its HLO: scores of
  (1, 1, 8, 4, 32, 128) a device; here (2, 1, 8, 4, 16, 128)).
* MoE's groups at pair 6's layout (the multi mesh under fsdp: groups on pod
  x data, the embedding on model; the microbatch's rows on data and its
  sequence on model) go back to the tokens with no replicated view.
* ``local_chunk_attention`` through ``chunk_view`` on plain CPU tensors
  equals the reference's JAX ``local_chunk_attention`` within f32 2e-5.
* On a ``gloo`` group of 4 CPU processes, the chunk view form's output and
  the gradients of q, k and v equal the plain function's (a chunk over two
  ranks of a 2 x 2 mesh, the keys sharded or whole; two chunks a rank of a
  1-D mesh).
* Pair 215 traced whole by the port's engine gives today's reference's
  kinds (``parity.SMOKE_PAIRS``, which the card is held to) and its
  useful-FLOP ratio within ``parity.USEFUL_RATIO_REL_BOUND``, with no op run
  replicated; the reference runs afresh in a subprocess with 32 host devices.
"""
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import anomaly as ref_anomaly
from repro_torch.core import anomaly, parity
from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.engine import Engine
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch import traceanalysis, xlaforms
from repro_torch.models import attention, moe

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAIRS = ROOT / "benchmarks" / "results" / "bench_fidelity_pairs.json"
PAIR = 215


def _fake(fake, dm, local, placements, shape, grad=True):
    from torch.distributed.tensor import DTensor
    stride = tuple(int(np.prod(shape[k + 1:])) for k in range(len(shape)))
    with fake:
        return DTensor.from_local(torch.empty(local, requires_grad=grad), dm, placements,
                                  run_check=False, shape=torch.Size(shape), stride=stride)


def _traced(fn):
    """``fn()`` under the trace's forms and hooks on fake tensors, its
    output's sum differentiated: -> (output, recorder)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    xlaforms.register_strategies()
    with fake:
        args = fn(fake)
    with fake, rec, implicit_replication(), traceanalysis.dtensor_hooks(rec), \
            xlaforms.XlaForms():
        out = args[0](*args[1:])
        out.float().sum().backward()
    return out, rec


def test_the_chunk_view_at_215s_layout_runs_sharded_with_xlas_flops():
    """Pair 215: q (2, 256, 8, 4, 32) and k, v (2, 256, 8, 32), the sequence
    on data x model (16 positions a rank), window 64: the data ranks hold
    the chunks, the model ranks a quarter of one each."""
    from torch.distributed.tensor import Shard
    dm = bench_meshes()["single"].device_mesh("cpu")
    seq = [Shard(1), Shard(1)]

    def args(fake):
        pos = torch.arange(256, dtype=torch.int32).expand(2, 256)
        return (lambda q, k, v: attention.local_chunk_attention(q, k, v, pos, pos, 64),
                _fake(fake, dm, (2, 16, 8, 4, 32), seq, (2, 256, 8, 4, 32)),
                _fake(fake, dm, (2, 16, 8, 32), seq, (2, 256, 8, 32)),
                _fake(fake, dm, (2, 16, 8, 32), seq, (2, 256, 8, 32)))
    out, rec = _traced(args)
    assert rec.replicated == {}
    assert list(out.placements) == seq and tuple(out.to_local().shape) == (2, 16, 8, 4, 32)
    scores = [r for r in rec.records
              if r.get("eqn") == "bnqkgd,bntkd->bnkgqt" and r["phase"] == "F"]
    assert len(scores) == 1
    # XLA's per-device score product: 1 row x 1 chunk x 8 KV x 4 G x 32
    # queries x 128 keys x 32 head dims, two FLOPs a multiply-add
    assert scores[0]["flops"] == 2 * 1 * 1 * 8 * 4 * 32 * 128 * 32
    assert tuple(scores[0]["out"][0][0]) == (2, 1, 8, 4, 16, 128)
    colls = [(r["coll"], r["in"][0][0]) for r in rec.records
             if r["kind"] == "collective" and r["phase"] == "F"]
    # k and v gathered over model to their chunk, each chunk's previous one
    # from the previous data rank (a permute's operand is flattened)
    assert sorted(colls) == sorted([("all-gather", (2, 16, 8, 32))] * 2
                                   + [("collective-permute", (2 * 64 * 8 * 32,))] * 2)


def test_moe_groups_under_fsdp_go_back_to_the_tokens_with_no_replicated_view():
    """Pair 6's layout (multi mesh, fsdp, 8 microbatches of 4 rows): the
    groups (32, 32, 256) on pod x data with the embedding on model, back to
    a microbatch (4, 256, 256) whose rows are on data and sequence on
    model: the groups resharded onto data x model (gathered over pod and
    off the embedding), then each rank's groups are its tokens."""
    from torch.distributed.tensor import Replicate, Shard
    dm = bench_meshes()["multi"].device_mesh("cpu")
    x_pl = [Replicate(), Shard(0), Shard(1)]

    def args(fake):
        x = _fake(fake, dm, (1, 64, 256), x_pl, (4, 256, 256), grad=False)
        y = _fake(fake, dm, (4, 32, 64), [Shard(0), Shard(0), Shard(2)], (32, 32, 256))
        return (lambda y: moe.ungroup(y, x), y)
    out, rec = _traced(args)
    assert rec.replicated == {}
    assert list(out.placements) == x_pl and tuple(out.to_local().shape) == (1, 64, 256)
    assert {r["coll"] for r in rec.records if r["kind"] == "collective"
            and r["phase"] == "F"} == {"all-gather"}


@pytest.mark.parametrize("S,window,KV,G", [(256, 64, 2, 4), (100, 16, 1, 3)])
def test_local_chunk_attention_through_the_chunk_view_matches_reference(S, window, KV, G):
    import jax.numpy as jnp
    from repro.models import attention as jattn
    rng = np.random.default_rng(20)
    B, dh = 2, 16
    q = rng.standard_normal((B, S, KV, G, dh), np.float32)
    k = rng.standard_normal((B, S, KV, dh), np.float32)
    v = rng.standard_normal((B, S, KV, dh), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    got = attention.local_chunk_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                          window=window).numpy()
    want = np.asarray(jattn.local_chunk_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                                  window=window))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max())


_GLOO = """
import sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import xlaforms
from repro_torch.models.attention import local_chunk_attention
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
xlaforms.register_strategies()
rng = np.random.default_rng(0)
full = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
        for s in ((2, 32, 2, 3, 8), (2, 32, 2, 8), (2, 32, 2, 8), (2, 32, 2, 3, 8))]
pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
res = {}
for name, shape, q_pl, kv_pl, C in (
        ("2d", (2, 2), [Shard(1), Shard(1)], [Shard(1), Shard(1)], 16),
        ("2d_whole_keys", (2, 2), [Shard(1), Shard(1)], [Replicate(), Replicate()], 16),
        ("1d", (4,), [Shard(1)], [Shard(1)], 4)):
    dm = DeviceMesh("cpu", torch.arange(4).reshape(shape))
    rep = [Replicate()] * len(shape)
    q, k, v = (DTensor.from_local(t, dm, rep).redistribute(dm, pl).detach().requires_grad_()
               for t, pl in zip(full[:3], (q_pl, kv_pl, kv_pl)))
    with implicit_replication(), xlaforms.XlaForms():
        o = local_chunk_attention(q, k, v, pos, pos, C)
        o.backward(DTensor.from_local(full[3], dm, rep).redistribute(dm, o.placements))
    res[name + "/placements"] = np.array(str(list(o.placements)))
    res[name + "/o"] = o.full_tensor().detach().numpy()
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        res[f"{name}/{n}"] = t.grad.full_tensor().numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo group's results, one a rank, and pair 215's (the point, the
    port's counters, the engine, the reference's counters from a fresh
    run): the reference's subprocess and the gloo group's four start
    together and run while the port traces the pair."""
    tmp = tmp_path_factory.mktemp("micro")
    archs, restrict, rows = parity.pair_points(PAIRS, moe=True)
    point = next(p for i, p, _ in rows if i == PAIR)
    arg = tmp / "points.json"
    arg.write_text(json.dumps([[point], archs, {k: list(v) for k, v in restrict.items()}]))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=32",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "reference_counters.py"),
                            str(arg)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    group = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_GLOO), str(r), str(port),
                               str(tmp / f"r{r}.npz")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    eng = Engine(SearchSpace(bench_archs(archs), BENCH_SHAPES, restrict=restrict),
                 bench_meshes(), persistent_cache=False, struct_dedup=False, device="cpu")
    got = eng.measure(point)
    eng.close()
    for p in group:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    out, err = ref.communicate(timeout=900)
    assert ref.returncode == 0, err[-3000:]
    return ([dict(np.load(tmp / f"r{r}.npz")) for r in range(4)],
            (point, got, eng, json.loads(out.strip().splitlines()[-1])[0]))


@pytest.mark.parametrize("case,C", [("2d", 16), ("2d_whole_keys", 16), ("1d", 4)])
def test_the_chunk_view_form_is_plain_autograd_on_gloo(runs, case, C):
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 32, 2, 3, 8), (2, 32, 2, 8), (2, 32, 2, 8), (2, 32, 2, 3, 8)))
    for t in (q, k, v):
        t.requires_grad_()
    pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
    o = attention.local_chunk_attention(q, k, v, pos, pos, C)
    o.backward(g)
    for r in runs[0]:
        assert str(r[f"{case}/placements"]) in ("[Shard(dim=1), Shard(dim=1)]", "[Shard(dim=1)]")
        np.testing.assert_allclose(r[f"{case}/o"], o.detach().numpy(), rtol=1e-5, atol=1e-6)
        for n, t in (("dq", q), ("dk", k), ("dv", v)):
            np.testing.assert_allclose(r[f"{case}/{n}"], t.grad.numpy(), rtol=1e-5, atol=1e-6)


def test_pair_215_gives_todays_reference_kinds_and_useful_ratio(runs):
    point, got, eng, ref = runs[1]
    assert eng.n_failures == 0, eng.errors
    assert not parity.unlisted_at(eng.replicated_at)
    assert eng.replicated_ops == {}
    ref_kinds = tuple(sorted(ref_anomaly.kinds(ref, point["remat"])))
    assert ref_kinds == parity.SMOKE_PAIRS[PAIR]
    assert PAIR not in parity.PAIR_KIND_DIFFERENCES
    assert tuple(sorted(anomaly.kinds(got, point["remat"]))) == ref_kinds
    u, ur = got["perf.useful_flops_ratio"], ref["perf.useful_flops_ratio"]
    assert abs(u / ur - 1) <= parity.USEFUL_RATIO_REL_BOUND, (u, ur)
