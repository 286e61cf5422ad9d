"""The trace's halo form of a shift along a sharded dim, and its hoisted
select of a sharded dim (``repro_torch.launch.xlaforms``).

GSPMD partitions a constant pad before a sharded sequence followed by the
slice back to its length (``layers.shift``: rwkv6's token shift, the
RG-LRU's causal conv) as a halo exchange: each shard shifted, its first
``k`` rows the previous shard's last ``k``, taken by one
collective-permute.  DTensor's own concatenation all-gathers the sequence
instead.

* On the single bench mesh (fake tensors), the shift by ``k`` of an
  activation sharded on its sequence keeps it sharded, and the trace runs
  one collective-permute of ``k`` rows a shard forward and one backward,
  and no other collective.
* On a ``gloo`` group of 4 CPU processes (a 1-D mesh, and a 2 x 2 mesh with
  the sequence on one axis), the shift's values and the input's gradient
  equal the plain shift's bit for bit, for ``k`` = 1 and 3; a pad of the
  sharded sequence is the plain pad; the only collectives of
  the shift are one-peer all-to-alls (``funcol.permute_tensor``'s form),
  none an all-gather.  rwkv6's split of its five mixed streams, a cumsum
  along a dim the mesh does not shard and the loss over vocab-sharded
  logits give the plain functions' values and gradients there too.
* A loop of selects along a sharded dim (the chunked WKV's ``rc[:, ci]``)
  all-gathers the dim once, not once a select.
* The rwkv6-7b corpus witness (fsdp ``train_s``) traces no all-gather of
  its sequence-sharded activation for the shift: a collective-permute a
  shift, forward and backward (16; the reference's ``n_permute`` counts 25:
  these 16, 8 more of 3 rows in its backward, and 1 in the embedding's
  backward).
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
import torch.nn.functional as F

from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from repro_torch.core.searchspace import SearchSpace
from repro_torch.launch import traceanalysis, xlaforms
from repro_torch.launch.steps import build_cell
from repro_torch.models.layers import shift
from repro_torch.models.transformer import lm_loss

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _fake_activation(fake, dm, grad=True):
    """(32, 256, 256) f32 on the single bench mesh: rows on data, the
    sequence on model (8 x 64 x 256 a rank)."""
    from torch.distributed.tensor import DTensor, Shard
    with fake:
        return DTensor.from_local(torch.empty(8, 64, 256, requires_grad=grad), dm,
                                  [Shard(0), Shard(1)], run_check=False,
                                  shape=torch.Size((32, 256, 256)), stride=(65536, 256, 1))


@pytest.mark.parametrize("k", [1, 3])
def test_the_shift_is_one_collective_permute_of_k_rows_each_way(k):
    from torch._subclasses.fake_tensor import FakeTensorMode
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    x = _fake_activation(fake, dm)
    with fake, rec, traceanalysis.dtensor_hooks(rec), xlaforms.XlaForms():
        y = shift(x, k)
        assert y.placements == x.placements and tuple(y.to_local().shape) == (8, 64, 256)
        n_fwd = len([r for r in rec.records if r["kind"] == "collective"])
        y.sum().backward()
    colls = [r for r in rec.records if r["kind"] == "collective"]
    assert n_fwd == 1 and [r["coll"] for r in colls] == ["collective-permute"] * 2
    assert [r["in_bytes"] for r in colls] == [8 * k * 256 * 4] * 2
    assert rec.replicated == {}


def test_a_loop_of_selects_on_a_sharded_dim_gathers_once():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Shard
    dm = bench_meshes()["single"].device_mesh("cpu")
    fake = FakeTensorMode()
    rec = traceanalysis.Recorder(fake)
    with fake:       # (B, chunks, C, H, hs): the chunks on model
        rc = DTensor.from_local(torch.empty(8, 4, 16, 8, 32), dm, [Shard(0), Shard(1)],
                                run_check=False, shape=torch.Size((32, 16, 16, 8, 32)),
                                stride=(65536, 4096, 256, 32, 1))
    with fake, rec, traceanalysis.dtensor_hooks(rec), xlaforms.XlaForms():
        chunks = [rc[:, ci] for ci in range(16)]
    assert all(tuple(c.to_local().shape) == (8, 16, 8, 32) for c in chunks)
    assert [r["coll"] for r in rec.records if r["kind"] == "collective"] == ["all-gather"]


_GLOO = """
import sys, numpy as np, torch, torch.distributed as dist, torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch.launch import xlaforms
from repro_torch.models.layers import shift
from repro_torch.models.rwkv6 import split_streams
from repro_torch.models.transformer import lm_loss
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)


class Log(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("_c10d_functional.") and "wait" not in name:
            peers = None
            if "all_to_all_single" in name:
                peers = (sum(1 for n in args[2] if n), sum(1 for n in args[1] if n))
            self.ops.append((name.split(".")[1], peers))
        return func(*args, **(kwargs or {}))


rng = np.random.default_rng(0)
x_full = torch.from_numpy(rng.standard_normal((2, 16, 3)).astype(np.float32))
g_full = torch.from_numpy(rng.standard_normal((2, 16, 3)).astype(np.float32))
m_full = torch.from_numpy(rng.standard_normal((2, 16, 5, 3)).astype(np.float32))
l_full = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
lab_full = torch.from_numpy(rng.integers(-1, 8, (2, 16)))
res = {}
for name, shape, pl in (("1d", (4,), [Shard(1)]), ("2d", (2, 2), [Replicate(), Shard(1)])):
    dm = DeviceMesh("cpu", torch.arange(4).reshape(shape))
    for k in (1, 3):
        x = DTensor.from_local(x_full, dm, [Replicate()] * len(shape)).redistribute(dm, pl)
        x = x.detach().requires_grad_()
        log = Log()
        with log, xlaforms.XlaForms():
            y = shift(x, k)
            y.backward(DTensor.from_local(g_full, dm, [Replicate()] * len(shape))
                       .redistribute(dm, pl))
        res[f"{name}/{k}/y"] = y.full_tensor().detach().numpy()
        res[f"{name}/{k}/dx"] = x.grad.full_tensor().numpy()
        res[f"{name}/{k}/ops"] = np.array(json.dumps(log.ops))
        with xlaforms.XlaForms():
            z = F.pad(x.detach(), (0, 0, k, 0)) * 2.0
        res[f"{name}/{k}/z"] = z.full_tensor().numpy()
    # rwkv6's split of its mixed streams and a cumsum along an unsharded dim
    m = DTensor.from_local(m_full, dm, [Replicate()] * len(shape)).redistribute(
        dm, [Shard(1) if p.is_shard() else p for p in pl]).detach().requires_grad_()
    c = x.detach().requires_grad_()
    with xlaforms.XlaForms():
        streams = split_streams(m)
        sum(s * float(i + 1) for i, s in enumerate(streams)).sum().backward()
        (c.cumsum(2) * DTensor.from_local(g_full, dm, [Replicate()] * len(shape))
         .redistribute(dm, pl)).sum().backward()
    res[f"{name}/streams"] = np.stack([s.full_tensor().detach().numpy() for s in streams])
    res[f"{name}/dmixed"] = m.grad.full_tensor().numpy()
    res[f"{name}/cumsum_dx"] = c.grad.full_tensor().numpy()
    # the loss over vocab-sharded logits: log_softmax and the label's pick
    lg = DTensor.from_local(l_full, dm, [Replicate()] * len(shape)).redistribute(
        dm, [Shard(2) if p.is_shard() else p for p in pl]).detach().requires_grad_()
    with xlaforms.XlaForms():
        loss = lm_loss(lg, DTensor.from_local(lab_full, dm, [Replicate()] * len(shape)))
        loss.backward()
    res[f"{name}/loss"] = loss.full_tensor().detach().numpy()
    res[f"{name}/dlogits"] = lg.grad.full_tensor().numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = "import json\n" + textwrap.dedent(_GLOO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(port),
                               str(tmp / f"r{r}.npz")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(4)]


def _plain(k):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 16, 3)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 16, 3)).astype(np.float32))
    y = F.pad(x, (0, 0, k, 0))[:, :16]
    y.backward(g)
    return y.detach().numpy(), x.grad.numpy(), F.pad(x.detach(), (0, 0, k, 0)).numpy() * 2.0


@pytest.mark.parametrize("mesh", ["1d", "2d"])
@pytest.mark.parametrize("k", [1, 3])
def test_the_halo_shift_is_the_plain_shift_on_gloo(gloo, mesh, k):
    y, dx, z = _plain(k)
    for r in gloo:
        assert np.array_equal(r[f"{mesh}/{k}/y"], y)
        assert np.array_equal(r[f"{mesh}/{k}/dx"], dx)
        assert np.array_equal(r[f"{mesh}/{k}/z"], z)
        ops = json.loads(str(r[f"{mesh}/{k}/ops"]))
        assert "all_gather_into_tensor" not in [o for o, _ in ops]
        # the shift forward and backward: one permute each; the gradient's
        # redistribution to the input's placement is local
        assert [o for o in ops if o[0] == "all_to_all_single"] == \
            [["all_to_all_single", [1, 1]]] * 2


@pytest.mark.parametrize("mesh", ["1d", "2d"])
def test_the_stream_split_cumsum_and_loss_forms_are_plain_autograd_on_gloo(gloo, mesh):
    """rwkv6's split of its five mixed streams (``xlaforms._Streams``, whose
    backward records XLA's collectives and moves no data), a cumsum of a
    sequence-sharded DTensor along its last dim (``xlaforms._Cumsum``), and
    the loss over vocab-sharded logits (``_log_softmax``, ``_GradSummed``,
    ``_Picked``; labels -1 masked) give the plain functions' values and
    gradients."""
    rng = np.random.default_rng(0)
    x, g, m, logits = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       for s in ((2, 16, 3), (2, 16, 3), (2, 16, 5, 3), (2, 16, 8)))
    labels = torch.from_numpy(rng.integers(-1, 8, (2, 16)))
    x.requires_grad_(), m.requires_grad_(), logits.requires_grad_()
    streams = m.unbind(2)
    sum(s * float(i + 1) for i, s in enumerate(streams)).sum().backward()
    (x.cumsum(2) * g).sum().backward()
    loss = lm_loss(logits, labels)
    loss.backward()
    for r in gloo:
        assert np.array_equal(r[f"{mesh}/streams"], torch.stack(streams).detach().numpy())
        assert np.array_equal(r[f"{mesh}/dmixed"], m.grad.numpy())
        np.testing.assert_allclose(r[f"{mesh}/cumsum_dx"], x.grad.numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"{mesh}/loss"], loss.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(r[f"{mesh}/dlogits"], logits.grad.numpy(), rtol=1e-5,
                                   atol=1e-7)


def test_the_rwkv6_witness_shifts_by_collective_permutes():
    """The corpus's rwkv6-7b A1 witness: every shift (time-mix and
    channel-mix, 4 layers) is one collective-permute forward and one
    backward, and the sequence-sharded (B, S, D) activation is never
    all-gathered."""
    data = json.loads((ROOT / "benchmarks" / "results" / "anomaly_corpus.json").read_text())
    p = next(e["witness"] for e in data["entries"] if e["witness"]["arch"] == "rwkv6-7b")
    space = SearchSpace(bench_archs(["rwkv6-7b"]), BENCH_SHAPES)
    cfg, shape, policy, mk = space.to_run(space.normalize(p))
    trace = build_cell(cfg, shape, policy, bench_meshes()[mk]).trace("cpu")
    # (the collectives that xlaforms._recorded records move no data)
    recs = [r for r in trace.records if r["op"] != "prim.device.default"
            and "wait_tensor" not in r["op"] and not r["op"].startswith("repro_trace.wire")]
    assert len([r for r in recs if r.get("coll") == "collective-permute"]) == 16
    # a rank's (B, S, D) activation (8 rows of 64 steps of 256) is gathered
    # only for the products that take its whole sequence (the unembedding
    # and its backward, as the reference's) and the embedding's backward:
    # after the gather's rearrangement (a chunk or split and a cat) comes
    # one of those, never the pad's filled slice
    for i, r in enumerate(recs):
        if r.get("coll") == "all-gather" and r["in"][0][0] == (8, 64, 256):
            assert recs[i + 3]["op"].split(".")[1] in ("dot_general",
                                                       "embedding_dense_backward")
