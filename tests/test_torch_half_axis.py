"""Port vs reference: a dense train step's microbatches of 1-2 rows, which no
whole mesh axis of the batch rules divides, traced as XLA's loop over
microbatches computes them (``repro_torch.launch.xlaforms._Body``).

XLA tiles the (n, B/n) reshape of a batch on R ranks so that a microbatch's
rows sit on the R/n minor ranks where R > n: pair 149's point (qwen2-1.5b-
bench ``train_s`` under dp on the multi mesh) in 16 microbatches has 2 rows
on the low half of the model axis.  Under ZeRO-1 its loop splits every
weight over the data axis, on the dim the optimizer state is split on, or,
for a stacked layer weight (whose state is split on the layers the layer
loop slices), on its embedding dim: each product contracts a quarter of the
width and all-reduces its partial sums over data, and each layer's weight
gradients are all-gathered over data (the HLO: ``tests/reference_counters.py
--wire``, and ``PERF.md`` §6).  The trace runs the loop body on a finer mesh
over the same ranks, the model axis split 2 x 2, without the axes that only
compute the microbatch again.

* At pair 149's layout in 16 microbatches (fake tensors) a microbatch is
  one row a rank on the low half of the model axis, a stacked weight enters
  the body split on its embedding dim over data and the tied table on its
  vocab, one layer's gate product has XLA's per-device FLOPs and
  all-reduce, and the weight's gradient comes back all-gathered over data
  into its optimizer state's layout.
* At pair 50's layout (rwkv6-7b-bench under ep on the single mesh, 16
  microbatches of 2 rows on 4 data ranks, R <= n) XLA keeps both rows on
  every rank: the microbatch stays whole and the weights are split over
  data only.
* On a ``gloo`` group of 4 CPU processes a small dense model's
  microbatched step (its loss and every gradient) through the form equals
  the plain step within f32 2e-5: ZeRO-1's split over a 2 x 2 mesh (rows of
  1), and rows of 2 on half of a 1-D mesh of 4 without ZeRO-1.
"""
import dataclasses
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core.benchscale import bench_meshes
from repro_torch.launch import sharding, traceanalysis, xlaforms
from repro_torch.train import train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]

_GLOO = """
import dataclasses, sys, numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.launch import sharding, xlaforms
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api
from repro_torch.models.module import flatten, unflatten
from repro_torch.train.train_step import compute_grads
sys.path.insert(0, sys.argv[4])
from test_torch_half_axis import CASES, small_step
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
torch.set_num_threads(1)
xlaforms.register_strategies()
res = {}
for name, (shape, names, n, zero1) in CASES.items():
    cfg, policy, params, batch = small_step(n, zero1)
    mesh = make_mesh(shape, names)
    mesh._meshes["cpu"] = dm = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                                          mesh_dim_names=names)
    rules = dict(policy.rules_dict())
    if zero1:
        rules[sharding.ZERO1] = (("data",),)

    def placed(t, spec):
        rep = DTensor.from_local(t, dm, [Replicate()] * len(shape))
        return rep.redistribute(dm, sharding.placements_for(spec, mesh))
    specs = sharding.tree_specs(mesh, params, api.axes(cfg), rules)
    params = unflatten([(p, placed(t, s)) for (p, t), (_, s) in
                        zip(flatten(params), flatten(specs))])
    spec = sharding.spec_for(tuple(batch["tokens"].shape), ("batch", None), rules, mesh)
    batch = {k: placed(v, spec) for k, v in batch.items()}
    with sharding.use_rules(mesh, rules), implicit_replication(), xlaforms.XlaForms():
        loss, aux, grads = compute_grads(cfg, policy, params, batch)
    res[name + "/loss"] = loss.full_tensor().detach().numpy()
    for p, g in flatten(grads):
        res[name + "/" + "/".join(p)] = g.full_tensor().numpy()
np.savez(out, **res)
dist.destroy_process_group()
"""

# the gloo group's cases: name -> (mesh shape, mesh axes, microbatches, ZeRO-1)
CASES = {"zero1_split": ((2, 2), ("data", "model"), 4, True),
         "half_axis": ((4,), ("data",), 2, False)}


def small_step(n, zero1):
    """A 2-layer qwen2-shaped model (d_model 32, 4 heads over 2 KV heads,
    vocab 64) in f32, its dp step in ``n`` microbatches, and a batch of 4
    rows of 8 tokens, from numpy seed 1.  The table is drawn at unit scale,
    not the init's 0.02: rows of rms 0.02 make the first norm's backward
    scale its input's f32 rounding by 1/rms (the split's partial sums round
    otherwise than the whole sums)."""
    from repro_torch.configs.base import RunPolicy, get_config
    from repro_torch.models import api
    cfg = dataclasses.replace(get_config("qwen2-1.5b"), n_layers=2, d_model=32, d_ff=64,
                              n_heads=4, n_kv_heads=2, d_head=8, vocab_size=64)
    policy = RunPolicy(sharding_preset="dp", remat="none", n_microbatch=n, dtype="f32",
                       zero1=zero1)
    params = api.init(cfg, seed=0, device="cpu")
    params["embed"]["table"] = params["embed"]["table"] * 50
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, 64, (4, 8)).astype(np.int64))
             for k in ("tokens", "labels")}
    return cfg, policy, params, batch


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def gloo_group(tmp_path_factory):
    """The gloo group's four processes, started before the fake-tensor tests
    run; -> a function that waits for them and returns their results."""
    tmp = tmp_path_factory.mktemp("half_axis")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(_GLOO), str(r), str(port),
                               str(tmp / f"r{r}.npz"), str(ROOT / "tests")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]

    def results():
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
        return [dict(np.load(tmp / f"r{r}.npz")) for r in range(4)]
    return results


def _fake(fake, dm, local, placements, shape, dtype=torch.float32, grad=False):
    from torch.distributed.tensor import DTensor
    stride = tuple(int(np.prod(shape[k + 1:])) for k in range(len(shape)))
    with fake:
        t = torch.empty(local, dtype=dtype, requires_grad=grad)
        return DTensor.from_local(t, dm, placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


class _Traced:
    """The trace's modes, forms, hooks and the rules of ``mesh``."""

    def __init__(self, mesh, rules):
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.distributed.tensor.experimental import implicit_replication
        xlaforms.register_strategies()
        self.fake = FakeTensorMode()
        self.rec = traceanalysis.Recorder(self.fake)
        self.modes = [self.fake, sharding.use_rules(mesh, rules), self.rec,
                      implicit_replication(), traceanalysis.dtensor_hooks(self.rec),
                      xlaforms.XlaForms()]

    def __enter__(self):
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)

    def records(self, phase, kind):
        return [r for r in self.rec.records if r["phase"] == phase and r["kind"] == kind]


def _rules(preset):
    rules = sharding.make_rules(preset)
    rules[sharding.ZERO1] = (("data",),)
    return rules


def test_149_in_16_microbatches_runs_a_row_a_rank_with_xlas_products(gloo_group):
    """The batch (32, 256) on all 32 ranks of the multi mesh, 16
    microbatches: each is 2 rows on model_lo, one a rank.  XLA's loop body
    (the HLO of the point): a row's gate product [256,512] <- [256,64] x
    [64,512] a device, its partial sums all-reduced over data (groups of 4),
    and the stacked weight's gradient all-gathered over data, each layer
    kept on its own data rank, as the optimizer state holds it."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = bench_meshes()["multi"]
    dm = mesh.device_mesh("cpu")
    R = Replicate()
    with _Traced(mesh, _rules("dp")) as tr:
        tokens = _fake(tr.fake, dm, (1, 256), [Shard(0)] * 3, (32, 256), torch.int64)
        w = _fake(tr.fake, dm, (4, 256, 512), [R] * 3, (4, 256, 512), grad=True)
        table = _fake(tr.fake, dm, (8192, 256), [R] * 3, (8192, 256), grad=True)
        mb = train_step.microbatches(tokens, 16)[0]
        assert mb.device_mesh.mesh_dim_names == ("pod", "data", "model_hi", "model_lo")
        assert list(mb.placements) == [R, R, R, Shard(0)]
        assert tuple(mb.to_local().shape) == (1, 256)
        axes = {"w": ("layers", "embed", "mlp"), "embed": {"table": ("vocab", "embed")}}
        params = {"w": w, "embed": {"table": table}}
        with train_step.loop_body(params, {"tokens": mb}, axes) as (p, m):
            body = m["tokens"].device_mesh
            assert body.mesh_dim_names == ("data", "model_lo")
            assert list(m["tokens"].placements) == [R, Shard(0)]
            assert list(p["w"].placements) == [Shard(1), R]
            assert tuple(p["w"].to_local().shape) == (4, 64, 512)
            assert list(p["embed"]["table"].placements) == [Shard(0), R]
            x = _fake(tr.fake, body, (1, 256, 256), [R, Shard(0)], (2, 256, 256))
            y = x @ p["w"][0]
            assert list(y.placements) == [R, Shard(0)]
            gw, = torch.autograd.grad(y.sum(), [w])
    products = tr.records("F", "product")
    assert [r["flops"] for r in products] == [2 * 256 * 64 * 512]
    # (the others gather the tokens before the loop)
    assert [(r["coll"], tuple(r["in"][0][0]), r["group"]) for r in tr.records("F", "collective")
            if r["in"][0][1] == "float32"] == [("all-reduce", (1, 256, 512), 4)]
    # the layer dim on data, ZeRO-1's layout of the state, from a gather over data
    assert list(gw.placements) == [R, Shard(0), R] and tuple(gw.to_local().shape) == (1, 256, 512)
    assert ("all-gather", (4, 64, 512), 4) in [
        (r["coll"], tuple(r["in"][0][0]), r["group"]) for r in tr.records("G", "collective")]


def test_pair_50s_rows_stay_whole_and_its_weights_split_over_data(gloo_group):
    """Pair 50's layout: the batch (32, 256) on the 4 data ranks of the
    single mesh under ep, 16 microbatches of 2 rows (R = 4 <= n): XLA keeps
    both rows on every rank (its HLO: 512 tokens a device, the embedding dim
    split over data, the heads over model), so the body keeps the step's
    mesh and splits rwkv6's receptance weight over data on its embedding
    dim beside its heads' shard on model."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = bench_meshes()["single"]
    dm = mesh.device_mesh("cpu")
    R = Replicate()
    with _Traced(mesh, _rules("ep")) as tr:
        tokens = _fake(tr.fake, dm, (8, 256), [Shard(0), R], (32, 256), torch.int64)
        wr = _fake(tr.fake, dm, (4, 256, 2, 32), [R, Shard(2)], (4, 256, 8, 32), grad=True)
        mb = train_step.microbatches(tokens, 16)[0]
        assert mb.device_mesh is dm and list(mb.placements) == [R, R]
        axes = {"wr": ("layers", "embed", "rwkv_heads", "head_dim")}
        with train_step.loop_body({"wr": wr}, {"tokens": mb}, axes) as (p, m):
            assert m["tokens"].device_mesh is dm
            assert tuple(m["tokens"].to_local().shape) == (2, 256)
            assert list(p["wr"].placements) == [Shard(1), Shard(2)]
            assert tuple(p["wr"].to_local().shape) == (4, 64, 2, 32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_form_is_the_plain_step_on_gloo(gloo_group, case):
    from repro_torch.models.module import flatten
    from repro_torch.train.train_step import compute_grads
    runs = gloo_group()
    cfg, policy, params, batch = small_step(*CASES[case][2:])
    loss, _, grads = compute_grads(cfg, policy, params, batch)
    for r in runs:
        assert abs(float(r[case + "/loss"]) - loss.item()) <= 2e-5 * max(1.0, abs(loss.item()))
        for path, g in flatten(grads):
            got, want = r[case + "/" + "/".join(path)], g.numpy()
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 2e-5 * max(1.0, np.abs(want).max()), path
