"""The port's ``ckpt/checkpoint.py`` against the JAX package's: the
reference's own cases (``tests/test_checkpoint.py``), a bit-exact resume
through the port's train step (``tests/test_system.py``'s), and checkpoints
restored across the two packages both ways, a bf16 leaf included (values
equal bit for bit)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefManager
from repro.configs.all_archs import smoke_config as ref_smoke
from repro.configs.base import RunPolicy as RefPolicy
from repro.models import api as ref_api
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import RunPolicy, ShapeSpec
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api
from repro_torch.models.module import flatten
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts


@pytest.fixture
def tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"m": torch.ones((4,)), "step": torch.tensor(7, dtype=torch.int32)}}


@pytest.fixture
def one_thread():
    """One intra-op thread, so that CPU sums run in one order every time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------- the reference's cases

def test_roundtrip(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(3, tree)
    meta, restored = cm.restore_latest(tree)
    assert meta["step"] == 3
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert int(restored["opt"]["step"]) == 7
    assert restored["opt"]["step"].dtype == torch.int32


def test_corruption_falls_back(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree)
    cm.save(2, tree)
    with open(os.path.join(str(tmp_path), "step_2", "arrays.npz"), "wb") as f:
        f.write(b"corrupt")
    meta, restored = cm.restore_latest(tree)
    assert meta["step"] == 1


def test_gc_keeps_last(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    for s in (1, 2, 3, 4):
        cm.save(s, tree)
    assert cm.list_steps() == [3, 4]


def test_async_save(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(5, tree)
    cm.wait()
    meta, _ = cm.restore_latest(tree)
    assert meta["step"] == 5


def test_restore_empty(tmp_path, tree):
    cm = CheckpointManager(str(tmp_path))
    meta, restored = cm.restore_latest(tree)
    assert meta is None and restored is None


def test_partial_write_invisible(tmp_path, tree):
    """A .tmp dir (simulated crash mid-write) is never restored."""
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    meta, _ = cm.restore_latest(tree)
    assert meta["step"] == 1


# ------------------------------------------------------------- the port's own

def test_async_save_snapshots_before_the_tensors_change(tmp_path, tree):
    """The optimizer updates in place: a save returns with its own copy,
    so a change after ``save`` does not reach the file."""
    want = tree["params"]["w"].clone()
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(1, tree)
    tree["params"]["w"].add_(100.0)
    cm.wait()
    _, restored = cm.restore_latest(tree)
    assert torch.equal(restored["params"]["w"], want)


def test_a_corrupt_newest_array_falls_back(tmp_path, tree):
    """A newest step whose array no longer matches its CRC is skipped."""
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(1, tree)
    cm.save(2, {"params": {"w": tree["params"]["w"] + 1}, "opt": tree["opt"]})
    path = os.path.join(str(tmp_path), "step_2", "arrays.npz")
    arrays = dict(np.load(path))
    arrays["params/w"] = arrays["params/w"] + 1          # same layout, other bits
    np.savez(path, **arrays)
    meta, restored = cm.restore_latest(tree)
    assert meta["step"] == 1
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])


def test_resume_is_bit_exact(tmp_path, one_thread):
    """train 12 == train 8 + save + restore + train 4 (same data order)."""
    cfg = smoke_config("tinyllama-1.1b")
    pol = RunPolicy(remat="none", dtype="f32", n_microbatch=2)
    opt = popt.OptConfig(lr=3e-3, warmup=5, decay_steps=200)
    pipe = SyntheticLM(cfg, ShapeSpec("sys", "train", 64, 8), seed=1)
    step = pts.make_train_step(cfg, pol, opt)

    def train(params, st, start, n):
        for i in range(start, start + n):
            batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
            params, st, _ = step(params, st, batch)
        return params, st

    def fresh():
        p = api.init(cfg, seed=0, device="cpu")
        return p, pts.make_init_opt(cfg, pol, opt)(p)

    pA, _ = train(*fresh(), 0, 12)
    pB, sB = train(*fresh(), 0, 8)
    cm = CheckpointManager(str(tmp_path), async_write=False)
    cm.save(8, {"params": pB, "opt": sB})
    meta, restored = cm.restore_latest({"params": fresh()[0], "opt": fresh()[1]})
    assert meta["step"] == 8
    pC, _ = train(restored["params"], restored["opt"], 8, 4)
    for (ka, a), (kc, c) in zip(flatten(pA), flatten(pC)):
        assert ka == kc and torch.equal(a, c), ka


# ---------------------------------------------------------- across packages

CFG = "qwen2-1.5b"


def _ref_state():
    """The reference's smoke params, an AdamW state after one update (nonzero
    moments) and a bf16 leaf."""
    cfg = ref_smoke(CFG)
    params = ref_api.init(cfg, jax.random.PRNGKey(3))
    opt = ropt.OptConfig(warmup=2)
    st = rts.make_init_opt(cfg, RefPolicy(dtype="f32"), opt)(params)
    grads = jax.tree.map(lambda a: jnp.full(a.shape, 0.01, jnp.float32), params)
    params, st, _ = ropt.opt_update(opt, grads, st, params)
    half = params["embed"]["table"].astype(jnp.bfloat16) * 3
    return {"params": params, "opt": st, "half": half}


def _port_template():
    cfg = smoke_config(CFG)
    params = api.init(cfg, seed=0, device="cpu")
    st = popt.init_opt_state(popt.OptConfig(warmup=2), params)
    return cfg, {"params": params, "opt": st,
                 "half": params["embed"]["table"].to(torch.bfloat16)}


def test_the_port_restores_the_references_checkpoint(tmp_path):
    ref = _ref_state()
    RefManager(str(tmp_path), async_write=False).save(4, ref)
    cfg, template = _port_template()
    meta, got = CheckpointManager(str(tmp_path)).restore_latest(template)
    assert meta["step"] == 4
    host = jax.tree.map(np.asarray, ref)
    want_p = api.from_numpy_params(cfg, host["params"], "cpu")
    want_o = popt.from_numpy_opt_state(popt.OptConfig(warmup=2), host["opt"], "cpu")
    for want, have in ((want_p, got["params"]), (want_o, got["opt"])):
        fw, fh = flatten(want), flatten(have)
        assert [k for k, _ in fw] == [k for k, _ in fh]
        for (k, a), (_, b) in zip(fw, fh):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    half = got["half"]
    assert half.dtype == torch.bfloat16
    assert np.array_equal(half.view(torch.int16).numpy().view(np.uint16),
                          host["half"].view(np.uint16))


def test_the_reference_restores_the_ports_checkpoint(tmp_path):
    cfg, tree = _port_template()
    tree["opt"]["step"] += 5
    cm = CheckpointManager(str(tmp_path), async_write=True)
    cm.save(6, tree)
    cm.wait()
    meta, got = RefManager(str(tmp_path)).restore_latest(_ref_state())
    assert meta is not None and meta["step"] == 6
    ours = dict(flatten(tree))
    theirs = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(ours) == len(theirs)
    for path, a in theirs.items():
        key = tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path)
        t = ours[key]
        if t.dtype == torch.bfloat16:
            assert a.dtype.kind == "V"           # as the reference's own bf16 reads back
            assert np.array_equal(a.view(np.uint16),
                                  t.view(torch.int16).numpy().view(np.uint16)), key
        else:
            assert np.array_equal(np.asarray(a), t.numpy()), key
