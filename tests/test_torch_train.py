"""The port's training path against the JAX package's, from the same weights.

Weights and optimizer states are drawn or computed by the JAX package and
carried across with ``api.from_numpy_params`` and
``optimizer.from_numpy_opt_state``; tokens, gradients and other inputs are
drawn with numpy.  Everything runs in f32 on the CPU, the JAX package's
Pallas kernels in interpret mode (``use_pallas=True``).

Tolerances, each relative to the reference's largest magnitude in the leaf
(taken as at least ``1e-30``):

* optimizer updates on the same trees: params, moments 2e-5 (the same f32
  arithmetic in another order);
* a train step: loss 1e-5 absolute; grads, grad norm and moments 5e-4.  XLA
  on the CPU and PyTorch differ in summation order and in their exp/log
  approximations: with the kernels off in both packages the grads already
  differ by ~1.2e-4 of a leaf's largest value at these sizes, while a wrong
  mask, head grouping or a missing attention gradient moves them by O(1).
  Updated params: 5e-2 of the learning rate where |g_ref| > 1e-6 of the
  leaf's largest gradient (AdamW's step is ~lr * sign(g), so a gradient that
  is ~0 in both packages may flip sign and move its param by 2 lr);
* remat policies against each other: 1e-6 (the same ops, recomputed).
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.all_archs import smoke_config as ref_smoke
from repro.configs.base import RunPolicy as RefPolicy
from repro.configs.base import ShapeSpec as RefShapeSpec
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models import api as ref_api
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import RunPolicy, ShapeSpec
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.models import api
from repro_torch.models.module import flatten
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

OPT_TOL = 2e-5
GRAD_TOL = 5e-4
PARAM_TOL_LR = 5e-2
REMAT_TOL = 1e-6


def _flat_ref(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_flat_port(v, key))
        else:
            out[key] = v.detach().float().numpy()
    return out


def _rel(ref, port):
    """Largest |ref - port| over the leaf's largest |ref|, per leaf."""
    r, p = _flat_ref(ref), _flat_port(port)
    assert r.keys() == p.keys()
    return {k: float(np.max(np.abs(r[k] - p[k])) / max(np.max(np.abs(r[k])), 1e-30))
            for k in r}


def _worst(ref, port):
    errs = _rel(ref, port)
    k = max(errs, key=errs.get)
    return errs[k], k


# ------------------------------------------------------------------ optimizer

def _opt_trees(seed):
    """A param tree with 1-D (unfactored) and 2-D/3-D (factored) leaves."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": {"a": (3, 4, 5), "b": (7,)}, "bias": (5,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return draw(shapes), [draw(shapes) for _ in range(3)]


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["adamw", "sgdm", "adafactor"])
def test_optimizer_matches_reference(name):
    """Three updates with the same gradients: params and state equal the
    reference's, adafactor's factored (2-D, 3-D) and unfactored (1-D) leaves
    alike."""
    params, grads = _opt_trees(0)
    rcfg = ropt.OptConfig(name=name, warmup=2, decay_steps=5, grad_clip=2.0)
    pcfg = popt.OptConfig(name=name, warmup=2, decay_steps=5, grad_clip=2.0)
    rp, pp = _to_jax(params), _to_torch(params)
    rs, ps = ropt.init_opt_state(rcfg, rp), popt.init_opt_state(pcfg, pp)
    for g in grads:
        rp, rs, rstats = ropt.opt_update(rcfg, _to_jax(g), rs, rp)
        pp, ps, pstats = popt.opt_update(pcfg, _to_torch(g), ps, pp)
        assert abs(float(rstats["grad_norm"]) - float(pstats["grad_norm"])) \
            < OPT_TOL * float(rstats["grad_norm"])
        assert abs(float(rstats["lr"]) - float(pstats["lr"])) < 1e-12
        assert _worst(rp, pp)[0] < OPT_TOL
        for k in rs["mom"]:
            assert _worst(rs["mom"][k], ps["mom"][k])[0] < OPT_TOL, k
        assert int(rs["step"]) == int(ps["step"])


def test_schedule_and_clip_match_reference():
    rcfg, pcfg = ropt.OptConfig(warmup=10, decay_steps=50), popt.OptConfig(warmup=10,
                                                                          decay_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 50, 80):
        a = float(ropt.schedule(rcfg, jnp.asarray(step, jnp.int32)))
        b = float(popt.schedule(pcfg, torch.tensor(step, dtype=torch.int32)))
        assert abs(a - b) <= 1e-6 * max(a, 1e-12), step
    _, grads = _opt_trees(1)
    for max_norm in (0.5, 100.0):
        rc, rn = ropt.clip_by_global_norm(_to_jax(grads[0]), max_norm)
        pc, pn = popt.clip_by_global_norm(_to_torch(grads[0]), max_norm)
        assert abs(float(rn) - float(pn)) < OPT_TOL * float(rn)
        assert _worst(rc, pc)[0] < OPT_TOL


def test_from_numpy_opt_state_checks_its_tree():
    params, _ = _opt_trees(2)
    st = jax.tree.map(np.asarray, ropt.init_opt_state(ropt.OptConfig(), _to_jax(params)))
    got = popt.from_numpy_opt_state(popt.OptConfig(), st, "cpu")
    assert got["step"].dtype == torch.int32 and got["mom"]["m"]["w"].shape == (6, 5)
    with pytest.raises(ValueError, match="moments"):
        popt.from_numpy_opt_state(popt.OptConfig(name="sgdm"), st, "cpu")


# ------------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def smoke():
    """The qwen2 smoke config, its reference params with nonzero QKV biases,
    and a batch of 4 sequences of 32 tokens."""
    rcfg, pcfg = ref_smoke("qwen2-1.5b"), smoke_config("qwen2-1.5b")
    rp = ref_api.init(rcfg, jax.random.PRNGKey(0))
    rp = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(p))), a.shape)
        if str(p[-1]).strip("[]'") in ("bq", "bk", "bv") else a, rp)
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return rcfg, pcfg, rp, batch


def _policies(remat="dots", n_microbatch=2):
    kw = dict(remat=remat, n_microbatch=n_microbatch, dtype="f32", use_pallas=True)
    return RefPolicy(**kw), RunPolicy(**kw)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("n_microbatch", [1, 2])
def test_compute_grads_matches_reference(smoke, n_microbatch):
    rcfg, pcfg, rp, batch = smoke
    rpol, ppol = _policies(n_microbatch=n_microbatch)
    rl, ra, rg = jax.jit(lambda p, b: rts.compute_grads(rcfg, rpol, p, b))(rp, _jb(batch))
    pp = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp), "cpu")
    pl, pa, pg = pts.compute_grads(pcfg, ppol, pp, _tb(batch))
    assert abs(float(rl) - float(pl)) < 1e-5
    assert np.allclose(np.asarray(ra), pa.numpy())
    assert all(g.dtype == torch.float32 for _, g in flatten(pg))
    err, leaf = _worst(rg, pg)
    assert err < GRAD_TOL, (err, leaf)
    attn = pg["units"]["b0"]["attn"]
    assert all(float(attn[w].abs().max()) > 0 for w in ("wq", "wk", "wv", "bq"))


def test_train_step_matches_reference_from_its_state(smoke):
    """Step 2 of adamw, started in both packages from the reference's params
    and optimizer state after its step 1."""
    rcfg, pcfg, rp, batch = smoke
    rpol, ppol = _policies()
    ro = ropt.OptConfig(warmup=2)
    rstep = jax.jit(rts.make_train_step(rcfg, rpol, ro))
    rp1, rs1, _ = rstep(rp, rts.make_init_opt(rcfg, rpol, ro)(rp), _jb(batch))
    rg = jax.jit(lambda p, b: rts.compute_grads(rcfg, rpol, p, b)[2])(rp1, _jb(batch))
    rp2, rs2, rm2 = rstep(rp1, rs1, _jb(batch))

    po = popt.OptConfig(warmup=2)
    pp1 = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp1), "cpu")
    ps1 = popt.from_numpy_opt_state(po, jax.tree.map(np.asarray, rs1), "cpu")
    pp2, ps2, pm2 = pts.make_train_step(pcfg, ppol, po)(pp1, ps1, _tb(batch))

    assert abs(float(rm2["loss"]) - float(pm2["loss"])) < 1e-5
    assert abs(float(rm2["grad_norm"]) - float(pm2["grad_norm"])) \
        < GRAD_TOL * float(rm2["grad_norm"])
    assert float(rm2["lr"]) == pytest.approx(float(pm2["lr"]), rel=1e-6)
    assert int(ps2["step"]) == int(rs2["step"]) == 2
    for k in ("m", "v"):
        err, leaf = _worst(rs2["mom"][k], ps2["mom"][k])
        assert err < GRAD_TOL, (k, err, leaf)
    g, r, p = _flat_ref(rg), _flat_ref(rp2), _flat_port(pp2)
    lr = float(rm2["lr"])
    for k in r:
        live = np.abs(g[k]) > 1e-6 * np.abs(g[k]).max()
        assert np.max(np.abs(r[k] - p[k]) * live) < PARAM_TOL_LR * lr, k
        assert np.max(np.abs(r[k] - p[k])) <= 2.5 * lr, k      # a sign flip at most


def test_remat_policies_give_the_same_loss_and_grads(smoke):
    _, pcfg, rp, batch = smoke
    pp = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp), "cpu")
    out = {r: pts.compute_grads(pcfg, _policies(remat=r)[1], pp, _tb(batch))
           for r in ("none", "dots", "full")}
    base_l, _, base_g = out["none"]
    flat = _flat_port(base_g)
    for r in ("dots", "full"):
        loss, _, grads = out[r]
        assert abs(float(loss) - float(base_l)) < REMAT_TOL
        for k, v in _flat_port(grads).items():
            assert np.max(np.abs(v - flat[k])) <= REMAT_TOL * max(np.max(np.abs(flat[k])),
                                                                 1e-30), (r, k)


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("dots", 2), ("full", 2)])
def test_remat_recomputes_the_attention_forward(smoke, remat, per_layer, monkeypatch):
    """The flash-attention forward runs once per layer and microbatch without
    remat and twice under dots/full (recomputed in backward); the backward
    once per layer and microbatch; prefill without autograd once per layer."""
    _, pcfg, rp, batch = smoke
    pp = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp), "cpu")
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd

    def counted(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(fa_mod, "flash_attention_fwd", counted("fwd", fwd))
    monkeypatch.setattr(fa_mod, "flash_attention_bwd", counted("bwd", bwd))
    ppol = _policies(remat=remat)[1]
    pts.compute_grads(pcfg, ppol, pp, _tb(batch))
    n = pcfg.n_layers * ppol.n_microbatch
    assert calls == {"fwd": per_layer * n, "bwd": n}
    calls.update(fwd=0, bwd=0)
    with torch.inference_mode():
        api.forward(pp, {"tokens": _tb(batch)["tokens"]}, pcfg, ppol,
                    return_cache=True, cache_len=40)
    assert calls == {"fwd": pcfg.n_layers, "bwd": 0}


def test_attention_output_carries_the_flash_attention_grad_fn(smoke):
    """The model's attention output is differentiable through FlashAttention;
    calling the forward wrapper on inputs that need grad raises."""
    _, pcfg, rp, _ = smoke
    from repro_torch.models import attention
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 2, 16, generator=g, requires_grad=True)
    k = torch.randn(1, 8, 2, 16, generator=g, requires_grad=True)
    out = attention.pallas_attention(q, k, k)
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    assert any(type(f).__name__ == "FlashAttentionBackward" for f in seen)
    with pytest.raises(RuntimeError, match="call flash_attention"):
        fa_mod.flash_attention_fwd(q[:, :, 0].transpose(1, 2), k.transpose(1, 2),
                                   k.transpose(1, 2))


def test_compute_grads_refuses_serving_cast_params(smoke):
    _, pcfg, rp, batch = smoke
    pp = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp), "cpu")
    with pytest.raises(ValueError, match="unembed_f32"):
        pts.compute_grads(pcfg, _policies()[1], api.cast_params(pp, torch.bfloat16),
                          _tb(batch))


def test_train_step_options_that_need_a_mesh_raise(smoke):
    """grad_compress without a pod axis (no mesh, or a mesh without "pod")
    trains as "none" does, as in the JAX package; a mesh alone is taken (the
    arguments' DTensor placements carry the sharding); an uneven microbatch
    split raises."""
    _, pcfg, rp, batch = smoke
    po = popt.OptConfig(warmup=2)
    pp = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp), "cpu")
    no_pod = type("Mesh", (), {"shape": {"data": 4, "model": 4}})()
    runs = []
    for gc, mesh in (("none", None), ("int8", None), ("bf16", no_pod)):
        pol = RunPolicy(remat="none", n_microbatch=1, dtype="f32", grad_compress=gc)
        st = pts.make_init_opt(pcfg, pol, po, mesh)(pp)
        assert "ef" not in st
        runs.append(pts.make_train_step(pcfg, pol, po, mesh)(pp, st, _tb(batch)))
    for p, st, m in runs[1:]:
        assert float(m["loss"]) == float(runs[0][2]["loss"])
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten(p),
                                                               flatten(runs[0][0])))
    with pytest.raises(ValueError, match="divisible"):
        pts.microbatches(torch.zeros(3, 4), 2)


# ------------------------------------------------------------------------ data

@pytest.mark.parametrize("arch", ["qwen2-1.5b", "tinyllama-1.1b"])
def test_synthetic_lm_gives_the_reference_tokens(arch):
    ref = RefSyntheticLM(ref_smoke(arch), RefShapeSpec("t", "train", 64, 4), seed=3)
    ours = SyntheticLM(smoke_config(arch), ShapeSpec("t", "train", 64, 4), seed=3)
    pf = Prefetcher(ours, start_step=5)
    try:
        for step in (5, 6, 7):
            got_step, b = pf.next()
            assert got_step == step
            want = ref.batch(step)
            assert b.keys() == want.keys()
            for k in want:
                assert b[k].dtype == want[k].dtype and np.array_equal(b[k], want[k])
    finally:
        pf.close()
    assert not pf._t.is_alive()


def test_train_cli_runs_on_the_cpu(tmp_path):
    # a fresh checkpoint directory: the launcher resumes from the newest step
    # in --ckpt-dir, as the reference's does
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                        "--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": "src"},
                       cwd=pathlib.Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "step     1 loss" in r.stdout and "[launch] done" in r.stdout
