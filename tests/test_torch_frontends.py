"""The frontend archs (internvl2-1b's vit prefix, musicgen-medium's encodec
codebooks) through the port's model, training and serving paths against the
JAX package's, from the same weights.

Smoke configs of both archs, and internvl2 with its published 14 query heads
over 2 KV heads (G = 7) at smoke width; the reference's weights are carried
across with ``api.from_numpy_params``, tokens and patch embeddings drawn with
numpy.  Tolerances, relative to the reference's largest magnitude (taken as
at least 1):

* the embedding, the unembedding and the loss: f32 2e-5, bf16 2e-2;
* the forward, prefill and decode logits and the K/V cache in f32: 5e-5, the
  bound of ``test_torch_model.py`` (internvl2's patch prefix lifts the
  random-init activations to ~1e3, where the two packages' f32 summation
  orders leave its logits 2.1e-5 apart);
* a bf16 forward: no further from the f32 reference than twice the
  reference's own bf16 forward (one bf16 step of the projector's gelu,
  which the two packages round differently, grows through random-init
  layers to ~0.1 of the logits in both);
* a train step: loss 1e-5 absolute; grads (every leaf, the projector and the
  codebook tables included), grad norm and adamw moments 5e-4, the bound of
  ``test_torch_train.py`` (at 5e-5 the projector's ``w2`` is 7.0e-5 apart and
  musicgen's ``bk``, a bias gradient that nearly cancels, 2.5e-4);
* the serving engines give the same tokens at temperature 0.
"""
import dataclasses

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
from repro.models import transformer as ref_tfm
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import RunPolicy, ShapeSpec
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import api
from repro_torch.models import transformer as tfm
from repro_torch.models.module import flatten
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

TOL, MODEL_TOL, BF16_TOL, GRAD_TOL = 2e-5, 5e-5, 2e-2, 5e-4
ARCHS = ["internvl2-1b", "musicgen-medium"]


def _g7(smoke):
    return dataclasses.replace(smoke("internvl2-1b"), name="internvl2-1b-g7",
                               n_heads=14, n_kv_heads=2)


CONFIGS = {"internvl2-smoke": (ref_smoke("internvl2-1b"), smoke_config("internvl2-1b")),
           "internvl2-g7": (_g7(ref_smoke), _g7(smoke_config)),
           "musicgen-smoke": (ref_smoke("musicgen-medium"), smoke_config("musicgen-medium"))}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    rcfg, pcfg = CONFIGS[request.param]
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    rparams = ref_api.init(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, rparams, api.from_numpy_params(
        pcfg, jax.tree.map(np.asarray, rparams), "cpu")


def _batch(cfg, B, S, seed=0, labels=False):
    """A numpy batch of S positions: the vit's text is S - n_prefix tokens
    after its patch embeddings; encodec's tokens carry the K codebooks."""
    rng = np.random.default_rng(seed)
    k = (cfg.n_codebooks,) if cfg.frontend == "encodec" else ()
    s_text = S - cfg.n_prefix if cfg.frontend == "vit" else S
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s_text) + k).astype(np.int32)}
    if cfg.frontend == "vit":
        out["patch_embeds"] = rng.standard_normal((B, cfg.n_prefix, cfg.d_frontend)) \
            .astype(np.float32)
    if labels:
        lab = rng.integers(0, cfg.vocab_size, (B, S) + k).astype(np.int32)
        if cfg.frontend == "vit":
            lab[:, :cfg.n_prefix] = -1
        out["labels"] = lab
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(a, b):
    a = np.asarray(a, np.float32)
    b = b.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(a)))))


def _policy(dtype="f32", use_pallas=False):
    return (RefPolicy(remat="none", dtype=dtype, use_pallas=use_pallas),
            RunPolicy(remat="none", dtype=dtype, use_pallas=use_pallas))


_DTYPES = {"f32": (jnp.float32, torch.float32, TOL), "bf16": (jnp.bfloat16, torch.bfloat16,
                                                           BF16_TOL)}


# ------------------------------------------------------------- the frontends

@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_embed_tokens(model, dtype):
    rcfg, pcfg, rp, pp = model
    jd, td, tol = _DTYPES[dtype]
    b = _batch(rcfg, 2, 24, seed=1)
    rx, rpos = ref_tfm.embed_tokens(jax.tree.map(lambda a: a.astype(jd), rp), rcfg,
                                    _jb(b), jd)
    px, ppos = tfm.embed_tokens(tfm.cast_params(pp, td), pcfg, _tb(b), td)
    assert px.dtype == td and px.shape == (2, 24, pcfg.d_model)
    assert _close(rx, px) < tol
    assert np.array_equal(np.asarray(rpos), ppos.numpy())


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("lead", [(2, 5), (3,)], ids=["seq", "decode"])
def test_unembed_logits(model, dtype, lead):
    """(B,S,D) and a decode step's (B,D): (..., V), or (..., K, V) for
    encodec, from the compute-dtype-rounded table widened to f32."""
    rcfg, pcfg, rp, pp = model
    jd, td, tol = _DTYPES[dtype]
    x = np.random.default_rng(2).standard_normal(lead + (pcfg.d_model,)).astype(np.float32)
    rl = ref_tfm.unembed_logits(jax.tree.map(lambda a: a.astype(jd), rp), rcfg,
                                jnp.asarray(x).astype(jd))
    pl = tfm.unembed_logits(tfm.cast_params(pp, td), pcfg, torch.from_numpy(x).to(td))
    k = (pcfg.n_codebooks,) if pcfg.frontend == "encodec" else ()
    assert pl.dtype == torch.float32 and tuple(pl.shape) == lead + k + (pcfg.vocab_size,)
    assert _close(rl, pl) < tol


@pytest.mark.parametrize("frontend", ["vit", "encodec"])
def test_lm_loss_with_frontend_labels(frontend):
    """encodec's (B,S,K) labels over (B,S,K,V) logits; the vit's labels -1
    over the patch prefix."""
    rng = np.random.default_rng(3)
    k = (4,) if frontend == "encodec" else ()
    logits = (3 * rng.standard_normal((2, 9) + k + (33,))).astype(np.float32)
    labels = rng.integers(-1, 33, (2, 9) + k).astype(np.int32)
    if frontend == "vit":
        labels[:, :4] = -1
    a = ref_api.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    b = api.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(float(a) - float(b)) < TOL * max(1.0, abs(float(a)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(arch, kind):
    rcfg, pcfg = ref_smoke(arch), smoke_config(arch)
    rs, ra = ref_api.input_specs(rcfg, RefShapeSpec("t", kind, 24, 2))
    ps, pa = api.input_specs(pcfg, ShapeSpec("t", kind, 24, 2))
    assert ra == pa and rs.keys() == ps.keys()
    for k in rs:
        assert tuple(rs[k].shape) == ps[k][0], k
        assert str(rs[k].dtype) == str(ps[k][1]).removeprefix("torch."), k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """Every leaf's shape and logical axes, the projector and the (K, V, D)
    tables included, and the parameter counts."""
    rcfg, pcfg = ref_smoke(arch), smoke_config(arch)
    want = {jax.tree_util.keystr(p): (tuple(s.shape), tuple(s.axes)) for p, s in
            jax.tree_util.tree_flatten_with_path(ref_api.specs(rcfg),
                                                 is_leaf=lambda x: hasattr(x, "axes"))[0]}
    got = {"".join(f"['{k}']" for k in path): (tuple(s.shape), tuple(s.axes))
           for path, s in flatten(api.specs(pcfg))}
    assert got == want
    assert api.n_params(pcfg) == ref_api.n_params(rcfg)
    assert api.matmul_active_params(pcfg) == ref_api.matmul_active_params(rcfg)
    assert any(k.startswith("['projector']") for k in got) == (arch == "internvl2-1b")


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits(model, use_pallas):
    rcfg, pcfg, rp, pp = model
    rpol, ppol = _policy(use_pallas=use_pallas)
    b = _batch(rcfg, 2, 24)
    rl, _ = ref_api.forward(rp, _jb(b), rcfg, rpol)
    pl, _ = api.forward(pp, _tb(b), pcfg, ppol)
    assert _close(rl, pl) < MODEL_TOL


def test_bf16_forward_no_further_from_f32_than_twice_the_reference(model):
    rcfg, pcfg, rp, pp = model
    b = _batch(rcfg, 2, 24)
    truth = np.asarray(ref_api.forward(rp, _jb(b), rcfg, _policy()[0])[0])
    ref16 = ref_api.forward(rp, _jb(b), rcfg, _policy("bf16")[0])[0]
    ours16 = api.forward(pp, _tb(b), pcfg, _policy("bf16")[1])[0]
    scale = max(1.0, float(np.max(np.abs(truth))))
    ref_err = float(np.max(np.abs(np.asarray(ref16, np.float32) - truth))) / scale
    our_err = float(np.max(np.abs(ours16.float().numpy() - truth))) / scale
    assert our_err <= 2 * ref_err + BF16_TOL * 1e-2, (our_err, ref_err)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_then_decode(model, use_pallas):
    """Prefill S-1 positions (the vit's with its patch prefix), then decode
    the last token at position S-1 and three more: each against the
    reference's, and the prefill and first decode against the port's own
    full forward (as ``tests/test_archs_smoke.py`` holds the reference)."""
    rcfg, pcfg, rp, pp = model
    rpol, ppol = _policy(use_pallas=use_pallas)
    B, S, T = 2, 24, 32
    b = _batch(rcfg, B, S, seed=4)
    full, _ = api.forward(pp, _tb(b), pcfg, ppol)
    pre = {k: (v[:, :-1] if k == "tokens" else v) for k, v in b.items()}
    rl, _, rst = ref_api.forward(rp, _jb(pre), rcfg, rpol, return_cache=True, cache_len=T)
    pl, _, pst = api.forward(pp, _tb(pre), pcfg, ppol, return_cache=True, cache_len=T)
    assert _close(rl, pl) < MODEL_TOL
    assert _close(full[:, S - 2].numpy(), pl) < MODEL_TOL
    for name in ("k", "v"):
        assert _close(rst["units"]["b0"][name], pst["units"]["b0"][name]) < MODEL_TOL
    rng = np.random.default_rng(5)
    toks = [b["tokens"][:, -1:]] + [
        rng.integers(0, rcfg.vocab_size, b["tokens"][:, -1:].shape).astype(np.int32)
        for _ in range(3)]
    for j, tok in enumerate(toks):
        pos = np.full((B,), S - 1 + j, np.int32)
        rl, rst = ref_api.decode_step(rp, rst, {"tokens": jnp.asarray(tok),
                                                "position": jnp.asarray(pos)}, rcfg, rpol)
        pl, pst = api.decode_step(pp, pst, {"tokens": torch.from_numpy(tok),
                                            "position": torch.from_numpy(pos)}, pcfg, ppol)
        assert _close(rl, pl) < MODEL_TOL, j
        if j == 0:
            assert _close(full[:, S - 1].numpy(), pl) < MODEL_TOL


# ------------------------------------------------------------------- training

def _flat_ref(tree):
    return {jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"".join(f"['{k}']" for k in path): v.detach().float().numpy()
            for path, v in flatten(tree)}


def _rel(ref, port):
    r, p = _flat_ref(ref), _flat_port(port)
    assert r.keys() == p.keys()
    return {k: float(np.max(np.abs(r[k] - p[k])) / max(np.max(np.abs(r[k])), 1e-30))
            for k in r}


def test_train_step_from_the_reference_state(model):
    """adamw's step 2, remat dots, 2 microbatches, kernels on, started in both
    packages from the reference's params and state after its step 1: loss,
    grad norm, every gradient leaf and both moments."""
    rcfg, pcfg, rp, _ = model
    kw = dict(remat="dots", n_microbatch=2, dtype="f32", use_pallas=True)
    rpol, ppol = RefPolicy(**kw), RunPolicy(**kw)
    b = _batch(rcfg, 4, 24, seed=6, labels=True)
    ro, po = ropt.OptConfig(warmup=2), popt.OptConfig(warmup=2)
    rstep = jax.jit(rts.make_train_step(rcfg, rpol, ro))
    rp1, rs1, _ = rstep(rp, rts.make_init_opt(rcfg, rpol, ro)(rp), _jb(b))
    rl, _, rg = jax.jit(lambda p, x: rts.compute_grads(rcfg, rpol, p, x))(rp1, _jb(b))
    _, rs2, rm2 = rstep(rp1, rs1, _jb(b))

    pp1 = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp1), "cpu")
    pl, _, pg = pts.compute_grads(pcfg, ppol, pp1, _tb(b))
    ps1 = popt.from_numpy_opt_state(po, jax.tree.map(np.asarray, rs1), "cpu")
    _, ps2, pm2 = pts.make_train_step(pcfg, ppol, po)(pp1, ps1, _tb(b))

    assert abs(float(rl) - float(pl)) < 1e-5
    assert abs(float(rm2["loss"]) - float(pm2["loss"])) < 1e-5
    assert abs(float(rm2["grad_norm"]) - float(pm2["grad_norm"])) \
        < GRAD_TOL * float(rm2["grad_norm"])
    errs = _rel(rg, pg)
    worst = max(errs, key=errs.get)
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])
    fe = [k for k in errs if "projector" in k or "table" in k]
    assert len(fe) == (3 + 1 if pcfg.frontend == "vit" else 2), fe
    assert all(float(np.abs(_flat_port(pg)[k]).max()) > 0 for k in fe)
    for m in ("m", "v"):
        e = _rel(rs2["mom"][m], ps2["mom"][m])
        assert max(e.values()) < GRAD_TOL, m


# -------------------------------------------------------------------- serving

def _prompts(vocab, n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.choice([5, 9, 14]))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_serving_engine_serves_internvl2_as_text(use_pallas):
    """The reference's engine sends only ``tokens``: internvl2 is served as
    text, in both packages, to the same tokens."""
    rcfg, pcfg = ref_smoke("internvl2-1b"), smoke_config("internvl2-1b")
    rp = ref_api.init(rcfg, jax.random.PRNGKey(1))
    pp = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rp), "cpu")
    ref = RefEngine(rcfg, RefPolicy(remat="none", dtype="f32"), rp, n_slots=3,
                    cache_len=32, temperature=0.0)
    eng = ServingEngine(pcfg, RunPolicy(remat="none", dtype="f32", use_pallas=use_pallas),
                        pp, n_slots=3, cache_len=32, temperature=0.0, device="cpu")
    for i, p in enumerate(_prompts(rcfg.vocab_size)):
        ref.add_request(RefRequest(rid=i, prompt=p, max_new_tokens=4 + i % 3))
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=4 + i % 3))
    want = {r.rid: r.out for r in ref.run()}
    assert {r.rid: r.out for r in eng.run()} == want
    assert eng.stats == ref.stats


def test_serving_engine_refuses_musicgen_as_the_reference_does():
    rcfg, pcfg = ref_smoke("musicgen-medium"), smoke_config("musicgen-medium")
    with pytest.raises(NotImplementedError):
        RefEngine(rcfg, RefPolicy(dtype="f32"), ref_api.init(rcfg, jax.random.PRNGKey(0)))
    with pytest.raises(NotImplementedError, match="token-stream"):
        ServingEngine(pcfg, RunPolicy(dtype="f32"), api.init(pcfg, device="cpu"),
                      device="cpu")


# ----------------------------------------------------------------------- data

@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_lm_gives_the_reference_batches(arch):
    ref = RefSyntheticLM(ref_smoke(arch), RefShapeSpec("t", "train", 24, 4), seed=3)
    ours = SyntheticLM(smoke_config(arch), ShapeSpec("t", "train", 24, 4), seed=3)
    for step in (0, 5):
        want, got = ref.batch(step), ours.batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    b = ours.batch(0)
    if arch == "internvl2-1b":
        cfg = smoke_config(arch)
        assert b["patch_embeds"].shape == (4, cfg.n_prefix, cfg.d_frontend)
        assert (b["labels"][:, :cfg.n_prefix] == -1).all()
    else:
        assert b["tokens"].shape == b["labels"].shape == (4, 24, 4)
