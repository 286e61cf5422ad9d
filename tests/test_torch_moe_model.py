"""The MoE archs (mixtral-8x7b, phi3.5-moe) through the port's model,
training and serving paths against the JAX package's, from the same weights.

Smoke configs of both archs (4 experts top-2; mixtral's with its sliding
window of 16), the reference's weights carried across with
``api.from_numpy_params``, tokens drawn with numpy, f32 on the CPU.
Tolerances are those of ``test_torch_model.py`` (logits and K/V cache 5e-5
of the reference's largest magnitude) and ``test_torch_train.py`` (a train
step: loss 1e-5 absolute, grad norm 5e-4 relative); the router's
``moe_lb`` within 1e-5 and ``moe_drop`` exact, and the serving engines give
the same tokens at temperature 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.all_archs import smoke_config as ref_smoke
from repro.configs.base import RunPolicy as RefPolicy
from repro.models import api as ref_api
from repro.serve.engine import Request as RefRequest
from repro.serve.engine import ServingEngine as RefEngine
from repro.train import optimizer as ropt
from repro.train import train_step as rts
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import RunPolicy
from repro_torch.models import api
from repro_torch.serve.engine import Request, ServingEngine
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pts

TOL, GRAD_TOL = 5e-5, 5e-4
ARCHS = ["mixtral-8x7b", "phi3.5-moe-42b-a6.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    rcfg, pcfg = ref_smoke(request.param), smoke_config(request.param)
    rparams = ref_api.init(rcfg, jax.random.PRNGKey(0))
    return rcfg, pcfg, rparams, api.from_numpy_params(
        pcfg, jax.tree.map(np.asarray, rparams), "cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(a, b):
    a = np.asarray(a, np.float32)
    b = b.float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(a)))))


def _policy(use_pallas):
    return (RefPolicy(remat="none", dtype="f32", use_pallas=use_pallas),
            RunPolicy(remat="none", dtype="f32", use_pallas=use_pallas))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits_and_router_aux(model, use_pallas):
    rcfg, pcfg, rparams, pparams = model
    rpol, ppol = _policy(use_pallas)
    toks = _tokens(rcfg, 2, 24)
    rl, ra = ref_api.forward(rparams, {"tokens": jnp.asarray(toks)}, rcfg, rpol)
    pl, pa = api.forward(pparams, {"tokens": torch.from_numpy(toks)}, pcfg, ppol)
    assert _close(rl, pl) < TOL
    assert abs(float(ra[0]) - float(pa[0])) < 1e-5
    assert float(ra[1]) == pytest.approx(float(pa[1]), abs=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_then_teacher_forced_decode(model, use_pallas):
    """A prompt longer than mixtral's window (ring cache), then decode steps
    over 3 lanes: T=3 tokens for 4 experts, so decode routes as one group of
    capacity 2, where tokens can be dropped, in both packages."""
    rcfg, pcfg, rparams, pparams = model
    rpol, ppol = _policy(use_pallas)
    B, S, T = 3, 20, 16
    toks = _tokens(rcfg, B, S, seed=1)
    rl, _, rst = ref_api.forward(rparams, {"tokens": jnp.asarray(toks)}, rcfg, rpol,
                                 return_cache=True, cache_len=T if rcfg.window else 32)
    pl, _, pst = api.forward(pparams, {"tokens": torch.from_numpy(toks)}, pcfg, ppol,
                             return_cache=True, cache_len=T if pcfg.window else 32)
    assert _close(rl, pl) < TOL
    nxt = _tokens(rcfg, B, 4, seed=2)
    for j in range(4):
        pos = np.full((B,), S + j, np.int32)
        rl, rst = ref_api.decode_step(rparams, rst, {"tokens": jnp.asarray(nxt[:, j:j + 1]),
                                                     "position": jnp.asarray(pos)},
                                      rcfg, rpol)
        pl, pst = api.decode_step(pparams, pst, {"tokens": torch.from_numpy(nxt[:, j:j + 1]),
                                                 "position": torch.from_numpy(pos)},
                                  pcfg, ppol)
        assert _close(rl, pl) < TOL, j
        for name in ("k", "v"):
            assert _close(rst["units"]["b0"][name], pst["units"]["b0"][name]) < TOL


def test_train_step_matches_reference(model):
    """One adamw step with the kernels on and remat dots, 2 microbatches:
    loss, grad norm and the router's aux metrics."""
    rcfg, pcfg, rparams, pparams = model
    kw = dict(remat="dots", n_microbatch=2, dtype="f32", use_pallas=True)
    toks = _tokens(rcfg, 4, 33, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rpol, ro = RefPolicy(**kw), ropt.OptConfig(warmup=2)
    rstep = jax.jit(rts.make_train_step(rcfg, rpol, ro))
    _, _, rm = rstep(rparams, rts.make_init_opt(rcfg, rpol, ro)(rparams),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    ppol, po = RunPolicy(**kw), popt.OptConfig(warmup=2)
    _, _, pm = pts.make_train_step(pcfg, ppol, po)(
        pparams, pts.make_init_opt(pcfg, ppol, po)(pparams),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(rm["loss"]) - float(pm["loss"])) < 1e-5
    assert abs(float(rm["grad_norm"]) - float(pm["grad_norm"])) \
        < GRAD_TOL * float(rm["grad_norm"])
    assert abs(float(rm["moe_lb"]) - float(pm["moe_lb"])) < 1e-5
    assert float(rm["moe_drop"]) == pytest.approx(float(pm["moe_drop"]), abs=1e-6)
    assert float(pm["moe_lb"]) > 0


def _prompts(vocab, n=6):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(rng.choice([5, 9, 14]))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_serving_engine_matches_reference(model, use_pallas):
    rcfg, pcfg, rparams, pparams = model
    cache_len = 16          # mixtral's smoke window
    ref = RefEngine(rcfg, RefPolicy(remat="none", dtype="f32"), rparams, n_slots=3,
                    cache_len=cache_len, temperature=0.0)
    eng = ServingEngine(pcfg, RunPolicy(remat="none", dtype="f32", use_pallas=use_pallas),
                        pparams, n_slots=3, cache_len=cache_len, temperature=0.0,
                        device="cpu")
    for i, p in enumerate(_prompts(rcfg.vocab_size)):
        ref.add_request(RefRequest(rid=i, prompt=p, max_new_tokens=4 + i % 3))
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=4 + i % 3))
    want = {r.rid: r.out for r in ref.run()}
    assert {r.rid: r.out for r in eng.run()} == want
    assert eng.stats == ref.stats
