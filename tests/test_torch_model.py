"""The port's model path against the JAX package's, from the same weights.

Weights are drawn by the JAX package and carried across with
``api.from_numpy_params``; token inputs are drawn with numpy.  Everything runs
in f32 on the CPU.  Tolerance: 5e-5 of the reference's largest magnitude
(taken as at least 1) for logits and for the K/V cache; the two packages sum
in different orders, so bit equality is not expected, while any real
divergence (a wrong mask, head grouping or RoPE pairing) is orders of
magnitude larger.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.all_archs import smoke_config as ref_smoke
from repro.configs.base import RunPolicy as RefPolicy
from repro.models import api as ref_api
from repro.models import attention as ref_attn
from repro_torch.configs.all_archs import smoke_config
from repro_torch.configs.base import RunPolicy
from repro_torch.models import api, attention

TOL = 5e-5


def _narrow(smoke):
    """qwen2 smoke variant that keeps the published 12 query / 2 KV heads."""
    return dataclasses.replace(smoke("qwen2-1.5b"), name="qwen2-1.5b-narrow",
                               n_heads=12, n_kv_heads=2, d_head=16, d_model=96)


CONFIGS = {
    "qwen2-smoke": (ref_smoke("qwen2-1.5b"), smoke_config("qwen2-1.5b")),
    "tinyllama-smoke": (ref_smoke("tinyllama-1.1b"), smoke_config("tinyllama-1.1b")),
    "qwen2-narrow": (_narrow(ref_smoke), _narrow(smoke_config)),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    rcfg, pcfg = CONFIGS[request.param]
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)
    rparams = ref_api.init(rcfg, jax.random.PRNGKey(0))
    # qkv biases init to zero: give them values so the bias path is exercised
    rparams = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(len(str(p))),
                                                 a.shape)
        if str(p[-1]).strip("[]'") in ("bq", "bk", "bv") else a, rparams)
    tree = jax.tree.map(np.asarray, rparams)
    return rcfg, pcfg, rparams, api.from_numpy_params(pcfg, tree, "cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float32)
    b = b.float().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(a)))))


def _policy(use_pallas):
    return (RefPolicy(remat="none", dtype="f32", use_pallas=use_pallas),
            RunPolicy(remat="none", dtype="f32", use_pallas=use_pallas))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_logits(model, use_pallas):
    rcfg, pcfg, rparams, pparams = model
    rpol, ppol = _policy(use_pallas)
    toks = _tokens(rcfg, 2, 24)
    rl, _ = ref_api.forward(rparams, {"tokens": jnp.asarray(toks)}, rcfg, rpol)
    pl, aux = api.forward(pparams, {"tokens": torch.from_numpy(toks)}, pcfg, ppol)
    assert pl.dtype == torch.float32 and aux.shape == (2,)
    assert _close(rl, pl) < TOL


@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_then_teacher_forced_decode(model, use_pallas):
    rcfg, pcfg, rparams, pparams = model
    rpol, ppol = _policy(use_pallas)
    B, S, T = 2, 12, 32
    toks = _tokens(rcfg, B, S, seed=1)
    rl, _, rst = ref_api.forward(rparams, {"tokens": jnp.asarray(toks)}, rcfg, rpol,
                                 return_cache=True, cache_len=T)
    pl, _, pst = api.forward(pparams, {"tokens": torch.from_numpy(toks)}, pcfg, ppol,
                             return_cache=True, cache_len=T)
    assert _close(rl, pl) < TOL

    def check_state():
        for blk, leaves in rst["units"].items():
            for name, leaf in leaves.items():
                if name == "pos":
                    assert np.array_equal(np.asarray(leaf), pst["units"][blk][name].numpy())
                else:
                    assert _close(leaf, pst["units"][blk][name]) < TOL, (blk, name)
    check_state()
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
        check_state()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sliding_window_ring_cache(use_pallas):
    """A window shorter than the prompt: ring-buffer prefill cache, then
    windowed decode that wraps the ring."""
    rcfg = dataclasses.replace(ref_smoke("qwen2-1.5b"), window=8)
    pcfg = dataclasses.replace(smoke_config("qwen2-1.5b"), window=8)
    rparams = ref_api.init(rcfg, jax.random.PRNGKey(1))
    pparams = api.from_numpy_params(pcfg, jax.tree.map(np.asarray, rparams), "cpu")
    rpol, ppol = _policy(use_pallas)
    B, S, T = 2, 12, 8
    toks = _tokens(rcfg, B, S, seed=6)
    rl, _, rst = ref_api.forward(rparams, {"tokens": jnp.asarray(toks)}, rcfg, rpol,
                                 return_cache=True, cache_len=T)
    pl, _, pst = api.forward(pparams, {"tokens": torch.from_numpy(toks)}, pcfg, ppol,
                             return_cache=True, cache_len=T)
    assert _close(rl, pl) < TOL
    assert np.array_equal(np.asarray(rst["units"]["b0"]["pos"]),
                          pst["units"]["b0"]["pos"].numpy())
    nxt = _tokens(rcfg, B, 4, seed=7)
    for j in range(4):
        pos = np.full((B,), S + j, np.int32)
        rl, rst = ref_api.decode_step(rparams, rst, {"tokens": jnp.asarray(nxt[:, j:j + 1]),
                                                     "position": jnp.asarray(pos)},
                                      rcfg, rpol)
        pl, pst = api.decode_step(pparams, pst, {"tokens": torch.from_numpy(nxt[:, j:j + 1]),
                                                 "position": torch.from_numpy(pos)},
                                  pcfg, ppol)
        assert _close(rl, pl) < TOL, j
        assert _close(rst["units"]["b0"]["k"], pst["units"]["b0"]["k"]) < TOL


def test_blocked_attention_matches_reference():
    """The port's online-softmax path == the reference's, ragged last block."""
    rng = np.random.default_rng(7)
    B, S, KV, G, dh = 2, 65, 2, 3, 16
    q = rng.standard_normal((B, S, KV, G, dh), np.float32)
    k = rng.standard_normal((B, S, KV, dh), np.float32)
    v = rng.standard_normal((B, S, KV, dh), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    for win in (None, 20):
        pos = pos.copy()
        a = attention.blocked_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                        window=win, block=16)
        b = ref_attn.blocked_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                       window=win, block=16)
        c = attention.plain_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                      window=win)
        assert _close(b, a) < 2e-5
        assert _close(b, c) < 2e-5


@pytest.mark.parametrize("S", [16, 2047, 2048, 5000])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mixtral-8x7b"])
@pytest.mark.parametrize("use_pallas,attn_impl", [(False, "auto"), (True, "auto"),
                                                  (False, "plain")])
def test_attn_impl_resolution_matches_reference(arch, S, use_pallas, attn_impl):
    """Same path choice as the reference: blocked at S >= 2048 without kernels."""
    from repro.models.transformer import _resolve_attn_impl as ref_resolve
    from repro_torch.models.transformer import _resolve_attn_impl
    from repro.configs.base import get_config as ref_get
    from repro_torch.configs.base import get_config
    rp = RefPolicy(use_pallas=use_pallas, attn_impl=attn_impl)
    pp = RunPolicy(use_pallas=use_pallas, attn_impl=attn_impl)
    assert _resolve_attn_impl(get_config(arch), pp, S) == ref_resolve(ref_get(arch), rp, S)


def test_bf16_cast_once_equals_cast_per_call(model):
    """The engine's cast-once params give the same logits as casting on every
    call, and the tied table is the bf16-rounded one, widened to f32."""
    _, pcfg, _, pparams = model
    pol = RunPolicy(use_pallas=True)             # bf16 compute, f32 params
    cparams = api.cast_params(pparams, torch.bfloat16)
    assert api.cast_params(cparams, torch.bfloat16)["units"]["b0"]["attn"]["wq"] \
        is cparams["units"]["b0"]["attn"]["wq"]
    src = pparams["unembed"] if "unembed" in pparams else pparams["embed"]
    assert torch.equal(cparams["unembed_f32"], src["table"].to(torch.bfloat16).float())
    toks = torch.from_numpy(_tokens(pcfg, 1, 10, seed=5))
    a, _ = api.forward(pparams, {"tokens": toks}, pcfg, pol)
    b, _ = api.forward(cparams, {"tokens": toks}, pcfg, pol)
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_from_numpy_params_rejects_wrong_tree(model):
    rcfg, pcfg, rparams, _ = model
    tree = jax.tree.map(np.asarray, rparams)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm/scale"):
        api.from_numpy_params(pcfg, tree, "cpu")
    tree = jax.tree.map(np.asarray, rparams)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        api.from_numpy_params(pcfg, tree, "cpu")


def test_param_count_and_shapes_match_reference(model):
    rcfg, pcfg, rparams, pparams = model
    assert api.n_params(pcfg) == ref_api.n_params(rcfg)
    ours = api.init(pcfg, seed=0, device="cpu")
    flat_r = {jax.tree_util.keystr(p): a.shape
              for p, a in jax.tree_util.tree_flatten_with_path(rparams)[0]}
    flat_p = {jax.tree_util.keystr(p): tuple(a.shape)
              for p, a in jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat_r == flat_p
    meta = api.abstract_params(pcfg)
    assert meta["units"]["b0"]["attn"]["wq"].shape == ours["units"]["b0"]["attn"]["wq"].shape
    assert meta["units"]["b0"]["attn"]["wq"].device.type == "meta"


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((2, 7, 33), np.float32)
    labels = rng.integers(-1, 33, (2, 7)).astype(np.int32)
    a = ref_api.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    b = api.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    assert abs(float(a) - float(b)) < 1e-6
