"""The port's MoE layer (``repro_torch.models.moe``) against the JAX package's.

The same numpy inputs, drawn from a seed, go through both ``apply_moe``.
Tolerances, each of the reference's largest magnitude (taken as at least 1):
outputs 2e-5 in f32 and 2e-2 in bf16 (one bf16 step at these magnitudes:
the two packages round the expert products' sums apart), ``lb_loss`` the
same, ``dropped_frac`` exact; gradients 5e-5 of each leaf's largest value.
Group count and capacity are compared exactly, as the reference's dispatch
buffer's shape (read from its ``maybe_constrain`` call), over token counts
and capacity factors that cover every branch of its choice.  The properties
of ``tests/test_moe.py`` are held on the port as cases of one test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro_torch.models import moe as pmoe

F32_TOL, BF16_TOL, GRAD_TOL = 2e-5, 2e-2, 5e-5


def _params(seed, d=16, f=32, E=4, scale=0.3):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, E)).astype(np.float32),
            "wi_gate": (scale * rng.standard_normal((E, d, f))).astype(np.float32),
            "wi_up": (scale * rng.standard_normal((E, d, f))).astype(np.float32),
            "wo": (scale * rng.standard_normal((E, f, d))).astype(np.float32)}


def _x(seed, B, S, d=16):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _both(p, x, dtype="f32", **kw):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ry, ra = rmoe.apply_moe({k: jnp.asarray(v, jd) for k, v in p.items()},
                            jnp.asarray(x, jd), **kw)
    py, pa = pmoe.apply_moe({k: torch.from_numpy(v).to(td) for k, v in p.items()},
                            torch.from_numpy(x).to(td), **kw)
    return (np.asarray(ry, np.float32), {k: float(v) for k, v in ra.items()},
            py.float().numpy(), {k: float(v) for k, v in pa.items()})


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(a)))))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,cf", [(2, 32, 1.25), (1, 7, 1.0), (4, 1, 1.25), (3, 125, 2.0),
                                    (2, 64, 0.5)])
def test_apply_moe_matches_reference(B, S, cf, dtype):
    p, x = _params(B * 100 + S), _x(S, B, S)
    ry, ra, py, pa = _both(p, x, dtype, top_k=2, act="silu", capacity_factor=cf)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    assert py.shape == ry.shape
    assert _rel(ry, py) < tol
    assert abs(ra["lb_loss"] - pa["lb_loss"]) < tol * max(1.0, abs(ra["lb_loss"]))
    assert pa["dropped_frac"] == pytest.approx(ra["dropped_frac"], abs=1e-6)


def _dispatch_shape(mod, monkeypatch, pmod_is_torch, T, E, cf):
    """(G, cap) of the dispatch buffer ``mod.apply_moe`` builds for T tokens."""
    seen = []

    def record(x, axes):
        if tuple(axes) == ("batch", "expert", None, "act_embed") and not seen:
            seen.append(tuple(x.shape))
        return x
    monkeypatch.setattr(mod, "maybe_constrain", record)
    d = 4
    if pmod_is_torch:
        p = {k: torch.from_numpy(v) for k, v in _params(0, d=d, f=8, E=E).items()}
        mod.apply_moe(p, torch.zeros((1, T, d)), top_k=2, act="silu", capacity_factor=cf)
    else:
        p = {k: jnp.asarray(v) for k, v in _params(0, d=d, f=8, E=E).items()}
        jax.eval_shape(lambda p, x: mod.apply_moe(p, x, top_k=2, act="silu",
                                                  capacity_factor=cf),
                       p, jax.ShapeDtypeStruct((1, T, d), jnp.float32))
    G, E_, cap, _ = seen[0]
    assert E_ == E
    return G, cap


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 8.0])
@pytest.mark.parametrize("T", [4, 7, 64, 375, 3000])
def test_groups_and_capacity_match_reference(T, cf, monkeypatch):
    E = 8
    ref = _dispatch_shape(rmoe, monkeypatch, False, T, E, cf)
    assert pmoe.groups_and_capacity(T, E, 2, cf) == ref
    assert _dispatch_shape(pmoe, monkeypatch, True, T, E, cf) == ref


def test_tied_router_logits_pick_the_reference_experts():
    """Columns of the router repeated in pairs: every token's logits tie in
    pairs (in bf16 as in f32), and the experts differ, so the output shows
    which of two tied experts each package took."""
    p = _params(5, E=4)
    p["router"][:, 1] = p["router"][:, 0]
    p["router"][:, 3] = p["router"][:, 2]
    x = _x(6, 2, 16)
    for dtype, tol in (("f32", F32_TOL), ("bf16", BF16_TOL)):
        ry, ra, py, pa = _both(p, x, dtype, top_k=1, act="silu", capacity_factor=4.0)
        assert _rel(ry, py) < tol, dtype
    ry, ra, py, pa = _both(p, x, "f32", top_k=2, act="silu", capacity_factor=1.0)
    assert _rel(ry, py) < F32_TOL
    assert pa["dropped_frac"] == pytest.approx(ra["dropped_frac"], abs=1e-6)


@pytest.mark.parametrize("B,S,cf", [(2, 16, 1.25), (1, 24, 0.75)])
def test_gradients_match_reference(B, S, cf):
    p, x = _params(11, scale=0.5), _x(12, B, S)

    def rloss(p, x):
        y, aux = rmoe.apply_moe(p, x, top_k=2, act="silu", capacity_factor=cf)
        return jnp.sum(jnp.square(y)) + 0.01 * aux["lb_loss"]
    rg = jax.grad(rloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()},
                                         jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = pmoe.apply_moe(tp, tx, top_k=2, act="silu", capacity_factor=cf)
    (torch.sum(torch.square(y)) + 0.01 * aux["lb_loss"]).backward()
    pairs = [(rg[0][k], tp[k].grad) for k in p] + [(rg[1], tx.grad)]
    for r, t in pairs:
        r = np.asarray(r)
        assert np.max(np.abs(r - t.numpy())) <= GRAD_TOL * max(np.max(np.abs(r)), 1e-30)
    assert float(tp["router"].grad.abs().sum()) > 0


# --------------------------------------------------- tests/test_moe.py, on the port

def _tp(seed, d=16, f=32, E=4):
    return {k: torch.from_numpy(v) for k, v in _params(seed, d, f, E).items()}


def _tx(seed, B, S, d=16):
    return torch.from_numpy(_x(seed, B, S, d))


def _dropless_at_cf_E():
    _, aux = pmoe.apply_moe(_tp(0), _tx(1, 2, 32), top_k=2, act="silu", capacity_factor=4.0)
    assert float(aux["dropped_frac"]) == 0.0


def _grouping_invariance_dropless():
    p, x = _tp(1), _tx(2, 2, 32)
    outs = []
    for g in (1, 4, 16):
        y, aux = pmoe.apply_moe(p, x, top_k=2, act="silu", capacity_factor=4.0, n_groups=g)
        assert float(aux["dropped_frac"]) == 0.0
        outs.append(y)
    for y in outs[1:]:
        assert float((y - outs[0]).abs().max()) < 2e-5


def _drops_grow_as_cf_shrinks():
    p, x = _tp(2), _tx(3, 4, 64)
    drops = [float(pmoe.apply_moe(p, x, top_k=2, act="silu", capacity_factor=cf)[1]
                   ["dropped_frac"]) for cf in (4.0, 1.0, 0.5)]
    assert drops[0] == 0.0 and drops[0] <= drops[1] <= drops[2]


def _lb_loss_detects_imbalance():
    """Every token's logit of expert 0 raised by 100 (through a feature that
    is 1 in every token)."""
    p, x = _tp(3), _tx(4, 2, 64)
    x[..., 0] = 1.0
    bal = float(pmoe.apply_moe(p, x, top_k=2, act="silu")[1]["lb_loss"])
    biased = dict(p, router=p["router"].clone())
    biased["router"][0, 0] += 100.0
    assert float(pmoe.apply_moe(biased, x, top_k=2, act="silu")[1]["lb_loss"]) > bal


def _differentiable():
    p = {k: v.requires_grad_() for k, v in _tp(4).items()}
    y, aux = pmoe.apply_moe(p, _tx(5, 2, 16), top_k=2, act="silu")
    (torch.sum(torch.square(y)) + 0.01 * aux["lb_loss"]).backward()
    gn = sum(float(v.grad.abs().sum()) for v in p.values())
    assert np.isfinite(gn) and gn > 0 and float(p["router"].grad.abs().sum()) > 0


def _bounded_outputs():
    for seed in range(15):
        y, _ = pmoe.apply_moe(_tp(seed), _tx(seed + 1, 1, 16), top_k=2, act="silu",
                              capacity_factor=0.5)
        assert not bool(torch.isnan(y).any()) and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("prop", [_dropless_at_cf_E, _grouping_invariance_dropless,
                                  _drops_grow_as_cf_shrinks, _lb_loss_detects_imbalance,
                                  _differentiable, _bounded_outputs],
                         ids=lambda f: f.__name__.strip("_"))
def test_moe_properties(prop):
    prop()


def test_decode_drops_tokens_as_the_reference():
    """Four decode lanes over 8 experts: one group of capacity 2, so lanes
    routed to one expert past its capacity are dropped in both packages."""
    assert pmoe.groups_and_capacity(4, 8, 2, 1.25) == (1, 2)
    p, x = _params(21, E=8), _x(22, 4, 1)
    x[..., 0] = 1.0
    p["router"][0, :2] += 100.0       # every lane picks experts 0 and 1
    ry, ra, py, pa = _both(p, x, "f32", top_k=2, act="silu", capacity_factor=1.25)
    assert ra["dropped_frac"] == 0.5
    assert pa["dropped_frac"] == pytest.approx(ra["dropped_frac"], abs=1e-6)
    assert _rel(ry, py) < F32_TOL
