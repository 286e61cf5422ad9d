"""The port's RG-LRU and RWKV-6 WKV kernel modules against the JAX package's.

On the CPU each wrapper runs its kernel's plain version; the Pallas kernels
run in interpret mode, as tests/test_kernels.py runs them.  Inputs are drawn
with numpy and handed to both packages.  Tolerances are the reference's own
(tests/test_kernels.py): the RG-LRU scan 1e-5 absolute, the WKV 1e-5 relative
to the largest reference output; the plain WKV forms of the model, which sum
in other orders than the port's, 2e-5 relative in f32 and 2e-2 relative in
bf16.  The CUDA kernels themselves are tested on a GPU by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_scan as j_rglru_scan
from repro.kernels.rwkv6_kernel import rwkv6_wkv as j_rwkv6_wkv
from repro.models import attention as jattn
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models.transformer import _wkv_scan_with_state as j_wkv_scan_with_state
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.rglru_scan import CHANNELS, STAGES, STEPS, rglru_scan
from repro_torch.kernels.rwkv6_kernel import rwkv6_wkv
from repro_torch.models import attention, rglru, rwkv6
from repro_torch.models.module import tree_paths

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
FORM_TOL = {"f32": 2e-5, "bf16": 2e-2}


def rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-9))


@pytest.mark.parametrize("B,S,W", [(2, 50, 64), (1, 256, 128), (3, 17, 32)])
def test_rglru_plain_matches_pallas(B, S, W):
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h = rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    jh = j_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=16, interpret=True)
    assert h.dtype == torch.float32 and h.shape == (B, S, W)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.rglru_scan_ref(a, b)), atol=1e-5)


@pytest.mark.parametrize("B,S,W", [(2, 50, 64), (1, 300, 16)])
def test_associative_scan_matches_sequential(B, S, W):
    """The model's plain scan (log-depth, differentiable) == the kernel's
    plain version, and both == the JAX package's scan."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, S, W)).astype(np.float32))
    h = rglru.associative_scan(a, b)
    np.testing.assert_allclose(h.numpy(), tref.rglru_scan_ref(a, b).numpy(), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jref.rglru_scan_ref(a.numpy(),
                                                                         b.numpy())),
                               atol=1e-5)


def _rglru_rehearsal(a, b, stages):
    """The CUDA kernel's tiling of the RG-LRU scan in plain PyTorch.  A block
    per (batch row, CHANNELS channels): its producer fills a ring of `stages`
    tiles of STEPS steps, either as boxes of the (W, S, B) tensor map (zeros
    past the edges) or, where W is not a multiple of 4, element by element
    (the ring keeps what it held elsewhere: NaN here); one chain per channel
    walks the tiles in order, rounding the product and then the sum, and
    each tile of h leaves in one piece, clipped at the tensor's edges."""
    B, S, W = a.shape
    h = torch.full_like(a, float("nan"))
    ring = torch.full((stages, 2, STEPS, CHANNELS), float("nan"))
    for bi in range(B):
        for c0 in range(0, W, CHANNELS):
            c1 = min(W, c0 + CHANNELS)
            hv = torch.zeros(CHANNELS)
            for i in range(-(-S // STEPS)):
                t0, s, n = i * STEPS, i % stages, min(STEPS, S - i * STEPS)
                if W % 4 == 0:
                    ring[s].zero_()
                ring[s, 0, :n, :c1 - c0] = a[bi, t0:t0 + n, c0:c1]
                ring[s, 1, :n, :c1 - c0] = b[bi, t0:t0 + n, c0:c1]
                tile = torch.empty(STEPS, CHANNELS)
                for r in range(n):
                    hv = ring[s, 0, r] * hv + ring[s, 1, r]
                    tile[r] = hv
                h[bi, t0:t0 + n, c0:c1] = tile[:n, :c1 - c0]
    return h


@pytest.mark.parametrize("B,S,W", [(2, 130, 32), (1, 200, 33), (3, 17, 20), (2, 64, 7)])
@pytest.mark.parametrize("stages", [STAGES, 2])
def test_rglru_kernel_tiling_matches_plain_and_pallas(B, S, W, stages):
    """The kernel's channel blocks, ring stages, ragged last tile and ragged W
    give the plain version's bits, and the Pallas kernel's values within the
    reference's 1e-5."""
    rng = np.random.default_rng(6)
    a = rng.uniform(0.5, 0.999, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    h = _rglru_rehearsal(torch.from_numpy(a), torch.from_numpy(b), stages)
    assert torch.equal(h, tref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b)))
    jh = j_rglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=16, interpret=True)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)


def _wkv_inputs(B, H, S, hs, seed=4, decay_sd=1.0):
    """r, k, v, w_log (B,H,S,hs) and u (H,hs) f32, w_log = -exp(N(0, decay_sd))."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, S, hs)).astype(np.float32) for _ in range(3))
    w_log = -np.exp(decay_sd * rng.standard_normal((B, H, S, hs))).astype(np.float32)
    u = rng.standard_normal((H, hs)).astype(np.float32)
    return r, k, v, w_log, u


@pytest.mark.parametrize("B,H,S,hs", [(2, 3, 70, 16), (1, 2, 64, 32), (1, 1, 130, 64)])
@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv_plain_matches_pallas(B, H, S, hs, chunk):
    x = _wkv_inputs(B, H, S, hs)
    o, state = rwkv6_wkv(*map(torch.from_numpy, x))
    jo = j_rwkv6_wkv(*map(jnp.asarray, x), chunk=chunk, interpret=True)
    assert o.dtype == torch.float32 and o.shape == (B, H, S, hs)
    assert state.dtype == torch.float32 and state.shape == (B, H, hs, hs)
    assert rel(jo, o) < 1e-5
    assert rel(jref.rwkv6_wkv_ref(*map(jnp.asarray, x)), o) < 1e-5


def test_pallas_wkv_prefix_sum_decays_lose_accuracy_at_strong_decays():
    """Why the CUDA kernel takes its pairwise decays as running products:
    with decays like exp(-exp(N(0, 3))) a step (the random-weight models
    reach them) the Pallas kernel's differences of chunk-local prefix sums are
    far from the exact scan, which the port's plain version matches."""
    x = _wkv_inputs(1, 2, 130, 32, seed=11, decay_sd=3.0)
    exact = jref.rwkv6_wkv_ref(*map(jnp.asarray, x))
    pallas = j_rwkv6_wkv(*map(jnp.asarray, x), chunk=64, interpret=True)
    o, _ = rwkv6_wkv(*map(torch.from_numpy, x))
    assert rel(exact, o) < 1e-5
    assert float(jnp.max(jnp.abs(pallas - exact)) / jnp.max(jnp.abs(exact))) > 1e-4


def _wkv_three_passes(r, k, v, w_log, u, C=64, SC=8):
    """The CUDA kernel's decomposition in plain f32 torch, pass by pass.
    1: per chunk c, DT_c = prod of its decays and dS_c = KH^T V with KH[s] =
    k[s] * the decay after s to the chunk end; 2: the states entering the
    chunks, S_0 = 0, S_{c+1} = DT_c S_c + dS_c; 3: per chunk, A (within
    8-row sub-chunks by walking the decays step by step, across them
    through the sub-chunk decays), and o = RD S_c + A V with RD = Q * PP.
    Rows past S are padded with r = k = v = 0 and w_log = 0."""
    B, H, S, hs = r.shape
    nc = -(-S // C)
    pad = lambda x: torch.nn.functional.pad(x.float(), (0, 0, 0, nc * C - S))
    r, k, v, e = (pad(x).reshape(B, H, nc, C, hs) for x in (r, k, v, w_log))
    e = torch.exp(e)
    # pass 1
    kh, d = torch.empty_like(k), torch.ones_like(e[..., 0, :])
    for t in range(C - 1, -1, -1):
        kh[..., t, :] = k[..., t, :] * d
        d = d * e[..., t, :]
    dt, ds = d, kh.transpose(-1, -2) @ v                     # (B,H,nc,hs), (B,H,nc,hs,hs)
    # pass 2
    states, st = torch.empty_like(ds), torch.zeros_like(ds[:, :, 0])
    for c in range(nc):
        states[:, :, c] = st
        st = dt[:, :, c, :, None] * st + ds[:, :, c]
    # pass 3: Q (r times the decay from its sub-chunk's start), KQ (k times
    # the decay to its sub-chunk's end), SD (each sub-chunk's decay), PP (the
    # decay of the sub-chunks before)
    q, kq = torch.empty_like(r), torch.empty_like(k)
    nsc = C // SC
    sd = torch.empty(*e.shape[:3], nsc, hs)
    pp = torch.empty_like(sd)
    dd = torch.ones_like(e[..., 0, :])
    for i in range(nsc):
        pp[..., i, :] = dd
        p = torch.ones_like(dd)
        for t in range(i * SC, (i + 1) * SC):
            q[..., t, :] = r[..., t, :] * p
            p = p * e[..., t, :]
        sd[..., i, :] = p
        dd = dd * p
        p = torch.ones_like(dd)
        for t in range((i + 1) * SC - 1, i * SC - 1, -1):
            kq[..., t, :] = k[..., t, :] * p
            p = p * e[..., t, :]
    A = torch.zeros(*e.shape[:3], C, C)
    for t in range(C):                      # inside a sub-chunk, step by step
        A[..., t, t] = (r[..., t, :] * u.float()[None, :, None] * k[..., t, :]).sum(-1)
        walk = torch.ones_like(dd)
        for s in range(t - 1, t - t % SC - 1, -1):
            A[..., t, s] = (r[..., t, :] * k[..., s, :] * walk).sum(-1)
            walk = walk * e[..., s, :]
    for i in range(1, nsc):                 # across sub-chunks
        g = torch.ones_like(dd)
        for j in range(i - 1, -1, -1):
            A[..., i * SC:(i + 1) * SC, j * SC:(j + 1) * SC] = \
                (q[..., i * SC:(i + 1) * SC, :] * g[..., None, :]) \
                @ kq[..., j * SC:(j + 1) * SC, :].transpose(-1, -2)
            g = g * sd[..., j, :]
    rd = q * pp.repeat_interleave(SC, dim=-2)
    o = rd @ states + A @ v
    return o.reshape(B, H, nc * C, hs)[:, :, :S], st


@pytest.mark.parametrize("S", [1, 64, 130, 333])
@pytest.mark.parametrize("decay_sd", [1.0, 3.0])
@pytest.mark.parametrize("hs", [32, 64])
def test_wkv_three_pass_decomposition_matches_exact_scan(S, decay_sd, hs):
    """The algebra of the CUDA kernel's three passes (each chunk's state
    increment and decay, the chunk-entering states, the per-chunk output)
    gives the exact scan's output and final state within the reference's
    1e-5 relative bound, also at decays as strong as the random-weight
    models' (decay sd 3)."""
    x = [torch.from_numpy(a) for a in _wkv_inputs(2, 2, S, hs, seed=17, decay_sd=decay_sd)]
    o, state = _wkv_three_passes(*x)
    ro, rstate = tref.rwkv6_wkv_ref(*x)
    assert o.shape == ro.shape and state.shape == rstate.shape
    assert rel(ro.numpy(), o) < 1e-5
    assert rel(rstate.numpy(), state) < 1e-5


@pytest.mark.parametrize("B,H,S,hs", [(2, 3, 70, 16), (1, 2, 64, 32), (1, 1, 130, 64)])
def test_wkv_final_state_matches_wkv_chunked(B, H, S, hs):
    """The plain WKV's second output is the state after the last token: the
    second output of the JAX package's ``wkv_chunked``, which its prefill
    keeps for decode."""
    x = _wkv_inputs(B, H, S, hs, seed=5)
    o, state = rwkv6_wkv(*map(torch.from_numpy, x))
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)        # (B,S,H,hs)
    jo, jstate = jrwkv.wkv_chunked(*map(tr, x[:4]), jnp.asarray(x[4]))
    assert rel(jstate, state) < 1e-5
    assert rel(jo, o.transpose(1, 2)) < 1e-5


def _seq_major(x, dt):
    """(B,H,S,hs) numpy -> (B,S,H,hs) as a JAX array and a torch tensor."""
    y = np.ascontiguousarray(x.transpose(0, 2, 1, 3))
    return jnp.asarray(y).astype(JDT[dt]), torch.from_numpy(y).to(TDT[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["scan", "chunked", "seq_parallel"])
def test_wkv_forms_match_reference(form, dt):
    """The model's plain WKV forms against the JAX package's: ``_wkv_scan``
    (with its final state, ``_wkv_scan_with_state``), ``wkv_chunked`` and
    ``wkv_seq_parallel``, with r, k, v in the compute dtype and w_log f32."""
    B, H, S, hs = (2, 2, 40, 16) if form == "scan" else (1, 2, 256, 16)
    r, k, v, w_log, u = _wkv_inputs(B, H, S, hs, seed=6)
    (jr, tr_), (jk, tk), (jv, tv) = (_seq_major(a, dt) for a in (r, k, v))
    jw, tw = _seq_major(w_log, "f32")
    ju, tu = jnp.asarray(u).astype(JDT[dt]), torch.from_numpy(u).to(TDT[dt])
    if form == "scan":
        jo, jstate = j_wkv_scan_with_state(jr, jk, jv, jw, ju)
        o, state = rwkv6._wkv_scan(tr_, tk, tv, tw, tu)
    elif form == "chunked":
        jo, jstate = jrwkv.wkv_chunked(jr, jk, jv, jw, ju)
        o, state = rwkv6.wkv_chunked(tr_, tk, tv, tw, tu)
    else:
        jo, jstate = jrwkv.wkv_seq_parallel(jr, jk, jv, jw, ju)
        o, state = rwkv6.wkv_seq_parallel(tr_, tk, tv, tw, tu)
    assert o.dtype == torch.float32 and state.dtype == torch.float32
    assert rel(jo, o) < FORM_TOL[dt]
    assert rel(jstate, state) < FORM_TOL[dt]


def test_wkv_forms_agree_with_the_kernels_plain_version():
    """The three plain forms of the model and the kernel's plain version
    compute one function (moderate decays, where the chunked forms' centred
    factors stay in f32 range)."""
    r, k, v, w_log, u = _wkv_inputs(1, 2, 256, 16, seed=7)
    o_ref, s_ref = tref.rwkv6_wkv_ref(*map(torch.from_numpy, (r, k, v, w_log, u)))
    sm = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
          for a in (r, k, v, w_log)]
    for fn in (rwkv6._wkv_scan, rwkv6.wkv_chunked, rwkv6.wkv_seq_parallel):
        o, state = fn(*sm, torch.from_numpy(u))
        assert rel(o_ref.transpose(1, 2).numpy(), o) < 2e-5, fn.__name__
        assert rel(s_ref.numpy(), state) < 2e-5, fn.__name__


def test_chunked_form_overflows_where_the_kernel_form_does_not():
    """w_log of -exp(11) on every other step overflows the centred factors
    of ``wkv_chunked`` in both packages, while
    the kernel's plain version stays finite.  The port keeps the reference's
    plain forms as they are and records the difference (ROADMAP queue 3)."""
    r, k, v, _, u = _wkv_inputs(1, 1, 64, 16, seed=8)
    w_log = np.full(r.shape, -np.exp(11.0), np.float32)
    w_log[..., ::2, :] = -0.1                       # alternate strong and weak steps
    sm = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))
    jo, _ = jrwkv.wkv_chunked(*(jnp.asarray(sm(a)) for a in (r, k, v, w_log)),
                              jnp.asarray(u))
    o, _ = rwkv6.wkv_chunked(*(torch.from_numpy(sm(a)) for a in (r, k, v, w_log)),
                             torch.from_numpy(u))
    assert not np.isfinite(np.asarray(jo)).all()
    assert np.array_equal(np.isfinite(np.asarray(jo)), torch.isfinite(o).numpy())
    ko, kstate = rwkv6_wkv(*map(torch.from_numpy, (r, k, v, w_log, u)))
    assert torch.isfinite(ko).all() and torch.isfinite(kstate).all()


@pytest.mark.parametrize("S,window,KV,G", [(100, 16, 1, 2), (64, 16, 2, 3), (37, 8, 1, 10)])
def test_local_chunk_attention_matches_reference(S, window, KV, G):
    rng = np.random.default_rng(9)
    B, dh = 2, 16
    q = rng.standard_normal((B, S, KV, G, dh), np.float32)
    k = rng.standard_normal((B, S, KV, dh), np.float32)
    v = rng.standard_normal((B, S, KV, dh), np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    a = attention.local_chunk_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                        window=window)
    b = jattn.local_chunk_attention(*map(jnp.asarray, (q, k, v, pos, pos)), window=window)
    c = attention.plain_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), window=window)
    assert rel(b, a) < 2e-5
    assert rel(b, c) < 2e-5


def test_recurrent_wrappers_run_their_plain_versions_on_cpu():
    """On the CPU each new wrapper is its plain version, also on the strided
    (B,S,H,hs)-memory views the model passes, and counts no launch."""
    ops.reset_launch_counts()
    r, k, v, w_log, u = map(torch.from_numpy, _wkv_inputs(1, 2, 20, 16, seed=10))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, w_log)]
    got = rwkv6_wkv(*views, u)
    want = tref.rwkv6_wkv_ref(r, k, v, w_log, u)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = torch.rand(2, 9, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(rglru_scan(a, a), tref.rglru_scan_ref(a, a))
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == 0 and counts["rwkv6_wkv"] == 0
    assert set(counts) == {"flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv", "flash_decode", "rglru_scan",
                           "rwkv6_wkv"}


def test_recurrent_wrappers_refuse_inputs_that_require_grad():
    """Neither TPU kernel has a VJP, so neither wrapper gives a gradient: with
    grad mode on, inputs that require grad raise on every device (the CPU
    too, so that the CPU tests catch what would train wrongly on the card);
    under no_grad they run."""
    a = torch.rand(1, 5, 4, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rglru_scan(a, a.detach())
    r, k, v, w_log, u = map(torch.from_numpy, _wkv_inputs(1, 1, 5, 16))
    with pytest.raises(RuntimeError, match="no backward"):
        rwkv6_wkv(r, k.requires_grad_(), v, w_log, u)
    with torch.no_grad():
        rglru_scan(a, a)
        rwkv6_wkv(r, k, v, w_log, u)


def _module_params(specs, seed):
    """numpy draws for a block's ParamSpec tree (normal, std 0.3; uniform
    leaves in their [-scale, scale]), as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    jp, tp = {}, {}
    for path, spec in tree_paths(specs):
        if spec.init == "uniform_scale":
            a = rng.uniform(-spec.scale, spec.scale, spec.shape)
        else:
            a = 0.3 * rng.standard_normal(spec.shape)
        a = a.astype(np.float32)
        jp[path[-1]], tp[path[-1]] = jnp.asarray(a), torch.from_numpy(a)
    return jp, tp


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rglru_block_matches_reference(use_kernel):
    """apply_rglru (through the scan or the kernel's plain version) and one
    decode step from a drawn state, against the JAX package's module."""
    D, W, nb, B, S = 24, 32, 2, 2, 19
    jp, tp = _module_params(rglru.rglru_specs(D, W, nb), 12)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ref = jrglru.apply_rglru(jp, jnp.asarray(x), n_blocks=nb)
    got = rglru.apply_rglru(tp, torch.from_numpy(x), n_blocks=nb, use_pallas=use_kernel)
    assert rel(ref, got) < 2e-5
    state = {"h": rng.standard_normal((B, W)).astype(np.float32),
             "conv": rng.standard_normal((B, rglru.CONV_K - 1, W)).astype(np.float32)}
    x1 = x[:, :1]
    rout, rstate = jrglru.decode_rglru(jp, {k: jnp.asarray(v) for k, v in state.items()},
                                       jnp.asarray(x1), n_blocks=nb)
    tstate = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    out = rglru.decode_rglru(tp, tstate, torch.from_numpy(x1), n_blocks=nb)
    assert rel(rout, out) < 2e-5
    for k in state:
        assert rel(rstate[k], tstate[k]) < 2e-5, k


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rwkv_block_matches_reference(use_kernel):
    """apply_timemix (through the sequential scan or the kernel's plain
    version), apply_channelmix, and one decode step of each from a drawn
    state, against the JAX package's module."""
    D, H, hs, F_, B, S = 32, 2, 16, 48, 2, 21
    jt, tt = _module_params(rwkv6.timemix_specs(D, H, hs), 14)
    jc, tc = _module_params(rwkv6.channelmix_specs(D, F_), 15)
    rng = np.random.default_rng(16)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    ref = jrwkv.apply_timemix(jt, jnp.asarray(x), n_heads=H, head_size=hs)
    got = rwkv6.apply_timemix(tt, torch.from_numpy(x), n_heads=H, head_size=hs,
                              use_kernel=use_kernel)
    assert rel(ref, got) < 2e-5
    assert rel(jrwkv.apply_channelmix(jc, jnp.asarray(x)),
               rwkv6.apply_channelmix(tc, torch.from_numpy(x))) < 2e-5
    state = {"tm_x": rng.standard_normal((B, D)).astype(np.float32),
             "cm_x": rng.standard_normal((B, D)).astype(np.float32),
             "wkv": rng.standard_normal((B, H, hs, hs)).astype(np.float32)}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
    x1 = jnp.asarray(x[:, :1])
    rt, rtm_x, rwkv_s = jrwkv.decode_timemix(jt, js, x1, n_heads=H, head_size=hs)
    rc, rcm_x = jrwkv.decode_channelmix(jc, js, x1)
    t1 = torch.from_numpy(x[:, :1])
    assert rel(rt, rwkv6.decode_timemix(tt, ts, t1, n_heads=H, head_size=hs)) < 2e-5
    assert rel(rc, rwkv6.decode_channelmix(tc, ts, t1)) < 2e-5
    for k, want in (("tm_x", rtm_x), ("cm_x", rcm_x), ("wkv", rwkv_s)):
        assert rel(want, ts[k]) < 2e-5, k
