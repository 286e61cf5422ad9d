"""Decoder stack over the block patterns of the dense GQA, RG-LRU hybrid and
RWKV-6 archs.

Layers are grouped into repeating *pattern units* as in the JAX package
(e.g. ("rec", "rec", "attn") for recurrentgemma); unit parameters and decode
state are stacked along a leading ``layers`` dim and the port walks the units
in a Python loop (PyTorch runs eagerly, so ``scan_layers`` changes nothing
here).  Under autograd each unit is rematerialised as ``RunPolicy.remat``
says (``_remat_wrap``).  An attention block of an arch with experts has a
routed MoE MLP (``models/moe.py``), whose router statistics are the block's
aux output.  The vit/encodec frontends raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.overrides import _get_current_function_mode_stack
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg
from . import rwkv6 as rwkv
from .layers import (apply_glu_mlp, apply_norm, apply_plain_mlp, embed_lookup,
                     glu_mlp_specs, norm_specs, plain_mlp_specs)
from .module import ParamSpec, map_specs, stack_layer_specs, tree_map
from ..configs.base import ModelConfig, RunPolicy
from ..launch.sharding import maybe_constrain

_LATER = {
    "vit": "vit frontend: ROADMAP module queue, frontends",
    "encodec": "encodec frontend: ROADMAP module queue, frontends",
}
BLOCK_TYPES = ("attn", "rec", "rwkv")


def _check_supported(cfg: ModelConfig):
    for bt in cfg.block_pattern:
        if bt not in BLOCK_TYPES:
            raise ValueError(bt)
    if cfg.frontend:
        raise NotImplementedError(_LATER[cfg.frontend])


def compute_dtype(policy: RunPolicy):
    return torch.bfloat16 if policy.dtype == "bf16" else torch.float32


# ----------------------------------------------------------------- spec build

def block_specs(cfg: ModelConfig, bt: str):
    if bt == "rec":
        return {"ln1": norm_specs(cfg.d_model, cfg.norm),
                "rec": rg.rglru_specs(cfg.d_model, cfg.rec_width, cfg.n_heads),
                "ln2": norm_specs(cfg.d_model, cfg.norm),
                "mlp": glu_mlp_specs(cfg.d_model, cfg.d_ff)}
    if bt == "rwkv":
        return {"ln1": norm_specs(cfg.d_model, cfg.norm),
                "tm": rwkv.timemix_specs(cfg.d_model, cfg.n_heads, cfg.head_size),
                "ln2": norm_specs(cfg.d_model, cfg.norm),
                "cm": rwkv.channelmix_specs(cfg.d_model, cfg.d_ff)}
    if cfg.n_experts:
        mlp = moe_mod.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts)
    elif cfg.act == "gelu" and cfg.norm == "layernorm":
        mlp = plain_mlp_specs(cfg.d_model, cfg.d_ff)   # musicgen-style
    else:
        mlp = glu_mlp_specs(cfg.d_model, cfg.d_ff)
    return {"ln1": norm_specs(cfg.d_model, cfg.norm),
            "attn": attn.attn_specs(cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.d_head, cfg.qkv_bias),
            "ln2": norm_specs(cfg.d_model, cfg.norm),
            "mlp": mlp}


def n_units_tail(cfg: ModelConfig):
    plen = len(cfg.block_pattern)
    return cfg.n_layers // plen, cfg.n_layers % plen


def _table_specs(cfg: ModelConfig):
    if cfg.frontend == "encodec":
        return {"table": ParamSpec((cfg.n_codebooks, cfg.vocab_size, cfg.d_model),
                                   (None, "vocab", "embed"), "embed")}
    return {"table": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "embed")}


def build_specs(cfg: ModelConfig, runnable: bool = True):
    """The parameter specs of ``cfg``.  ``runnable=False`` also gives those of
    the archs whose frontends the port does not run yet (vit and encodec),
    for counting parameters; by default they raise."""
    if runnable:
        _check_supported(cfg)
    n_units, tail = n_units_tail(cfg)
    unit = {f"b{i}": block_specs(cfg, bt) for i, bt in enumerate(cfg.block_pattern)}
    specs: dict[str, Any] = {
        "embed": _table_specs(cfg),
        "units": map_specs(lambda s: stack_layer_specs(s, n_units), unit),
        "final_norm": norm_specs(cfg.d_model, cfg.norm),
    }
    if tail:
        specs["tail"] = {f"t{i}": block_specs(cfg, cfg.block_pattern[i])
                         for i in range(tail)}
    if not cfg.tie_embeddings:
        specs["unembed"] = _table_specs(cfg)
    if cfg.frontend == "vit":
        specs["projector"] = {
            "ln": norm_specs(cfg.d_frontend, cfg.norm),
            "w1": ParamSpec((cfg.d_frontend, cfg.d_model), (None, "embed")),
            "w2": ParamSpec((cfg.d_model, cfg.d_model), ("embed", None)),
        }
    return specs


# ------------------------------------------------------------ parameter cast

def cast_params(params, dtype):
    """Cast every f32 leaf to the compute dtype, as the JAX package does on
    every call.  Leaves already in ``dtype`` are passed through uncopied, so
    casting cast params is free: the serving engine casts once at build time.

    For a bf16 compute dtype the result also holds ``unembed_f32``, the
    bf16-rounded unembedding table widened back to f32, from which the
    logits are computed (the JAX package rounds the table the same way and
    computes the logits in f32).  Keeping it avoids re-widening the table on
    every decode step.
    """
    out = {k: tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a, v)
           for k, v in params.items() if k != "unembed_f32"}
    if dtype != torch.float32:
        cached = params.get("unembed_f32")
        if cached is None:
            src = out["unembed"] if "unembed" in out else out["embed"]
            cached = src["table"].float()
        out["unembed_f32"] = cached
    return out


# ------------------------------------------------------------------ embedding

def embed_tokens(params, cfg: ModelConfig, batch, compute_dtype):
    """Returns (x (B,S,D), positions (B,S))."""
    x = embed_lookup(params["embed"], batch["tokens"]).to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def unembed_logits(params, cfg: ModelConfig, x):
    """f32 logits from the (compute-dtype-rounded) unembedding table."""
    table = params.get("unembed_f32")
    if table is None:
        table = (params["embed"] if cfg.tie_embeddings else params["unembed"])["table"]
        table = table.float()
    logits = x.float() @ table.T
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


# ------------------------------------------------------------ full-seq blocks

def _resolve_attn_impl(cfg, policy, S):
    if policy.use_pallas:
        return "pallas"
    if policy.attn_impl != "auto":
        return policy.attn_impl
    if cfg.window is not None and S > 2 * cfg.window:
        return "local"
    if S >= 2048:
        return "blocked"     # flash-attention algebra: matches the kernel
    return "plain"


def _mlp(p, x, cfg, capacity_factor):
    """The block's MLP: (out, aux (2,) f32), aux the MoE router's
    [lb_loss, dropped_frac] (zeros without experts)."""
    if cfg.n_experts:
        m, a = moe_mod.apply_moe(p, x, top_k=cfg.top_k, act=cfg.act,
                                 capacity_factor=capacity_factor)
        return m, torch.stack([a["lb_loss"], a["dropped_frac"]])
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    if "wi" in p:
        return apply_plain_mlp(p, x, cfg.act), aux
    return apply_glu_mlp(p, x, cfg.act), aux


def apply_block_full(bt, p, x, positions, cfg: ModelConfig, policy: RunPolicy,
                     cache_len: int | None = None):
    """Returns (x, aux (2,) f32, state-or-None).

    With a cache (prefill) and ``use_pallas`` on, attention goes through the
    flash-attention kernel and the recurrences through the RG-LRU and WKV
    kernels; the JAX package's prefill reaches none of its kernels even then
    (``plain_attention``, ``associative_scan``, ``wkv_chunked``).  Both
    compute the same functions.
    """
    x, aux, state = _block_full(bt, p, x, positions, cfg, policy, cache_len)
    return maybe_constrain(x, ("batch", "seq_q", "act_embed")), aux, state


def _block_full(bt, p, x, positions, cfg, policy, cache_len):
    if bt == "rec":
        return _rec_block_full(p, x, cfg, policy, cache_len)
    if bt == "rwkv":
        return _rwkv_block_full(p, x, cfg, policy, cache_len)
    state = None
    S = x.shape[1]
    h = apply_norm(p["ln1"], x, cfg.norm)
    impl = _resolve_attn_impl(cfg, policy, S)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.d_head,
              rope_theta=cfg.rope_theta, window=cfg.window, use_rope=cfg.use_rope)
    if cache_len is None:
        a = attn.full_attention(p["attn"], h, positions, impl=impl, **kw)
    else:
        q, k, v = attn.qkv_proj(p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
                                cfg.d_head, positions, cfg.rope_theta, cfg.use_rope)
        o = attn.attend(q, k, v, positions, impl, cfg.window)
        a = attn.out_proj(p["attn"], o)
        state = _cache_from_kv(k, v, positions, cache_len, cfg)
    x = x + a
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    m, aux = _mlp(p["mlp"], h2, cfg, policy.capacity_factor)
    return x + m, aux, state


def _rec_block_full(p, x, cfg, policy, cache_len):
    """RG-LRU block; with a cache, also its decode state (``h`` is the scan's
    last step, as in the JAX package's ``_rglru_with_state``)."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    h = apply_norm(p["ln1"], x, cfg.norm)
    r, state = rg.rglru_with_state(p["rec"], h, cfg.n_heads, policy.use_pallas)
    x = x + r
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    x = x + apply_glu_mlp(p["mlp"], h2, cfg.act)
    return x, aux, state if cache_len is not None else None


def _rwkv_block_full(p, x, cfg, policy, cache_len):
    """RWKV-6 block; with a cache, also its decode state (the final WKV state
    and the last inputs of the two token shifts)."""
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
    h = apply_norm(p["ln1"], x, cfg.norm)
    t, final = rwkv.timemix_with_state(p["tm"], h, n_heads=cfg.n_heads,
                                       head_size=cfg.head_size,
                                       use_kernel=policy.use_pallas)
    x = x + t
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    x = x + rwkv.apply_channelmix(p["cm"], h2)
    state = None
    if cache_len is not None:
        state = {"tm_x": h[:, -1], "cm_x": h2[:, -1], "wkv": final}
    return x, aux, state


def _cache_from_kv(k, v, positions, cache_len, cfg):
    B, S = k.shape[:2]
    if cfg.window is not None and cache_len < S:
        kk, vv, pos = k[:, -cache_len:], v[:, -cache_len:], positions[:, -cache_len:]
        slot = (pos % cache_len).long()
        bidx = torch.arange(B, device=k.device)[:, None]
        ck = torch.zeros((B, cache_len) + k.shape[2:], dtype=k.dtype, device=k.device)
        cv = torch.zeros_like(ck)
        cp = torch.full((B, cache_len), -1, dtype=torch.int32, device=k.device)
        ck[bidx, slot] = kk
        cv[bidx, slot] = vv
        cp[bidx, slot] = pos.to(torch.int32)
        return {"k": ck, "v": cv, "pos": cp}
    pad = cache_len - S
    if pad < 0:
        raise ValueError("cache_len < seq_len for linear cache")
    # padded, as the JAX package does: a DTensor k keeps its placements (a
    # slice assignment into a fresh replicated cache has no DTensor rule)
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
            "pos": F.pad(positions.to(torch.int32), (0, pad), value=-1)}


# -------------------------------------------------------------- decode blocks

def apply_block_decode(bt, p, state, x, position, cfg: ModelConfig,
                       policy: RunPolicy | None = None):
    """One-token block.  ``state`` (this layer's cache or recurrent state) is
    updated in place.

    With ``use_pallas`` on, decode attention goes through the flash-decode
    kernel; the JAX package uses its einsum path even then.  Both compute the
    same function.  The recurrent blocks decode in plain PyTorch, as the JAX
    package does: it has no kernel for one step.
    """
    if bt == "rec":
        h = apply_norm(p["ln1"], x, cfg.norm)
        x = x + rg.decode_rglru(p["rec"], state, h, n_blocks=cfg.n_heads)
        h2 = apply_norm(p["ln2"], x, cfg.norm)
        return x + apply_glu_mlp(p["mlp"], h2, cfg.act), state
    if bt == "rwkv":
        h = apply_norm(p["ln1"], x, cfg.norm)
        x = x + rwkv.decode_timemix(p["tm"], state, h, n_heads=cfg.n_heads,
                                    head_size=cfg.head_size)
        h2 = apply_norm(p["ln2"], x, cfg.norm)
        return x + rwkv.decode_channelmix(p["cm"], state, h2), state
    use_kernel = policy is not None and policy.use_pallas
    cf = policy.capacity_factor if policy is not None else 1.25
    h = apply_norm(p["ln1"], x, cfg.norm)
    o, new_cache = attn.decode_attention(
        p["attn"], state, h, position, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, d_head=cfg.d_head, rope_theta=cfg.rope_theta,
        window=cfg.window, use_rope=cfg.use_rope, use_kernel=use_kernel)
    x = x + attn.out_proj(p["attn"], o)
    h2 = apply_norm(p["ln2"], x, cfg.norm)
    return x + _mlp(p["mlp"], h2, cfg, cf)[0], new_cache


# ------------------------------------------------------------- state builders

def block_state_shapes(cfg: ModelConfig, bt: str, batch: int, cache_len: int, dtype):
    if bt == "rec":
        return rg.rglru_state_shapes(batch, cfg.rec_width, dtype)
    if bt == "rwkv":
        return rwkv.rwkv_state_shapes(batch, cfg.d_model, cfg.n_heads,
                                      cfg.head_size, dtype)
    clen = min(cache_len, cfg.window) if cfg.window else cache_len
    return attn.cache_shapes(batch, clen, cfg.n_kv_heads, cfg.d_head, dtype)


def block_state_axes(bt: str):
    return {"attn": attn.CACHE_AXES, "rec": rg.RGLRU_STATE_AXES,
            "rwkv": rwkv.RWKV_STATE_AXES}[bt]


def model_state_axes(cfg: ModelConfig):
    """Logical axes of the decode state, parallel to ``model_state_shapes``."""
    n_units, tail = n_units_tail(cfg)
    out = {"units": {f"b{i}": {k: ("layers",) + tuple(a)
                               for k, a in block_state_axes(bt).items()}
                     for i, bt in enumerate(cfg.block_pattern)}}
    if tail:
        out["tail"] = {f"t{i}": dict(block_state_axes(cfg.block_pattern[i]))
                       for i in range(tail)}
    return out


def model_state_shapes(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """Tree of (shape, dtype) leaves; unit leaves carry a leading n_units dim."""
    _check_supported(cfg)
    n_units, tail = n_units_tail(cfg)
    unit = {f"b{i}": block_state_shapes(cfg, bt, batch, cache_len, dtype)
            for i, bt in enumerate(cfg.block_pattern)}
    stacked = {b: {k: ((n_units,) + s, dt) for k, (s, dt) in leaves.items()}
               for b, leaves in unit.items()}
    out = {"units": stacked}
    if tail:
        out["tail"] = {f"t{i}": block_state_shapes(cfg, cfg.block_pattern[i], batch,
                                                   cache_len, dtype)
                       for i in range(tail)}
    return out


# --------------------------------------------------------------- full forward

def _unit(tree, u):
    return tree_map(lambda a: a[u], tree)


# the products whose outputs remat "dots" keeps: the unbatched matmuls, the
# analogue of JAX's dots_with_no_batch_dims_saveable.  An op maps to None
# (always kept) or to a predicate of its arguments; a tracer that runs the
# step in other product ops adds them here.
SAVED_PRODUCTS = {torch.ops.aten.mm.default: None, torch.ops.aten.addmm.default: None}


def _save_dots_policy(ctx, op, *args, **kwargs):
    if op in SAVED_PRODUCTS and (SAVED_PRODUCTS[op] is None or SAVED_PRODUCTS[op](*args)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_SAVE_DOTS = functools.partial(create_selective_checkpoint_contexts, _save_dots_policy)


_RECOMPUTE_DEPTH = [0]


def recomputing() -> bool:
    """Whether a checkpointed unit is being recomputed in backward now (the
    measurement counts the products run then as remat FLOPs)."""
    return _RECOMPUTE_DEPTH[0] > 0


def _marked(fn, modes):
    """``fn``, which marks the calls that autograd makes in backward (the
    recompute) for ``recomputing`` and runs them under ``modes``, the
    torch-function modes of the forward (autograd's recompute does not
    restore them)."""
    def run(*args):
        if torch._C._current_graph_task_id() == -1:
            return fn(*args)
        _RECOMPUTE_DEPTH[0] += 1
        try:
            with contextlib.ExitStack() as stack:
                for m in modes:
                    stack.enter_context(m)
                return fn(*args)
        finally:
            _RECOMPUTE_DEPTH[0] -= 1
    return run


def _remat_wrap(fn, policy: RunPolicy):
    """Rematerialise ``fn`` in backward, the counterpart of the JAX package's
    ``_remat_wrap``.  ``none`` keeps every activation; ``full`` recomputes
    all of ``fn``; ``dots`` keeps the outputs of ``SAVED_PRODUCTS``
    (``aten.mm``/``aten.addmm``) and recomputes the rest.  Under ``dots`` and ``full`` the flash-attention
    forward therefore runs twice per layer in a training step.  Without
    autograd (prefill under ``inference_mode``) ``fn`` runs as it is."""
    if policy.remat == "none":
        return fn
    if policy.remat not in ("dots", "full"):
        raise ValueError(f"remat {policy.remat!r} not in none | dots | full")
    kw = {"context_fn": _SAVE_DOTS} if policy.remat == "dots" else {}

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        modes = _get_current_function_mode_stack()
        return checkpoint(_marked(fn, modes), *args, use_reentrant=False, **kw)
    return wrapped


def forward(params, batch, cfg: ModelConfig, policy: RunPolicy,
            return_cache: bool = False, cache_len: int | None = None):
    """Full-sequence forward.

    Returns (logits, aux) for training (full-seq logits), or
    (last_logits, aux, state) when return_cache (prefill).
    """
    _check_supported(cfg)
    cd = compute_dtype(policy)
    cparams = cast_params(params, cd)
    x, positions = embed_tokens(cparams, cfg, batch, cd)
    x = maybe_constrain(x, ("batch", "seq_q", "act_embed"))
    pattern = cfg.block_pattern
    n_units, tail = n_units_tail(cfg)
    cl = cache_len if return_cache else None
    aux = torch.zeros((2,), dtype=torch.float32, device=x.device)

    def unit_fn(x, unit_params):
        unit_aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
        states = {}
        for i, bt in enumerate(pattern):
            x, a, st = apply_block_full(bt, unit_params[f"b{i}"], x, positions, cfg,
                                        policy, cache_len=cl)
            unit_aux = unit_aux + a
            states[f"b{i}"] = st
        return x, unit_aux, states

    unit_fn_r = _remat_wrap(unit_fn, policy)
    unit_states = []
    for u in range(n_units):
        x, a, st = unit_fn_r(x, _unit(cparams["units"], u))
        aux = aux + a
        unit_states.append(st)
    tail_states = {}
    for i in range(tail):
        x, a, s = apply_block_full(pattern[i], cparams["tail"][f"t{i}"], x,
                                   positions, cfg, policy, cache_len=cl)
        aux = aux + a
        tail_states[f"t{i}"] = s

    x = apply_norm(cparams["final_norm"], x, cfg.norm)
    if return_cache:
        logits = unembed_logits(cparams, cfg, x[:, -1])
        states = {b: {k: torch.stack([st[b][k] for st in unit_states])
                      for k in unit_states[0][b]}
                  for b in unit_states[0]} if unit_states else {}
        state = {"units": states}
        if tail:
            state["tail"] = tail_states
        return logits, aux, state
    return unembed_logits(cparams, cfg, x), aux


def decode_step(params, state, batch, cfg: ModelConfig, policy: RunPolicy):
    """One-token decode.  batch: {"tokens": (B,1), "position": (B,)}.

    ``state`` is updated in place (each layer's cache is a view into the
    stacked tensors) and returned.  Returns (logits (B,V), state).
    """
    _check_supported(cfg)
    cd = compute_dtype(policy)
    cparams = cast_params(params, cd)
    x, _ = embed_tokens(cparams, cfg, batch, cd)
    position = batch["position"]
    pattern = cfg.block_pattern
    n_units, tail = n_units_tail(cfg)
    for u in range(n_units):
        up, us = _unit(cparams["units"], u), _unit(state["units"], u)
        for i, bt in enumerate(pattern):
            x, _ = apply_block_decode(bt, up[f"b{i}"], us[f"b{i}"], x, position,
                                      cfg, policy)
    for i in range(tail):
        x, _ = apply_block_decode(pattern[i], cparams["tail"][f"t{i}"],
                                  state["tail"][f"t{i}"], x, position, cfg, policy)
    x = apply_norm(cparams["final_norm"], x, cfg.norm)
    return unembed_logits(cparams, cfg, x[:, 0]), state


# ----------------------------------------------------------------------- loss

def lm_loss(logits, labels):
    """Cross-entropy with mask (labels < 0 ignored). logits f32."""
    V = logits.shape[-1]
    mask = labels >= 0
    labels_c = labels.clamp(0, V - 1).long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels_c[..., None])[..., 0]
    n = torch.clamp(mask.sum(), min=1)
    return -(ll * mask).sum() / n
