"""First-principles cost floors ("the spec") for anomaly detection + roofline.

These play the role of the RNIC datasheet in the paper's anomaly definition:
MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per the assignment, plus
textbook parallelism cost models for expected collective traffic and memory.
All estimates are *floors* — the anomaly monitor applies headroom factors.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ModelConfig, RunPolicy, ShapeSpec
from ..models import api


def _axis_size(mesh, names):
    n = 1
    for a in names:
        n *= mesh.shape.get(a, 1)
    return n


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Assignment MODEL_FLOPS: 6·N·D train / 2·N·D inference, N = active."""
    n_active = api.n_active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def matmul_model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Scale-stable variant of MODEL_FLOPS counting only matmul params
    (embedding gathers do no FLOPs) — used by the A3 anomaly check."""
    n = api.matmul_active_params(cfg)
    mult = 6.0 if shape.kind == "train" else 2.0
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    return mult * n * tokens


def attention_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Quadratic (or windowed) attention term not included in 6·N·D."""
    if cfg.attn_free:
        return 0.0
    pattern = cfg.block_pattern
    n_attn = sum(1 for _ in range(cfg.n_layers)
                 if pattern[_ % len(pattern)] == "attn")
    S = shape.seq_len
    B = shape.global_batch
    hd = cfg.n_heads * cfg.d_head
    if shape.kind == "decode":
        ctx = min(S, cfg.window) if cfg.window else S
        return 2.0 * 2 * B * ctx * hd * n_attn          # qk + av vs cache
    ctx = min(S, cfg.window) if cfg.window else S
    # causal halves the full square; windowed is S*W
    per_layer = 2.0 * 2 * B * S * ctx * hd * (0.5 if not cfg.window else 1.0)
    mult = 3.0 if shape.kind == "train" else 1.0
    return per_layer * n_attn * mult


def recurrence_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Linear-state recurrence term (rwkv wkv / rg-lru scan)."""
    tokens = (shape.global_batch if shape.kind == "decode"
              else shape.global_batch * shape.seq_len)
    mult = 3.0 if shape.kind == "train" else 1.0
    per_tok = 0.0
    pattern = cfg.block_pattern
    n_rwkv = sum(1 for i in range(cfg.n_layers) if pattern[i % len(pattern)] == "rwkv")
    n_rec = sum(1 for i in range(cfg.n_layers) if pattern[i % len(pattern)] == "rec")
    if n_rwkv:
        per_tok += n_rwkv * 4.0 * cfg.n_heads * cfg.head_size ** 2
    if n_rec:
        per_tok += n_rec * 8.0 * cfg.rec_width
    return per_tok * tokens * mult


def total_model_flops(cfg, shape) -> float:
    return model_flops(cfg, shape) + attention_flops(cfg, shape) \
        + recurrence_flops(cfg, shape)


# --------------------------------------------------------------- memory floor

def memory_floor_bytes(cfg: ModelConfig, shape: ShapeSpec, policy: RunPolicy,
                       mesh) -> float:
    """Expected resident bytes per device (params + opt + grads + states)."""
    P = api.n_params(cfg)
    n_m = mesh.shape.get("model", 1)
    n_d = _axis_size(mesh, ("pod", "data"))
    pdtype = 4 if policy.params_f32 else 2
    adtype = 2 if policy.dtype == "bf16" else 4
    # params sharded over model in fsdp/tp/ep presets; replicated in dp
    pshard = n_m if policy.sharding_preset != "dp" else 1
    mem = P * pdtype / pshard
    if shape.kind == "train":
        opt_mult = {"adamw": 2.0, "sgdm": 1.0, "adafactor": 0.1}[policy.optimizer]
        oshard = pshard * (n_d if policy.zero1 else 1)
        mem += P * 4 * opt_mult / oshard
        mem += P * 4 / pshard                      # grad accumulator (f32)
        B_local = max(shape.global_batch // n_d, 1) // max(policy.n_microbatch, 1)
        B_local = max(B_local, 1)
        act_mult = {"full": 1.5, "dots": 8.0, "none": 14.0}[policy.remat]
        layers = cfg.n_layers
        mem += layers * B_local * shape.seq_len * cfg.d_model * adtype * act_mult
    elif shape.kind == "decode":
        B_local = max(shape.global_batch // n_d, 1)
        clen = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
        pattern = cfg.block_pattern
        n_attn = sum(1 for i in range(cfg.n_layers)
                     if pattern[i % len(pattern)] == "attn")
        mem += 2 * n_attn * B_local * clen * cfg.n_kv_heads * cfg.d_head * adtype
    elif shape.kind == "prefill":
        B_local = max(shape.global_batch // n_d, 1)
        mem += 2 * cfg.n_layers * B_local * shape.seq_len * \
            max(cfg.n_kv_heads, 1) * cfg.d_head * adtype
    return mem


# ----------------------------------------------------------- collective floor

def collective_floor_bytes(cfg: ModelConfig, shape: ShapeSpec,
                           policy: RunPolicy, mesh) -> float:
    """Expected per-device wire bytes per step (ring model lower bound)."""
    P = api.n_params(cfg)
    n_m = mesh.shape.get("model", 1)
    n_d = _axis_size(mesh, ("pod", "data"))
    adtype = 2 if policy.dtype == "bf16" else 4
    wire = 0.0
    if shape.kind == "train" and n_d > 1:
        # gradient all-reduce over the data axes (grads themselves sharded
        # over model when params are)
        gbytes = P * 4 / (n_m if policy.sharding_preset != "dp" else 1)
        if policy.grad_compress == "int8":
            gbytes = gbytes / 4
        elif policy.grad_compress == "bf16":
            gbytes = gbytes / 2
        wire += 2.0 * (n_d - 1) / n_d * gbytes
        if policy.zero1:
            # ZeRO-1: reduce-scatter grads + all-gather updated params instead
            # of a pure all-reduce — same ring bytes to first order
            pass
    if policy.sharding_preset == "fsdp" and n_m > 1:
        # per-(layer × microbatch) weight all-gathers, fwd + bwd
        n_micro = max(policy.n_microbatch, 1) if shape.kind == "train" else 1
        passes = 3.0 if shape.kind == "train" else 1.0   # fwd, bwd, remat-fwd
        wire += passes * n_micro * P * adtype * (n_m - 1) / n_m
    if policy.sharding_preset in ("tp", "ep") and n_m > 1:
        tokens_local = (shape.global_batch // max(n_d, 1)) * \
            (1 if shape.kind == "decode" else shape.seq_len)
        per_layer = 2 * tokens_local * cfg.d_model * adtype
        passes = 4.0 if shape.kind == "train" else 2.0
        wire += passes * cfg.n_layers * per_layer * 2.0 * (n_m - 1) / n_m
    return wire


# ------------------------------------------------------------- the step floor

def activation_bytes_floor(cfg, shape, policy, mesh) -> float:
    """Per-device HBM traffic from activations (reads+writes of the main
    per-layer tensors; attention scores excluded — flash-kernel target)."""
    if shape.kind == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.global_batch * shape.seq_len
    n = mesh.size
    tokens_dev = max(tokens / n, 1.0)   # best case: fully sharded activations
    adtype = 2 if policy.dtype == "bf16" else 4
    per_tok = cfg.n_layers * adtype * (8 * cfg.d_model + 4 * cfg.d_ff)
    passes = 3.0 if shape.kind == "train" else 1.0
    return per_tok * tokens_dev * passes


def step_floor_seconds(cfg, shape, policy, mesh, chip=None) -> dict:
    from .. import hw
    chip = chip or hw.V5E
    n = mesh.size
    fl = total_model_flops(cfg, shape)
    # unavoidable HBM traffic: read params once (+opt r/w for train) + states
    P = api.n_params(cfg)
    n_m = mesh.shape.get("model", 1)
    pshard = n_m if policy.sharding_preset != "dp" else 1
    pdtype = 4 if policy.params_f32 else 2
    bytes_dev = P * pdtype / pshard
    if shape.kind == "train":
        bytes_dev *= 3 * max(policy.n_microbatch, 1)   # fwd+bwd+remat reads
        bytes_dev += 3 * P * 4 / pshard                # grads + opt r/w
    bytes_dev += activation_bytes_floor(cfg, shape, policy, mesh)
    mem_floor = memory_floor_bytes(cfg, shape, policy, mesh)
    if shape.kind == "decode":
        bytes_dev += mem_floor                          # cache read dominates
    coll = collective_floor_bytes(cfg, shape, policy, mesh)
    compute_s = fl / (n * chip.peak_flops_bf16)
    memory_s = bytes_dev / chip.hbm_bw
    coll_s = coll / chip.ici_bw
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s,
            "floor_s": max(compute_s, memory_s, coll_s),
            "model_flops": fl, "assignment_model_flops": model_flops(cfg, shape),
            "matmul_model_flops": matmul_model_flops(cfg, shape),
            "bytes_floor": bytes_dev, "collective_floor": coll,
            "memory_floor": mem_floor}
