#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device   — require CUDA; print the card's name and power limit.
2. build    — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``.
3. kernels  — hold each kernel against its plain PyTorch version on the card
              at the serving shapes (bf16 within 2e-2, f32 within 2e-5 with
              TF32 off), and time kernel, plain version and one PyTorch
              library call on the same work (the library call is a yardstick
              only; the port never calls it).
4. serve    — qwen2-1.5b at full published width, random weights from a
              seeded generator, ServingEngine(n_slots=4, cache_len=4096,
              temperature=0) over 8 requests; launch counts must equal
              28 x prefills and 28 x decode steps; on the tensors the model
              hands the kernels (strided prefill views, the cache read in
              place by a 4-lane decode step) each bf16 kernel must match its
              plain version within 2e-2 of the call's output scale (the
              activations reach ~40); teacher-forced logits with the
              kernels on must match the plain versions on the card (f32
              within 1e-3 of the largest logit; bf16, a loose extra check, no
              further from the f32 logits than twice the plain bf16 path).
5. report   — one JSON line of kernels, the nvidia-smi line, and the result
              line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# Teacher-forced logits of one request (prefill + 8 decode steps), kernels on
# vs the plain versions, on the card.
# f32: the kernels agree with their plain versions to ~1e-6 per call; through
# 28 layers that stays far below 1e-3 of the largest logit, while a wrongly
# wired kernel (layout, head group, mask) moves the logits by O(1).
F32_LOGIT_TOL = 1e-3
# bf16: the random weights follow the JAX package's init, whose stacked layer
# weights take fan_in = n_layers (std 1/sqrt(28), ~7x the usual scale), so bf16
# rounding alone moves these logits by O(1): the plain bf16 path is itself
# ~0.5-1 away from the f32 logits.  The kernels may add no more than that:
# their bf16 logits must be no further from the f32 logits than
# BF16_ERROR_RATIO times the plain bf16 path's distance.
BF16_ERROR_RATIO = 2.0
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12          # H100 SXM HBM3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str):
    print(f"== {name}", flush=True)


# ---------------------------------------------------------------- timing

class Timer:
    """Mean device time of ``fn`` over ``iters`` runs, L2 flushed before each.

    The device first sleeps ~0.1 s so that the host queues every run before
    any starts: the events then time the device alone, not the Python and
    launch overhead between them (which the serve phase measures instead).
    """

    SLEEP_CYCLES = 200_000_000

    def __init__(self, device):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters=10, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
        torch.cuda._sleep(self.SLEEP_CYCLES)
        for s, e in ev:
            self.flush_buf.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / iters


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------- kernels

def attn_inputs(gen, dev, dtype, B, H, KVH, Sq, Skv, D):
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    return mk(B, H, Sq, D), mk(B, KVH, Skv, D), mk(B, KVH, Skv, D)


def visible_pairs(Sq, Skv, window, shift):
    qa = np.arange(Sq)[:, None] + shift
    ka = np.arange(Skv)[None, :]
    vis = ka <= qa
    if window is not None:
        vis &= ka > qa - window
    return int(vis.sum())


def check_flash_attention(gen, dev, timer):
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    cases = [  # (dtype, B, H, KVH, Sq, Skv, D, window, shift)
        (torch.bfloat16, 1, 12, 2, 1024, 1024, 128, None, 0),
        (torch.bfloat16, 1, 12, 2, 3000, 3000, 128, None, 0),
        (torch.float32, 1, 12, 2, 1024, 1024, 128, None, 0),
        (torch.float32, 1, 12, 2, 3000, 3000, 128, None, 0),
        (torch.bfloat16, 1, 12, 2, 3000, 3000, 128, 512, 0),
        (torch.bfloat16, 1, 12, 2, 1024, 3000, 128, None, 1976),
        (torch.bfloat16, 2, 32, 4, 777, 777, 64, None, 0),
        (torch.float32, 2, 32, 4, 777, 777, 64, 100, 0),
    ]
    worst = 0.0
    for dtype, B, H, KVH, Sq, Skv, D, window, shift in cases:
        q, k, v = attn_inputs(gen, dev, dtype, B, H, KVH, Sq, Skv, D)
        o, lse = flash_attention_fwd(q, k, v, window=window, causal_shift=shift)
        ro, rlse = ref.flash_attention_ref(q, k, v, window=window, causal_shift=shift)
        torch.cuda.synchronize()
        e_o = (o.float() - ro.float()).abs().max().item()
        e_l = (lse - rlse).abs().max().item()
        ok = e_o <= TOL[dtype] and e_l <= TOL[dtype]
        print(f"flash_attention_fwd {str(dtype)[6:]} B={B} H={H} KVH={KVH} Sq={Sq} "
              f"Skv={Skv} D={D} window={window} shift={shift}: max|o|err={e_o:.3e} "
              f"max|lse|err={e_l:.3e} tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("flash_attention_fwd disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, e_o, e_l)

    # timing at the serving prefill shape: one layer of a 3000-token prompt
    B, H, KVH, S, D = 1, 12, 2, 3000, 128
    q, k, v = attn_inputs(gen, dev, torch.bfloat16, B, H, KVH, S, S, D)
    kx, vx = k.repeat_interleave(H // KVH, 1), v.repeat_interleave(H // KVH, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {
        "ms": timer.ms(lambda: flash_attention_fwd(q, k, v)),
        "plain_ms": timer.ms(lambda: ref.flash_attention_ref(q, k, v), iters=3),
        "library_ms": timer.ms(lambda: sdpa(q, kx, vx, is_causal=True)),
    }
    flops = 4.0 * B * H * D * visible_pairs(S, S, None, 0)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * B * H * S
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"flash_attention_fwd work at B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; kernel {row['ms']:.4f} ms "
          f"({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain {row['plain_ms']:.4f} ms, "
          f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    row["max_abs_err"] = worst
    return row


def decode_inputs(gen, dev, dtype, B, H, KVH, T, D, fills, window):
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=torch.float32).to(dtype)
    q, k, v = mk(B, H, D), mk(B, KVH, T, D), mk(B, KVH, T, D)
    pos = torch.full((B, T), -1, dtype=torch.int32)
    qpos = torch.zeros(B, dtype=torch.int32)
    for b, n in enumerate(fills):
        if window is None:                 # linear cache, first n slots written
            pos[b, :n] = torch.arange(n, dtype=torch.int32)
            qpos[b] = n - 1
        else:                              # ring cache after n tokens
            p = torch.arange(max(0, n - T), n, dtype=torch.int32)
            pos[b, p % T] = p
            qpos[b] = n - 1
    return q, k, v, pos.to(dev), qpos.to(dev)


def check_flash_decode(gen, dev, timer):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    cases = [  # (dtype, B, H, KVH, T, D, fills, window)
        (torch.bfloat16, 4, 12, 2, 4096, 128, (4096, 3000, 1000, 64), None),
        (torch.float32, 4, 12, 2, 4096, 128, (4096, 3000, 1000, 64), None),
        (torch.bfloat16, 4, 12, 2, 4096, 128, (9000, 4500, 700, 1), 1024),
        (torch.bfloat16, 3, 32, 4, 1000, 64, (1000, 500, 3), None),
        (torch.float32, 3, 32, 4, 1000, 64, (2500, 500, 3), 300),
        (torch.bfloat16, 2, 12, 1, 700, 64, (700, 300), None),          # G = 12
    ]
    worst = 0.0
    for dtype, B, H, KVH, T, D, fills, window in cases:
        q, k, v, pos, qpos = decode_inputs(gen, dev, dtype, B, H, KVH, T, D, fills, window)
        o = flash_decode(q, k, v, pos, qpos, window=window)
        r = ref.flash_decode_ref(q, k, v, pos, qpos, window=window)
        torch.cuda.synchronize()
        err = (o.float() - r.float()).abs().max().item()
        ok = err <= TOL[dtype]
        print(f"flash_decode {str(dtype)[6:]} B={B} H={H} KVH={KVH} T={T} D={D} "
              f"fills={fills} window={window}: max|o|err={err:.3e} tol={TOL[dtype]:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("flash_decode disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, err)

    # timing at the serving decode shape: one layer, 4 lanes, cache 4096
    B, H, KVH, T, D = 4, 12, 2, 4096, 128
    fills = (4096, 3000, 1000, 64)
    q, k, v, pos, qpos = decode_inputs(gen, dev, torch.bfloat16, B, H, KVH, T, D, fills, None)
    kx, vx = k.repeat_interleave(H // KVH, 1), v.repeat_interleave(H // KVH, 1)
    mask = ((pos >= 0) & (pos <= qpos[:, None]))[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {
        "ms": timer.ms(lambda: flash_decode(q, k, v, pos, qpos), iters=50),
        "plain_ms": timer.ms(lambda: ref.flash_decode_ref(q, k, v, pos, qpos), iters=20),
        "library_ms": timer.ms(lambda: sdpa(q[:, :, None], kx, vx, attn_mask=mask), iters=50),
    }
    n_vis = int(mask.sum().item())
    flops = 4.0 * H * D * n_vis
    nbytes = (2 * 2 * KVH * D * n_vis            # visible K and V rows, bf16
              + 4 * n_vis                         # their positions
              + 2 * 2 * B * H * D + 4 * B)        # q, o, qpos
    full_bytes = 2 * 2 * B * KVH * T * D
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
    print(f"flash_decode work at B={B} H={H} KVH={KVH} T={T} D={D} bf16 fills={fills}: "
          f"full cache {full_bytes / 1e6:.2f} MB, visible {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e6:.1f} MFLOP; kernel {row['ms']:.4f} ms "
          f"({full_bytes / row['ms'] / 1e6:.0f} GB/s of full cache), "
          f"plain {row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    row["max_abs_err"] = worst
    return row


# ---------------------------------------------------------------- serve

def teacher_forced(api, cfg, params, policy, req, dev, n_steps=8):
    """Logits (1 + n_steps, 1, V) f32 of a prefill and n_steps decode steps fed
    the request's own output tokens."""
    with torch.inference_mode():
        prompt = torch.as_tensor(req.prompt, device=dev)[None, :]
        logits, _, state = api.forward(params, {"tokens": prompt}, cfg, policy,
                                       return_cache=True, cache_len=4096)
        seq = [logits]
        for j, tok in enumerate(req.out[:n_steps]):
            batch = {"tokens": torch.tensor([[tok]], dtype=torch.int32, device=dev),
                     "position": torch.tensor([len(req.prompt) + j], dtype=torch.int32,
                                              device=dev)}
            logits, state = api.decode_step(params, state, batch, cfg, policy)
            seq.append(logits)
        return torch.stack(seq).float()


def profile_decode(eng, prompts, Request, n_steps=5):
    """Where a decode step's time goes: torch.profiler over ``n_steps`` steps
    with all four lanes busy.  Prints wall ms per step, device-busy ms per
    step, the idle share and the top kernels; says "not measured" when the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(eng.n_slots):
        eng.add_request(Request(rid=100 + i, prompt=prompts[i][:2000],
                                max_new_tokens=n_steps + 3))
    eng.step()                               # admit and prefill all lanes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    eng.run()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n_steps, ev.count // n_steps, ev.key))
    busy = sum(r[0] for r in rows)
    if busy == 0:
        print(f"decode profile: wall {wall:.3f} ms/step; device time not measured "
              f"(the profiler recorded no device events)", flush=True)
        return
    rows.sort(reverse=True)
    top = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}" for ms, n, k in rows[:8])
    print(f"decode profile ({n_steps} steps, 4 lanes busy): wall {wall:.3f} ms/step, "
          f"device busy {busy:.3f} ms/step, idle share {1 - busy / wall:.3f}; "
          f"top kernels per step: {top}", flush=True)


def check_in_model_layouts(eng, prompts, Request):
    """Hold both bf16 kernels against their plain versions on the very
    tensors the model hands them: the strided q/k/v views of four prefills
    (the 3000-token prompt among them) and the (B,T,KVH,D) cache that one
    decode step with all four lanes busy reads in place.  Every layer's call
    is checked.

    The model's activations are far from unit scale (outputs up to ~40),
    where one bf16 rounding step of an output is up to 0.25, and the bf16
    flash-attention kernel rounds the probabilities P to bf16 for its P.V
    product (the plain version keeps them in f32), which moves an output by
    up to 2^-9 x max|v|.  So each call's largest error must be within
    TOL[bf16] of that call's scale, max(1, max|plain output|); lse (f32)
    within TOL[bf16] absolute.  A wrongly wired kernel (head group, mask,
    stride) misses by a good part of the scale.  Returns, per kernel, the
    largest absolute error, the largest |plain output|, the largest error
    over its call's scale, and the largest lse error.
    """
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    fa, fd = attn.flash_attention_fwd, attn.flash_decode
    stats = {n: {"max_abs_err": 0.0, "max_abs_value": 0.0, "max_scaled_err": 0.0,
                 "max_lse_err": 0.0, "calls": 0}
             for n in ("flash_attention_fwd", "flash_decode")}
    layouts = {}

    def record(name, o, r):
        st = stats[name]
        err = (o.float() - r.float()).abs().max().item()
        value = r.float().abs().max().item()
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["max_abs_value"] = max(st["max_abs_value"], value)
        st["max_scaled_err"] = max(st["max_scaled_err"], err / max(1.0, value))
        st["calls"] += 1

    def fa_checked(q, k, v, **kw):
        o, lse = fa(q, k, v, **kw)
        ro, rlse = ref.flash_attention_ref(q, k, v, **kw)
        record("flash_attention_fwd", o, ro)
        st = stats["flash_attention_fwd"]
        st["max_lse_err"] = max(st["max_lse_err"], (lse - rlse).abs().max().item())
        layouts.setdefault(("flash_attention_fwd", q.shape[2]),
                           (tuple(q.shape), q.stride(), k.stride(), q.dtype))
        return o, lse

    def fd_checked(q, k, v, pos, qpos, **kw):
        o = fd(q, k, v, pos, qpos, **kw)
        record("flash_decode", o, ref.flash_decode_ref(q, k, v, pos, qpos, **kw))
        layouts.setdefault(("flash_decode", q.shape[0]),
                           (tuple(k.shape), q.stride(), k.stride(), q.dtype))
        return o

    longest = max(range(len(prompts)), key=lambda i: len(prompts[i]))
    pick = [longest] + [i for i in range(len(prompts)) if i != longest][:eng.n_slots - 1]
    for j, i in enumerate(pick):
        eng.add_request(Request(rid=200 + j, prompt=prompts[i], max_new_tokens=4))
    attn.flash_attention_fwd, attn.flash_decode = fa_checked, fd_checked
    try:
        eng.step()                           # four prefills, one 4-lane decode step
        torch.cuda.synchronize()
    finally:
        attn.flash_attention_fwd, attn.flash_decode = fa, fd
    eng.run()
    for (name, n), (shape, qs, ks, dt) in sorted(layouts.items()):
        print(f"in-model layout {name} ({n}): shape {shape} {str(dt)[6:]}, "
              f"q strides {qs}, k strides {ks}", flush=True)
    tol = TOL[torch.bfloat16]
    print(f"in-model kernels vs plain versions ({[len(prompts[i]) for i in pick]} "
          f"prefills, one 4-lane decode step, every layer): {stats}; tol {tol:g} x "
          f"max(1, max|plain output|) per call, lse {tol:g}", flush=True)
    for name, st in stats.items():
        if st["calls"] == 0:
            fail(f"in-model check saw no call of {name}")
        if not (st["max_scaled_err"] <= tol and st["max_lse_err"] <= tol):
            fail(f"{name} in the model's layout disagrees with its plain version: "
                 f"{st}")
    return stats


def serve(dev):
    from repro_torch.configs.base import RunPolicy, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = get_config("qwen2-1.5b")
    policy = RunPolicy(use_pallas=True)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"qwen2-1.5b: {api.n_params(cfg) / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(0)
    lens = rng.integers(64, 3001, size=8)
    lens[int(rng.integers(0, 8))] = 3000
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]

    def make_engine():
        return ServingEngine(cfg, policy, params, n_slots=4, cache_len=4096,
                             temperature=0.0, device=dev)

    # warm-up: cuBLAS handles and kernel libraries, off the record
    warm = make_engine()
    warm.add_request(Request(rid=-1, prompt=prompts[0][:64], max_new_tokens=2))
    warm.run()
    del warm

    eng = make_engine()
    cparams = eng.params
    del params
    prefill_ms, decode_ms = [], []

    def timed(fn, sink):
        def wrapped(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    eng.prefill = timed(eng.prefill, prefill_ms)
    eng.decode = timed(eng.decode, decode_ms)
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = list(eng.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    st = eng.stats
    n_layers = cfg.n_layers
    print(f"serve: {len(done)} requests, stats {st}, launches {counts}", flush=True)
    if len(done) != len(prompts) or not all(r.done and len(r.out) == 32 for r in done):
        fail("not every request completed with 32 tokens")
    if counts["flash_attention_fwd"] != n_layers * st["prefills"]:
        fail(f"flash_attention_fwd launches {counts['flash_attention_fwd']} != "
             f"{n_layers} x {st['prefills']} prefills")
    if counts["flash_decode"] != n_layers * st["decode_steps"]:
        fail(f"flash_decode launches {counts['flash_decode']} != "
             f"{n_layers} x {st['decode_steps']} decode steps")
    tps = st["tokens_out"] / wall
    print(f"serve: prompt lengths {[int(n) for n in lens]}; prefill ms per request "
          f"{[round(x, 3) for x in prefill_ms]} (mean {np.mean(prefill_ms):.3f}); "
          f"decode ms per step median {np.median(decode_ms):.3f} p90 "
          f"{np.percentile(decode_ms, 90):.3f} over {len(decode_ms)} steps; "
          f"{st['tokens_out']} tokens in {wall:.3f} s = {tps:.1f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB", flush=True)

    profile_decode(eng, prompts, Request)
    in_model = check_in_model_layouts(eng, prompts, Request)

    # teacher-forced: the longest request, kernels on vs plain versions on card
    del eng
    req = max(done, key=lambda r: len(r.prompt))
    params32 = api.init(cfg, seed=0, device=dev)
    runs = {
        "kernels bf16": (cparams, policy),
        "plain bf16": (cparams, RunPolicy(use_pallas=False)),
        "kernels f32": (params32, RunPolicy(dtype="f32", use_pallas=True)),
        "plain f32": (params32, RunPolicy(dtype="f32", use_pallas=False)),
    }
    out = {name: teacher_forced(api, cfg, p, pol, req, dev)
           for name, (p, pol) in runs.items()}
    for name, x in out.items():
        if x.shape != (9, 1, cfg.vocab_size) or not torch.isfinite(x).all():
            fail(f"{name}: logits of shape {tuple(x.shape)} or not finite")
    ref32 = out["plain f32"]
    scale = max(1.0, ref32.abs().max().item())
    dist = {name: (x - ref32).abs().max().item() for name, x in out.items()}
    agree = {name: (x.argmax(-1) == ref32.argmax(-1)).float().mean().item()
             for name, x in out.items()}
    print(f"serve teacher-forced (rid {req.rid}, prompt {len(req.prompt)}, prefill + 8 "
          f"decode steps): max|logit| {scale:.4f}; max|logit - plain f32| "
          f"{ {k: round(v, 6) for k, v in dist.items()} }; argmax agreement with plain "
          f"f32 { {k: round(v, 3) for k, v in agree.items()} }", flush=True)
    if dist["kernels f32"] > F32_LOGIT_TOL * scale:
        fail(f"f32 kernels-on logits differ from the plain versions by "
             f"{dist['kernels f32']:.3e} > {F32_LOGIT_TOL} x {scale:.3f}")
    if dist["kernels bf16"] > BF16_ERROR_RATIO * dist["plain bf16"]:
        fail(f"bf16 kernels-on logits are {dist['kernels bf16']:.4f} from the f32 ones, "
             f"more than {BF16_ERROR_RATIO} x the plain bf16 path's "
             f"{dist['plain bf16']:.4f}")
    return counts, in_model


# ---------------------------------------------------------------- main

def main():
    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from the repository")
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # f32 checks need full f32 products: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"{smi_line}", flush=True)

    phase("build")
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    times = build.build()
    print(f"build: {', '.join(f'{n} {t:.1f} s' for n, t in times.items()) or 'cached'}; "
          f"total {time.perf_counter() - t0:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    phase("kernels")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    fa = check_flash_attention(gen, dev, timer)
    fd = check_flash_decode(gen, dev, timer)
    del timer
    torch.cuda.empty_cache()

    phase("serve")
    counts, in_model = serve(dev)
    for name, row in (("flash_attention_fwd", fa), ("flash_decode", fd)):
        st = in_model[name]
        row["in_model_max_abs_err"] = st["max_abs_err"]
        row["in_model_max_abs_value"] = st["max_abs_value"]
        row["in_model_max_scaled_err"] = st["max_scaled_err"]

    phase("report")
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=counts["flash_attention_fwd"], tolerance=TOL[torch.bfloat16], **fa),
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:23",
             launches=counts["flash_decode"], tolerance=TOL[torch.bfloat16], **fd),
    ]
    for kr in kernels:
        if not all(math.isfinite(kr[k]) for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite numbers for {kr['name']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
