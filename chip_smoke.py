#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device   — require CUDA; print the card's name and power limit.
2. build    — compile every CUDA kernel from ``src/repro_torch/kernels/csrc``;
              print each kernel's registers, spills and ptxas performance
              warnings (``-Xptxas -v``).
3. kernels  — hold each kernel against its plain PyTorch version on the card
              at the serving and training shapes (forward kernels: bf16
              within 2e-2, f32 within 2e-5 with TF32 off; backward kernels:
              bf16 within 2e-2 and f32 within 5e-5 of each call's
              max(1, max|plain grad|)), check that two dq and two dk/dv
              runs at the training shape, and two WKV runs at rwkv6-7b's
              prefill shape, give the same bits, and time kernel, plain
              version and one PyTorch library call on the same work, with
              the kernel's achieved TFLOP/s (the library call is
              a yardstick only; the port never calls it).  The kernels of
              the recurrent archs too: the forward and decode kernels at
              D=256 (recurrentgemma's local attention: 10 query heads over
              one KV head, window 2048; bf16 within 2e-2, f32 within 2e-5),
              the RG-LRU scan (the plain version's bits, and within 1e-5) and
              the RWKV-6 WKV (output and final state within 1e-5 of the
              largest plain value).  Flash-decode is also held at head dims
              16 and 32 and on a lane with no visible slot; for it and the
              RG-LRU scan a line gives ms, GB/s (of the visible and of the
              full cache for decode), the bound, registers and spills, and
              whether a rerun gives the same bits.
3b. kernels_d32 — the forward (bf16, f32), dq and dk/dv at head dim 32
              against their plain versions at the bench train cell's shapes
              (q (32,12,256,32), k/v (32,2,256,32), causal), with a window,
              a causal shift and G = 1, 6; two runs of dq and of dk/dv must
              give the same bits; flash-decode (bf16, f32) at the bench
              decode_s step's per-call shape (16 lanes, a 1024-slot cache
              holding 513 tokens) within TOL; a line each of ms, bound,
              SDPA's time, registers and spills, and the card's name and
              power limit.
3c. bench_step — qwen2-1.5b-bench (the search's own config) and
              mixtral-8x7b-bench (8 experts top-2, window 64: the windowed
              head-dim-32 kernels) on one card: one train_s step's
              gradients (remat "dots") of each and one qwen2 decode_s
              step, kernels on against off from the same params, f32 and
              bf16 (BENCH_LOSS_TOL, BENCH_GRAD_TOL, F32_LOGIT_TOL; bf16
              gradients and logits no further from the f32 ones than
              BF16_ERROR_RATIO times the plain bf16 path's), with exact
              launch counts (8 forward, 4 dq, 4 dk/dv each; 4 flash-decode).
3d. measure — ``chip_smoke.py --measure``, in a process of its own (its
              fake process group stays out of the card phases; its failure
              fails the run): the committed corpus's 8 witnesses and 8
              controls (the 6 of mixtral-8x7b included) measured by
              ``measure_cell`` (V5E spec, fake cuda tensors), each point's
              kinds exactly the reference's today (``parity.REFERENCE``) or
              a listed difference, its useful-FLOP ratio within 10 % of the
              reference's (or the listed value), and no op run
              replicated but those ``parity.REPLICATED_OPS`` admits at the
              point's class; the same points kernels on
              (no launch, no pointer read; counter deltas printed);
              qwen2-1.5b at train_4k on the 16x16 production mesh (useful
              ratio within 10 % of the CPU trace's, no unlisted replicated
              op; counters and trace seconds printed).
3e. corpus — the port's replay of the 8 committed corpus entries,
              ``python -m repro_torch.core.corpus replay --parity`` on fake
              cuda tensors in a process of its own, run on the host beside
              the measure phase (both trace on the host only; their trace
              seconds are taken side by side): no failed trace, and
              every verdict (kind still fires at the witness, not at the
              controls) the reference's today or a listed difference
              (``parity.REPLAY_REFERENCE``, ``REPLAY_DIFFERENCES``).
3f. search — Collie's campaign end to end on the traced counters, in
              processes of their own: ``python -m
              repro_torch.examples.collie_search --device cuda --budget 24``
              (the restricted serving space of the JAX package's
              ``examples/collie_search.py``: qwen2-1.5b-bench and
              tinyllama-1.1b-bench, prefill_s and decode_s, on the bench
              meshes; fake cuda tensors, no kernel) with 4 workers and a
              fresh temporary ``COLLIE_CACHE``: it must end with no failed
              trace, at least one event and no op run replicated at a point
              whose class ``parity.REPLICATED_OPS`` does not admit it (by
              arch, preset, shape kind and microbatch count); then the same
              command in a new
              process with another ``PYTHONHASHSEED``, one worker and the
              same cache must trace nothing (no lowering, no mesh trace) and
              print the same catalog and events.  The anomaly table, the MFS
              list, the engine's counts and host seconds are printed.
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
5. train    — qwen2-1.5b at full published width, random weights from a
              seed, RunPolicy(use_pallas=True, remat="dots", n_microbatch=2)
              (bf16 compute, f32 params), adamw as the launcher builds it,
              SyntheticLM at seq 4096, global batch 2: 1 warm-up and 3 timed
              steps.  Each step must launch the forward kernel 28 x 2 x 2
              times (remat "dots" recomputes it in backward) and each
              backward kernel 28 x 2 times; on the tensors the model and
              autograd hand the backward kernels (every layer of one
              microbatch) dq, dk and dv must match the plain backward within
              2e-2 of the call's scale; the f32 gradients of one whole step
              (batch 1, seq 512) with the kernels on must match the plain
              versions' leaf by leaf, and the attention weights' gradients
              must be nonzero.
6. serve recurrentgemma-2b, 7. serve rwkv6-7b — each at full published
              width, random weights from seed 0, bf16 compute and f32 params,
              kernels on: ServingEngine(n_slots=4, temperature=0) over 8
              requests of 32 new tokens (recurrentgemma: cache_len 2048, its
              window, prompts 64-2000; rwkv6: cache_len 4096, prompts
              64-3000), with exact launch counts per prefill (18 RG-LRU and
              8 forward; 32 WKV) and per decode step (8 flash-decode; none),
              a decode-step and a prefill profile, every kernel held against
              its plain version on the model's own tensors, and one
              cache-less ``api.forward`` of 4096 tokens (the scoring path)
              with exact launch counts, whose f32 logits with the kernels on
              must match the plain versions' within 1e-3 of the largest
              logit (bf16, the loose check, as for qwen2).
8. serve mixtral-8x7b — at full published width, 6 of its 32 layers
              (f32 params and their bf16 copy take ~54 GB), random weights
              from seed 0, kernels on: ServingEngine(n_slots=4,
              cache_len=4096, its window, temperature=0) over 8 requests of
              32 new tokens, prompts 64-3000 from numpy seed 0, with exact
              launch counts (6 forward a prefill, 6 flash-decode a decode
              step), prefill and decode ms, tokens/s, peak memory, a
              decode and a prefill profile, the kernels held against their
              plain versions on the model's own tensors, the MoE layer's
              dropped fraction at prefill and at decode, and teacher-forced
              logits of the longest request, kernels on against the plain
              versions (f32 within 1e-3 of the largest logit; bf16, the
              loose check).
9. report   — each phase's seconds, one JSON line of kernels (the head-dim-32
              rows under ``d32``), the nvidia-smi line, and the result line
              ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --step-times [SRC]`` times qwen2-1.5b's serving and
train steps with ``repro_torch`` imported from SRC (``step_times_main``), so
that two trees can be timed in turn on one card.

Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# Backward kernels: the reference's grad bound for f32 (tests/test_kernels.py);
# both relative to each call's scale max(1, max|plain grad|).
GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 5e-5}
# f32 gradients of a whole train step, kernels on vs plain versions, per leaf
# relative to the leaf's largest plain gradient.  Per call the f32 kernels
# agree with their plain versions to ~1e-6; through 28 layers of the
# random-weight model (whose init amplifies rounding, ROADMAP queue 3) that
# grows, but stays far below 1e-2, while a detached or wrongly wired
# attention gradient is off by O(1).
F32_GRAD_TOL = 1e-2
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
# f32 where the plain f32 path is itself inexact: mixtral's random init drives
# its attention scores to ~3000 (after the 1/sqrt(D) scale), where f32
# rounding of a score moves its weight by ~1e-4, so the plain f32 versions
# are ~1e-4 (decode) to ~5e-4 (forward) of the output's scale from the same
# attention in f64 on the H100, and the model's gain carries that to the
# logits.  There the kernels are held to the exact (f64) attention: no
# further from it than F32_ERROR_RATIO times the plain f32 versions, summed
# over the calls, at the worst call and in the logits.
F32_ERROR_RATIO = 2.0
# The recurrences: the reference's bounds (tests/test_kernels.py), the RG-LRU
# scan absolute, the WKV relative to the largest plain value.
RGLRU_TOL = 1e-5
WKV_REL_TOL = 1e-5
# The kernels on the recurrent archs' own tensors: which error of a call is
# held to which bound (the bf16 attention kernels as in the qwen2 check).
IN_MODEL_TOL = {"flash_attention_fwd": ("max_scaled_err", 2e-2),
                "flash_decode": ("max_scaled_err", 2e-2),
                "rglru_scan": ("max_abs_err", RGLRU_TOL),
                "rwkv6_wkv": ("max_rel_err", WKV_REL_TOL)}
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
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


def kernel_name(mangled: str) -> str:
    """``fwd_bf16<128>`` or ``wkv_chunk_out<__nv_bfloat16, 64>`` from the
    Itanium name of a kernel in an anonymous namespace (length-prefixed
    components; template arguments that are int or bool literals, named
    types or ``float``)."""
    def ident(i):
        j = i
        while mangled[j].isdigit():
            j += 1
        return mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])

    i, names = mangled.find("N") + 1, []
    while 0 < i < len(mangled) and mangled[i].isdigit():
        name, i = ident(i)
        names.append(name)
        if mangled.startswith("I", i):
            i, args = i + 1, []
            while i < len(mangled) and mangled[i] != "E":
                if mangled.startswith("L", i):        # a literal: L <type> <value> E
                    j = mangled.index("E", i)
                    value = mangled[i + 2:j]
                    args.append({"b0": "false", "b1": "true"}.get(mangled[i + 1] + value, value))
                    i = j + 1
                elif mangled[i].isdigit():
                    arg, i = ident(i)
                    args.append(arg)
                else:
                    args.append({"f": "float", "i": "int"}.get(mangled[i], mangled[i]))
                    i += 1
            return f"{names[-1]}<{', '.join(args)}>"
    return names[-1] if names else mangled


def ptxas_summary(log: str):
    """[(kernel, registers, spill line, [performance warnings])] from the
    ``-Xptxas -v`` output of one library."""
    out, warn = {}, {}
    current = None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            current = kernel_name(line.split("'")[1] if "'" in line else line.split()[-1])
            out.setdefault(current, ["?", "no spill line"])
        elif "spill stores" in line and current:
            out[current][1] = line.strip()
        elif "Used" in line and "registers" in line and current:
            out[current][0] = line.split("Used")[1].split()[0]
        if "Performance Loss" in line and "'" in line:
            warn.setdefault(kernel_name(line.rsplit("'", 2)[1]), []).append(
                line.split(":", 1)[1].split(" for the function")[0].split(" in the function")[0].strip())
    return [(k, r, sp, warn.get(k, [])) for k, (r, sp) in out.items()]


def kernel_regs(lib: str, mark: str) -> str:
    """'R registers, S bytes spilled' of the kernels of ``lib`` whose names
    hold ``mark`` (from the build's -Xptxas -v log)."""
    from repro_torch.kernels import build
    got = []
    for kernel, regs, spills, _ in ptxas_summary(build.ptxas_log(lib)):
        if mark in kernel:
            n = spills.split(" bytes spill stores")[0].split(",")[-1].strip()
            got.append(f"{kernel}: {regs} registers, {n} bytes spilled")
    return "; ".join(got) or "not in the build log"


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
    row["tflops"] = flops / row["ms"] / 1e9
    print(f"flash_attention_fwd work at B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal: "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; kernel {row['ms']:.4f} ms "
          f"({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain {row['plain_ms']:.4f} ms, "
          f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    row["max_abs_err"] = worst
    return row


def scaled_err(got, want):
    """(max|got - want|, max|want|, the first over max(1, the second))."""
    err = (got.float() - want.float()).abs().max().item()
    value = want.float().abs().max().item()
    return err, value, err / max(1.0, value)


def check_flash_attention_bwd(gen, dev, timer):
    """Both backward kernels against the plain backward, then their times at
    the training shape (one microbatch: B=1, H=12, KVH=2, S=4096, D=128,
    causal).  Returns the report rows of dq and dk/dv."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    cases = [  # (dtype, B, H, KVH, Sq, Skv, D, window, shift)
        (torch.bfloat16, 1, 12, 2, 4096, 4096, 128, None, 0),
        (torch.float32, 1, 12, 2, 1024, 1024, 128, None, 0),
        (torch.bfloat16, 1, 12, 2, 3000, 3000, 128, 512, 0),
        (torch.bfloat16, 1, 12, 2, 1024, 3000, 128, None, 1976),
        (torch.bfloat16, 2, 32, 4, 777, 777, 64, None, 0),
        (torch.float32, 2, 32, 4, 777, 777, 64, 100, 0),
        (torch.float32, 1, 12, 2, 500, 700, 128, 300, 200),
    ]
    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    for dtype, B, H, KVH, Sq, Skv, D, window, shift in cases:
        q, k, v = attn_inputs(gen, dev, dtype, B, H, KVH, Sq, Skv, D)
        do = torch.randn(B, H, Sq, D, generator=gen, device=dev).to(dtype)
        o, lse = ref.flash_attention_ref(q, k, v, window=window, causal_shift=shift)
        got = flash_attention_bwd(q, k, v, o, lse, do, window=window, causal_shift=shift)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window,
                                           causal_shift=shift)
        torch.cuda.synchronize()
        errs = {n: scaled_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        ok = all(e[2] <= GRAD_TOL[dtype] for e in errs.values())
        print(f"flash_attention_bwd {str(dtype)[6:]} B={B} H={H} KVH={KVH} Sq={Sq} "
              f"Skv={Skv} D={D} window={window} shift={shift}: "
              + ", ".join(f"{n} max|err|={e[0]:.3e} max|plain|={e[1]:.3e}"
                          for n, e in errs.items())
              + f"; tol {GRAD_TOL[dtype]:g} x max(1, max|plain|) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("flash_attention_bwd disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst["flash_attention_bwd_dq"] = max(worst["flash_attention_bwd_dq"],
                                                  errs["dq"][0])
            worst["flash_attention_bwd_dkv"] = max(worst["flash_attention_bwd_dkv"],
                                                   errs["dk"][0], errs["dv"][0])
        del q, k, v, do, o, lse, got, want

    # timing at the training shape: one layer of one 4096-token microbatch
    B, H, KVH, S, D = 1, 12, 2, 4096, 128
    q, k, v = attn_inputs(gen, dev, torch.bfloat16, B, H, KVH, S, S, D)
    do = torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = ref.flash_attention_ref(q, k, v)
    # dq keeps its sum in registers and writes it once, dk/dv adds each KV
    # head's query-head partials in a fixed order: two runs of each must give
    # the same bits
    dq_runs = [flash_attention_bwd_dq(q, k, v, o, lse, do) for _ in range(2)]
    delta = dq_runs[0][1]
    dkv_runs = [flash_attention_bwd_dkv(q, k, v, lse, delta, do) for _ in range(2)]
    torch.cuda.synchronize()
    bit_equal = {}
    for name, runs in (("flash_attention_bwd_dq", dq_runs),
                       ("flash_attention_bwd_dkv", dkv_runs)):
        bit_equal[name] = all(torch.equal(a, b) for a, b in zip(*runs))
        print(f"{name} at B={B} H={H} KVH={KVH} S={S} D={D}: two runs "
              f"{'bit-equal' if bit_equal[name] else 'DIFFER'}", flush=True)
        if not bit_equal[name]:
            fail(f"{name} is not deterministic")
    del dq_runs, dkv_runs
    qx, kx, vx = (t.detach().requires_grad_() for t in
                  (q, k.repeat_interleave(H // KVH, 1), v.repeat_interleave(H // KVH, 1)))
    out = torch.nn.functional.scaled_dot_product_attention(qx, kx, vx, is_causal=True)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qx, kx, vx), do, retain_graph=True)
    library_ms = timer.ms(sdpa_bwd)
    pairs = B * H * visible_pairs(S, S, None, 0)
    n_qo = q.numel()                      # elements of each (B,H,S,D) tensor
    n_kv = k.numel()
    rows = {}
    for name, fn, plain, n_mm, nbytes in (
            ("flash_attention_bwd_dq",
             lambda: flash_attention_bwd_dq(q, k, v, o, lse, do),
             lambda: ref.flash_attention_bwd_dq_ref(q, k, v, o, lse, do),
             3, 2 * (4 * n_qo + 2 * n_kv) + 4 * 2 * B * H * S),   # q o do dq, k v; lse delta
            ("flash_attention_bwd_dkv",
             lambda: flash_attention_bwd_dkv(q, k, v, lse, delta, do),
             lambda: ref.flash_attention_bwd_dkv_ref(q, k, v, lse, delta, do),
             4, 2 * (2 * n_qo + 4 * n_kv) + 4 * 2 * B * H * S)):  # q do, k v dk dv; lse delta
        flops = 2.0 * D * pairs * n_mm
        row = {"ms": timer.ms(fn), "plain_ms": timer.ms(plain, iters=3),
               "library_ms": library_ms, "max_abs_err": worst[name]}
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
        row["tflops"] = flops / row["ms"] / 1e9
        row["bit_equal_runs"] = bit_equal[name]
        print(f"{name} work at B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal: "
              f"{n_mm} products, {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; kernel "
              f"{row['ms']:.4f} ms ({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain "
              f"{row['plain_ms']:.4f} ms, sdpa backward (dq, dk, dv together) "
              f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
              flush=True)
        rows[name] = row
    return rows


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
        # the reference's small head dims, and a lane with no visible slot
        (torch.bfloat16, 3, 32, 2, 1000, 16, (1000, 40, 0), None),      # G = 16
        (torch.float32, 3, 32, 2, 1000, 16, (1000, 40, 0), 100),
        (torch.bfloat16, 3, 8, 2, 555, 32, (1555, 100, 0), 50),
        (torch.float32, 3, 8, 2, 555, 32, (555, 100, 0), None),
        (torch.bfloat16, 4, 12, 2, 4096, 128, (4096, 64, 1, 0), None),
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
    decode_report(row, flash_decode, (q, k, v, pos, qpos), None, nbytes, full_bytes, D)
    return row


def decode_report(row, flash_decode, args, window, nbytes, full_bytes, D):
    """The redesign's line for flash-decode at one serving shape: ms, GB/s of
    the visible and of the full cache, the bound, registers and spills of the
    bf16 kernel at this head dim, and whether a rerun gives the same bits
    (fails if not: every sum has a fixed order)."""
    from repro_torch.kernels import decode_attention as da
    q, k = args[0], args[1]
    B, KVH, T = k.shape[0], k.shape[1], k.shape[2]
    dev = torch.cuda.current_device()
    plan = da._plan(dev, B, KVH, T, D, da._DTYPES[q.dtype], q.element_size())
    row["cluster"] = plan.cluster
    row["clusters_co_resident"] = da.max_clusters(dev, D, da._DTYPES[q.dtype], plan.cluster)
    o1 = flash_decode(*args, window=window)
    o2 = flash_decode(*args, window=window)
    torch.cuda.synchronize()
    row["bit_equal_runs"] = bool(torch.equal(o1, o2))
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
    row["full_cache_gb_per_s"] = full_bytes / row["ms"] / 1e6
    row["registers"] = kernel_regs("decode_attention", f"bfloat16, {D}>")
    print(f"flash_decode redesign at D={D}: {row['ms']:.4f} ms, {row['gb_per_s']:.0f} GB/s "
          f"of visible bytes, {row['full_cache_gb_per_s']:.0f} GB/s of the full cache; bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {row['registers']}; rerun "
          f"{'bit-equal' if row['bit_equal_runs'] else 'DIFFERS'}; {B * KVH} clusters of "
          f"{plan.cluster} blocks of {plan.slots} slots and {plan.smem} bytes of shared "
          f"memory (the card holds {row['clusters_co_resident']} such clusters at once)",
          flush=True)
    if not row["bit_equal_runs"]:
        fail("flash_decode is not deterministic")


# ------------------------------------------------ kernels of the recurrent slice

def check_flash_attention_d256(gen, dev, timer):
    """The forward kernel at recurrentgemma's local-attention shapes: H=10
    query heads over one KV head of D=256, a 2000-token prefill (the window
    of 2048 does not cut) and a 4096-token scoring forward (it does)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    cases = [  # (dtype, B, H, KVH, S, D, window)
        (torch.bfloat16, 1, 10, 1, 2000, 256, 2048),
        (torch.bfloat16, 1, 10, 1, 4096, 256, 2048),
        (torch.float32, 1, 10, 1, 2000, 256, 2048),
        (torch.float32, 1, 10, 1, 4096, 256, 2048),
        (torch.bfloat16, 2, 10, 1, 333, 256, 100),
    ]
    worst = 0.0
    for dtype, B, H, KVH, S, D, window in cases:
        q, k, v = attn_inputs(gen, dev, dtype, B, H, KVH, S, S, D)
        o, lse = flash_attention_fwd(q, k, v, window=window)
        ro, rlse = ref.flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        e_o = (o.float() - ro.float()).abs().max().item()
        e_l = (lse - rlse).abs().max().item()
        ok = e_o <= TOL[dtype] and e_l <= TOL[dtype]
        print(f"flash_attention_fwd {str(dtype)[6:]} B={B} H={H} KVH={KVH} S={S} D={D} "
              f"window={window}: max|o|err={e_o:.3e} max|lse|err={e_l:.3e} "
              f"tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("flash_attention_fwd at D=256 disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, e_o, e_l)
        del q, k, v, o, lse, ro, rlse

    # timing at the hybrid's serving prefill: one local-attention layer, 2000 tokens
    B, H, KVH, S, D, window = 1, 10, 1, 2000, 256, 2048
    q, k, v = attn_inputs(gen, dev, torch.bfloat16, B, H, KVH, S, S, D)
    kx, vx = k.repeat_interleave(H // KVH, 1), v.repeat_interleave(H // KVH, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {
        "ms": timer.ms(lambda: flash_attention_fwd(q, k, v, window=window)),
        "plain_ms": timer.ms(lambda: ref.flash_attention_ref(q, k, v, window=window), iters=3),
        "library_ms": timer.ms(lambda: sdpa(q, kx, vx, is_causal=True)),
    }
    flops = 4.0 * B * H * D * visible_pairs(S, S, window, 0)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * B * H * S
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
    row["tflops"] = flops / row["ms"] / 1e9
    print(f"flash_attention_fwd work at B={B} H={H} KVH={KVH} S={S} D={D} bf16 window "
          f"{window}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB; kernel {row['ms']:.4f} ms "
          f"({flops / row['ms'] / 1e9:.1f} TFLOP/s), plain {row['plain_ms']:.4f} ms, sdpa "
          f"(causal; the window does not cut at S={S}) {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    row["max_abs_err"] = worst
    return row


def check_flash_decode_d256(gen, dev, timer):
    """The decode kernel at recurrentgemma's shapes: 10 query heads over one KV
    head of D=256, four lanes on a ring of 2048 slots with a window of 2048."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    B, H, KVH, T, D, window = 4, 10, 1, 2048, 256, 2048
    fills = (2048, 2000, 700, 64)
    worst = 0.0
    for dtype, fl in ((torch.bfloat16, fills), (torch.float32, fills),
                      (torch.bfloat16, (5000, 2049, 3, 1)),        # the ring wrapped
                      (torch.float32, (5000, 2000, 1, 0))):        # a lane with nothing visible
        q, k, v, pos, qpos = decode_inputs(gen, dev, dtype, B, H, KVH, T, D, fl, window)
        o = flash_decode(q, k, v, pos, qpos, window=window)
        r = ref.flash_decode_ref(q, k, v, pos, qpos, window=window)
        torch.cuda.synchronize()
        err = (o.float() - r.float()).abs().max().item()
        ok = err <= TOL[dtype]
        print(f"flash_decode {str(dtype)[6:]} B={B} H={H} KVH={KVH} T={T} D={D} fills={fl} "
              f"window={window}: max|o|err={err:.3e} tol={TOL[dtype]:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("flash_decode at D=256 disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst = max(worst, err)

    q, k, v, pos, qpos = decode_inputs(gen, dev, torch.bfloat16, B, H, KVH, T, D, fills, window)
    kx, vx = k.repeat_interleave(H // KVH, 1), v.repeat_interleave(H // KVH, 1)
    mask = ((pos >= 0) & (pos <= qpos[:, None]) & (pos > qpos[:, None] - window))
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {
        "ms": timer.ms(lambda: flash_decode(q, k, v, pos, qpos, window=window), iters=50),
        "plain_ms": timer.ms(lambda: ref.flash_decode_ref(q, k, v, pos, qpos, window=window),
                             iters=20),
        "library_ms": timer.ms(lambda: sdpa(q[:, :, None], kx, vx, attn_mask=mask), iters=50),
    }
    n_vis = int(mask.sum().item())
    flops = 4.0 * H * D * n_vis
    nbytes = 2 * 2 * KVH * D * n_vis + 4 * n_vis + 2 * 2 * B * H * D + 4 * B
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
    full_bytes = 2 * 2 * B * KVH * T * D
    print(f"flash_decode work at B={B} H={H} KVH={KVH} T={T} D={D} bf16 fills={fills} "
          f"window={window}: full cache {full_bytes / 1e6:.2f} MB, visible "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP; kernel "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, sdpa "
          f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})",
          flush=True)
    row["max_abs_err"] = worst
    decode_report(row, flash_decode, (q, k, v, pos, qpos), window, nbytes, full_bytes, D)
    return row


def check_rglru_scan(gen, dev, timer):
    """The RG-LRU scan against its plain version at the hybrid's prefill and
    scoring shapes and ragged ones (W = 33 takes the kernel's cp.async path):
    the same bits (the chain rounds the product, then the sum, as the plain
    version does), hence also within the reference's 1e-5; timed at the
    prefill shape.  No single PyTorch call computes this recurrence, so
    there is no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan
    worst = 0.0
    for B, S, W in ((1, 2000, 2560), (3, 17, 32), (2, 4096, 2560), (2, 130, 33)):
        a = torch.rand(B, S, W, generator=gen, device=dev) * 0.5 + 0.499
        b = torch.randn(B, S, W, generator=gen, device=dev)
        h = rglru_scan(a, b)
        r = ref.rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        err = (h - r).abs().max().item()
        equal = torch.equal(h, r)
        ok = err <= RGLRU_TOL and equal
        print(f"rglru_scan f32 B={B} S={S} W={W}: max|h|err={err:.3e} "
              f"max|h|={r.abs().max().item():.3e} tol={RGLRU_TOL:g}, "
              f"{'bit-equal' if equal else 'NOT bit-equal'} {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            fail("rglru_scan disagrees with its plain version")
        worst = max(worst, err)
    B, S, W = 1, 2000, 2560
    a = torch.rand(B, S, W, generator=gen, device=dev) * 0.5 + 0.499
    b = torch.randn(B, S, W, generator=gen, device=dev)
    row = {"ms": timer.ms(lambda: rglru_scan(a, b), iters=20),
           "plain_ms": timer.ms(lambda: ref.rglru_scan_ref(a, b), iters=3),
           "library_ms": None}
    nbytes = 3 * 4 * B * S * W                   # a, b read, h written
    flops = 2.0 * B * S * W                      # one multiply and one add
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_F32_FLOPS)
    print(f"rglru_scan work at B={B} S={S} W={W} f32: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e6:.1f} MFLOP; kernel {row['ms']:.4f} ms "
          f"({nbytes / row['ms'] / 1e6:.0f} GB/s), plain {row['plain_ms']:.4f} ms, "
          f"library none, bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    row["max_abs_err"] = worst
    runs = [rglru_scan(a, b) for _ in range(2)]
    torch.cuda.synchronize()
    row["bit_equal_runs"] = bool(torch.equal(*runs))
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
    row["registers"] = kernel_regs("rglru_scan", "rglru_chain")
    S2 = 4096
    a2 = torch.rand(B, S2, W, generator=gen, device=dev) * 0.5 + 0.499
    b2 = torch.randn(B, S2, W, generator=gen, device=dev)
    row["scoring_ms"] = timer.ms(lambda: rglru_scan(a2, b2), iters=20)
    print(f"rglru_scan redesign: {row['ms']:.4f} ms at S={S}, {row['gb_per_s']:.0f} GB/s; "
          f"{row['scoring_ms']:.4f} ms at the scoring shape S={S2} "
          f"({3 * 4 * B * S2 * W / row['scoring_ms'] / 1e6:.0f} GB/s); bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}); {row['registers']}; rerun "
          f"{'bit-equal' if row['bit_equal_runs'] else 'DIFFERS'}", flush=True)
    if not row["bit_equal_runs"]:
        fail("rglru_scan is not deterministic")
    return row


def wkv_inputs(gen, dev, dtype, B, H, S, hs, decay_sd=1.0):
    """r, k, v (dtype) and w_log (f32) as (B,H,S,hs) views of (B,S,H,hs)
    memory, as the model passes them; u (H,hs) in dtype.  w_log =
    -exp(N(0, decay_sd))."""
    mk = lambda: torch.randn(B, S, H, hs, generator=gen, device=dev).transpose(1, 2)
    r, k, v = (mk().to(dtype) for _ in range(3))
    w_log = -torch.exp(decay_sd * mk())
    u = torch.randn(H, hs, generator=gen, device=dev).to(dtype)
    return r, k, v, w_log, u


def check_rwkv6_wkv(gen, dev, timer):
    """The WKV kernel against its plain version (the exact sequential scan):
    output and final state within 1e-5 of the largest plain value (the
    reference's relative bound), at rwkv6-7b's prefill shape (B=1, H=64,
    S=3000, hs=64) in bf16 and f32, with decays as strong as the random-weight
    model's (up to exp(exp(3 sd))) a step, and a ragged (2, 3, 70, 32); timed
    at the prefill shape in bf16.  No single PyTorch call computes this
    recurrence, so there is no library time."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_kernel import rwkv6_wkv
    worst_abs, worst_rel = 0.0, 0.0
    for dtype, B, H, S, hs, sd in ((torch.bfloat16, 1, 64, 3000, 64, 1.0),
                                   (torch.float32, 1, 64, 3000, 64, 1.0),
                                   (torch.float32, 1, 64, 3000, 64, 3.0),
                                   (torch.bfloat16, 2, 3, 70, 32, 1.0),
                                   (torch.float32, 2, 3, 70, 32, 3.0)):
        x = wkv_inputs(gen, dev, dtype, B, H, S, hs, sd)
        o, state = rwkv6_wkv(*x)
        ro, rstate = ref.rwkv6_wkv_ref(*x)
        torch.cuda.synchronize()
        errs = [((a - b).abs().max().item(), b.abs().max().item())
                for a, b in ((o, ro), (state, rstate))]
        rels = [e / max(m, 1e-30) for e, m in errs]
        ok = all(r <= WKV_REL_TOL for r in rels) and all(
            torch.isfinite(t).all().item() for t in (o, state))
        print(f"rwkv6_wkv {str(dtype)[6:]} B={B} H={H} S={S} hs={hs} decay sd {sd}: "
              f"o max|err|={errs[0][0]:.3e} of max {errs[0][1]:.3e} ({rels[0]:.2e}), state "
              f"max|err|={errs[1][0]:.3e} of max {errs[1][1]:.3e} ({rels[1]:.2e}); tol "
              f"{WKV_REL_TOL:g} relative {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("rwkv6_wkv disagrees with its plain version")
        worst_abs = max(worst_abs, errs[0][0], errs[1][0])
        worst_rel = max(worst_rel, *rels)
        del x, o, state, ro, rstate
    B, H, S, hs = 1, 64, 3000, 64
    x = wkv_inputs(gen, dev, torch.bfloat16, B, H, S, hs)
    # every pass sums in a fixed order, with no atomics: two runs must give
    # the same bits
    runs = [rwkv6_wkv(*x) for _ in range(2)]
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a, b) for a, b in zip(*runs))
    print(f"rwkv6_wkv at B={B} H={H} S={S} hs={hs} bf16: two runs "
          f"{'bit-equal' if bit_equal else 'DIFFER'}", flush=True)
    if not bit_equal:
        fail("rwkv6_wkv is not deterministic")
    del runs
    row = {"ms": timer.ms(lambda: rwkv6_wkv(*x), iters=10),
           "plain_ms": timer.ms(lambda: ref.rwkv6_wkv_ref(*x), iters=2),
           "library_ms": None}
    n = B * H * S * hs
    nbytes = 3 * 2 * n + 4 * n + 2 * H * hs + 4 * n + 4 * B * H * hs * hs
    flops = 4.0 * B * H * S * hs * hs            # per token and head: r S and k v^T into S
    row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_F32_FLOPS)
    print(f"rwkv6_wkv work at B={B} H={H} S={S} hs={hs} bf16 r/k/v, f32 w_log/o/state: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP (f32); kernel {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, library none, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']})", flush=True)
    row["max_abs_err"] = worst_abs
    row["max_rel_err"] = worst_rel
    row["bit_equal_runs"] = bit_equal
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
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


# kernel-name marks of the device-time kinds a profile reports
PROFILE_KINDS = (
    ("attention kernels", ("fwd_bf16", "fwd_f32", "dq_bf16", "dq_f32", "dkv_bf16",
                           "dkv_f32", "dkv_reduce", "flash_decode_kernel", "decode_partial",
                           "decode_combine")),
    ("recurrence kernels", ("rglru_chain", "rglru_scan_kernel", "wkv_chunk_state",
                            "wkv_state_scan", "wkv_chunk_out")),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("copy/fill", ("Memcpy", "Memset", "copy_", "fill")),
    ("elementwise/reduce", ("elementwise", "reduce", "softmax", "Reduce")),
)


def device_profile(run, n_steps):
    """torch.profiler over ``run()`` (which does ``n_steps`` steps): wall ms
    per step, device-busy ms per step (None when the profiler records no
    device time), and as a string the device time by kind, each of the
    port's kernels, the top kernels and the host ops with the most self host
    time.

    Busy time sums the device-side events (kernels, copies, fills) alone:
    a host-side op's "self device time" is the time of the kernels it
    launched, which appear again as device events of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_steps
    rows, host = [], []
    for ev in prof.key_averages():
        dev_us = ev.self_device_time_total
        if ev.device_type != DeviceType.CPU and dev_us > 0:
            rows.append((dev_us / 1e3 / n_steps, ev.count // n_steps, ev.key))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.self_cpu_time_total / 1e3 / n_steps, ev.count // n_steps, ev.key))
    host.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    kinds, port = {}, []
    for ms, n, k in rows:
        kind = next((name for name, marks in PROFILE_KINDS if any(m in k for m in marks)),
                    "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        if kind in ("attention kernels", "recurrence kernels"):
            port.append(f"{k.split('::', 1)[-1].split('(')[0]} {ms:.3f} ms x{n}")
    top = ("by kind " + ", ".join(f"{k} {ms:.3f} ms" for k, ms in
                                  sorted(kinds.items(), key=lambda x: -x[1]))
           + "; port kernels " + ("; ".join(port) or "none")
           + "; top kernels " + "; ".join(f"{k[:70]} {ms:.3f} ms x{n}"
                                          for ms, n, k in rows[:12])
           + f"; host ops {sum(n for _, n, _ in host)}, top by self host time "
           + "; ".join(f"{k[:40]} {ms:.3f} ms x{n}" for ms, n, k in host[:8]))
    return wall, (busy if busy > 0 else None), top


def print_profile(what, wall, busy, top):
    if busy is None:
        print(f"{what}: wall {wall:.3f} ms/step; device time not measured "
              f"(the profiler recorded no device events)", flush=True)
    else:
        print(f"{what}: wall {wall:.3f} ms/step, device busy {busy:.3f} ms/step, "
              f"idle share {1 - busy / wall:.3f}; per step {top}", flush=True)


def profile_decode(eng, prompts, Request, n_steps=5):
    """Where a decode step's time goes: torch.profiler over ``n_steps`` steps
    with all four lanes busy."""
    for i in range(eng.n_slots):
        eng.add_request(Request(rid=100 + i, prompt=prompts[i][:2000],
                                max_new_tokens=n_steps + 3))
    eng.step()                               # admit and prefill all lanes

    def run():
        for _ in range(n_steps):
            eng.step()
    print_profile(f"decode profile ({n_steps} steps, 4 lanes busy)",
                  *device_profile(run, n_steps))
    eng.run()


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
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    fa, fd = fa_mod.flash_attention_fwd, attn.flash_decode
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
    # the model reaches the forward kernel through FlashAttention, which looks
    # the wrapper up in its module at each call; the wrapper then counts its
    # launch on whatever that name holds, here the stand-in, so the check's
    # launches stay off the wrapper's own count
    fa_checked.launches = 0
    fa_mod.flash_attention_fwd, attn.flash_decode = fa_checked, fd_checked
    try:
        eng.step()                           # four prefills, one 4-lane decode step
        torch.cuda.synchronize()
    finally:
        fa_mod.flash_attention_fwd, attn.flash_decode = fa, fd
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


# ---------------------------------------------------------------- train

def check_bwd_in_model(cfg, policy, params, batch):
    """Hold both bf16 backward kernels against the plain backward on the very
    tensors the model and autograd hand them: every layer of one 4096-token
    microbatch (strided q/k/v views of (B,S,H,D) memory, the saved o and lse,
    and the do that autograd passes).

    Each call's dq, dk and dv must lie within GRAD_TOL[bf16] of the call's
    scale max(1, max|plain|), and also within GRAD_TOL[bf16] of max|plain|
    itself: the loss is a mean over 4096 tokens, so these gradients are far
    below 1 and the first bound alone would pass a kernel whose gradients
    were all wrong.  Returns the microbatch's grads and the largest errors.
    """
    import dataclasses
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.train import train_step as pts
    real = fa_mod.flash_attention_bwd
    stats = {n: {"max_abs_err": 0.0, "max_abs_value": 0.0, "max_scaled_err": 0.0,
                 "max_rel_err": 0.0} for n in ("dq", "dk", "dv")}
    seen = {"calls": 0}

    def checked(q, k, v, o, lse, do, **kw):
        got = real(q, k, v, o, lse, do, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            err, value, sc = scaled_err(a, b)
            st = stats[n]
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["max_abs_value"] = max(st["max_abs_value"], value)
            st["max_scaled_err"] = max(st["max_scaled_err"], sc)
            st["max_rel_err"] = max(st["max_rel_err"], err / max(value, 1e-30))
        if seen["calls"] == 0:
            print(f"in-model backward layout: q {tuple(q.shape)} strides {q.stride()}, "
                  f"k strides {k.stride()}, o strides {o.stride()}, do strides "
                  f"{do.stride()}, {str(q.dtype)[6:]}", flush=True)
        seen["calls"] += 1
        return got

    mb = {k: v[:1] for k, v in batch.items()}
    fa_mod.flash_attention_bwd = checked
    try:
        _, _, grads = pts.compute_grads(cfg, dataclasses.replace(policy, n_microbatch=1),
                                        params, mb)
        torch.cuda.synchronize()
    finally:
        fa_mod.flash_attention_bwd = real
    tol = GRAD_TOL[torch.bfloat16]
    print(f"in-model backward kernels vs plain backward ({seen['calls']} calls, one "
          f"{mb['tokens'].shape[1]}-token microbatch): {stats}; tol {tol:g} x "
          f"max(1, max|plain|) and {tol:g} x max|plain| per call", flush=True)
    if seen["calls"] != cfg.n_layers:
        fail(f"in-model backward check saw {seen['calls']} calls, not {cfg.n_layers}")
    for n, st in stats.items():
        if not (st["max_scaled_err"] <= tol and st["max_rel_err"] <= tol):
            fail(f"backward kernels' {n} in the model's layout disagrees with the "
                 f"plain backward: {st}")
    return grads, stats


def attention_grads(grads):
    a = grads["units"]["b0"]["attn"]
    return {w: a[w] for w in ("wq", "wk", "wv", "bq", "bk", "bv") if w in a}


def check_f32_step_grads(cfg, params, dev):
    """The f32 gradients of one whole step at full width (batch 1, seq 512),
    kernels on against the plain versions, on the card: every leaf within
    F32_GRAD_TOL of its largest plain gradient, and the attention weights'
    gradients nonzero."""
    from repro_torch.configs.base import RunPolicy, ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.module import flatten
    from repro_torch.train import train_step as pts
    batch = SyntheticLM(cfg, ShapeSpec("f32 check", "train", 512, 1), seed=1).batch(0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    out = {}
    for name, pallas in (("kernels", True), ("plain", False)):
        pol = RunPolicy(dtype="f32", use_pallas=pallas, remat="dots", n_microbatch=1)
        out[name] = pts.compute_grads(cfg, pol, params, batch)
    (lk, _, gk), (lp, _, gp) = out["kernels"], out["plain"]
    flat_k, flat_p = dict(flatten(gk)), dict(flatten(gp))
    errs = {}
    for path, g in flat_p.items():
        scale = g.abs().max().item()
        errs["/".join(path)] = ((flat_k[path] - g).abs().max().item() / max(scale, 1e-30),
                                scale)
    worst = max(errs, key=lambda p: errs[p][0])
    attn = {w: (g.abs().max().item(), errs["/".join(("units", "b0", "attn", w))][0])
            for w, g in attention_grads(gp).items()}
    print(f"f32 step grads, kernels vs plain (batch 1, seq 512, {len(errs)} leaves): "
          f"loss {lk.item():.6f} vs {lp.item():.6f}; worst leaf {worst} "
          f"{errs[worst][0]:.3e} of its max |grad| {errs[worst][1]:.3e}; attention "
          f"weights (max|grad|, rel err) { {w: (f'{a:.3e}', f'{e:.2e}') for w, (a, e) in attn.items()} }"
          f"; tol {F32_GRAD_TOL:g}", flush=True)
    if not (math.isfinite(lk.item()) and abs(lk.item() - lp.item()) <= 1e-4 * abs(lp.item())):
        fail(f"f32 losses differ: kernels {lk.item()} plain {lp.item()}")
    if errs[worst][0] > F32_GRAD_TOL:
        fail(f"f32 step gradients, kernels vs plain: {worst} off by {errs[worst][0]:.3e}")
    if any(a == 0.0 or not math.isfinite(a) for a, _ in attn.values()):
        fail(f"attention-weight gradients missing: {attn}")
    return errs[worst][0]


def train(dev):
    from repro_torch.configs.base import SHAPES, RunPolicy, ShapeSpec, get_config
    from repro_torch.data.pipeline import Prefetcher, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import opt_config
    from repro_torch.models import api
    from repro_torch.models.module import flatten
    from repro_torch.train import train_step as pts

    cfg = get_config("qwen2-1.5b")
    policy = RunPolicy(use_pallas=True, remat="dots", n_microbatch=2)
    n_timed = 3
    opt = opt_config("adamw", lr=1e-3, steps=1 + n_timed)
    # the published train_4k length; the global batch is cut from 256 to 2
    shape = ShapeSpec("train_4k, batch 2", "train", SHAPES["train_4k"].seq_len, 2)
    n_fwd = cfg.n_layers * policy.n_microbatch * 2    # "dots" recomputes the forward
    n_bwd = cfg.n_layers * policy.n_microbatch
    expect = {"flash_attention_fwd": n_fwd, "flash_attention_bwd_dq": n_bwd,
              "flash_attention_bwd_dkv": n_bwd, "flash_decode": 0}
    print(f"train: {cfg.name} at full width, seq {shape.seq_len}, global batch "
          f"{shape.global_batch} in {policy.n_microbatch} microbatches, remat "
          f"{policy.remat}, {policy.dtype} compute, adamw {opt}; expected launches per "
          f"step {expect}", flush=True)
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    opt_state = pts.make_init_opt(cfg, policy, opt)(params)
    step_fn = pts.make_train_step(cfg, policy, opt)
    torch.cuda.synchronize()
    print(f"train: init {time.perf_counter() - t0:.2f} s", flush=True)
    pf = Prefetcher(SyntheticLM(cfg, shape, seed=0))
    state = {"params": params, "opt": opt_state}
    del params, opt_state

    def one_step():
        _, b = pf.next()
        b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["params"], state["opt"], m = step_fn(state["params"], state["opt"], b)
        torch.cuda.synchronize()
        return b, m, (time.perf_counter() - t) * 1e3

    try:
        _, m, ms = one_step()                            # warm-up, off the record
        print(f"train: warm-up step {ms:.1f} ms, loss {m['loss'].item():.4f}", flush=True)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        losses, norms, step_ms = [], [], []
        for _ in range(n_timed):
            batch, m, ms = one_step()
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            step_ms.append(ms)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        tokens = shape.seq_len * shape.global_batch
        print(f"train: {n_timed} steps, loss {[round(x, 4) for x in losses]}, grad norm "
              f"{[round(x, 4) for x in norms]}; step ms {[round(x, 3) for x in step_ms]} "
              f"(median {np.median(step_ms):.3f}); {tokens / np.median(step_ms) * 1e3:.1f} "
              f"tokens/s; peak memory {peak_gb:.2f} GB; launches {counts}", flush=True)
        for name, n in expect.items():
            if counts[name] != n_timed * n:
                fail(f"train: {name} launched {counts[name]} times in {n_timed} steps, "
                     f"expected {n_timed} x {n}")
        if not all(math.isfinite(x) for x in losses + norms):
            fail(f"train: non-finite loss or grad norm {losses} {norms}")
        bad = [p for p, a in flatten(state["params"]) if not torch.isfinite(a).all()]
        if bad:
            fail(f"train: non-finite params after {n_timed} steps: {bad[:4]}")
        prof = device_profile(one_step, 1)
        print_profile("train profile (1 step)", *prof)
        if prof[1] is not None:
            print(f"train: device busy {prof[1]:.3f} ms of the unprofiled median step "
                  f"{np.median(step_ms):.3f} ms: idle share "
                  f"{1 - prof[1] / np.median(step_ms):.3f}", flush=True)
    finally:
        pf.close()

    grads, in_model = check_bwd_in_model(cfg, policy, state["params"], batch)
    attn = {w: g.abs().max().item() for w, g in attention_grads(grads).items()}
    print(f"train: bf16 attention-weight gradients of one microbatch, max |grad| "
          f"{ {w: f'{a:.3e}' for w, a in attn.items()} }", flush=True)
    if any(a == 0.0 or not math.isfinite(a) for a in attn.values()):
        fail(f"train: attention-weight gradients missing: {attn}")
    del grads, state["opt"]
    torch.cuda.empty_cache()
    f32_err = check_f32_step_grads(cfg, state["params"], dev)
    return counts, in_model, f32_err


# ------------------------------------------------ serve and score the recurrent archs

# kernel launches per prefill (and per scoring forward) and per decode step of
# the two archs of the recurrent slice; every other kernel launches no time
# the serving phases' kernel launches per prefill and per decode step
SERVE_LAUNCHES = {
    # 26 layers: 8 units of (rec, rec, attn) and a (rec, rec) tail
    "recurrentgemma-2b": ({"rglru_scan": 18, "flash_attention_fwd": 8}, {"flash_decode": 8}),
    "rwkv6-7b": ({"rwkv6_wkv": 32}, {}),
    # the depth cut to MIXTRAL_LAYERS of 32 (f32 params and their bf16 copy
    # of 6 layers take ~54 GB of the card's 80)
    "mixtral-8x7b": ({"flash_attention_fwd": 6}, {"flash_decode": 6}),
}
MIXTRAL_LAYERS = 6


def kernel_sites():
    """(module, name, plain version, outputs to compare) of every kernel
    wrapper the recurrent archs call, by the name the model looks it up
    under at each call."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models import rglru, rwkv6
    return [(fa_mod, "flash_attention_fwd",
             lambda q, k, v, **kw: ref.flash_attention_ref(q, k, v, **kw), lambda x: x[:1]),
            (attn, "flash_decode", ref.flash_decode_ref, lambda x: (x,)),
            (rglru, "rglru_scan", ref.rglru_scan_ref, lambda x: (x,)),
            (rwkv6, "rwkv6_wkv", ref.rwkv6_wkv_ref, lambda x: x)]


@contextlib.contextmanager
def swapped(make):
    """Every kernel site's wrapper replaced by ``make(name, wrapper, plain,
    outputs)`` for the duration."""
    sites = kernel_sites()
    saved = [(m, n, getattr(m, n)) for m, n, _, _ in sites]
    try:
        for m, n, plain, outputs in sites:
            setattr(m, n, make(n, getattr(m, n), plain, outputs))
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def plain_kernels():
    """The kernels' plain versions on the card in place of the kernels, the
    same data flow otherwise."""
    return swapped(lambda name, real, plain, outputs: plain)


def checked_kernels(stats):
    """Every kernel wrapper held against its plain version on the very
    tensors the model hands it (each call; the check's plain calls launch
    nothing).  ``stats[name]`` collects, per wrapper, the calls and the
    largest absolute error, |plain|, error over max(1, max|plain|) and error
    over max|plain|."""
    def record(name, got, want):
        st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0.0, "max_abs_value": 0.0,
                                     "max_scaled_err": 0.0, "max_rel_err": 0.0})
        for a, b in zip(got, want):
            err = (a.float() - b.float()).abs().max().item()
            value = b.float().abs().max().item()
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["max_abs_value"] = max(st["max_abs_value"], value)
            st["max_scaled_err"] = max(st["max_scaled_err"], err / max(1.0, value))
            st["max_rel_err"] = max(st["max_rel_err"], err / max(value, 1e-30))
        st["calls"] += 1

    def make(name, real, plain, outputs):
        def checked(*args, **kw):
            got = real(*args, **kw)
            record(name, outputs(got), outputs(plain(*args, **kw)))
            return got
        checked.launches = 0          # the module-level wrapper keeps its own count
        return checked
    return swapped(make)


def serve_full_width(dev, arch, cache_len, max_prompt, cfg=None, run_ctx=None):
    """One arch at full published width (``cfg``, where given, is its config
    with the depth cut) with random weights from
    seed 0, bf16 compute and f32 params, kernels on, served by
    ServingEngine(n_slots=4, cache_len, temperature=0) over 8 requests with
    prompt lengths drawn with numpy seed 0 from 64..max_prompt (one of exactly
    max_prompt) and 32 new tokens each.  Launch counts must be exact per
    prefill and per decode step.  Then a decode-step and a prefill profile,
    and every kernel held against its plain version on the model's own
    tensors for four prefills and one 4-lane decode step.  Returns the f32
    params, the engine's cast params, the launch counts, the in-model
    errors, the serving numbers (``run_record``: what ``run_ctx()``, a
    context manager entered around the serving run alone, yielded) and the
    completed requests."""
    from repro_torch.configs.base import RunPolicy, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = cfg or get_config(arch)
    policy = RunPolicy(use_pallas=True)
    per_prefill, per_decode = SERVE_LAUNCHES[arch]
    t0 = time.perf_counter()
    params = api.init(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{arch}: {api.n_params(cfg) / 1e9:.3f} B params, init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(64, max_prompt + 1, size=8)
    lens[int(rng.integers(0, 8))] = max_prompt
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32) for n in lens]

    eng = ServingEngine(cfg, policy, params, n_slots=4, cache_len=cache_len,
                        temperature=0.0, device=dev)
    eng.add_request(Request(rid=-1, prompt=prompts[0][:64], max_new_tokens=2))
    eng.run()                                    # warm-up, off the record
    eng.completed.clear()
    eng.stats = {k: 0 for k in eng.stats}
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

    prefill, decode = eng.prefill, eng.decode
    eng.prefill, eng.decode = timed(prefill, prefill_ms), timed(decode, decode_ms)
    for i, p in enumerate(prompts):
        eng.add_request(Request(rid=i, prompt=p, max_new_tokens=32))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with (run_ctx or contextlib.nullcontext)() as run_record:
        t0 = time.perf_counter()
        done = list(eng.run())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    eng.prefill, eng.decode = prefill, decode
    st = dict(eng.stats)
    print(f"{arch} serve: {len(done)} requests, stats {st}, launches {counts}", flush=True)
    if len(done) != len(prompts) or not all(r.done and len(r.out) == 32 for r in done):
        fail(f"{arch}: not every request completed with 32 tokens")
    want = {n: per_prefill.get(n, 0) * st["prefills"] + per_decode.get(n, 0)
            * st["decode_steps"] for n in counts}
    if counts != want:
        fail(f"{arch} serve launches {counts} != expected {want} ({per_prefill} per "
             f"prefill, {per_decode} per decode step)")
    tps = st["tokens_out"] / wall
    print(f"{arch} serve: prompt lengths {[int(n) for n in lens]}; prefill ms per request "
          f"{[round(x, 3) for x in prefill_ms]} (mean {np.mean(prefill_ms):.3f}); decode ms "
          f"per step median {np.median(decode_ms):.3f} p90 {np.percentile(decode_ms, 90):.3f} "
          f"over {len(decode_ms)} steps; {st['tokens_out']} tokens in {wall:.3f} s = "
          f"{tps:.1f} tokens/s; peak memory {peak_gb:.2f} GB", flush=True)

    profile_decode(eng, prompts, Request)
    longest = int(np.argmax(lens))
    prompt = torch.as_tensor(prompts[longest], device=dev)[None, :]
    with torch.inference_mode():
        print_profile(f"{arch} prefill profile (one {len(prompts[longest])}-token prompt)",
                      *device_profile(lambda: eng.prefill(eng.params, {"tokens": prompt}), 1))

    stats = {}
    pick = [longest] + [i for i in range(len(prompts)) if i != longest][:eng.n_slots - 1]
    for j, i in enumerate(pick):
        eng.add_request(Request(rid=200 + j, prompt=prompts[i], max_new_tokens=4))
    with checked_kernels(stats):
        eng.step()                               # four prefills, one 4-lane decode step
        torch.cuda.synchronize()
    eng.run()
    print(f"{arch} in-model kernels vs plain versions ({[int(lens[i]) for i in pick]} "
          f"prefills, one 4-lane decode step, every layer): {stats}", flush=True)
    names = set(per_prefill) | set(per_decode)
    if set(stats) != names:
        fail(f"{arch}: in-model check saw calls of {sorted(stats)}, expected {sorted(names)}")
    for name, s in stats.items():
        key, tol = IN_MODEL_TOL[name]
        if not s[key] <= tol:
            fail(f"{arch}: {name} in the model's layout disagrees with its plain version: "
                 f"{key} {s[key]:.3e} > {tol:g}; {s}")
    cparams = eng.params
    del eng
    numbers = {"prefill_ms_mean": float(np.mean(prefill_ms)),
               "decode_ms_median": float(np.median(decode_ms)),
               "decode_ms_p90": float(np.percentile(decode_ms, 90)), "tokens_per_s": tps,
               "peak_gb": peak_gb, "run_record": run_record}
    return params, cparams, counts, stats, numbers, done


def score(dev, arch, params, cparams, seq=4096):
    """One cache-less ``api.forward`` of batch 1 at ``seq`` tokens (kernels
    on, bf16), with exact launch counts; then its logits, kernels on, against
    the plain versions on the card: f32 within F32_LOGIT_TOL of the largest
    logit, and bf16 (the loose check) no further from the f32 plain logits
    than BF16_ERROR_RATIO times the plain bf16 path.  For recurrentgemma the
    plain path is the model without the kernels (associative scan, blocked
    attention); for rwkv6 it is the kernels' plain versions (the exact
    sequential WKV), because the model's own plain WKV forms, the JAX
    package's, overflow f32 at these random weights' decays (ROADMAP queue
    3)."""
    from repro_torch.configs.base import RunPolicy, get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    cfg = get_config(arch)
    per_call, _ = SERVE_LAUNCHES[arch]
    want = {name: per_call.get(name, 0) for name in ops.launch_counts()}
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, seq)).astype(np.int32)).to(dev)
    batch = {"tokens": tokens}

    def run(p, pol, plain=False):
        with torch.inference_mode():
            if plain and arch == "rwkv6-7b":
                with plain_kernels():
                    return api.forward(p, batch, cfg, dataclasses.replace(pol, use_pallas=True))[0]
            return api.forward(p, batch, cfg, pol)[0]

    kernels16 = RunPolicy(use_pallas=True)
    plain16 = RunPolicy(use_pallas=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits16 = run(cparams, kernels16)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = ops.launch_counts()
    print(f"{arch} score: forward of 1 x {seq} tokens, bf16, kernels on: {ms:.3f} ms "
          f"(first call), launches {counts}", flush=True)
    if counts != want:
        fail(f"{arch} score launches {counts} != expected {want}")
    if logits16.shape != (1, seq, cfg.vocab_size) or not torch.isfinite(logits16).all():
        fail(f"{arch} score: bf16 logits of shape {tuple(logits16.shape)} or not finite")
    plain_logits16 = run(cparams, plain16, plain=True)
    ref32 = run(params, RunPolicy(dtype="f32", use_pallas=False), plain=True)
    got32 = run(params, RunPolicy(dtype="f32", use_pallas=True))
    for name, x in (("plain bf16", plain_logits16), ("plain f32", ref32), ("kernels f32", got32)):
        if not torch.isfinite(x).all():
            fail(f"{arch} score: {name} logits not finite")
    scale = max(1.0, ref32.abs().max().item())
    dist = {name: (x.float() - ref32).abs().max().item() for name, x in
            (("kernels f32", got32), ("kernels bf16", logits16), ("plain bf16", plain_logits16))}
    agree = {name: (x.argmax(-1) == ref32.argmax(-1)).float().mean().item() for name, x in
             (("kernels f32", got32), ("kernels bf16", logits16), ("plain bf16", plain_logits16))}
    print(f"{arch} score: max|logit| {scale:.4f}; max|logit - plain f32| "
          f"{ {k: round(v, 6) for k, v in dist.items()} }; argmax agreement with plain f32 "
          f"{ {k: round(v, 4) for k, v in agree.items()} }", flush=True)
    if dist["kernels f32"] > F32_LOGIT_TOL * scale:
        fail(f"{arch}: f32 kernels-on logits differ from the plain versions by "
             f"{dist['kernels f32']:.3e} > {F32_LOGIT_TOL} x {scale:.3f}")
    if dist["kernels bf16"] > BF16_ERROR_RATIO * max(dist["plain bf16"], 1e-6):
        fail(f"{arch}: bf16 kernels-on logits are {dist['kernels bf16']:.4f} from the f32 "
             f"ones, more than {BF16_ERROR_RATIO} x the plain bf16 path's "
             f"{dist['plain bf16']:.4f}")
    return counts, dist["kernels f32"] / scale


def recurrent(dev, arch, cache_len, max_prompt):
    """Serve, then score, one recurrent arch; frees the model after."""
    params, cparams, counts, in_model, numbers, _ = serve_full_width(dev, arch, cache_len,
                                                                     max_prompt)
    numbers.pop("run_record")
    score_counts, f32_err = score(dev, arch, params, cparams)
    del params, cparams
    torch.cuda.empty_cache()
    return {"serve_launches": counts, "score_launches": score_counts, "in_model": in_model,
            "f32_logit_err": f32_err, **numbers}


@contextlib.contextmanager
def moe_drops():
    """The MoE layer's ``dropped_frac`` of every call while active, as
    [(tokens routed, dropped_frac tensor)] (read after the run: no sync in
    it)."""
    from repro_torch.models import moe
    real, calls = moe.apply_moe, []

    def recorded(p, x, **kw):
        y, aux = real(p, x, **kw)
        calls.append((x.shape[0] * x.shape[1], aux["dropped_frac"].detach()))
        return y, aux
    moe.apply_moe = recorded
    try:
        yield calls
    finally:
        moe.apply_moe = real


def exact_attention_fwd(q, k, v, window=None, causal_shift=0):
    """``ref.flash_attention_ref`` computed in f64: (o in q's dtype, lse f32)."""
    from repro_torch.kernels import ref
    B, H, Sq, D = q.shape
    KVH, Skv = k.shape[1], k.shape[2]
    qr = q.reshape(B, KVH, H // KVH, Sq, D).double()
    sc = torch.einsum("bkgqd,bktd->bkgqt", qr, k.double()) / math.sqrt(D)
    sc = torch.where(ref._mask(Sq, Skv, window, causal_shift, q.device), sc, -1e300)
    o = torch.einsum("bkgqt,bktd->bkgqd", torch.softmax(sc, dim=-1), v.double())
    return (o.reshape(B, H, Sq, D).to(q.dtype),
            torch.logsumexp(sc, dim=-1).reshape(B, H, Sq).float())


def exact_decode(q, k, v, pos, qpos, window=None):
    """``ref.flash_decode_ref`` computed in f64, in q's dtype."""
    B, H, D = q.shape
    KVH = k.shape[1]
    sc = torch.einsum("bkgd,bktd->bkgt", q.reshape(B, KVH, H // KVH, D).double(),
                      k.double()) / math.sqrt(D)
    mask = (pos >= 0) & (pos <= qpos[:, None])
    if window is not None:
        mask &= pos > qpos[:, None] - window
    sc = torch.where(mask[:, None, None], sc, -1e300)
    o = torch.einsum("bkgt,bktd->bkgd", torch.softmax(sc, dim=-1), v.double())
    return o.reshape(B, H, D).to(q.dtype)


@contextlib.contextmanager
def attention_sites(fwd, decode):
    """The model's two attention kernel wrappers replaced by ``fwd`` and
    ``decode`` for the duration (the stand-ins take the wrappers' names, so
    their calls are not counted launches)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models import attention as attn
    real = fa_mod.flash_attention_fwd, attn.flash_decode
    fwd.launches = 0
    fa_mod.flash_attention_fwd, attn.flash_decode = fwd, decode
    try:
        yield
    finally:
        fa_mod.flash_attention_fwd, attn.flash_decode = real


def against_exact(stats):
    """The attention kernels, each call also held against its plain f32
    version and against the f64 evaluation of the same call: ``stats[name]``
    sums over the calls each one's largest error over the call's max|f64
    output| (``*_vs_f64``; the largest of them, ``*_vs_f64_max``)."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    fa, fd = fa_mod.flash_attention_fwd, attn.flash_decode

    def record(name, got, plain, exact):
        st = stats.setdefault(name, {"calls": 0, "kernel_vs_f64": 0.0, "plain_vs_f64": 0.0,
                                     "kernel_vs_f64_max": 0.0, "plain_vs_f64_max": 0.0})
        scale = max(exact.float().abs().max().item(), 1e-30)
        st["calls"] += 1
        for who, x in (("kernel", got), ("plain", plain)):
            err = (x.double() - exact.double()).abs().max().item() / scale
            st[f"{who}_vs_f64"] += err
            st[f"{who}_vs_f64_max"] = max(st[f"{who}_vs_f64_max"], err)

    def fwd(q, k, v, **kw):
        o, lse = fa(q, k, v, **kw)
        record("flash_attention_fwd", o, ref.flash_attention_ref(q, k, v, **kw)[0],
               exact_attention_fwd(q, k, v, **kw)[0])
        return o, lse

    def decode(q, k, v, pos, qpos, **kw):
        o = fd(q, k, v, pos, qpos, **kw)
        record("flash_decode", o, ref.flash_decode_ref(q, k, v, pos, qpos, **kw),
               exact_decode(q, k, v, pos, qpos, **kw))
        return o
    return attention_sites(fwd, decode)


@contextlib.contextmanager
def routing(record, replay=False):
    """The MoE layer's routing sorts recorded into ``record`` (the indices of
    each stable sort of router logits, in call order), or, with ``replay``,
    taken from it: the logits are gathered in the recorded order, so every
    token goes to the recorded experts and the capacity drops follow.  The
    module's other calls of torch go through unchanged."""
    from repro_torch.models import moe
    calls = iter(list(record))

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        def sort(self, x, *args, **kwargs):
            if not replay:
                values, idx = torch.sort(x, *args, **kwargs)
                record.append(idx)
                return values, idx
            idx = next(calls)
            return torch.gather(x, -1, idx), idx
    real = moe.torch
    moe.torch = Torch()
    try:
        yield record
    finally:
        moe.torch = real


def serve_moe(dev):
    """mixtral-8x7b at full published width, depth cut to MIXTRAL_LAYERS of
    its 32 layers: served as the recurrent archs are (8 requests of 32 new
    tokens, prompts 64-3000 from numpy seed 0, cache_len 4096 = its window),
    with the kernels held against their plain versions on the model's own
    tensors and the MoE layer's dropped fraction at prefill and at decode
    (4 lanes route as one group of capacity 2 over 8 experts); then
    teacher-forced logits of the longest request: f32 with the kernels, per
    call and in the logits, no further from the model with f64 attention than
    F32_ERROR_RATIO times the plain f32 versions (each run with the f64 run's
    router choices); bf16, the loose check, no further from the f32 plain
    logits than BF16_ERROR_RATIO times the plain bf16 path."""
    from repro_torch.configs.base import RunPolicy, get_config
    from repro_torch.models import api
    arch = "mixtral-8x7b"
    cfg = dataclasses.replace(get_config(arch), n_layers=MIXTRAL_LAYERS)
    print(f"{arch}: published width, {MIXTRAL_LAYERS} of 32 layers", flush=True)
    params, cparams, counts, in_model, numbers, done = serve_full_width(
        dev, arch, 4096, 3000, cfg=cfg, run_ctx=moe_drops)
    # the serving run's calls: prefill routes a prompt (T > 4), decode the 4 lanes
    calls = numbers.pop("run_record")
    pre = [float(d) for t, d in calls if t > 4]
    dec = [float(d) for t, d in calls if t <= 4]
    drops = {"prefill_mean": float(np.mean(pre)), "prefill_max": float(np.max(pre)),
             "decode_mean": float(np.mean(dec)), "decode_max": float(np.max(dec)),
             "prefill_calls": len(pre), "decode_calls": len(dec)}
    print(f"{arch} MoE dropped_frac (capacity factor 1.25): {json.dumps(drops)}", flush=True)
    req = max(done, key=lambda r: len(r.prompt))
    runs = {"kernels bf16": (cparams, RunPolicy(use_pallas=True)),
            "plain bf16": (cparams, RunPolicy(use_pallas=False)),
            "kernels f32": (params, RunPolicy(dtype="f32", use_pallas=True)),
            "plain f32": (params, RunPolicy(dtype="f32", use_pallas=False))}
    out = {name: teacher_forced(api, cfg, p, pol, req, dev) for name, (p, pol) in runs.items()}
    # f32 against the exact attention (see F32_ERROR_RATIO): the same model
    # with each attention call computed in f64, every run with that run's
    # router choices (a router logit within rounding of a tie would send a
    # token to another expert in one run only)
    record, exact_calls = [], {}
    with routing(record), attention_sites(exact_attention_fwd, exact_decode):
        exact = teacher_forced(api, cfg, params, runs["kernels f32"][1], req, dev)
    f32 = {}
    for name in ("kernels f32", "plain f32"):
        with routing(record, replay=True), \
                (against_exact(exact_calls) if name == "kernels f32" else contextlib.nullcontext()):
            f32[name] = teacher_forced(api, cfg, params, runs[name][1], req, dev)
    for name, x in list(out.items()) + list(f32.items()):
        if x.shape != (9, 1, cfg.vocab_size) or not torch.isfinite(x).all():
            fail(f"{arch} {name}: logits of shape {tuple(x.shape)} or not finite")
    ref32 = out["plain f32"]
    scale = max(1.0, ref32.abs().max().item())
    dist = {name: (x - ref32).abs().max().item() for name, x in out.items()}
    to_exact = {name: (x - exact).abs().max().item() for name, x in f32.items()}
    print(f"{arch} teacher-forced (rid {req.rid}, prompt {len(req.prompt)}, prefill + 8 "
          f"decode steps): max|logit| {scale:.4f}; max|logit - plain f32| "
          f"{ {k: round(v, 6) for k, v in dist.items()} }; with the exact run's routing "
          f"({len(record)} routing sorts), max|logit - logits of f64 attention| "
          f"{ {k: round(v, 6) for k, v in to_exact.items()} }; per attention call, error "
          f"over max|f64 output| {json.dumps(exact_calls)}", flush=True)
    for name, st in exact_calls.items():
        # summed over the calls, and at the worst call
        if st["calls"] == 0 or st["kernel_vs_f64"] > F32_ERROR_RATIO * st["plain_vs_f64"] \
                or st["kernel_vs_f64_max"] > F32_ERROR_RATIO * st["plain_vs_f64_max"]:
            fail(f"{arch}: f32 {name} is further from the f64 attention than "
                 f"{F32_ERROR_RATIO} x its plain version: {st}")
    if to_exact["kernels f32"] > F32_ERROR_RATIO * to_exact["plain f32"]:
        fail(f"{arch}: f32 kernels-on logits are {to_exact['kernels f32']:.3e} from those of "
             f"the f64 attention, more than {F32_ERROR_RATIO} x the plain f32 path's "
             f"{to_exact['plain f32']:.3e}")
    if dist["kernels bf16"] > BF16_ERROR_RATIO * dist["plain bf16"]:
        fail(f"{arch}: bf16 kernels-on logits are {dist['kernels bf16']:.4f} from the f32 "
             f"ones, more than {BF16_ERROR_RATIO} x the plain bf16 path's "
             f"{dist['plain bf16']:.4f}")
    del params, cparams, out
    torch.cuda.empty_cache()
    return {"serve_launches": counts, "in_model": in_model, "dropped": drops,
            "f32_exact_calls": exact_calls, "f32_logits_to_exact": to_exact, **numbers}


# ------------------------------------------------ head dim 32, the bench cells

# the bench train cell's per-call attention shapes (qwen2-1.5b-bench at
# train_s): B, H, KVH, S, D
D32_SHAPE = (32, 12, 2, 256, 32)
D32_DECODE_SHAPE = (16, 1024)     # bench decode_s: lanes, cache slots
# the bench step, kernels on vs the plain versions from the same params and
# batch: the loss relative to its value; f32 gradients leaf by leaf relative
# to the leaf's largest plain gradient; bf16 gradients against the f32 ones,
# no further than BF16_ERROR_RATIO times the plain bf16 path's (bf16 rounding
# alone moves small leaves by O(1) of their scale)
BENCH_LOSS_TOL = {"bf16": 1e-2, "f32": 1e-5}
BENCH_GRAD_TOL = {"f32": F32_GRAD_TOL}


def check_attention_d32(gen, dev, timer, context):
    """The forward (bf16, f32), dq and dk/dv at head dim 32 against their
    plain versions at the bench train cell's per-call shapes (causal), plus
    a window, a causal shift and G = 1 and 6; two runs of dq and of dk/dv
    must give the same bits.  Returns a report row per kernel: kernel, plain
    and SDPA times, the bound, registers and spills."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq,
                                                     flash_attention_fwd)
    B, H, KVH, S, D = D32_SHAPE
    cases = [  # (dtype, B, H, KVH, Sq, Skv, window, shift)
        (torch.bfloat16, B, H, KVH, S, S, None, 0),
        (torch.float32, B, H, KVH, S, S, None, 0),
        (torch.bfloat16, 2, 6, 1, 777, 777, 100, 0),
        (torch.float32, 2, 6, 6, 500, 700, 300, 200),
        (torch.bfloat16, 1, 12, 2, 1024, 3000, None, 1976),
    ]
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for dtype, b, h, kvh, sq, skv, window, shift in cases:
        q, k, v = attn_inputs(gen, dev, dtype, b, h, kvh, sq, skv, D)
        do = torch.randn(b, h, sq, D, generator=gen, device=dev).to(dtype)
        o, lse = flash_attention_fwd(q, k, v, window=window, causal_shift=shift)
        ro, rlse = ref.flash_attention_ref(q, k, v, window=window, causal_shift=shift)
        got = flash_attention_bwd(q, k, v, ro, rlse, do, window=window, causal_shift=shift)
        want = ref.flash_attention_bwd_ref(q, k, v, ro, rlse, do, window=window,
                                           causal_shift=shift)
        torch.cuda.synchronize()
        e_o = (o.float() - ro.float()).abs().max().item()
        e_l = (lse - rlse).abs().max().item()
        errs = {n: scaled_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        ok = e_o <= TOL[dtype] and e_l <= TOL[dtype] and \
            all(e[2] <= GRAD_TOL[dtype] for e in errs.values())
        print(f"d32 {str(dtype)[6:]} B={b} H={h} KVH={kvh} Sq={sq} Skv={skv} D={D} "
              f"window={window} shift={shift}: max|o|err={e_o:.3e} max|lse|err={e_l:.3e} "
              + ", ".join(f"{n} err/max(1,|plain|)={e[2]:.3e}" for n, e in errs.items())
              + f" {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("an attention kernel at head dim 32 disagrees with its plain version")
        if dtype == torch.bfloat16:
            worst["fwd"] = max(worst["fwd"], e_o, e_l)
            worst["dq"] = max(worst["dq"], errs["dq"][0])
            worst["dkv"] = max(worst["dkv"], errs["dk"][0], errs["dv"][0])
        del q, k, v, do, o, lse, ro, rlse, got, want
    # flash-decode at the bench decode_s step's per-call shape: 16 lanes, a
    # 1024-slot cache holding a 512-token prefill, the new token at 512
    from repro_torch.kernels.decode_attention import flash_decode
    dB, dT = D32_DECODE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, pos, qpos = decode_inputs(gen, dev, dtype, dB, H, KVH, dT, D,
                                           (513,) * dB, None)
        err = (flash_decode(q, k, v, pos, qpos).float()
               - ref.flash_decode_ref(q, k, v, pos, qpos).float()).abs().max().item()
        ok = err <= TOL[dtype]
        print(f"d32 flash_decode {str(dtype)[6:]} B={dB} H={H} KVH={KVH} T={dT} D={D} "
              f"fills=513 x {dB}: max|o|err={err:.3e} tol={TOL[dtype]:g} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail("flash_decode at the bench decode_s shape disagrees with its plain version")

    q, k, v = attn_inputs(gen, dev, torch.bfloat16, B, H, KVH, S, S, D)
    do = torch.randn(B, H, S, D, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = ref.flash_attention_ref(q, k, v)
    dq_runs = [flash_attention_bwd_dq(q, k, v, o, lse, do) for _ in range(2)]
    delta = dq_runs[0][1]
    dkv_runs = [flash_attention_bwd_dkv(q, k, v, lse, delta, do) for _ in range(2)]
    torch.cuda.synchronize()
    bit_equal = {"dq": all(torch.equal(a, b) for a, b in zip(*dq_runs)),
                 "dkv": all(torch.equal(a, b) for a, b in zip(*dkv_runs))}
    print(f"d32 at B={B} H={H} KVH={KVH} S={S} D={D}: two dq runs "
          f"{'bit-equal' if bit_equal['dq'] else 'DIFFER'}, two dk/dv runs "
          f"{'bit-equal' if bit_equal['dkv'] else 'DIFFER'}", flush=True)
    if not all(bit_equal.values()):
        fail("a backward kernel at head dim 32 is not deterministic")
    del dq_runs, dkv_runs

    sdpa = torch.nn.functional.scaled_dot_product_attention
    kx, vx = k.repeat_interleave(H // KVH, 1), v.repeat_interleave(H // KVH, 1)
    qx, kxg, vxg = (t.detach().requires_grad_() for t in (q, kx, vx))
    out = sdpa(qx, kxg, vxg, is_causal=True)
    sdpa_bwd_ms = timer.ms(lambda: torch.autograd.grad(out, (qx, kxg, vxg), do,
                                                       retain_graph=True))
    pairs = B * H * visible_pairs(S, S, None, 0)
    n_qo, n_kv = q.numel(), k.numel()
    regs = kernel_regs("flash_attention", "32>") + "; " + \
        kernel_regs("flash_attention_bwd", "32>")
    rows = {}
    for name, key, fn, plain, lib_ms, n_mm, nbytes in (
            ("flash_attention_fwd", "fwd", lambda: flash_attention_fwd(q, k, v),
             lambda: ref.flash_attention_ref(q, k, v),
             timer.ms(lambda: sdpa(q, kx, vx, is_causal=True)), 2,
             2 * (2 * n_qo + 2 * n_kv) + 4 * B * H * S),               # q o, k v; lse
            ("flash_attention_bwd_dq", "dq", lambda: flash_attention_bwd_dq(q, k, v, o, lse, do),
             lambda: ref.flash_attention_bwd_dq_ref(q, k, v, o, lse, do), sdpa_bwd_ms, 3,
             2 * (4 * n_qo + 2 * n_kv) + 4 * 2 * B * H * S),           # q o do dq, k v; lse delta
            ("flash_attention_bwd_dkv", "dkv",
             lambda: flash_attention_bwd_dkv(q, k, v, lse, delta, do),
             lambda: ref.flash_attention_bwd_dkv_ref(q, k, v, lse, delta, do), sdpa_bwd_ms, 4,
             2 * (2 * n_qo + 4 * n_kv) + 4 * 2 * B * H * S)):          # q do, k v dk dv; lse delta
        flops = 2.0 * D * pairs * n_mm
        row = {"ms": timer.ms(fn), "plain_ms": timer.ms(plain, iters=3),
               "library_ms": lib_ms, "max_abs_err": worst[key],
               "bit_equal_runs": bit_equal.get(key, True),
               "shape": f"B={B} H={H} KVH={KVH} S={S} D={D} bf16 causal"}
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, PEAK_BF16_FLOPS)
        row["tflops"] = flops / row["ms"] / 1e9
        print(f"{name} at D=32 (bench train cell, {row['shape']}): {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.2f} MB; kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
              f"TFLOP/s), plain {row['plain_ms']:.4f} ms, sdpa{' backward' if n_mm > 2 else ''} "
              f"{lib_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"{context}", flush=True)
        rows[name] = row
    print(f"d32 registers: {regs}", flush=True)
    return rows


def _bench_batch(cfg, shape, dev, seed=0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (shape.global_batch, shape.seq_len + 1), generator=g)
    return {"tokens": toks[:, :-1].to(torch.int32).to(dev),
            "labels": toks[:, 1:].to(torch.int32).to(dev)}


def check_kernels_in_step(cfg, policy, params, batch):
    """Every attention kernel call of one train step (forward, and dq, dk,
    dv in backward) held against its plain version on the very tensors the
    model and autograd hand it, in the policy's dtype: o within TOL of the
    call's scale max(1, max|plain|) and lse within TOL; dq, dk and dv within
    GRAD_TOL of their scale and of max|plain|.  Not a counted run (the
    stand-ins take the wrappers' names).  Returns the largest errors."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import ref
    from repro_torch.train import train_step as pts
    fwd, bwd = fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd
    stats = {n: {"calls": 0, "max_scaled_err": 0.0, "max_rel_err": 0.0}
             for n in ("o", "lse", "dq", "dk", "dv")}

    def record(n, a, b):
        err, value, sc = scaled_err(a, b)
        st = stats[n]
        st["calls"] += 1
        st["max_scaled_err"] = max(st["max_scaled_err"], sc)
        st["max_rel_err"] = max(st["max_rel_err"], err / max(value, 1e-30))

    def fwd_checked(q, k, v, **kw):
        o, lse = fwd(q, k, v, **kw)
        ro, rlse = ref.flash_attention_ref(q, k, v, **kw)
        record("o", o, ro)
        stats["lse"]["calls"] += 1
        stats["lse"]["max_scaled_err"] = max(stats["lse"]["max_scaled_err"],
                                             (lse - rlse).abs().max().item())
        return o, lse

    def bwd_checked(q, k, v, o, lse, do, **kw):
        got = bwd(q, k, v, o, lse, do, **kw)
        for n, a, b in zip(("dq", "dk", "dv"), got,
                           ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)):
            record(n, a, b)
        return got
    fwd_checked.launches = 0
    fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd = fwd_checked, bwd_checked
    try:
        pts.compute_grads(cfg, policy, params, batch)
        torch.cuda.synchronize()
    finally:
        fa_mod.flash_attention_fwd, fa_mod.flash_attention_bwd = fwd, bwd
    dt = torch.bfloat16 if policy.dtype == "bf16" else torch.float32
    ok = stats["o"]["max_scaled_err"] <= TOL[dt] and stats["lse"]["max_scaled_err"] <= TOL[dt] \
        and all(stats[n]["max_scaled_err"] <= GRAD_TOL[dt] and
                stats[n]["max_rel_err"] <= GRAD_TOL[dt] for n in ("dq", "dk", "dv"))
    print(f"bench_step {cfg.name} train_s {policy.dtype}: every kernel call vs its plain "
          f"version on the step's own tensors {json.dumps(stats)}; tol o/lse {TOL[dt]:g}, "
          f"grads {GRAD_TOL[dt]:g} of max(1, max|plain|) and of max|plain| "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not all(st["calls"] for st in stats.values()):
        fail(f"bench_step {cfg.name}: a kernel call in the {policy.dtype} step disagrees "
             f"with its plain version, or none was seen")
    return stats


def bench_step(dev):
    """qwen2-1.5b-bench and mixtral-8x7b-bench (8 experts top-2, window 64)
    on the card: one train_s step's gradients (remat "dots") with the
    kernels on against the same step with them off, from the same params
    and batch, in bf16 and in f32, with the exact launch counts of the
    forward, dq and dk/dv kernels (head dim 32; mixtral's windowed); then
    one qwen2 decode_s step (flash-decode at head dim 32) against the plain
    one."""
    from repro_torch.configs.base import RunPolicy
    from repro_torch.core.benchscale import BENCH_SHAPES, bench_config
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.module import flatten
    from repro_torch.train import train_step as pts

    shape = BENCH_SHAPES["train_s"]
    out = {}

    def worst(g, want):
        """The worst leaf's max|g - want| over its max|want|."""
        return max((g[p] - want[p]).abs().max().item() / max(want[p].abs().max().item(), 1e-30)
                   for p in want)

    def worst_leaf(g, want):
        return max(want, key=lambda p: (g[p] - want[p]).abs().max().item()
                   / max(want[p].abs().max().item(), 1e-30))

    def norm_err(g, want):
        """||g - want|| over ||want||, all leaves as one vector."""
        num = sum(float((g[p] - want[p]).double().pow(2).sum()) for p in want)
        return math.sqrt(num / sum(float(want[p].double().pow(2).sum()) for p in want))
    for arch, tag in (("mixtral-8x7b", "mixtral_train"), ("qwen2-1.5b", "train")):
        cfg = bench_config(arch)
        params = api.init(cfg, seed=0, device=dev)
        batch = _bench_batch(cfg, shape, dev)
        n = cfg.n_layers
        expect = {"flash_attention_fwd": 2 * n, "flash_attention_bwd_dq": n,
                  "flash_attention_bwd_dkv": n, "flash_decode": 0, "rglru_scan": 0,
                  "rwkv6_wkv": 0}
        runs = {}
        for dtype in ("f32", "bf16"):
            for use in (False, True):
                policy = RunPolicy(use_pallas=use, remat="dots", dtype=dtype)
                ops.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, aux, grads = pts.compute_grads(cfg, policy, params, batch)
                torch.cuda.synchronize()
                runs[dtype, use] = (loss.item(), dict(flatten(grads)), ops.launch_counts(),
                                    (time.perf_counter() - t0) * 1e3, aux.tolist())
        if cfg.n_experts:
            for dtype in ("f32", "bf16"):
                out[f"{tag}_{dtype}_in_step"] = check_kernels_in_step(
                    cfg, RunPolicy(use_pallas=True, remat="dots", dtype=dtype), params, batch)
        exact = runs["f32", False][1]
        for dtype in ("f32", "bf16"):
            (l0, g0, c0, ms0, a0), (l1, g1, c1, ms1, a1) = runs[dtype, False], runs[dtype, True]
            loss_err = abs(l1 - l0) / abs(l0)
            metric = "worst grad leaf max|err|/max|ref|"
            if cfg.n_experts:
                # the MoE bench model's step is ill-conditioned at its random
                # init: kernel calls within ~1e-6 of their plain versions
                # move a small leaf's gradient by ~1e-2 of its largest value
                # (qwen2-1.5b-bench's by ~5e-4).  Each kernel call is held
                # to the reference's bounds above; the step is held by the
                # f32 gradient as one vector
                print(f"bench_step {cfg.name} train_s {dtype}: router aux [lb_loss, "
                      f"dropped_frac] kernels {a1} plain {a0}; worst leaf "
                      f"{worst_leaf(g1, g0)} at {worst(g1, g0):.3e}", flush=True)
            if dtype == "f32" and cfg.n_experts:
                grad_err, grad_tol, what = norm_err(g1, g0), BENCH_GRAD_TOL["f32"], \
                    "the plain f32 grads"
                metric = "grads ||err||/||ref|| (all leaves as one vector)"
            elif dtype == "f32":
                grad_err, grad_tol, what = worst(g1, g0), BENCH_GRAD_TOL["f32"], \
                    "the plain f32 grads"
            else:
                # bf16 rounding moves small gradient leaves by O(1) either way:
                # the kernels' bf16 grads may be no further from the f32 grads
                # than BF16_ERROR_RATIO times the plain bf16 path's
                grad_err, plain_err = worst(g1, exact), worst(g0, exact)
                grad_tol, what = BF16_ERROR_RATIO * plain_err, \
                    f"the f32 grads (plain bf16: {plain_err:.3e})"
            print(f"bench_step {cfg.name} train_s {dtype} remat dots: loss kernels {l1:.6f} "
                  f"plain {l0:.6f} (rel err {loss_err:.3e}, tol {BENCH_LOSS_TOL[dtype]:g}); "
                  f"{metric} against {what} {grad_err:.3e} (tol "
                  f"{grad_tol:.3e}); launches kernels on {c1}, off {c0}; grads {ms1:.1f} ms "
                  f"on, {ms0:.1f} ms off (first calls, not a timing)", flush=True)
            if c1 != expect or any(c0.values()):
                fail(f"bench_step {cfg.name}: launches {c1} (kernels on) / {c0} (off), "
                     f"expected {expect}")
            if not (loss_err <= BENCH_LOSS_TOL[dtype] and grad_err <= grad_tol):
                fail(f"bench_step {cfg.name}: {dtype} kernels-on step disagrees with the "
                     f"plain one")
            out[f"{tag}_{dtype}"] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
                                     "launches": c1}
        del runs, exact
    n = cfg.n_layers

    # decode_s: a cache filled by a 512-token prefill, one decode step on it
    dshape = BENCH_SHAPES["decode_s"]
    prompt = _bench_batch(cfg, dshape, dev, seed=1)["tokens"][:, :512]
    step = {"tokens": prompt[:, -1:],
            "position": torch.full((dshape.global_batch,), 512, dtype=torch.int32, device=dev)}
    logits = {}
    for dtype in ("f32", "bf16"):
        cp = api.cast_params(params, torch.bfloat16 if dtype == "bf16" else torch.float32)
        for use in (False, True):
            with torch.inference_mode():
                _, _, state = api.forward(cp, {"tokens": prompt}, cfg, RunPolicy(dtype=dtype),
                                          return_cache=True, cache_len=dshape.seq_len)
                ops.reset_launch_counts()
                lg, _ = api.decode_step(cp, state, step, cfg,
                                        RunPolicy(use_pallas=use, dtype=dtype))
                torch.cuda.synchronize()
                logits[dtype, use] = (lg.float(), ops.launch_counts())
    exact = logits["f32", False][0]
    scale = max(1.0, exact.abs().max().item())
    for dtype in ("f32", "bf16"):
        (a, c0), (b, c1) = logits[dtype, False], logits[dtype, True]
        if dtype == "f32":
            err, tol, what = (b - a).abs().max().item(), F32_LOGIT_TOL * scale, "plain f32"
        else:
            # bf16, as the serve phase holds it: no further from the f32
            # logits than BF16_ERROR_RATIO times the plain bf16 path
            err, plain = (b - exact).abs().max().item(), (a - exact).abs().max().item()
            tol, what = BF16_ERROR_RATIO * plain, f"f32 (plain bf16: {plain:.3e})"
        print(f"bench_step {cfg.name} decode_s {dtype}: logits kernels vs {what} max|err| "
              f"{err:.3e} (tol {tol:.3e}; max|logit| {scale:.3e}); launches {c1}", flush=True)
        if c1["flash_decode"] != n or any(v for k, v in c1.items() if k != "flash_decode") \
                or any(c0.values()):
            fail(f"bench_step: decode launches {c1} (on) / {c0} (off), expected {n} flash_decode")
        if err > tol:
            fail(f"bench_step: {dtype} decode logits disagree")
        out[f"decode_{dtype}"] = {"logit_err": err, "launches": c1}
    return out


def measure_main():
    """``chip_smoke.py --measure``, the measure phase's own process (its fake
    process group stays out of the card phases): the corpus's witnesses and
    controls that need no MoE, measured by ``measure_cell`` (V5E spec,
    kernels off) on fake cuda tensors, each held to the reference's kinds
    and useful-FLOP ratio that ``core/parity.py`` keeps (or a listed
    difference), with no op run replicated but those listed for its class; the same
    points kernels on (nothing may launch and no pointer may be read; the
    counter deltas are printed, not gated); then qwen2-1.5b at train_4k on
    the 16x16 production mesh, held to the CPU trace's useful-FLOP ratio.
    The last line is a JSON summary."""
    import dataclasses
    import warnings
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the measure phase traces on cuda tensors")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import SHAPES, RunPolicy, get_config
    from repro_torch.core import anomaly, parity
    from repro_torch.core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from repro_torch.core.counters import measure_cell
    from repro_torch.core.searchspace import SearchSpace
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    corpus = ROOT / "benchmarks" / "results" / "anomaly_corpus.json"
    meta = json.loads(corpus.read_text())["meta"]
    space = SearchSpace(bench_archs(meta["archs"]), BENCH_SHAPES,
                        restrict={k: tuple(v) for k, v in meta["restrict"].items()})
    meshes = bench_meshes()
    summary = {"points": [], "full_width": None}
    t_all = time.perf_counter()
    points = parity.corpus_points(corpus) + parity.corpus_points(corpus, moe=True)
    for sig, kind, role, p in points:
        cfg, shape, policy, mk = space.to_run(space.normalize(p))
        m = measure_cell(build_cell(cfg, shape, policy, meshes[mk]), device="cuda")
        c = m.counters()
        kinds = sorted(anomaly.kinds(c, policy.remat))
        key = parity.point_key(p) + (p["n_microbatch"],)
        want_kinds = list(parity.expected_kinds(p, role))
        ref_useful = parity.REFERENCE[parity.corpus_key(p, role)][1]
        useful = c["perf.useful_flops_ratio"]
        print(f"measure {sig} {role} {key} cache_shard={p['cache_shard']} "
              f"vocab_shard={p['vocab_shard']}: kinds {kinds} (expected {want_kinds}), "
              f"useful {useful:.4f} (reference {ref_useful:.4f}), trace {m.compile_s:.2f} s; "
              f"counters {json.dumps(c)}; ops DTensor ran replicated "
              f"{json.dumps(m.hlo['replicated_ops'])}", flush=True)
        # the reference's kinds today, or a listed difference (the committed
        # verdicts of the two mixtral A1 witnesses fail in the reference too)
        if kinds != want_kinds:
            fail(f"measure: the {role} {key} of {sig} gives kinds {kinds}, "
                 f"expected {want_kinds}")
        if not parity.useful_ok(parity.corpus_key(p, role), useful, ref_useful):
            fail(f"measure: the {role} {key} has useful-FLOP ratio {useful:.4f}, not "
                 f"within {parity.USEFUL_RATIO_REL_BOUND:.0%} of {ref_useful:.4f}")
        unlisted = parity.unlisted_replications(m.hlo["replicated_ops"], cfg.name,
                                                policy.sharding_preset, shape.kind,
                                                policy.n_microbatch)
        if unlisted:
            fail(f"measure: the {role} {key} ran unlisted ops replicated: {unlisted}")
        row = {"kind": kind, "role": role, "point": key, "kinds": kinds,
               "trace_s": m.compile_s, "counters": c}
        on = dataclasses.replace(policy, use_pallas=True)
        before = ops.launch_counts()
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*data.?p(oin)?t(e)?r.*")
            try:
                mo = measure_cell(build_cell(cfg, shape, on, meshes[mk]), device="cuda")
            except RuntimeError as e:
                if "no backward" not in str(e):
                    raise
                mo = None
                print(f"measure kernels-on {key}: {cfg.name} has no kernel backward: "
                      f"cannot train with the kernels on (as the reference)", flush=True)
        if ops.launch_counts() != before:
            fail(f"measure: the kernels-on trace of {key} launched kernels")
        if mo is not None:
            co = mo.counters()
            delta = {k: co[k] - c[k] for k in c if co[k] != c[k]}
            print(f"measure kernels-on {key}: kinds {sorted(anomaly.kinds(co, on.remat))}, "
                  f"trace {mo.compile_s:.2f} s; launches unchanged; counter deltas "
                  f"(on - off) {json.dumps(delta)}", flush=True)
            row["kernels_on_delta"] = delta
        summary["points"].append(row)
    cfg, shape = get_config("qwen2-1.5b"), SHAPES["train_4k"]
    t0 = time.perf_counter()
    policy = RunPolicy()
    m = measure_cell(build_cell(cfg, shape, policy, make_production_mesh()),
                     device="cuda")
    c = m.counters()
    print(f"measure full width: {cfg.name} {shape.name} (seq {shape.seq_len}, batch "
          f"{shape.global_batch}) on the 16x16 mesh, fsdp, remat dots: trace "
          f"{m.compile_s:.2f} s ({time.perf_counter() - t0:.2f} s with the build); kinds "
          f"{sorted(anomaly.kinds(c, 'dots'))}; counters {json.dumps(c)}; ops DTensor ran "
          f"replicated {json.dumps(m.hlo['replicated_ops'])}", flush=True)
    useful, want = c["perf.useful_flops_ratio"], parity.FULL_WIDTH_USEFUL
    if abs(useful - want) > parity.USEFUL_RATIO_REL_BOUND * want:
        fail(f"measure: the full-width point has useful-FLOP ratio {useful:.4f}, not "
             f"within {parity.USEFUL_RATIO_REL_BOUND:.0%} of the CPU trace's {want:.4f}")
    unlisted = parity.unlisted_replications(m.hlo["replicated_ops"], cfg.name,
                                            policy.sharding_preset, shape.kind,
                                            policy.n_microbatch)
    if unlisted:
        fail(f"measure: the full-width point ran unlisted ops replicated: {unlisted}")
    summary["full_width"] = {"trace_s": m.compile_s, "counters": c}
    summary["seconds"] = time.perf_counter() - t_all
    print(json.dumps({"measure": summary}), flush=True)


def corpus_start(tmp):
    """Start the port's replay of the committed corpus, ``python -m
    repro_torch.core.corpus replay --parity`` (fake cuda tensors), in a
    process of its own: it runs on the host while the measure phase does."""
    corpus = ROOT / "benchmarks" / "results" / "anomaly_corpus.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("COLLIE_")}
    env["PYTHONPATH"] = str(ROOT / "src")
    report = Path(tmp) / "replay.json"
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.core.corpus", "replay",
                             str(corpus), "--device", "cuda", "--parity", "--json",
                             str(report)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, report, time.perf_counter()


def corpus_finish(started):
    """The replay's result: all 8 entries, no failed trace, and every
    verdict the reference's today or a listed difference
    (``core/parity.py``)."""
    proc, report, t0 = started
    out, err = proc.communicate(timeout=900)
    seconds = time.perf_counter() - t0
    print(out.rstrip(), flush=True)
    if proc.returncode != 0 or not report.exists():
        print(err[-6000:], file=sys.stderr, flush=True)
        fail("corpus: the replay failed, or a verdict differs from the reference's "
             "unlisted")
    rep = json.loads(report.read_text())
    if len(rep["reports"]) != 8 or rep["errors"] or rep["unlisted_replay_differences"]:
        fail(f"corpus: {len(rep['reports'])} entries replayed, errors {rep['errors']}, "
             f"unlisted differences {rep['unlisted_replay_differences']}")
    return {"entries": len(rep["reports"]), "seconds": seconds, "stats": rep["stats"],
            "verdicts": {r["signature"]: [r["kind_ok"], r["controls_ok"]]
                         for r in rep["reports"]}}


def measure_phase():
    """Run ``measure_main`` in a process of its own; its failure fails the run."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--measure"],
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.splitlines()
    for line in lines[:-1] if proc.returncode == 0 else lines:
        print(line, flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], file=sys.stderr, flush=True)
        fail("measure: the measure phase failed")
    return json.loads(proc.stdout.strip().splitlines()[-1])["measure"]


SEARCH_BUDGET = 24
SEARCH_WORKERS = 4


def search_run(tmp, tag, workers, hash_seed):
    """One run of the port's ``collie_search`` CLI on the card's host, with
    the cache in ``tmp``: -> (stdout, its JSON report, host seconds)."""
    report = Path(tmp) / f"{tag}.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("COLLIE_")}
    env.update(PYTHONPATH=str(ROOT / "src"), PYTHONHASHSEED=str(hash_seed),
               COLLIE_CACHE=str(Path(tmp) / "cache.sqlite"), COLLIE_WORKERS=str(workers))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.examples.collie_search",
                           "--device", "cuda", "--budget", str(SEARCH_BUDGET),
                           "--report", str(report)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-6000:], file=sys.stderr, flush=True)
        fail(f"search: the {tag} run failed")
    return proc.stdout, json.loads(report.read_text()), seconds


def search_phase(smi_line):
    """The cold and the warm run of the Collie campaign (phase 3e)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import parity
    with tempfile.TemporaryDirectory(prefix="collie_search_") as tmp:
        cold_out, cold, cold_s = search_run(tmp, "cold", SEARCH_WORKERS, 1)
        warm_out, warm, warm_s = search_run(tmp, "warm", 1, 4242)
    print(cold_out.rstrip(), flush=True)
    cs, ws = cold["stats"], warm["stats"]
    for tag, st, sec in (("cold", cs, cold_s), ("warm", ws, warm_s)):
        print(f"search {tag}: {st['n_workers']} workers, n_attempts {st['n_attempts']}, "
              f"n_compiles {st['n_compiles']}, n_lowerings {st['n_lowerings']}, "
              f"n_struct_hits {st['n_struct_hits']}, n_cache_hits {st['n_cache_hits']}, "
              f"n_disk_hits {st['n_disk_hits']}, n_failures {st['n_failures']}; host "
              f"seconds: lower_time {st['lower_time']:.2f}, compile_time "
              f"{st['compile_time']:.2f} (summed over workers), run {sec:.2f}, "
              f"{sec / max(st['n_attempts'], 1):.3f} per attempt; {smi_line}", flush=True)
    for a in cold["anomalies"]:
        conds = ", ".join(f"{k}={'|'.join(map(str, v))}"
                          for k, v in sorted(a["conditions"].items()))
        print(f"search MFS: [{a['kind']}] {conds}", flush=True)
    print(f"search: ops the traces ran replicated {json.dumps(cold['replicated_ops'])}, "
          f"by (arch, preset, shape kind, n_microbatch) {json.dumps(cold['replicated_at'])}",
          flush=True)
    if cs["n_failures"] or cold["errors"]:
        fail(f"search: {cs['n_failures']} traces failed: {cold['errors'][:5]}")
    if not cold["events"]:
        fail("search: the cold run recorded no event")
    unlisted = parity.unlisted_at({tuple(cls) or None: ops for cls, ops in cold["replicated_at"]})
    if unlisted:
        fail(f"search: the traces ran ops replicated where parity.REPLICATED_OPS does not "
             f"admit them: {unlisted}")
    if ws["n_compiles"] or ws["n_lowerings"] or ws["n_failures"]:
        fail(f"search: the warm run traced (n_compiles {ws['n_compiles']}, n_lowerings "
             f"{ws['n_lowerings']}, n_failures {ws['n_failures']})")
    strip = lambda out: re.sub(r"\(\d+s\)", "", out)
    if strip(warm_out) != strip(cold_out):
        fail("search: the warm run printed another catalog than the cold run")
    if (warm["events"], warm["anomalies"], warm["n_attempts"]) != \
            (cold["events"], cold["anomalies"], cold["n_attempts"]):
        fail("search: the warm run's events or anomalies differ from the cold run's")
    return {"cold_s": cold_s, "warm_s": warm_s, "cold": cs, "warm": ws,
            "n_events": len(cold["events"]), "n_anomalies": len(cold["anomalies"])}


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
        for kernel, regs, spills, warnings in ptxas_summary(build.ptxas_log(name)):
            print(f"ptxas {name} {kernel}: {regs} registers, {spills}", flush=True)
            for w in warnings:
                print(f"ptxas {name} {kernel}: {w}", flush=True)

    phase_seconds = {}
    phase("kernels")
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    tiny = torch.zeros(1, device=dev)
    floor_ms = timer.ms(lambda: tiny.add_(1), iters=50)
    print(f"timer floor: one launch of a 1-element add, timed as the kernels are: "
          f"{floor_ms:.4f} ms", flush=True)
    fa = check_flash_attention(gen, dev, timer)
    fd = check_flash_decode(gen, dev, timer)
    bwd = check_flash_attention_bwd(gen, dev, timer)
    fa["d256"] = check_flash_attention_d256(gen, dev, timer)
    fd["d256"] = check_flash_decode_d256(gen, dev, timer)
    rg_row = check_rglru_scan(gen, dev, timer)
    wkv_row = check_rwkv6_wkv(gen, dev, timer)
    phase_seconds["kernels"] = time.perf_counter() - t_phase

    phase("kernels_d32")
    t_phase = time.perf_counter()
    d32 = check_attention_d32(gen, dev, timer, f"timer floor {floor_ms:.4f} ms; {smi_line}")
    fa["d32"] = d32["flash_attention_fwd"]
    bwd["flash_attention_bwd_dq"]["d32"] = d32["flash_attention_bwd_dq"]
    bwd["flash_attention_bwd_dkv"]["d32"] = d32["flash_attention_bwd_dkv"]
    phase_seconds["kernels_d32"] = time.perf_counter() - t_phase
    del timer
    torch.cuda.empty_cache()

    phase("bench_step")
    t_phase = time.perf_counter()
    bench = bench_step(dev)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        row = fa if name == "flash_attention_fwd" else bwd[name]
        row["d32"]["bench_train_launches"] = bench["train_bf16"]["launches"][name]
    fd["bench_decode_launches"] = bench["decode_bf16"]["launches"]["flash_decode"]
    phase_seconds["bench_step"] = time.perf_counter() - t_phase
    torch.cuda.empty_cache()

    # measure and corpus run on the host only, in processes of their own, at once
    phase("measure")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="corpus_replay_") as tmp:
        replay = corpus_start(tmp)
        measured = measure_phase()
        phase_seconds["measure"] = time.perf_counter() - t_phase
        print(f"measure: {len(measured['points'])} corpus points, kernels off and on, and "
              f"the full-width point in {measured['seconds']:.1f} s (beside the corpus "
              f"replay)", flush=True)
        phase("corpus")
        replayed = corpus_finish(replay)
    phase_seconds["measure + corpus"] = time.perf_counter() - t_phase
    print(f"corpus: {replayed['entries']} entries replayed in {replayed['seconds']:.1f} s "
          f"(beside the measure phase), verdicts (kind_ok, controls_ok) "
          f"{json.dumps(replayed['verdicts'])}", flush=True)

    phase("search")
    t_phase = time.perf_counter()
    searched = search_phase(smi_line)
    phase_seconds["search"] = time.perf_counter() - t_phase
    print(f"search: {searched['n_events']} events, {searched['n_anomalies']} anomalies in "
          f"{searched['cold']['n_attempts']} attempts; cold {searched['cold_s']:.1f} s "
          f"({searched['cold']['n_compiles']} mesh traces, {searched['cold']['n_struct_hits']} "
          f"structural hits), warm {searched['warm_s']:.1f} s ({searched['warm']['n_compiles']} "
          f"mesh traces) (host)", flush=True)

    phase("serve")
    t_phase = time.perf_counter()
    counts, in_model = serve(dev)
    for name, row in (("flash_attention_fwd", fa), ("flash_decode", fd)):
        st = in_model[name]
        row["in_model_max_abs_err"] = st["max_abs_err"]
        row["in_model_max_abs_value"] = st["max_abs_value"]
        row["in_model_max_scaled_err"] = st["max_scaled_err"]
    torch.cuda.empty_cache()

    phase_seconds["serve"] = time.perf_counter() - t_phase
    phase("train")
    t_phase = time.perf_counter()
    train_counts, bwd_in_model, f32_grad_err = train(dev)
    torch.cuda.empty_cache()
    phase_seconds["train"] = time.perf_counter() - t_phase
    fa["train_launches"] = train_counts["flash_attention_fwd"]
    for name, grads in (("flash_attention_bwd_dq", ("dq",)),
                        ("flash_attention_bwd_dkv", ("dk", "dv"))):
        row = bwd[name]
        row["in_model_max_abs_err"] = max(bwd_in_model[g]["max_abs_err"] for g in grads)
        row["in_model_max_scaled_err"] = max(bwd_in_model[g]["max_scaled_err"] for g in grads)
        row["in_model_max_rel_err"] = max(bwd_in_model[g]["max_rel_err"] for g in grads)
        row["f32_step_grad_rel_err"] = f32_grad_err

    phase("serve recurrentgemma-2b")
    t_phase = time.perf_counter()
    # the reference's engine takes no cache longer than the window (ROADMAP queue 3)
    hybrid = recurrent(dev, "recurrentgemma-2b", cache_len=2048, max_prompt=2000)
    phase("serve rwkv6-7b")
    ssm = recurrent(dev, "rwkv6-7b", cache_len=4096, max_prompt=3000)
    for name, row, runs in (("flash_attention_fwd", fa, (("recurrentgemma", hybrid),)),
                            ("flash_decode", fd, (("recurrentgemma", hybrid),)),
                            ("rglru_scan", rg_row, (("recurrentgemma", hybrid),)),
                            ("rwkv6_wkv", wkv_row, (("rwkv6", ssm),))):
        for tag, run in runs:
            row[f"{tag}_serve_launches"] = run["serve_launches"][name]
            row[f"{tag}_score_launches"] = run["score_launches"][name]
            row[f"{tag}_in_model"] = run["in_model"][name]
    for tag, run in (("recurrentgemma", hybrid), ("rwkv6", ssm)):
        print(f"{tag}: prefill ms mean {run['prefill_ms_mean']:.3f}, decode ms median "
              f"{run['decode_ms_median']:.3f}, {run['tokens_per_s']:.1f} tokens/s, peak "
              f"{run['peak_gb']:.2f} GB; f32 scoring logits, kernels vs plain, "
              f"{run['f32_logit_err']:.3e} of the largest logit", flush=True)

    phase_seconds["serve recurrent"] = time.perf_counter() - t_phase

    phase("serve mixtral-8x7b")
    t_phase = time.perf_counter()
    moe = serve_moe(dev)
    for name, row in (("flash_attention_fwd", fa), ("flash_decode", fd)):
        row["mixtral_serve_launches"] = moe["serve_launches"][name]
        row["mixtral_in_model"] = moe["in_model"][name]
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        row = fa if name == "flash_attention_fwd" else bwd[name]
        row["d32"]["mixtral_bench_train_launches"] = \
            bench["mixtral_train_bf16"]["launches"][name]
    print(f"mixtral-8x7b ({MIXTRAL_LAYERS} layers): prefill ms mean "
          f"{moe['prefill_ms_mean']:.3f}, decode ms median {moe['decode_ms_median']:.3f} p90 "
          f"{moe['decode_ms_p90']:.3f}, {moe['tokens_per_s']:.1f} tokens/s, peak "
          f"{moe['peak_gb']:.2f} GB; dropped_frac {json.dumps(moe['dropped'])}; f32 "
          f"teacher-forced logits from those of f64 attention "
          f"{json.dumps(moe['f32_logits_to_exact'])}; {smi_line}", flush=True)
    phase_seconds["serve mixtral-8x7b"] = time.perf_counter() - t_phase
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_seconds.items()})}",
          flush=True)

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
        dict(name="flash_attention_bwd_dq", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:127",
             launches=train_counts["flash_attention_bwd_dq"],
             tolerance=GRAD_TOL[torch.bfloat16], **bwd["flash_attention_bwd_dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention.py:172",
             launches=train_counts["flash_attention_bwd_dkv"],
             tolerance=GRAD_TOL[torch.bfloat16], **bwd["flash_attention_bwd_dkv"]),
        dict(name="rglru_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/rglru_scan.cu",
             replaces="src/repro/kernels/rglru_scan.py:19",
             launches=hybrid["serve_launches"]["rglru_scan"], tolerance=RGLRU_TOL, **rg_row),
        dict(name="rwkv6_wkv", route="cuda",
             source="src/repro_torch/kernels/csrc/rwkv6.cu",
             replaces="src/repro/kernels/rwkv6_kernel.py:28",
             launches=ssm["serve_launches"]["rwkv6_wkv"], tolerance=WKV_REL_TOL, **wkv_row),
    ]
    for kr in kernels:
        rows = [kr] + [kr[d] for d in ("d256", "d32") if d in kr]
        if not all(math.isfinite(r[k]) for r in rows
                   for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")):
            fail(f"non-finite numbers for {kr['name']}")
        if kr["launches"] <= 0:
            fail(f"{kr['name']} was not launched on its main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def step_times_main(src):
    """``chip_smoke.py --step-times [SRC]``: the wall time of qwen2-1.5b's
    serving steps and train step, kernels on, with ``repro_torch`` imported
    from SRC (default: this checkout's ``src``), so that two trees can be
    timed in turn on one card.  Serving as the serve phase runs it (4 lanes,
    a 4096-slot cache, 8 requests of 32 tokens): prefill ms per request and
    decode ms per step; training as the train phase (seq 4096, batch 2 in 2
    microbatches, remat "dots", bf16): the median of 5 steps after one
    warm-up.  The last line is a JSON summary."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: step times are taken on the card")
    sys.path.insert(0, str(Path(src).resolve()))
    from repro_torch.configs.base import SHAPES, RunPolicy, ShapeSpec, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build, ops
    from repro_torch.launch.train import opt_config
    from repro_torch.models import api
    from repro_torch.serve.engine import Request, ServingEngine
    from repro_torch.train import train_step as pts

    dev = torch.device("cuda", 0)
    build.build()
    cfg = get_config("qwen2-1.5b")
    params = api.init(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(64, 3001, size=8)]
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

    for rnd in range(2):                       # the first round warms up
        eng = ServingEngine(cfg, RunPolicy(use_pallas=True), params, n_slots=4,
                            cache_len=4096, temperature=0.0, device=dev)
        prefill_ms.clear()
        decode_ms.clear()
        eng.prefill = timed(eng.prefill, prefill_ms)
        eng.decode = timed(eng.decode, decode_ms)
        for i, p in enumerate(prompts):
            eng.add_request(Request(rid=i, prompt=p, max_new_tokens=32))
        ops.reset_launch_counts()
        list(eng.run())
        del eng
    serve_launches = ops.launch_counts()
    del params
    policy = RunPolicy(use_pallas=True, remat="dots", n_microbatch=2)
    opt = opt_config("adamw", lr=1e-3, steps=6)
    shape = ShapeSpec("train_4k, batch 2", "train", SHAPES["train_4k"].seq_len, 2)
    state = {"params": api.init(cfg, seed=0, device=dev)}
    state["opt"] = pts.make_init_opt(cfg, policy, opt)(state["params"])
    step_fn = pts.make_train_step(cfg, policy, opt)
    data = SyntheticLM(cfg, shape, seed=0)
    step_ms = []
    for i in range(6):
        b = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(i).items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state["params"], state["opt"], m = step_fn(state["params"], state["opt"], b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    out = {"src": str(src), "prefill_ms_mean": float(np.mean(prefill_ms)),
           "decode_ms_median": float(np.median(decode_ms)),
           "decode_ms_p90": float(np.percentile(decode_ms, 90)),
           "decode_steps": len(decode_ms), "train_step_ms_median": float(np.median(step_ms[1:])),
           "train_step_ms": step_ms[1:], "serve_launches": serve_launches,
           "loss": float(m["loss"].item()),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--measure"]:
        measure_main()
    elif sys.argv[1:2] == ["--step-times"]:
        step_times_main(sys.argv[2] if len(sys.argv) > 2 else ROOT / "src")
    else:
        main()
