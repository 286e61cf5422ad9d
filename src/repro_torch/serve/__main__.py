"""Batched serving from the command line: continuous-batching engine over a model.

  PYTHONPATH=src python -m repro_torch.serve --requests 12 --slots 4
  PYTHONPATH=src python -m repro_torch.serve --arch qwen2-1.5b --full
  PYTHONPATH=src python -m repro_torch.serve --arch recurrentgemma-2b --device cpu
  PYTHONPATH=src python -m repro_torch.serve --arch rwkv6-7b --full

Without ``--full`` the arch's reduced smoke config runs in f32, as the JAX
package's ``examples/serve_lm.py`` does; with ``--full`` the published config
runs with the default RunPolicy (bf16 compute, f32 params).  The kernels are
on; on the CPU (``--device cpu``) they are their plain versions.  The cache
holds 128 slots, or the window of a windowed arch if that is shorter (the
serving engine takes no longer cache there).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs.all_archs import smoke_config
from ..configs.base import RunPolicy, get_config
from ..models import api
from .engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="serve the published config, not its smoke variant")
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    if args.full:
        cfg, policy = get_config(args.arch), RunPolicy(use_pallas=True)
    else:
        cfg = smoke_config(args.arch)
        policy = RunPolicy(remat="none", dtype="f32", use_pallas=True)
    params = api.init(cfg, seed=0, device=device)
    cache_len = min(128, cfg.window) if cfg.window else 128
    eng = ServingEngine(cfg, policy, params, n_slots=args.slots, cache_len=cache_len,
                        temperature=args.temperature, device=device)
    del params

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.choice([8, 16]))
        eng.add_request(Request(rid=i,
                                prompt=rng.integers(0, cfg.vocab_size, plen,
                                                    dtype=np.int64).astype(np.int32),
                                max_new_tokens=args.max_new))
    done = eng.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"{len(done)} requests, {eng.stats['tokens_out']} tokens in "
          f"{dt:.1f}s ({eng.stats['tokens_out']/dt:.1f} tok/s) on {device}; "
          f"{eng.stats['decode_steps']} batched decode steps, "
          f"{eng.stats['prefills']} prefills")
    for r in done[:4]:
        print(f"  rid={r.rid} len(prompt)={len(r.prompt)} out={r.out[:8]}...")


if __name__ == "__main__":
    main()
