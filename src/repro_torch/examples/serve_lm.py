"""Batched serving example: continuous-batching engine over a small model.
The port's counterpart of the JAX package's ``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --requests 12 --slots 4 \
      --device cpu

It runs on ``cuda`` unless given ``--device cpu``.  The smoke config's head
dim (16) is below the attention kernels' (32-256), so this runs the plain
attention, as the reference's example does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs.all_archs import smoke_config
from ..configs.base import RunPolicy
from ..models import api
from ..serve.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = api.resolve_device(args.device)

    cfg = smoke_config(args.arch)
    policy = RunPolicy(remat="none", dtype="f32")
    params = api.init(cfg, seed=0, device=device)
    eng = ServingEngine(cfg, policy, params, n_slots=args.slots,
                        cache_len=128, temperature=args.temperature, device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(args.requests):
        plen = int(rng.choice([8, 16]))
        eng.add_request(Request(rid=i,
                                prompt=rng.integers(0, cfg.vocab_size, plen,
                                                    dtype=np.int64).astype(np.int32),
                                max_new_tokens=args.max_new))
    done = eng.run()
    dt = time.time() - t0
    print(f"{len(done)} requests, {eng.stats['tokens_out']} tokens in "
          f"{dt:.1f}s ({eng.stats['tokens_out']/dt:.1f} tok/s); "
          f"{eng.stats['decode_steps']} batched decode steps, "
          f"{eng.stats['prefills']} prefills")
    for r in done[:4]:
        print(f"  rid={r.rid} len(prompt)={len(r.prompt)} out={r.out[:8]}...")


if __name__ == "__main__":
    main()
