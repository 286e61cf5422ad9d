"""Quickstart: train a tiny qwen2-family model on synthetic data (CPU, ~1min),
then serve a few batched requests from the trained weights.  The port's
counterpart of the JAX package's ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

It runs on ``cuda`` unless given ``--device cpu``.  The smoke config's head
dim (16) is below the attention kernels' (32-256), so this runs the plain
attention, as the reference's example does.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.all_archs import smoke_config
from ..configs.base import RunPolicy, ShapeSpec
from ..data.pipeline import SyntheticLM
from ..models import api
from ..serve.engine import Request, ServingEngine
from ..train.optimizer import OptConfig
from ..train.train_step import make_init_opt, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = api.resolve_device(args.device)

    cfg = smoke_config("qwen2-1.5b")
    shape = ShapeSpec("quick", "train", 64, 8)
    policy = RunPolicy(remat="none", dtype="f32", n_microbatch=2)
    opt = OptConfig(lr=3e-3, warmup=5, decay_steps=300)

    params = api.init(cfg, seed=0, device=device)
    print(f"model: {cfg.name}, {api.n_params(cfg):,} params")
    opt_state = make_init_opt(cfg, policy, opt)(params)
    step = make_train_step(cfg, policy, opt)
    pipe = SyntheticLM(cfg, shape, seed=0)

    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch(i).items()}
        params, opt_state, m = step(params, opt_state, batch)
        if i % 10 == 0:
            print(f"step {i:3d} loss {float(m['loss']):.3f} "
                  f"lr {float(m['lr']):.2e} |grad| {float(m['grad_norm']):.2f}")

    print("\nserving 4 batched requests from the trained model:")
    eng = ServingEngine(cfg, RunPolicy(remat="none", dtype="f32"), params,
                        n_slots=2, cache_len=64, device=device)
    for i in range(4):
        eng.add_request(Request(rid=i, prompt=np.arange(6, dtype=np.int32) + i,
                                max_new_tokens=8))
    for r in eng.run():
        print(f"  request {r.rid}: {list(r.prompt)} -> {r.out}")
    print("stats:", eng.stats)


if __name__ == "__main__":
    main()
