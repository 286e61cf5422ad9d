"""Training launcher on one device: the counterpart of the JAX package's
``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
      --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --seq 4096 --batch 2 --dtype bf16 --steps 10
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium --smoke \
      --steps 2 --device cpu       # also internvl2-1b (a patch prefix in every batch)

It composes random params from a seed, the optimizer state, the microbatched
train step (kernels on: on the CPU they are their plain versions) and the
synthetic data pipeline with prefetch.  It runs on ``cuda`` unless given
``--device cpu``.  The reference launcher's mesh flags (``--preset``,
``--compress``, ``--production-mesh``), checkpointing and elastic hooks are
absent here: they wait for ROADMAP module queue 1.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs.all_archs import smoke_config
from ..configs.base import RunPolicy, ShapeSpec, get_config
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models import api
from ..train.optimizer import OptConfig
from ..train.train_step import make_init_opt, make_train_step


def opt_config(name: str, lr: float, steps: int) -> OptConfig:
    """The optimizer settings the JAX package's launcher builds."""
    return OptConfig(name=name, lr=lr, warmup=10, decay_steps=max(steps, 100))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", default="dots", choices=("none", "dots", "full"))
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "sgdm", "adafactor"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"),
                    help="compute dtype (params stay f32)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec("train", "train", args.seq, args.batch)
    policy = RunPolicy(remat=args.remat, n_microbatch=args.microbatch, dtype=args.dtype,
                       optimizer=args.optimizer, use_pallas=True)
    opt = opt_config(args.optimizer, args.lr, args.steps)

    params = api.init(cfg, seed=0, device=device)
    opt_state = make_init_opt(cfg, policy, opt)(params)
    step_fn = make_train_step(cfg, policy, opt)
    print(f"[launch] {cfg.name}: {api.n_params(cfg):,} params on {device}; "
          f"policy={args.dtype}/{args.remat}/mb{args.microbatch}/{args.optimizer}",
          flush=True)
    pf = Prefetcher(SyntheticLM(cfg, shape, seed=0))
    try:
        for i in range(args.steps):
            t0 = time.perf_counter()
            _, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])                     # waits for the step
            dt = time.perf_counter() - t0
            if i < 10 or i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {loss:.4f} grad_norm "
                      f"{float(m['grad_norm']):.4f} {dt * 1e3:7.0f} ms", flush=True)
    finally:
        pf.close()
    print("[launch] done")


if __name__ == "__main__":
    main()
