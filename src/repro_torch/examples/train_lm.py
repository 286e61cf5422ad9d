"""End-to-end training driver: data pipeline -> train loop -> checkpoints ->
fault-tolerance hooks (heartbeat/straggler/elastic) -> metrics log.  The
port's counterpart of the JAX package's ``examples/train_lm.py``.

Default preset trains a ~20M-param llama-family model for 200 steps; --preset
100m gives the ~100M-param configuration used on real accelerators (same
code path).  It runs on ``cuda`` unless given ``--device cpu``, with the
attention kernels on (on the CPU they are their plain versions).

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset 100m --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --resume   # continue from ckpt
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.base import ModelConfig, RunPolicy, ShapeSpec
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models import api
from ..runtime.elastic import ElasticController
from ..train.optimizer import OptConfig
from ..train.train_step import make_init_opt, make_train_step

PRESETS = {
    "20m": ModelConfig(name="llama-20m", family="dense", n_layers=6,
                       d_model=384, n_heads=6, n_kv_heads=2, d_head=64,
                       d_ff=1024, vocab_size=8192, rope_theta=1e4),
    "100m": ModelConfig(name="llama-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_head=64,
                        d_ff=2048, vocab_size=32000, rope_theta=1e4),
}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--preset", default="20m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = api.resolve_device(args.device)

    cfg = PRESETS[args.preset]
    shape = ShapeSpec("train", "train", args.seq, args.batch)
    policy = RunPolicy(remat="dots", dtype="f32", n_microbatch=2, use_pallas=True)
    opt = OptConfig(lr=1e-3, warmup=20, decay_steps=max(args.steps, 100))

    params = api.init(cfg, seed=0, device=device)
    opt_state = make_init_opt(cfg, policy, opt)(params)
    print(f"model: {cfg.name}, {api.n_params(cfg):,} params")

    cm = CheckpointManager(args.ckpt_dir, keep_last=2)
    start_step = 0
    if args.resume:
        meta, restored = cm.restore_latest({"params": params, "opt": opt_state})
        if meta is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = meta["step"]
            print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, policy, opt)
    pipe = SyntheticLM(cfg, shape, seed=0)
    pf = Prefetcher(pipe, start_step=start_step)
    ctl = ElasticController(["host0"], hosts_per_pod=1, chips_per_host=1,
                            model_axis=1, multi_pod=False)

    t_start = time.time()
    try:
        for i in range(start_step, start_step + args.steps):
            t0 = time.time()
            s, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])                     # waits for the step
            dt = time.time() - t0
            ctl.on_step({"host0": dt})
            restart, plan, stragglers = ctl.check()
            if stragglers:
                print(f"  [straggler mitigation] slow hosts: {stragglers}")
            if i % 10 == 0:
                tok_s = args.batch * args.seq / dt
                print(f"step {i:4d} loss {loss:.3f} "
                      f"{dt*1e3:6.0f} ms/step {tok_s:8.0f} tok/s")
            if (i + 1) % args.ckpt_every == 0:
                cm.save(i + 1, {"params": params, "opt": opt_state})
        cm.save(start_step + args.steps, {"params": params, "opt": opt_state})
        cm.wait()
        print(f"done: {args.steps} steps in {time.time()-t_start:.0f}s; "
              f"checkpoints in {args.ckpt_dir}")
    finally:
        pf.close()


if __name__ == "__main__":
    main()
