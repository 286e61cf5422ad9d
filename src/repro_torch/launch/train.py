"""Training launcher: the counterpart of the JAX package's ``launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke \
      --steps 20 --ckpt-dir /tmp/ck --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --seq 4096 --batch 2 --dtype bf16 --steps 10 --ckpt-dir /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-medium --smoke \
      --steps 2 --device cpu       # also internvl2-1b (a patch prefix in every batch)

It composes random params from a seed, the optimizer state, the microbatched
train step (kernels on: on the CPU they are their plain versions), the
synthetic data pipeline with prefetch, atomic async checkpointing with
resume, and the heartbeat/straggler/elastic hooks.  It runs on ``cuda``
unless given ``--device cpu``, on the local devices as a 1-D "data" mesh.

As in the reference:

* it resumes from the newest valid step under ``--ckpt-dir`` whenever there
  is one (pass a fresh directory for a fresh run), and the data pipeline
  with it; it saves every ``--ckpt-every`` steps and at the end;
* ``--preset`` and ``--compress`` enter the run policy; with no "pod" axis
  in the mesh the gradient is not compressed;
* ``ElasticController.on_step`` records every step's time (``check`` is the
  examples' to call);
* ``--production-mesh`` needs the 256 devices of the 16x16 mesh, and exits
  with a message where fewer are found.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.all_archs import smoke_config
from ..configs.base import RunPolicy, ShapeSpec, get_config
from ..data.pipeline import Prefetcher, SyntheticLM
from ..models import api
from ..runtime.elastic import ElasticController
from ..train.optimizer import OptConfig
from ..train.train_step import make_init_opt, make_train_step
from .mesh import make_host_mesh, make_production_mesh


def opt_config(name: str, lr: float, steps: int) -> OptConfig:
    """The optimizer settings the JAX package's launcher builds."""
    return OptConfig(name=name, lr=lr, warmup=10, decay_steps=max(steps, 100))


def local_devices(device: torch.device) -> int:
    return torch.cuda.device_count() if device.type == "cuda" else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--preset", default="fsdp", choices=("fsdp", "tp", "ep", "dp"))
    ap.add_argument("--remat", default="dots", choices=("none", "dots", "full"))
    ap.add_argument("--microbatch", type=int, default=2)
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "sgdm", "adafactor"))
    ap.add_argument("--compress", default="none", choices=("none", "bf16", "int8"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 production mesh (needs 256 devices)")
    ap.add_argument("--dtype", default="f32", choices=("f32", "bf16"),
                    help="compute dtype (params stay f32)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = api.resolve_device(args.device)
    if args.production_mesh:
        mesh = make_production_mesh()
        found = local_devices(device)
        if found < mesh.size:
            sys.exit(f"--production-mesh needs {mesh.size} devices (the 16x16 mesh); "
                     f"found {found} {device.type} device(s)")
    else:
        mesh = make_host_mesh(device.type)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    shape = ShapeSpec("train", "train", args.seq, args.batch)
    policy = RunPolicy(sharding_preset=args.preset, remat=args.remat,
                       n_microbatch=args.microbatch, dtype=args.dtype,
                       optimizer=args.optimizer, grad_compress=args.compress,
                       use_pallas=True)
    opt = opt_config(args.optimizer, args.lr, args.steps)

    params = api.init(cfg, seed=0, device=device)
    opt_state = make_init_opt(cfg, policy, opt, mesh)(params)
    step_fn = make_train_step(cfg, policy, opt, mesh)

    cm = CheckpointManager(args.ckpt_dir, keep_last=2)
    start = 0
    meta, restored = cm.restore_latest({"params": params, "opt": opt_state})
    if meta is not None:
        params, opt_state = restored["params"], restored["opt"]
        start = meta["step"]
        print(f"[launch] resumed from step {start}", flush=True)

    pf = Prefetcher(SyntheticLM(cfg, shape, seed=0), start_step=start)
    ctl = ElasticController(["host0"], hosts_per_pod=1,
                            chips_per_host=local_devices(device),
                            model_axis=mesh.shape.get("model", 1),
                            multi_pod="pod" in mesh.shape)
    print(f"[launch] {cfg.name}: {api.n_params(cfg):,} params on {device} "
          f"{mesh.shape}; policy={args.preset}/{args.remat}/mb{args.microbatch}/"
          f"{args.optimizer}/{args.dtype}/compress {args.compress}", flush=True)
    try:
        for i in range(start, start + args.steps):
            t0 = time.perf_counter()
            _, batch = pf.next()
            batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            params, opt_state, m = step_fn(params, opt_state, batch)
            loss = float(m["loss"])                     # waits for the step
            dt = time.perf_counter() - t0
            ctl.on_step({"host0": dt})
            if i - start < 10 or i % 10 == 0 or i == start + args.steps - 1:
                print(f"step {i:5d} loss {loss:.4f} grad_norm "
                      f"{float(m['grad_norm']):.4f} {dt * 1e3:7.0f} ms", flush=True)
            if (i + 1) % args.ckpt_every == 0:
                cm.save(i + 1, {"params": params, "opt": opt_state})
        cm.save(start + args.steps, {"params": params, "opt": opt_state})
        cm.wait()
    finally:
        pf.close()
    print("[launch] done")


if __name__ == "__main__":
    main()
