"""Fault-tolerance demo: training with simulated host failures — heartbeat
detection, elastic re-mesh planning, checkpoint restart, straggler flags.
The port's counterpart of the JAX package's ``examples/elastic_train.py``.

  PYTHONPATH=src python -m repro_torch.examples.elastic_train --device cpu

It runs on ``cuda`` unless given ``--device cpu``.  The smoke config's head
dim (16) is below the attention kernels' (32-256), so this runs the plain
attention, as the reference's example does.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from ..ckpt.checkpoint import CheckpointManager
from ..configs.all_archs import smoke_config
from ..configs.base import RunPolicy, ShapeSpec
from ..data.pipeline import SyntheticLM
from ..models import api
from ..runtime.elastic import ElasticController
from ..train.optimizer import OptConfig
from ..train.train_step import make_init_opt, make_train_step

FAILED_AT = 12          # host7 stops beating from this step on


class SimClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.elastic_train")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = api.resolve_device(args.device)

    cfg = smoke_config("tinyllama-1.1b")
    shape = ShapeSpec("el", "train", 64, 8)
    policy = RunPolicy(remat="none", dtype="f32")
    opt = OptConfig(lr=1e-3, warmup=5, decay_steps=100)
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_")

    hosts = [f"host{i}" for i in range(8)]
    clock = SimClock()
    ctl = ElasticController(hosts, hosts_per_pod=4, chips_per_host=4,
                            model_axis=4, multi_pod=True,
                            heartbeat_timeout_s=5, clock=clock)

    params = api.init(cfg, seed=0, device=device)
    st = make_init_opt(cfg, policy, opt)(params)
    step_fn = make_train_step(cfg, policy, opt)
    pipe = SyntheticLM(cfg, shape, seed=0)
    cm = CheckpointManager(ckpt_dir, async_write=False)

    i = 0
    while i < args.steps:
        clock.t += 1.0
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch(i).items()}
        params, st, m = step_fn(params, st, batch)
        # all hosts beat except host7 after the simulated failure
        times = {h: 1.0 for h in hosts if not (h == "host7" and i >= FAILED_AT)}
        times["host3"] = 1.8 if i % 3 == 0 else 1.0   # intermittent straggler
        ctl.on_step(times)
        if i % 5 == 0:
            cm.save(i, {"params": params, "opt": st})
            print(f"step {i:3d} loss {float(m['loss']):.3f} [checkpoint]")
        restart, plan, stragglers = ctl.check()
        if stragglers:
            print(f"step {i:3d} stragglers flagged: {stragglers}")
        if restart:
            print(f"step {i:3d} HOST FAILURE detected: {plan.dropped_hosts} "
                  f"-> new mesh {dict(zip(plan.axis_names, plan.mesh_shape))}"
                  f" ({plan.note})")
            meta, restored = cm.restore_latest({"params": params, "opt": st})
            params, st = restored["params"], restored["opt"]
            i = meta["step"]
            print(f"         resumed from checkpoint step {i}")
            # (on a real fleet: rebuild the step with the plan's mesh and placements)
        i += 1
    print("survived the failure; final loss",
          float(m["loss"]))


if __name__ == "__main__":
    main()
