"""Multi-pod dry-run driver: the counterpart of the JAX package's
``launch/dryrun.py``.

Traces every (architecture x input shape) cell on the production mesh —
16x16 single-pod (256 ranks) and 2x16x16 multi-pod (512 ranks) of the fake
process group (``launch/mesh.py``) — and records the trace's memory,
counters and roofline terms, one JSON file a cell, under ``results_torch/
dryrun/`` (``--out``).  The fake group sets the rank count, so no device
flag is needed.  The kernels are off (``RunPolicy.use_pallas`` defaults to
False), as in the reference.  A cell whose trace runs an op replicated that
``core/parity.py``'s ``REPLICATED_OPS`` does not admit at its class fails.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \
      --shape train_4k --mesh multi
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

from ..configs.base import SHAPES, RunPolicy, default_preset, get_config, list_archs
from ..core import counters, parity
from ..train.optimizer import OptConfig
from .mesh import make_production_mesh
from .steps import build_cell

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "results_torch" / "dryrun")


def default_policy(cfg, shape, **overrides) -> RunPolicy:
    """Paper-faithful baseline policy per cell."""
    base = dict(sharding_preset=default_preset(cfg))
    if shape.kind == "train":
        base.update(remat="full", n_microbatch=8)
    else:
        # inference: bf16 params, no remat
        base.update(remat="none", n_microbatch=1, params_f32=False)
    base.update(overrides)
    return RunPolicy(**base)


def cell_applicable(cfg, shape) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "skipped: full-attention arch at 524k decode " \
                      "(quadratic by construction; see DESIGN.md)"
    return True, ""


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             policy: RunPolicy | None = None, opt: OptConfig | None = None,
             device: str = "cuda"):
    """One cell traced on fake ``device`` tensors: the reference's summary
    keys, the ops the trace ran replicated (and those ``REPLICATED_OPS``
    does not admit at the cell's class) and the host seconds of the cell."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "status": "skipped", "reason": why}
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    policy = policy or default_policy(cfg, shape)
    cell = build_cell(cfg, shape, policy, mesh, opt)
    m = counters.measure_cell(cell, device=device)
    out = m.summary()
    replicated = m.hlo["replicated_ops"]
    out.update({"status": "ok", "mesh_kind": "multi" if multi_pod else "single",
                "replicated_ops": replicated,
                "unlisted_replications": parity.unlisted_replications(
                    replicated, cfg.name, policy.sharding_preset, shape.kind,
                    policy.n_microbatch),
                "host_s": time.perf_counter() - t0})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--preset", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--compress", default=None)
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--device", default="cuda", help="the fake tensors' device type")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(arch, shape) for arch in list_archs() for shape in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in cells:
        for mp in meshes:
            tag = f"{arch}__{shape_name}__{'multi' if mp else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            t0 = time.perf_counter()
            try:
                overrides = {}
                cfg = get_config(arch)
                shape = SHAPES[shape_name]
                if args.preset:
                    overrides["sharding_preset"] = args.preset
                if args.remat:
                    overrides["remat"] = args.remat
                if args.microbatch:
                    overrides["n_microbatch"] = args.microbatch
                if args.compress:
                    overrides["grad_compress"] = args.compress
                policy = default_policy(cfg, shape, **overrides)
                res = run_cell(arch, shape_name, mp, policy, device=args.device)
                if res.get("unlisted_replications"):
                    res["status"] = "fail"
                    res["error"] = ("ops run replicated outside parity.REPLICATED_OPS: "
                                    f"{res['unlisted_replications']}")
                with open(path, "w") as f:
                    json.dump(res, f, indent=1, default=str)
                if res["status"] == "ok":
                    r = res["roofline"]
                    print(f"[ok] {tag}: dominant={r['dominant']} "
                          f"bound={r['bound_s']*1e3:.2f}ms "
                          f"useful={r['useful_flops_ratio']:.3f} "
                          f"peak={res['memory']['peak_bytes']/2**30:.1f}GiB "
                          f"compile={res['compile_s']:.1f}s host={res['host_s']:.1f}s "
                          f"replicated={json.dumps(res['replicated_ops'])}", flush=True)
                elif res["status"] == "fail":
                    failures += 1
                    print(f"[FAIL] {tag}: {res['error']}", flush=True)
                else:
                    print(f"[skip] {tag}: {res['reason']}", flush=True)
            except Exception as e:
                failures += 1
                print(f"[FAIL] {tag}: {e} (host={time.perf_counter() - t0:.1f}s)",
                      flush=True)
                traceback.print_exc()
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape_name,
                               "status": "fail", "error": str(e)}, f)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
