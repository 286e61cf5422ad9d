"""THE paper's tool, end to end: search a restricted workload space for
performance anomalies, print their Minimal Feature Sets, and give the
application-design advice of paper §7.3.

Mirrors the paper's RPC-library case study: a developer restricts the space
to what their application can generate (here: serving a dense GQA model),
Collie reports which regions of that space are anomalous and which condition
to break.  The port's counterpart of the JAX package's
``examples/collie_search.py``: the same space, counters and seeds, and the
same output.  Each point is traced on fake ``--device`` tensors over a fake
process group that stands for the bench meshes' ranks (no device count to
force, nothing allocated or launched).

  PYTHONPATH=src python -m repro_torch.examples.collie_search --device cpu --budget 24

``COLLIE_WORKERS``, ``COLLIE_CACHE`` and the other ``COLLIE_*`` variables
configure the engine.  ``--report PATH`` also writes the run as JSON: the
events, the anomalies, the engine's stats, the ops the traces ran
replicated (in all, and by the traced point's arch, preset, shape kind and
microbatch count) and the messages of failed traces.
"""
from __future__ import annotations

import argparse
import json
import os

from ..core.benchscale import BENCH_SHAPES, bench_archs, bench_meshes
from ..core.catalog import render_markdown
from ..core.engine import Engine
from ..core.sa import campaign, rank_counters
from ..core.searchspace import SearchSpace

COUNTERS = ["diag.collective_blowup", "diag.memory_overshoot",
            "perf.roofline_efficiency"]


def report(result, engine) -> dict:
    """The run as JSON-ready data (``t`` and ``wall_s`` left out, so that two
    runs of one search give equal reports)."""
    return {
        "events": [{"n_spent": e.n_spent, "point": e.point,
                    "kinds": sorted(e.kinds), "counter_value": e.counter_value,
                    "mfs": None if e.new_mfs is None else e.new_mfs.describe()}
                   for e in result.events],
        "anomalies": [{"kind": a.kind,
                       "conditions": {k: list(v) for k, v in a.conditions.items()},
                       "witness": a.witness} for a in result.anomalies],
        "n_attempts": result.n_attempts,
        "stats": engine.stats(),
        "replicated_ops": dict(engine.replicated_ops),
        "replicated_at": [[list(cls or ()), ops]
                          for cls, ops in sorted(engine.replicated_at.items(), key=str)],
        "errors": list(engine.errors),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=int, default=60)
    ap.add_argument("--restrict", action="store_true", default=True,
                    help="restrict to the 'serving a dense model' sub-space")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors the traces run on")
    ap.add_argument("--report", default=None,
                    help="also write the run as JSON to this path")
    args = ap.parse_args(argv)

    restrict = {"arch": ("qwen2-1.5b", "tinyllama-1.1b"),
                "shape": ("prefill_s", "decode_s"),
                "grad_compress": ("none",)} if args.restrict else None
    space = SearchSpace(bench_archs(["qwen2-1.5b", "tinyllama-1.1b",
                                     "mixtral-8x7b"]),
                        BENCH_SHAPES, restrict=restrict)
    print(f"restricted search space: {space.size():.3g} points")
    eng = Engine(space, bench_meshes(), device=args.device)

    ranked = rank_counters(eng, space, COUNTERS, seed=5)
    order = [(c, "max" if c.startswith("diag.") else "min") for c in ranked]
    r = campaign(eng, space, order, seed=3, budget_compiles=args.budget)

    print(f"\n{len(r.anomalies)} anomalies in {r.n_attempts} attempts "
          f"({r.wall_s:.0f}s)\n")
    print(render_markdown(r.anomalies, "Anomalies in the restricted space"))

    print("\n-- design advice (paper §7.3 analogue) --")
    if not r.anomalies:
        print("no anomalies: any workload in this sub-space is safe "
              "(assuming the restriction captures the application).")
    for a in r.anomalies:
        breakable = [f"{f} (use any of "
                     f"{sorted(set(space.factors[f]) - set(v))})"
                     for f, v in a.conditions.items()
                     if f not in ("arch", "shape")
                     and set(v) != set(space.factors[f])]
        if breakable:
            print(f"* {a.describe()}\n    avoid by breaking: "
                  + "; or ".join(breakable[:3]))
        else:
            print(f"* {a.describe()}\n    intrinsic to this workload cell — "
                  "report to the platform team (vendor analogue)")
    eng.close()
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report(r, eng), f, indent=1, default=str)


if __name__ == "__main__":
    main()
