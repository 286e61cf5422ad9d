"""The measurement layer: trace a workload cell, harvest counters.

The counterpart of the JAX package's ``core/counters.py``, with the same
counter names and formulas.  The paper's two counter classes:

* performance counters — roofline-efficiency / useful-FLOP fraction (driven
  to LOW-value regions by the search);
* diagnostic counters — collective-traffic blowup, layout-thrash bytes, remat
  duplication, memory overshoot, sharding fallbacks (driven HIGH).

Two phases, as in the reference:

* :func:`lower_cell` — the step traced once on global fake tensors (the
  un-partitioned program, ``Cell.lower``) and a **structural fingerprint**:
  a hash of the canonical op log, the resolved spec of every input and of
  every ``maybe_constrain`` call (the reference's pre-XLA text carries its
  shardings; the global trace does not), the analytic floors, the
  sharding fallbacks, the mesh size and the chip.  Equal fingerprints imply
  equal counters.
* :func:`compile_lowered` — the step traced on the mesh's DTensors
  (``Cell.trace``: each device's program with its collectives, the
  counterpart of XLA's partitioned module), analysed by
  ``launch.traceanalysis`` and assembled into a :class:`Measurement`.

:func:`lowered_counters` is the fidelity-1 tier: the global trace's counters
divided by the mesh size, collectives and peak memory absent.

Fake tensors live on ``device`` (``cuda`` by default; the CPU tests pass
``"cpu"``): nothing is allocated or launched either way.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Any

from .. import hw
from . import analytic


@dataclasses.dataclass
class Measurement:
    cell: Any
    compile_s: float
    memory: dict
    cost_analysis: dict
    hlo: dict
    roofline: dict
    floors: dict
    perf: dict          # performance counters (lower = worse)
    diag: dict          # diagnostic counters (higher = more stressed)

    def summary(self) -> dict:
        return {
            "arch": self.cell.cfg.name, "shape": self.cell.shape.name,
            "mesh": dict(self.cell.mesh.shape), "compile_s": self.compile_s,
            "memory": self.memory, "roofline": self.roofline,
            "floors": {k: v for k, v in self.floors.items()},
            "perf": self.perf, "diag": self.diag,
            "hlo": {k: v for k, v in self.hlo.items() if k != "op_hist"},
            "policy": dataclasses.asdict(self.cell.policy),
        }

    def counters(self) -> dict:
        """The flat ``perf.*`` / ``diag.*`` dict that ``anomaly.detect`` reads."""
        return {**{f"perf.{k}": v for k, v in self.perf.items()},
                **{f"diag.{k}": v for k, v in self.diag.items()}}


# ------------------------------------------------------------ lower phase

@dataclasses.dataclass
class LoweredCell:
    """Phase-1 artifact: the global trace of a cell and its fingerprint."""
    cell: Any
    lowered: Any            # steps.Trace on global fake tensors
    text: str               # the canonical op log
    lower_s: float
    floors: dict
    mf_useful: float
    fingerprint: str
    device: str = "cuda"


def _floors_of(cell, chip: hw.ChipSpec):
    floors = analytic.step_floor_seconds(cell.cfg, cell.shape, cell.policy,
                                         cell.mesh, chip)
    mf_useful = (floors["matmul_model_flops"]
                 + analytic.attention_flops(cell.cfg, cell.shape)
                 + analytic.recurrence_flops(cell.cfg, cell.shape))
    return floors, mf_useful


def _specs_text(cell, constraints) -> str:
    """The resolved specs of every input leaf and every constraint call."""
    def walk(t, path):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(t[k], path + (k,))]
        return [f"{'/'.join(path)}={t!r}"]
    lines = [x for i, s in enumerate(cell.in_specs) for x in walk(s, (f"arg{i}",))]
    lines += [f"constrain{shape}{axes}={spec}" for shape, axes, spec in constraints]
    return "\n".join(lines)


def lower_cell(cell, chip: hw.ChipSpec = hw.V5E, device: str = "cuda") -> LoweredCell:
    """Trace the step on global fake tensors and fingerprint its structure."""
    from ..launch import traceanalysis
    t0 = time.time()
    lowered = cell.lower(device)
    text = traceanalysis.canonical_log(lowered.records)
    lower_s = time.time() - t0
    floors, mf_useful = _floors_of(cell, chip)
    h = hashlib.sha256(text.encode())
    h.update(_specs_text(cell, lowered.constraints).encode())
    h.update(json.dumps(
        {"floors": {k: float(v) for k, v in sorted(floors.items())},
         "mf_useful": float(mf_useful),
         "fallbacks": int(cell.stats.fallbacks),
         "mesh_size": int(cell.mesh.size),
         "chip": chip.name},
        sort_keys=True).encode())
    return LoweredCell(cell, lowered, text, lower_s, floors, mf_useful,
                       h.hexdigest()[:24], device)


def lowered_counters(lc: LoweredCell, chip: hw.ChipSpec = hw.V5E) -> dict:
    """Fidelity-1 structural counters from the global trace (no mesh).

    The global trace computes the whole program, so structure-derived
    quantities are global and scaled per device by the mesh size.  Collective
    counts and peak memory are absent (the engine overlays estimates).
    """
    hlo = lc.lowered.analyze()
    n = max(lc.cell.mesh.size, 1)
    floors = lc.floors
    flops_dev = hlo["flops"] / n
    bytes_dev = hlo["bytes_hbm"] / n
    compute_s = flops_dev / chip.peak_flops_bf16
    memory_s = bytes_dev / chip.hbm_bw
    # collective term is unknown without the mesh: bound by its floor
    bound_s = max(compute_s, memory_s, floors["collective_s"])
    return {
        "perf.roofline_efficiency":
            min(floors["floor_s"] / max(bound_s, 1e-30), 1.0),
        "perf.useful_flops_ratio":
            lc.mf_useful / max(hlo["flops"], 1.0),
        "diag.transpose_bytes": hlo["transpose_bytes"] / n,
    }


# ---------------------------------------------------------- compile phase

def compile_lowered(lc: LoweredCell, chip: hw.ChipSpec = hw.V5E) -> Measurement:
    """Trace the step on the mesh's DTensors and assemble the counters."""
    cell = lc.cell
    t0 = time.time()
    trace = cell.trace(lc.device)
    compile_s = lc.lower_s + (time.time() - t0)
    cell.release_lowered()
    hlo = trace.analyze()
    memory = {
        "argument_bytes": trace.arg_bytes,
        "output_bytes": trace.out_new_bytes,
        "temp_bytes": trace.max_live,
        "alias_bytes": min(trace.donated_bytes, trace.out_new_bytes),
        "peak_bytes": hlo["peak_bytes"],
    }

    n = cell.mesh.size
    # per-device quantities straight from the traced local shards
    flops_dev = hlo["flops"]
    bytes_dev = hlo["bytes_hbm"]
    wire_dev = hlo["collective_wire_total"]
    compute_s = flops_dev / chip.peak_flops_bf16
    memory_s = bytes_dev / chip.hbm_bw
    coll_s = wire_dev / chip.ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dom = max(terms, key=terms.get)
    bound_s = terms[dom]

    floors = lc.floors
    mf = floors["assignment_model_flops"]
    # scale-stable numerator: matmul params + attention + recurrence terms
    mf_useful = lc.mf_useful
    total_hlo_flops = flops_dev * n
    roofline = {
        **terms, "dominant": dom, "bound_s": bound_s,
        "hlo_flops_per_dev": flops_dev, "hlo_bytes_per_dev": bytes_dev,
        "collective_wire_per_dev": wire_dev,
        "collective_bytes_per_dev": hlo["collective_bytes_total"],
        "model_flops": mf,
        "model_flops_ratio": mf / max(total_hlo_flops, 1.0),
        "useful_flops_ratio": mf_useful / max(total_hlo_flops, 1.0),
        "roofline_fraction": floors["compute_s"] / max(bound_s, 1e-30),
    }

    perf = {
        # fraction of ideal step time actually achievable (<=1; low = anomaly)
        "roofline_efficiency": min(floors["floor_s"] / max(bound_s, 1e-30), 1.0),
        "useful_flops_ratio": roofline["useful_flops_ratio"],
    }
    peak = memory["peak_bytes"]
    diag = {
        "collective_blowup": wire_dev / max(floors["collective_floor"], 16e6),
        "collective_wire_bytes": wire_dev,
        "transpose_bytes": hlo["transpose_bytes"],
        "remat_flops_frac": hlo["remat_flops"] / max(flops_dev, 1.0),
        "memory_overshoot": peak / max(floors["memory_floor"], 1.0),
        "peak_bytes": peak,
        "hbm_oversubscribed": peak / chip.hbm_bytes,
        "shard_fallbacks": cell.stats.fallbacks,
        "n_allgather": hlo["collective_count"].get("all-gather", 0),
        "n_allreduce": hlo["collective_count"].get("all-reduce", 0),
        "n_alltoall": hlo["collective_count"].get("all-to-all", 0),
        "n_permute": hlo["collective_count"].get("collective-permute", 0),
    }
    return Measurement(cell, compile_s, memory, {}, hlo, roofline, floors, perf, diag)


def measure_cell(cell, chip: hw.ChipSpec = hw.V5E, device: str = "cuda") -> Measurement:
    """One-shot lower + compile + analyze, on fake ``device`` tensors."""
    return compile_lowered(lower_cell(cell, chip, device), chip)


def main(argv=None):
    """``python -m repro_torch.core.counters --arch qwen2-1.5b --shape train_s``:
    measure one bench point and print its counters and anomaly kinds."""
    import argparse
    from . import anomaly
    from .benchscale import BENCH_SHAPES, bench_archs, bench_meshes
    from .searchspace import SearchSpace
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--shape", default="train_s", choices=sorted(BENCH_SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--preset", default="fsdp", choices=("fsdp", "tp", "ep", "dp"))
    ap.add_argument("--remat", default="none", choices=("none", "dots", "full"))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    space = SearchSpace(bench_archs([a.arch]), BENCH_SHAPES)
    point = {k: v[0] for k, v in space.factors.items()}
    point.update(arch=a.arch, shape=a.shape, mesh=a.mesh, preset=a.preset, remat=a.remat,
                 n_microbatch=1, grad_compress="none", seq_shard=True, cache_shard=True,
                 vocab_shard=True, scan_layers=True, attn_impl="auto", zero1=True,
                 optimizer="adamw", params_f32=True)
    cfg, shape, policy, mesh_kind = space.to_run(space.normalize(point))
    from ..launch.steps import build_cell
    m = measure_cell(build_cell(cfg, shape, policy, bench_meshes()[mesh_kind]),
                     device=a.device)
    c = m.counters()
    print(json.dumps({"counters": c, "trace_s": m.compile_s,
                      "kinds": sorted(anomaly.kinds(c, policy.remat))}, indent=1))


if __name__ == "__main__":
    main()
