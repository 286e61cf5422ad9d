"""Anomaly catalog: persistence + Table-2-style rendering."""
from __future__ import annotations

import dataclasses
import json
import os

from .mfs import MFS


def save_catalog(anomalies: list, path: str, meta: dict | None = None):
    d = os.path.dirname(path)
    if d:                       # bare filenames have no directory to create
        os.makedirs(d, exist_ok=True)
    data = {"meta": meta or {}, "anomalies": [
        {"kind": a.kind, "conditions": {k: list(v) for k, v in
                                        a.conditions.items()},
         "witness": a.witness, "counters": a.counters,
         "n_tests": a.n_tests} for a in anomalies]}
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=str)


def load_catalog(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    return [MFS(a["kind"], {k: tuple(v) for k, v in a["conditions"].items()},
                a["witness"], a.get("counters"), a.get("n_tests", 0))
            for a in data["anomalies"]]


_SYMPTOM = {
    "A1": "step >> analytic floor",
    "A2": "collective traffic blow-up",
    "A3": "compute replication/waste",
    "A4": "HBM oversubscription",
}


def render_markdown(anomalies: list, title: str = "Anomaly catalog") -> str:
    lines = [f"### {title}", "",
             "| # | kind | symptom | trigger conditions (MFS) | witness cell |",
             "|---|------|---------|--------------------------|--------------|"]
    for i, a in enumerate(anomalies, 1):
        conds = "; ".join(f"{k}∈{{{','.join(map(str, v))}}}"
                          for k, v in sorted(a.conditions.items())
                          if k not in ("arch", "shape"))
        cell = f"{a.witness.get('arch')}×{a.witness.get('shape')}"
        arch_cond = a.conditions.get("arch")
        shape_cond = a.conditions.get("shape")
        scope = []
        if arch_cond:
            scope.append(f"arch∈{{{','.join(arch_cond)}}}")
        if shape_cond:
            scope.append(f"shape∈{{{','.join(shape_cond)}}}")
        conds = "; ".join(scope + ([conds] if conds else []))
        lines.append(f"| {i} | {a.kind} | {_SYMPTOM[a.kind]} | {conds or 'any'}"
                     f" | {cell} |")
    return "\n".join(lines)
