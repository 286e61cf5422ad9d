"""Import firewall: the port loads with JAX blocked and loads nothing of the
JAX package; its sources name neither in an import statement."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "repro loaded:", bad)
assert not bad, bad
for n in ("repro_torch.train.optimizer", "repro_torch.train.train_step",
          "repro_torch.data.pipeline", "repro_torch.launch.train",
          "repro_torch.hw", "repro_torch.launch.sharding", "repro_torch.launch.mesh",
          "repro_torch.launch.steps", "repro_torch.launch.traceanalysis",
          "repro_torch.launch.xlaforms", "repro_torch.core.parity",
          "repro_torch.core.benchscale", "repro_torch.core.analytic",
          "repro_torch.core.counters", "repro_torch.core.searchspace",
          "repro_torch.core.anomaly", "repro_torch.kernels.traceable",
          "repro_torch.core.measure_cache", "repro_torch.core.surrogate",
          "repro_torch.core.batching", "repro_torch.core.engine",
          "repro_torch.core.mfs", "repro_torch.core.sa", "repro_torch.core.catalog",
          "repro_torch.examples.collie_search", "repro_torch.core.random_search",
          "repro_torch.core.bo", "repro_torch.core.minimize",
          "repro_torch.launch.dryrun", "repro_torch.ckpt.checkpoint",
          "repro_torch.runtime.elastic", "repro_torch.examples.quickstart",
          "repro_torch.examples.serve_lm", "repro_torch.examples.train_lm",
          "repro_torch.examples.elastic_train"):
    assert n in names, n
import torch.distributed as dist
assert not dist.is_initialized()     # importing starts no process group
assert sys.modules["jax"] is None
"""


def test_port_imports_without_jax_or_reference():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "repro loaded: []" in r.stdout
    n = int(r.stdout.split()[0])
    assert n >= 25, r.stdout            # every module of slices 1 and 2 was walked


def test_port_sources_import_neither_jax_nor_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
