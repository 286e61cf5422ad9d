"""Build the CUDA kernels from ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/repro_torch_kernels/`` at the repository
root, named by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source is rebuilt and an unchanged one is loaded as it
is.  ``build()`` starts one ``nvcc`` per
missing source, all at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "rglru_scan",
           "rwkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    digest = hashlib.sha256()
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` said when ``name`` was built (registers, spills)."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel.  Returns seconds per build."""
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    times, errors = {}, []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu (rc {proc.returncode}):\n{out}")
            continue
        lib_path(n).with_suffix(".log").write_text(out)
        os.replace(tmp, lib_path(n))       # atomic: concurrent builders agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
