"""Atomic, versioned, async checkpointing with integrity checks and resume:
the counterpart of the JAX package's ``ckpt/checkpoint.py``, with its API
and its on-disk layout, so that either package restores the other's.

Layout:  <dir>/step_<N>/{arrays.npz, meta.json}   (+ <dir>/step_<N>.tmp while
writing; the atomic directory rename publishes the checkpoint).  Each array
records a CRC32 in meta.json; restore skips corrupt or partial checkpoints
and falls back to the newest valid one.  Keys are the tree's paths, dict
keys sorted and list indices, joined with "/".

``save`` copies every leaf to host memory before the writer thread starts:
the optimizer updates the params and its state in place, so a thread that
read the live tensors would race the next step.  A bf16 tensor is written
as the JAX package writes one, two-byte void records (``|V2``) of its bits;
on restore every leaf is viewed (void records) or cast through the
template's dtype.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten_into(template, flat):
    def walk(t, prefix):
        if isinstance(t, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, prefix + (str(i),)) for i, v in enumerate(t))
        return flat["/".join(prefix)]
    return walk(template, ())


def _to_host(v) -> np.ndarray:
    """A leaf as a host array of its own (a copy, also of a CPU tensor); a
    bf16 tensor as ``|V2`` records of its bits."""
    if not isinstance(v, torch.Tensor):
        return np.array(v)
    t = v.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _as_template(a: np.ndarray, like, device):
    """``a`` (as ``np.load`` gives it) in the dtype of the template leaf
    ``like``, a tensor on ``device`` (or ``like``'s device), or an array."""
    if not isinstance(like, torch.Tensor):
        like = np.asarray(like)
        return a.view(like.dtype) if a.dtype.kind == "V" else a.astype(like.dtype)
    if a.dtype.kind == "V":
        bits = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize]
        t = torch.from_numpy(a.view(bits).copy()).view(like.dtype)
    else:
        t = torch.from_numpy(np.array(a)).to(like.dtype)
    return t.to(like.device if device is None else device)


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3, async_write: bool = True):
        self.dir = directory
        self.keep_last = keep_last
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra_meta: dict | None = None):
        host = {k: _to_host(v) for k, v in _flatten(tree)}
        self.wait()
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra_meta or {}))
            self._thread.start()
        else:
            self._write(step, host, extra_meta or {})

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, extra_meta: dict):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        crcs = {k: zlib.crc32(np.ascontiguousarray(v).tobytes()) for k, v in host.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        meta = {"step": step, "crcs": crcs, **extra_meta}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def list_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)

    def _valid(self, step: int) -> dict | None:
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            data = np.load(os.path.join(path, "arrays.npz"))
            flat = {}
            for k, crc in meta["crcs"].items():
                v = data[k]
                if zlib.crc32(np.ascontiguousarray(v).tobytes()) != crc:
                    return None
                flat[k] = v
            return {"meta": meta, "flat": flat}
        except Exception:
            return None

    def restore_latest(self, template, device=None):
        """Restore the newest valid checkpoint into ``template``'s structure
        and dtypes.  Returns (meta, tree) or (None, None).  Tensors land on
        ``device``, or where the template's leaves are."""
        for step in reversed(self.list_steps()):
            got = self._valid(step)
            if got is None:
                continue
            like = dict(_flatten(template))
            flat = {k: _as_template(a, like[k], device) for k, a in got["flat"].items()
                    if k in like}
            return got["meta"], _unflatten_into(template, flat)
        return None, None
