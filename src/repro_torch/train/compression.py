"""Error-feedback gradient compression for cross-pod reduction.

Cross-pod links are the scarcest bandwidth in a multi-pod mesh, so gradients
crossing the "pod" axis are quantized (int8 with a shared per-tensor scale,
or bf16) before the all-reduce, with the quantization error fed back into
the next step (EF-SGD style; Seide et al., Karimireddy et al.).

The JAX package runs this inside a partial-manual ``shard_map`` over "pod";
here each function takes the pod dim's process group in place of the axis
name (None: a program of one pod, with no collective), and every collective
is one functional collective (``torch.distributed._functional_collectives``)
on that group: an f32 max and an int32 sum for int8, a bf16 sum for bf16.  The arguments are plain
tensors (a pod's whole gradient) or DTensors on the mesh of the other axes
(each rank's shard of it): a DTensor's shards are reduced over the pod group
and keep their placements, so the collectives run at the wire format's width
on each rank's shard, as XLA's partitioner runs the reference's.
"""
from __future__ import annotations

import torch

from ..models.module import flatten, unflatten


def _all_reduce(x, op: str, group):
    """``x`` reduced elementwise (``op`` "sum" or "max") over ``group`` by one
    functional all-reduce.  A DTensor (its partial sums first summed on its
    own mesh) has its local shard reduced and keeps its placements.  With no
    group (a program of one pod) ``x`` is its own reduction."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate
    if group is None:
        return x
    if isinstance(x, DTensor):
        if any(p.is_partial() for p in x.placements):
            x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                               for p in x.placements])
        local = _all_reduce(x.to_local(), op, group)
        return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())
    return funcol.wait_tensor(funcol.all_reduce(x, op, group))


def _n_members(group) -> int:
    import torch.distributed as dist
    return 1 if group is None else dist.get_world_size(group)


def _quantize_int8(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def compressed_psum_int8(g, group):
    """int8 all-reduce over ``group`` with a shared per-tensor scale.

    Returns (mean-reduced f32 gradient, local quantization error).
    """
    gf = g.float()
    amax = _all_reduce(gf.abs().amax(), "max", group)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = _quantize_int8(gf, scale)
    err = gf - q.float() * scale
    total = _all_reduce(q.to(torch.int32), "sum", group)
    return total.float() * scale / _n_members(group), err


def compressed_psum_bf16(g, group):
    gb = g.to(torch.bfloat16)
    err = g.float() - gb.float()
    return _all_reduce(gb, "sum", group).float() / _n_members(group), err


def reduce_grads(grads, ef_state, mode: str, group):
    """Reduce a grad tree over ``group`` (the pod dim's) with optional
    compression and error feedback.

    grads: per-pod mean gradients (already reduced within the pod).
    ef_state: tree of error-feedback buffers (f32, same shapes) or None.
    Returns (reduced grads, new ef_state).
    """
    if mode == "none":
        n = _n_members(group)
        return unflatten((p, _all_reduce(g.float(), "sum", group) / n)
                         for p, g in flatten(grads)), ef_state
    fn = {"int8": compressed_psum_int8, "bf16": compressed_psum_bf16}[mode]
    gl = flatten(grads)
    el = flatten(ef_state) if ef_state is not None else \
        [(p, torch.zeros_like(g, dtype=torch.float32)) for p, g in gl]
    outs = [(p, fn(g.float() + e, group)) for (p, g), (_, e) in zip(gl, el)]
    return unflatten((p, o[0]) for p, o in outs), unflatten((p, o[1]) for p, o in outs)
