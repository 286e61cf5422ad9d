"""What makes the kernel wrappers traceable: each kernel is a
``torch.library.custom_op`` with a fake implementation (output shapes and
strides, no pointer read, nothing launched), a FLOP formula
(``torch.utils.flop_counter``) and a DTensor sharding rule.

An eager call on plain tensors calls the implementation directly (``call``),
so serving and training do not pay the op dispatcher on every launch.

A sharding rule lists, for one mesh dim, the placements the op accepts
(output placements, then one per argument, None for a non-tensor); DTensor
expands them to the whole mesh and redistributes any input that fits none.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula


def visible_pairs(Sq, Skv, window, causal_shift) -> int:
    """(query, key) pairs that causal attention with ``window`` and
    ``causal_shift`` computes: query i (absolute i + shift) sees keys
    max(0, i + shift - window + 1) .. min(i + shift, Skv - 1)."""
    qa = np.arange(Sq, dtype=np.int64) + int(causal_shift)
    hi = np.minimum(qa, Skv - 1)
    lo = np.zeros_like(qa) if window is None else np.maximum(qa - int(window) + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def call(op, impl, *args):
    """``impl(*args)`` where every tensor argument is a plain tensor (an
    eager call, on the card or the CPU: the op dispatcher's per-call cost is
    skipped); the custom op ``op`` otherwise (fake tensors and DTensors, the
    measurement's traces)."""
    if all(type(a) is torch.Tensor for a in args if isinstance(a, torch.Tensor)):
        return impl(*args)
    return op(*args)


def flops(op):
    """Register ``fn(*shapes and other args, out_shape)`` as ``op``'s FLOPs."""
    return register_flop_formula(op)


def mesh_divides(spec, *sizes) -> bool:
    """Every mesh dim of ``spec``'s mesh divides every one of ``sizes``."""
    return all(s % n == 0 for n in spec.mesh.shape for s in sizes)


def shardings(op):
    """Register ``fn(*args) -> [(out placements, in placements)]`` for ``op``."""
    return register_sharding(op)


R = Replicate()
S = Shard
