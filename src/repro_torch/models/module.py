"""Minimal parameter system: ``ParamSpec`` trees materialised as torch tensors.

Parameters are declared as nested dicts of ``ParamSpec`` (shape + logical axis
names + initializer) built by pure functions of the model config, exactly as
in the JAX package, so the two packages hold the same parameter tree.  Each
leaf is drawn from its own ``torch.Generator`` seeded from the run seed and a
CRC of the leaf's path, so init is deterministic per path and independent of
tree order.  The draws differ from the JAX package's ``jax.random`` bits; the
tests carry weights across with ``api.from_numpy_params`` instead.
"""
from __future__ import annotations

import math
import zlib
from typing import Any, Callable, NamedTuple

import torch


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple              # logical axis name per dim (str or None)
    init: str = "normal"     # normal | zeros | ones | uniform_scale | embed
    scale: float = 1.0       # stddev multiplier (normal) / bound (uniform)
    dtype: Any = None        # None -> use the default param dtype


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_paths(tree, prefix=()):
    """Yield (path, leaf) for a nested-dict tree of ParamSpecs."""
    if is_spec(tree):
        yield prefix, tree
        return
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            yield from tree_paths(tree[k], prefix + (k,))
        return
    raise TypeError(f"unexpected node {type(tree)} at {prefix}")


def _path_generator(seed: int, path, device) -> torch.Generator:
    h = zlib.crc32("/".join(path).encode())
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 32 | h) & (2**63 - 1))
    return g


def _init_one(spec: ParamSpec, gen, device, default_dtype):
    dtype = spec.dtype or default_dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init in ("normal", "embed"):
        if spec.init == "normal":
            fan_in = spec.shape[0] if len(spec.shape) >= 1 else 1
            std = spec.scale / math.sqrt(max(fan_in, 1))
        else:
            std = 0.02 * spec.scale
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(std).to(dtype)
    if spec.init == "uniform_scale":
        x = torch.rand(spec.shape, generator=gen, dtype=torch.float32,
                       device=device)
        return x.mul_(2.0).sub_(1.0).mul_(spec.scale).to(dtype)
    raise ValueError(spec.init)


def init_params(specs, seed: int, device, default_dtype=torch.float32):
    """Materialise a ParamSpec tree into a nested dict of tensors on ``device``."""
    device = torch.device(device)

    def walk(tree, prefix):
        if is_spec(tree):
            return _init_one(tree, _path_generator(seed, prefix, device),
                             device, default_dtype)
        return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
    return walk(specs, ())


def param_shapes(specs, default_dtype=torch.float32):
    """Tree of meta tensors (shape and dtype, no storage)."""
    def walk(tree):
        if is_spec(tree):
            return torch.empty(tree.shape, dtype=tree.dtype or default_dtype,
                               device="meta")
        return {k: walk(v) for k, v in tree.items()}
    return walk(specs)


def count_params(specs) -> int:
    return int(sum(math.prod(s.shape) for _, s in tree_paths(specs)))


def stack_layer_specs(spec: ParamSpec, n_layers: int) -> ParamSpec:
    """Prepend a stacked 'layers' dim to a per-layer spec."""
    return ParamSpec((n_layers,) + spec.shape, ("layers",) + spec.axes,
                     spec.init, spec.scale, spec.dtype)


def map_specs(fn: Callable[[ParamSpec], ParamSpec], tree):
    if is_spec(tree):
        return fn(tree)
    return {k: map_specs(fn, v) for k, v in tree.items()}


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def flatten(tree, prefix=()):
    """[(path, leaf)] of a nested dict of tensors, keys sorted at each level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def unflatten(items):
    """The nested dict that ``flatten`` took apart, from (path, leaf) pairs."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out
