"""Logical-axis sharding rules with divisibility fallback, resolved to DTensor
placements.

A *rule set* maps logical axis names (declared in ParamSpecs and activation
annotations) to an ordered list of candidate mesh-axis tuples.  For each
tensor dim the first candidate whose mesh axes (a) all exist in the active
mesh, (b) are not already used by another dim of the same tensor, and
(c) whose total size divides the dim size, wins; otherwise the dim is
replicated.  ``spec_for`` gives, per tensor dim, the chosen mesh-axis names
(exactly the JAX package's PartitionSpec entries, as a tuple);
``placements_for`` turns such a spec into DTensor placements on a
``DeviceMesh`` (a dim over two mesh axes is ``Shard(d)`` on both, in order).

``maybe_constrain`` is the counterpart of ``with_sharding_constraint``:
inside ``use_rules`` it redistributes a DTensor to the resolved placements
(DTensor traces the collectives of that redistribution), and it records the
resolved spec of every call, which the measurement's fingerprint hashes.
Outside ``use_rules`` it returns its input.  The port has no ``shard_map``
yet, so there is no manual-axis branch.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Mapping, Sequence


class _Unconstrained:
    """A dim left to the propagation (the JAX package's P.UNCONSTRAINED)."""

    def __repr__(self):
        return "UNCONSTRAINED"


UNCONSTRAINED = _Unconstrained()

# ---------------------------------------------------------------- rule tables

def _rules(**kw):
    return {k: tuple(tuple(c) for c in v) for k, v in kw.items()}


_COMMON = dict(
    batch=[("pod", "data"), ("data",)],
    layers=[],
    head_dim=[],
    act_embed=[],
    norm=[],
)

PRESETS: dict[str, dict] = {
    # Fully-sharded-data-parallel flavour: params sharded over "model",
    # activations sharded on batch (+ sequence over "model").
    "fsdp": _rules(**_COMMON,
                   seq_q=[("model",)], cache_seq=[("model",)],
                   embed=[("model",)], mlp=[], heads=[], kv_heads=[],
                   q_per_kv=[], vocab=[("model",)], expert=[],
                   rec_width=[("model",)], rwkv_heads=[]),
    # Megatron-style tensor parallelism on "model".
    "tp": _rules(**_COMMON,
                 seq_q=[], cache_seq=[("model",)],
                 embed=[], mlp=[("model",)], heads=[("model",)],
                 kv_heads=[("model",)], q_per_kv=[],
                 vocab=[("model",)], expert=[],
                 rec_width=[("model",)], rwkv_heads=[("model",)]),
    # Expert parallelism on "model" (falls back to within-expert TP when the
    # expert count does not divide, e.g. mixtral 8e on a 16-way axis).
    "ep": _rules(**_COMMON,
                 seq_q=[], cache_seq=[("model",)],
                 embed=[], mlp=[("model",)], heads=[("model",)],
                 kv_heads=[("model",)], q_per_kv=[],
                 vocab=[("model",)], expert=[("model",)],
                 rec_width=[("model",)], rwkv_heads=[("model",)]),
    # Pure data parallelism (the "model" axis is folded into batch).
    "dp": _rules(**{**_COMMON, "batch": [("pod", "data", "model"),
                                         ("data", "model"),
                                         ("pod", "data"), ("data",)]},
                 seq_q=[], cache_seq=[("model",)],
                 embed=[], mlp=[], heads=[], kv_heads=[], q_per_kv=[],
                 vocab=[], expert=[], rec_width=[], rwkv_heads=[]),
}


def make_rules(preset: str = "fsdp", **overrides) -> dict:
    """Build a rule set from a preset with per-axis overrides.

    Overrides use the same format: ``axis=[("model",), ()]`` etc.; an empty
    list means "always replicate".
    """
    base = dict(PRESETS[preset])
    for k, v in overrides.items():
        base[k] = tuple(tuple(c) for c in v)
    return base


# ------------------------------------------------------------ spec resolution

class FallbackStats:
    """Diagnostic counter: how many dims fell back to replication."""
    def __init__(self):
        self.fallbacks = 0
        self.resolved = 0

    def as_dict(self):
        return {"shard_fallbacks": self.fallbacks, "shard_resolved": self.resolved}


def spec_for(shape: Sequence[int], axes: Sequence[str | None],
             rules: Mapping, mesh, *, unconstrained: bool = False,
             stats: FallbackStats | None = None) -> tuple:
    """Per tensor dim: None, a mesh-axis name, a tuple of names, or
    UNCONSTRAINED.  ``mesh`` is anything with a ``shape`` mapping of axis
    name to size (``launch.mesh.Mesh``)."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes}")
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        chosen = None
        if ax is not None:
            for cand in rules.get(ax, ()):  # unknown axis -> replicate
                if not cand:
                    continue
                if any(m not in mesh.shape for m in cand):
                    continue
                if any(m in used for m in cand):
                    continue
                total = 1
                for m in cand:
                    total *= mesh.shape[m]
                if total == 1 or dim % total != 0:
                    continue
                chosen = cand
                break
            if stats is not None:
                if chosen is None:
                    stats.fallbacks += 1
                else:
                    stats.resolved += 1
        if chosen is None:
            out.append(UNCONSTRAINED if (unconstrained and ax is not None) else None)
        else:
            used.update(chosen)
            out.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(out)


def _entry_axes(entry) -> tuple:
    if entry is None or entry is UNCONSTRAINED:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Sequence, mesh, current=None) -> tuple:
    """DTensor placements, one per mesh axis in mesh order, of a spec: a mesh
    axis named by dim d's entry is ``Shard(d)``; any other is ``Replicate()``,
    unless ``current`` (the tensor's placements) shards an UNCONSTRAINED dim
    on it, which is kept."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {m: d for d, entry in enumerate(spec) for m in _entry_axes(entry)}
    free = {d for d, entry in enumerate(spec) if entry is UNCONSTRAINED}
    out = []
    for i, name in enumerate(mesh.axis_names):
        if name in owner:
            out.append(Shard(owner[name]))
        elif current is not None and isinstance(current[i], Shard) \
                and current[i].dim in free:
            out.append(current[i])
        else:
            out.append(Replicate())
    return tuple(out)


def _leaf_shape(x):
    """The shape of a tree leaf: a tensor, or a (shape, dtype) pair."""
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return tuple(x[0])


def _is_leaf(x):
    return not isinstance(x, dict)


def tree_specs(mesh, shapes_tree, axes_tree, rules, stats=None):
    """Map a tree of shapes (tensors or (shape, dtype) leaves) and its axes
    tree to a tree of specs."""
    def walk(shapes, axes):
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], axes[k]) for k in shapes}
        return spec_for(_leaf_shape(shapes), axes, rules, mesh, stats=stats)
    return walk(shapes_tree, axes_tree)


def tree_shardings(mesh, shapes_tree, axes_tree, rules, stats=None):
    """Map a tree of shapes and its axes tree to a tree of placements."""
    def walk(spec):
        if isinstance(spec, dict):
            return {k: walk(v) for k, v in spec.items()}
        return placements_for(spec, mesh)
    return walk(tree_specs(mesh, shapes_tree, axes_tree, rules, stats))


# --------------------------------------------------------- activation context

class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules = None
        self.log = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_rules(mesh, rules: Mapping, log: list | None = None):
    """Activate ``rules`` on ``mesh`` for ``maybe_constrain``; each call's
    (shape, axes, resolved spec) is appended to ``log`` when one is given."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.log)
    _CTX.mesh, _CTX.rules, _CTX.log = mesh, rules, log
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.log = prev


def maybe_constrain(x, axes):
    """Annotate an activation with logical axes (no-op outside use_rules).

    Inside ``use_rules`` a DTensor is redistributed to the placements the
    rules resolve (a plain tensor, as in the global trace, is returned as
    it is); the resolved spec is logged either way."""
    if _CTX.mesh is None:
        return x
    spec = spec_for(tuple(x.shape), axes, _CTX.rules, _CTX.mesh, unconstrained=True)
    if _CTX.log is not None:
        _CTX.log.append((tuple(x.shape), tuple(axes), repr(spec)))
    if all(s is UNCONSTRAINED or s is None for s in spec):
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    target = placements_for(spec, _CTX.mesh, x.placements)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(x.device_mesh, target)
