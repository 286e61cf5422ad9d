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
Outside ``use_rules`` it returns its input.  Inside ``manual_axes`` (the
compressed gradient's per-pod body, the counterpart of the JAX package's
partial-manual ``shard_map``) it resolves on the mesh less those axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
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


# the rules' entry naming the mesh axis that ZeRO-1 shards the optimizer
# state over (set in a train step's rules where the policy has ZeRO-1):
# the measurement's forms make gradients in that layout, as GSPMD does
ZERO1 = "zero1"


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


def zero1_spec(shape: Sequence[int], spec: Sequence, mesh) -> tuple:
    """A parameter's ``spec`` with the ZeRO-1 optimizer state's extra "data"
    shard on its first dim that no mesh axis shards and "data" divides (the
    spec itself where "data" is taken or missing)."""
    parts = list(spec)
    used = {m for p in parts for m in entry_axes(p)}
    if "data" in mesh.shape and "data" not in used:
        dsz = mesh.shape["data"]
        for i, (dim, pt) in enumerate(zip(shape, parts)):
            if pt is None and dim % dsz == 0 and dim >= dsz:
                parts[i] = "data"
                break
    return tuple(parts)


def split_rules(rules: Mapping, axis: str, halves: tuple) -> dict:
    """``rules`` with mesh axis ``axis`` named as its two ``halves`` in every
    candidate (``launch.mesh.Mesh.split``): a dim resolved over ``axis`` is
    sharded over both, the same chunks on the same ranks."""
    return {k: tuple(tuple(m for a in cand for m in (halves if a == axis else (a,)))
                     for cand in v) for k, v in rules.items()}


def entry_axes(entry) -> tuple:
    if entry is None or entry is UNCONSTRAINED:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(spec: Sequence, mesh, current=None) -> tuple:
    """DTensor placements, one per mesh axis in mesh order, of a spec: a mesh
    axis named by dim d's entry is ``Shard(d)``; any other is ``Replicate()``,
    unless ``current`` (the tensor's placements) shards an UNCONSTRAINED dim
    on it, which is kept."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {m: d for d, entry in enumerate(spec) for m in entry_axes(entry)}
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


def active():
    """(mesh, rules) of the innermost ``use_rules`` (less the axes of an
    enclosing ``manual_axes``), or (None, None) outside it."""
    return _CTX.mesh, _CTX.rules


@dataclasses.dataclass(frozen=True)
class SubMesh:
    """The active mesh less some axes: the names and sizes that rules and
    placements read."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


@contextlib.contextmanager
def manual_axes(names):
    """Inside, ``maybe_constrain`` resolves on the active mesh less the mesh
    axes ``names`` and its rules drop every candidate that names one of them,
    as the JAX package's constraints do inside a partial-manual
    ``shard_map`` (the body owns those axes; its DTensors live on the mesh of
    the others).  A no-op outside ``use_rules``."""
    if _CTX.mesh is None:
        yield
        return
    mesh = _CTX.mesh
    keep = [(n, mesh.shape[n]) for n in mesh.axis_names if n not in names]
    sub = SubMesh(tuple(n for n, _ in keep), tuple(s for _, s in keep))
    rules = {k: tuple(c for c in v if not any(m in names for m in c))
             for k, v in _CTX.rules.items()}
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = sub, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


@contextlib.contextmanager
def resolving_on(mesh, rules: Mapping):
    """Inside, ``maybe_constrain`` resolves ``rules`` on ``mesh`` (a loop
    body's finer mesh over the same ranks), logging to the enclosing
    ``use_rules``'s log."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


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
