"""Cost and collective analysis of a traced step: the port's counterpart of
the JAX package's ``launch/hloanalysis.py``.

A step is traced once under a ``TorchDispatchMode`` (``Recorder``) on fake
tensors: on DTensors of a fake process group (the per-device program, as
XLA's partitioned module is) or on plain global tensors (the un-partitioned
program, as the pre-XLA text is).  The recorder sees the ops DTensor runs on
each rank's local shard, and the functional collectives of its
redistributions; it skips ops on DTensors themselves and DTensor's own shape
inference (fake tensors of another fake mode), which it runs once per op
signature on global shapes.  From the records, ``analyze`` reckons:

* ``flops``           — 2·M·N·K of every product on the local shards (mm,
                        bmm, addmm, baddbmm, and ``xlaforms``'s dot_general)
                        and the CUDA kernels' formulas:
                        what the reference counts, dots only;
* ``remat_flops``     — the same, of products run while the checkpoint
                        recompute is active (``transformer.recomputing``);
* ``bytes_hbm``       — an eager trace has no fusion, so the records are
                        grouped as XLA's CPU pipeline fuses the reference's
                        program (``fusion_groups``): elementwise chains
                        fused with their producers and consumers (a cheap
                        producer read by several fusions duplicated into
                        each, one that reads more than it writes where
                        XLA's all-paths condition holds, and into the
                        copies of products' operands), a reduction
                        closing a loop fusion, products,
                        kernels, gathers, scatters, concatenations and
                        collectives alone.  A fusion reads each external
                        tensor once, slice-aware, and writes what is read
                        outside it; a standalone op reads its inputs and
                        writes its outputs.  Widths are those of XLA's CPU
                        module (bf16 held in f32) with the reference's TPU
                        adjustments, and XLA's layout copies, layer-loop
                        slices and multi-kernel ops are counted as there,
                        and the stacks in which XLA's scanned loops (the
                        layer units, the WKV's chunks) keep their steps'
                        residuals for the backward (``_scan_residuals``).
                        This needs the dataflow: each record carries the
                        ids of the tensors it reads and writes (a view
                        shares its base's id, an in-place op makes a new
                        version of its target), a stable id of each
                        storage (alive while any alias is), its phase
                        (forward, recompute, gradients) and its loop step;
* ``transpose_bytes`` — bytes of the standalone copies whose output layout
                        differs from their input's and of the layout
                        copies XLA makes of a product's operands (the
                        reference's top-level transpose/copy bytes);
* ``collective_count``, ``collective_bytes``, ``collective_wire`` — per kind
                        (the reference's names), from the local operand
                        bytes and the group size, with the reference's
                        ring-model ``_WIRE_FACTOR`` (a one-peer
                        ``all_to_all_single``, ``funcol.permute_tensor``'s
                        form, is a collective-permute), as XLA's CPU
                        module runs them (``xla_collectives``): bf16 at
                        f32 width, a partial sum over several mesh dims
                        one all-reduce over the joint group, and the
                        group the reference's analyzer reads where XLA
                        writes the replica groups out as a list;
* ``bytes_by_phase``  — ``bytes_hbm`` by the phase of each group's last
                        record: "forward in loops" (in a scanned loop's
                        step, the residual stacks included), "forward"
                        (outside the loops, the optimizer's update
                        included), "recompute" and "backward";
* ``peak_bytes``      — the step's arguments plus the most bytes of local
                        storages alive at once over the trace, less the
                        donated arguments whose outputs are new storages
                        (XLA's argument + temp + output - alias);
* ``op_hist``         — the 20 most frequent ops.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from . import xlaforms

aten = torch.ops.aten

_PRODUCTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm, xlaforms.dot_general_op}
_KERNELS = ("repro_torch.",)
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
               aten.prod, aten.var, aten.var_mean, aten.std, aten._softmax,
               aten._log_softmax, aten._softmax_backward_data,
               aten._log_softmax_backward_data, aten.cumsum, aten.logsumexp,
               aten.linalg_vector_norm, aten.native_layer_norm,
               aten.native_layer_norm_backward, aten.any, aten.all}
_GATHERS = {aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_,
            aten.gather, aten.scatter, aten.scatter_, aten.scatter_add,
            aten.scatter_add_, aten.index_select, aten.embedding,
            aten.embedding_dense_backward, aten.index_add, aten.index_add_}
_COPIES = {aten.clone, aten.copy_, aten.copy, aten.cat, aten.stack}

_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_out": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all",      # DTensor's own op
               "permute_tensor": "collective-permute"}
# ring-model wire-bytes factor given group size P, as f(P) applied to operand
_WIRE_FACTOR = {
    "all-reduce": lambda p: 2.0 * (p - 1) / p,
    "all-gather": lambda p: float(p - 1),
    "reduce-scatter": lambda p: (p - 1) / p,
    "all-to-all": lambda p: (p - 1) / p,
    "collective-permute": lambda p: 1.0,
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    return getattr(t, "_local_tensor", t)


def _storage_key(t):
    return _local(t).untyped_storage()._cdata


def _view_bytes(t) -> int:
    """Bytes of the elements a view touches (a broadcast dim, stride 0,
    touches one)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return 0 if t.numel() == 0 else n * t.element_size()


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place (its schema's mutable arguments)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += [t for t in tree_flatten(v)[0] if isinstance(t, torch.Tensor)]
    return out


def _one_peer(args) -> bool:
    """Whether an ``all_to_all_single`` sends to one rank and receives from
    at most one: a collective-permute."""
    if len(args) < 3 or not isinstance(args[1], (list, tuple)) \
            or not isinstance(args[2], (list, tuple)):
        return False
    return sum(1 for n in args[2] if n) == 1 and sum(1 for n in args[1] if n) <= 1


def _group_size(kind, args) -> int:
    if kind in ("all-gather", "reduce-scatter"):
        return int(args[1] if kind == "all-gather" else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class Recorder(TorchDispatchMode):
    """Records every op run on tensors of ``fake_mode`` (local shards or
    global fake tensors) while active.  ``recomputing`` is a callable that
    says whether the checkpoint recompute is running, ``scope`` one that
    gives the scanned loop steps running now (``layers.scan_scope``).  Each
    record carries its phase: "F" (the forward), "R" (the checkpoint's
    recompute in the backward) or "G" (the rest of the backward)."""

    def __init__(self, fake_mode, recomputing=lambda: False, scope=lambda: ()):
        super().__init__()
        self.fake_mode = fake_mode
        self.recomputing = recomputing
        self.scope = scope
        self.records = []
        self.muted = 0               # > 0 inside DTensor's shape inference
        self.replicated = {}         # op -> times DTensor found no placement
        self._live = 0
        self.max_live = 0
        self._storages = {}          # storage key -> [bytes, tensors alive]
        self._ids = {}               # storage key -> the id of its current version
        self._sids, self._aliases = {}, {}   # and its stable id (``_sid``)
        self._next_id = 0

    # ---- live storages
    def _release(self, key):
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self._live -= ent[0]
            del self._storages[key]
            self._ids.pop(key, None)

    def _track(self, t):
        key = _storage_key(t)
        ent = self._storages.get(key)
        if ent is None:
            nb = t.untyped_storage().nbytes()
            ent = self._storages[key] = [nb, 0]
            self._live += nb
            self.max_live = max(self.max_live, self._live)
        ent[1] += 1
        weakref.finalize(t, self._release, key)

    def _ours(self, tensors) -> bool:
        return all(getattr(t, "fake_mode", None) is self.fake_mode for t in tensors)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.muted:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        if not self._ours(ins + outs):
            return out              # DTensor's shape inference on global shapes
        rec = self._record(func, args, kwargs, ins, outs, out)
        in_keys = {_storage_key(t) for t in ins}
        rec["view"] = bool(outs) and all(_storage_key(o) in in_keys for o in outs)
        rec["reads"] = [self._access(t) for t in ins]
        written = {_storage_key(t) for t in _written(func, args, kwargs)}
        rec["targets"] = [i for i, t in enumerate(ins) if _storage_key(t) in written]
        for key in written:                            # a new version of its target
            self._ids[key] = self._new_id()
        for o in outs:
            if _storage_key(o) not in in_keys:
                self._ids[_storage_key(o)] = self._new_id()
                self._track(o)
        rec["sreads"] = [self._sid(t) for t in ins]
        for key in written | {_storage_key(o) for o in outs if _storage_key(o) not in in_keys}:
            self._sids[key] = self._new_id()
        for o in outs:
            self._hold(o)
        rec["writes"] = [self._access(o) for o in outs]
        rec["swrites"] = [self._sid(o) for o in outs]
        self.records.append(rec)
        return out

    # ---- dataflow
    def _sid(self, t) -> int:
        """The stable id of ``t``'s storage's current version: kept while any
        alias of the storage lives (an id may be dropped when the tensor
        that made the storage dies and only an alias, such as the one a
        checkpoint saves, holds it)."""
        key = _storage_key(t)
        i = self._sids.get(key)
        if i is None:
            i = self._sids[key] = self._new_id()
        return i

    def _hold(self, t):
        key = _storage_key(t)
        self._aliases[key] = self._aliases.get(key, 0) + 1
        weakref.finalize(t, self._unhold, key)

    def _unhold(self, key):
        n = self._aliases.pop(key) - 1
        if n:
            self._aliases[key] = n
        else:
            self._sids.pop(key, None)

    def _new_id(self) -> int:
        self._next_id += 1
        return self._next_id

    def id_of(self, t) -> int:
        """The id of the current version of ``t``'s storage (a view shares
        its base's)."""
        key = _storage_key(t)
        i = self._ids.get(key)
        if i is None:
            i = self._ids[key] = self._new_id()
        return i

    def _access(self, t):
        """(id, bytes of the view, bytes of the storage, the view's place in
        it) of a tensor an op reads or writes."""
        t = _local(t)
        return (self.id_of(t), _view_bytes(t), t.untyped_storage().nbytes(),
                (tuple(t.shape), tuple(t.stride()), t.storage_offset()))

    def _record(self, func, args, kwargs, ins, outs, out):
        packet = func._overloadpacket
        name = str(func)
        rec = {"op": name, "in": [(tuple(t.shape), str(t.dtype)[6:]) for t in ins],
               "out": [(tuple(t.shape), str(t.dtype)[6:]) for t in outs],
               "in_bytes": sum(_nbytes(t) for t in ins),
               "flops": 0.0, "remat": False, "kind": "other", "scope": self.scope(),
               "phase": "F" if torch._C._current_graph_task_id() == -1
               else "R" if self.recomputing() else "G"}
        kernel = name.startswith(_KERNELS)
        if packet in _PRODUCTS or kernel:
            fn = flop_registry.get(packet)
            if fn is not None:       # takes the tensors, reads their shapes
                rec["flops"] = float(fn(*args, out_val=out, **kwargs))
            rec["remat"] = bool(self.recomputing())
            rec["kind"] = "product"
            if packet is xlaforms.dot_general_op:
                rec["eqn"] = args[3]
        elif packet in _REDUCTIONS:
            rec["kind"] = "reduction"
        elif packet in _GATHERS:
            rec["kind"] = "gather"
        elif packet in _COPIES:
            rec["kind"] = "copy"
            if len(ins) >= 1 and len(outs) == 1 and packet is not aten.cat \
                    and packet is not aten.stack:
                src = ins[-1]
                if src.shape == outs[0].shape and src.numel() > 1 \
                        and src.stride() != outs[0].stride():
                    rec["transpose"] = True
        elif packet is xlaforms.wire_op:        # a collective recorded, no data moved
            rec["kind"] = "collective"
            rec["coll"], rec["group"] = args[1], args[2]
        elif name.startswith(("_c10d_functional.", "_dtensor.")):
            kind = _FUNCTIONAL.get(name.split(".")[1])
            if kind == "all-to-all" and _one_peer(args):
                kind = "collective-permute"      # funcol.permute_tensor's all-to-all
            if kind is not None:
                rec["kind"] = "collective"
                rec["coll"] = kind
                rec["group"] = _group_size(kind, args)
        return rec


def _wrap(fn, ctx):
    def run(*args, **kwargs):
        with ctx():
            return fn(*args, **kwargs)
    return run


def _replicated_schema(schema):
    """``schema`` with every tensor argument replicated on every mesh axis."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import OpSchema

    def rep(a):
        if isinstance(a, DTensorSpec):
            return DTensorSpec(a.mesh, (Replicate(),) * a.mesh.ndim, tensor_meta=a.tensor_meta)
        if isinstance(a, (list, tuple)):
            return type(a)(rep(x) for x in a)
        return a
    return OpSchema(schema.op, rep(schema.args_schema),
                    {k: rep(v) for k, v in schema.kwargs_schema.items()},
                    schema_info=schema.schema_info)


_REPLICATED_OPS: set = set()


def _register_replicated(op):
    """Give ``op``, which DTensor has no strategy for, the one strategy that
    always holds: every tensor argument and output replicated."""
    if op in _REPLICATED_OPS:
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import register_sharding
    n_out = len(op._schema.returns)

    def strategy(*args, **kwargs):
        from torch.distributed.tensor._dtensor_spec import DTensorSpec
        ins = [Replicate() if isinstance(a, DTensorSpec) else None for a in args]
        return [([Replicate()] * n_out, ins)]
    register_sharding(op)(strategy)
    _REPLICATED_OPS.add(op)


# DTensor's refusals to place an op whose dim the mesh does not split evenly
# (by message, in the torch releases the port runs on: 2.11 and 2.13).  The
# trace runs such an op replicated, as XLA would reshard there, and counts it
# in ``replicated_ops``; any other failure of DTensor's propagation raises.
_UNEVEN = ("Cannot unflatten unevenly sharded tensor",
           "Cannot flatten unevenly sharded tensor",
           "Cannot shard unevenly distributed tensor",
           "Attempted to split the sharded dimension",
           "Attempted to flatten unevenly sharded dimension",
           "This operation would remove or reshape sharded dimension")
_NO_STRATEGY = "does not have a sharding strategy registered"


def _unplaceable(spec) -> bool:
    """Whether an output spec shards a dim over more ranks than the dim has
    entries (DTensor's view rule can plan that when it splits a sharded dim,
    e.g. a batch of 32 on 32 ranks viewed as 4 microbatches of 8, and the
    local op then fails), or strided-shards it (a view that flattens a dim
    sharded behind an unsharded one: the strategies of an op registered with
    ``register_sharding`` cannot take such an argument, and a fake trace
    cannot gather it)."""
    for s in spec if isinstance(spec, (list, tuple)) else (spec,):
        meta = getattr(s, "tensor_meta", None)
        if meta is None:
            continue
        ways: dict = {}
        for size, pl in zip(s.mesh.shape, s.placements):
            if type(pl).__name__ == "_StridedShard":
                return True
            if pl.is_shard():
                ways[pl.dim] = ways.get(pl.dim, 1) * size
        if any(n > meta.shape[d] for d, n in ways.items()):
            return True
    return False


def _replicating(propagate, recorder):
    """``propagate`` (DTensor's sharding propagation of one op), which runs
    the op replicated where DTensor refuses it for one of two reasons: an
    uneven split (``_UNEVEN``, or a plan whose output no later op can take,
    ``_unplaceable``), or no strategy at all for an op that has no
    decomposition (such an op gets the all-replicated strategy).  Each is
    counted in ``recorder.replicated`` under the op's name; every other
    error propagates."""
    def run(schema):
        try:
            out = propagate(schema)
            if not _unplaceable(out.output_spec):
                return out
        except NotImplementedError as e:
            if _NO_STRATEGY not in str(e) or torch._C._dispatch_has_kernel_for_dispatch_key(
                    schema.op.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
                raise
            _register_replicated(schema.op)
        except RuntimeError as e:
            if not any(m in str(e) for m in _UNEVEN):
                raise
        key = str(schema.op)
        recorder.replicated[key] = recorder.replicated.get(key, 0) + 1
        rep = _replicated_schema(schema)
        out = propagate(rep)
        if not out.needs_redistribute:
            out.redistribute_schema = rep
            out.needs_redistribute = True
        return out
    return run


def _alltoall_as_on_cuda(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's all-to-all of a shard from one dim to another, as a ``cuda``
    mesh runs it (one ``_dtensor.shard_dim_alltoall``) on every mesh: a
    ``cpu`` mesh would all-gather and chunk instead (gloo has no all-to-all),
    which a fake trace does not need."""
    return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                 mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def dtensor_hooks(recorder: Recorder):
    """While a step is traced on DTensors:

    * DTensor's shape inference (its op on fake global-shaped arguments,
      once per op signature, in the trace's own fake mode) is muted in
      ``recorder``: it is not part of any device's program;
    * an op DTensor refuses for an uneven split, or has no strategy for, is
      run replicated and counted (``_replicating``); any other refusal
      raises;
    * a shard moved from one dim to another is one all-to-all on a ``cpu``
      mesh as on a ``cuda`` one (``_alltoall_as_on_cuda``), so the CPU's
      counters are the card's.
    """
    from torch.distributed.tensor import DTensor, placement_types

    @contextlib.contextmanager
    def mute():
        recorder.muted += 1
        try:
            yield
        finally:
            recorder.muted -= 1

    prop = DTensor._op_dispatcher.sharding_propagator
    prop_names = [n for n in ("_propagate_tensor_meta_non_cached",) if hasattr(prop, n)]
    if not prop_names:
        raise RuntimeError("this torch's DTensor has no _propagate_tensor_meta_non_cached: "
                           "its shape inference cannot be told from the devices' ops")
    fallback_names = [n for n in ("propagate_op_sharding_non_cached", "propagate_op_sharding")
                      if hasattr(prop, n)]
    alltoall = placement_types.shard_dim_alltoall
    try:
        for n in prop_names:
            setattr(prop, n, _wrap(getattr(prop, n), mute))
        for n in fallback_names:
            setattr(prop, n, _replicating(getattr(prop, n), recorder))
        placement_types.shard_dim_alltoall = _alltoall_as_on_cuda
        yield
    finally:
        placement_types.shard_dim_alltoall = alltoall
        for n in prop_names + fallback_names:
            if n in vars(prop):
                delattr(prop, n)      # the instance attribute; the class's returns


# ops that stand alone besides products, kernels, gathers, scatters,
# collectives and copies that change the layout: XLA's CPU pipeline fuses
# none of them
_ALONE = ("cat", "stack", "sort", "topk", "argsort")
# elementwise ops XLA deems expensive: a fusion does not duplicate them
_EXPENSIVE = {"exp", "exp2", "expm1", "log", "log1p", "log2", "pow", "div", "rsqrt",
              "sqrt", "tanh", "sin", "cos", "tan", "sigmoid", "silu", "gelu", "erf",
              "reciprocal", "atan2", "remainder", "fmod", "softplus", "logit",
              "silu_backward", "gelu_backward", "sigmoid_backward", "tanh_backward"}
# ops torch runs as one kernel that XLA runs as several: (times the input is
# read, bytes moved through f32 temporaries in units of the output).  Softmax
# is a max, an exp written for a sum and a divide; a layer norm and the
# softmaxes' backwards read their inputs for a reduction and again after it.
_PASSES = {"_softmax": (2, 3), "_log_softmax": (3, 0), "_softmax_backward_data": (2, 0),
           "_log_softmax_backward_data": (2, 0), "native_layer_norm": (2, 0),
           "native_layer_norm_backward": (2, 0)}
# lookups: they read the rows they gather, not the whole table
_LOOKUPS = ("embedding", "index", "gather", "index_select")
_NARROW = ("bfloat16", "float16")


def _name(r) -> str:
    return r["op"].split(".")[1]


def _role(r) -> str:
    """How the fusion pass takes a record: "none" (writes nothing), "pass"
    (a view, or a collective's wait: its output is its input), "collective",
    "alone", "reduce" (closes a loop fusion) or "fuse" (elementwise)."""
    if not r["writes"]:
        return "none"
    if r["op"].startswith("_c10d_functional.wait_tensor") or (r["view"] and not r["targets"]):
        return "pass"
    kind = r["kind"]
    if kind == "collective":
        return "collective"
    if kind in ("product", "gather") or r.get("transpose") or _name(r) in _ALONE:
        return "alone"
    return "reduce" if kind == "reduction" else "fuse"


def _f32(a, dtype):
    """An access at the width XLA's CPU module holds it: a bf16 array in f32."""
    return (a[0], 2 * a[1], 2 * a[2], a[3]) if dtype in _NARROW else a


def _read_bytes(reads) -> float:
    """Bytes a fusion reads of its external tensors, each once: the views
    it takes of one tensor (slices of a stacked param) counted apart, never
    more than the whole tensor."""
    views, cap = defaultdict(dict), {}
    for i, nb, storage, where in reads:
        views[i][where] = nb
        cap[i] = storage
    return sum(min(sum(v.values()), cap[i]) for i, v in views.items())


def _dot_layout_ok(eqn, n, where) -> bool:
    """Whether operand ``n`` of a product (0, 1; 2: its output, laid out in
    the equation's order) is laid out as XLA's CPU dot takes it: batch dims
    leading, then (lhs) the free dims and the contracted ones, (rhs) the
    contracted ones and the free ones, or, with no batch dim, either order;
    (output) batch, lhs free, rhs free.  ``where`` is the operand's (shape,
    strides, offset), its dims in the order of their strides."""
    lhs, out = eqn.split("->")
    a, b = lhs.split(",")
    letters = (a, b, out)[n]
    if where is None:
        order = list(letters)
    else:
        shape, stride, _ = where
        order = [letters[d] for d in sorted((d for d in range(len(shape)) if shape[d] > 1),
                                            key=lambda d: -stride[d])]
    batch = set(a) & set(b) & set(out)

    def label(ch):
        if ch in batch:
            return 0
        if n == 0:
            return 1 if ch in out else 2
        if n == 1:
            return 2 if ch in out else 1
        return 1 if ch in a else 2
    labels = [label(ch) for ch in order]
    return labels == sorted(labels) or (n == 1 and not batch & set(order)
                                        and labels == sorted(labels, reverse=True))


def _gathered(r, c, producer, roles) -> bool:
    """Whether a concatenation joins the chunks of one collective's output:
    DTensor's all-gather along a dim other than the first gathers along the
    first and concatenates the chunks, where XLA's all-gather writes the
    gathered dim in place."""
    ids = {c(a[0]) for a in r["reads"]}
    p = producer.get(ids.pop()) if len(ids) == 1 else None
    return p is not None and roles[p] == "collective"


def fusion_groups(records, out_ids=(), arg_ids=()) -> list:
    """The records grouped as XLA's CPU pipeline runs the reference's
    program: [(role, record indices, bytes read, bytes written)], one entry
    a kernel.  ``out_ids`` and ``arg_ids`` are the recorder's ids of the
    step's outputs and arguments.

    * Elementwise ops (converts, broadcasts and copies that keep the layout
      included) fuse with their producers and consumers; a reduction closes
      a loop fusion with its elementwise producers; views and a
      collective's wait are free (a view reads through to its base).
    * Products, the CUDA kernels, gathers and scatters, concatenations,
      sorts, copies that change the layout, and collectives stand alone,
      so no fusion crosses one.  A concatenation of the chunks of one
      collective's output is the collective's (``_gathered``).
    * A residual of a scanned loop's step (``_scan_residuals``) is written
      by its step and read by the backward from the loop's stack, whose
      dynamic-update-slice is a "stack" group (the residual read and
      written) at each loop level; the stack's dynamic-slice writes the
      layout a product of the backward takes.  The backward of an outer
      loop slices its step's whole stack of an inner loop's residuals (the
      WKV's chunks in a layer unit) out of its own stack, read and written
      once more at each level but the innermost, whose slices are read by
      the fusions that consume them.
    * A fusion's output is written where a standalone op, a collective or
      the step's result reads it, or a later fusion that does not
      duplicate it; a reduction's output always.  An elementwise producer
      read by several fusions is duplicated into each, which reads its
      inputs again, where it is cheap (not one of XLA's expensive ops) and
      reads no more bytes than it writes; else it is written once and read
      by each.  A producer fused in through a slice computes that slice.
    * A cheap elementwise producer that reads more bytes than it writes (an
      ``add`` of several tensors) is held to XLA's own condition
      (``InstructionFusion::ComputeGloballyUnfusible``): it is duplicated
      into each fusion that reads it where it fuses into every consumer on
      every path, and written once where one refuses it.  What a consumer
      takes was read off XLA's CPU pipeline (jax 0.9.0, small functions
      compiled and their fusions read; ``tests/test_torch_xla_rules.py``):
      elementwise ops take it; so does the copy XLA makes of a product's
      operand in another layout than its dot takes (a transpose, which XLA
      moves above an elementwise op, so its fusion computes the producer
      from its operands even where the producer is written for another
      consumer: a "layout" group); so does a reduction over at most 32
      elements, or of a bf16 input (XLA upcasts it in a fusion first); a
      product that takes the operand's layout refuses it, as does a wider
      f32 reduction, which XLA's tree-reduction rewrite splits into a
      reduce-window that fuses nothing (``_takes_fused``,
      ``_fused_on_all_paths``; a path of two steps is checked, where the
      second consumer also reads the first).  A pad producing such a
      duplicated sum (the transpose of a slice: ``xlaforms._Streams``) is
      written by its own fusion, as XLA writes it; a lone pad read by
      several fusions is duplicated like any cheap op.
    * A fusion reads each external tensor once, slice-aware; a standalone
      op reads its inputs and writes its outputs, a lookup only the rows it
      gathers, an in-place update (a cache's ``index_put_``) only the
      update.  Collectives move no bytes here (the reference's count).

    The widths are those of XLA's CPU module, with the reference's
    adjustments for the TPU (``hloanalysis.py``): every bf16 array is held
    in f32, so fusions and standalone ops other than products read and
    write bf16 tensors at twice their bytes; a product reads its operands at
    their own width (the reference counts a dot's bf16 operands as bf16) and
    writes f32; a bf16 -> f32 upcast of a tensor no fusion computes is free,
    and its standalone consumers read the bf16 original.  The trace's own
    products already take bf16, so the reference's halving of a dot's
    upcast operands needs no counterpart.  And XLA's layouts and loops: a
    product whose operand is not laid out as XLA's CPU dot takes it (batch
    dims leading, contracted dims last on the left, ``_dot_layout_ok``), or
    is a slice of an argument (a layer's weight out of the stacked params:
    the layer loop's dynamic-slice), reads it through a copy (read and
    written at f32) unless a fusion writes it, a slice of an argument or of
    a cache the loop carries read twice (the reference's analyzer counts
    the dynamic-slice again for the loop index), and a single row's product
    with no batch dims fuses its weight's copy (written nowhere,
    ``_copies_for_product``); an update of a slice of an
    argument (a cache's layer, carried by the layer loop) rewrites the
    whole argument, which the loop also copies once; and the ops torch runs
    as one kernel but XLA as several (``_PASSES``) read their inputs again.
    """
    canon: dict = {}

    def c(i):
        while i in canon:
            i = canon[i]
        return i
    roles = [_role(r) for r in records]
    producer, consumers = {}, defaultdict(list)
    for k, (r, role) in enumerate(zip(records, roles)):
        if role == "none":
            continue
        if role == "alone" and _name(r) == "cat" and _gathered(r, c, producer, roles):
            role = roles[k] = "pass"
        if role == "pass":
            src = c(r["reads"][0][0]) if r["reads"] else None
            for w in r["writes"]:
                if src is not None and w[0] != src:
                    canon[w[0]] = src
            continue
        for i in {c(a[0]) for a in r["reads"]}:
            consumers[i].append(k)
        for w in r["writes"]:
            producer[c(w[0])] = k
    outs, args = {c(i) for i in out_ids}, {c(i) for i in arg_ids}
    fusible = ("fuse", "reduce")
    stacked = _scan_residuals(records, roles, c, args)

    # which fusible records write their outputs (reverse order: every
    # consumer is decided before its producer), and for those that do not,
    # the fusions that compute them: a record's own index, or (j, n) for the
    # copy XLA makes of operand n of product j
    written, roots, narrowing = {}, {}, set()
    for k in range(len(records) - 1, -1, -1):
        if roles[k] not in fusible:
            continue
        r = records[k]
        ids = {c(w[0]) for w in r["writes"]}
        cons = {j for i in ids for j in consumers.get(i, ())}
        mat = bool(ids & (outs | stacked.keys())) or (roles[k] == "reduce" and bool(cons))
        rest = [j for j in cons if roles[j] not in fusible]
        copies, others = _copy_consumers(rest, ids, records, c)
        groups = set()
        for j in cons:
            if roles[j] in fusible:
                groups |= ({j} if written[j] else set()) | roots[j]
        expensive = _name(r).rstrip("_") in _EXPENSIVE
        if roles[k] == "fuse" and not expensive \
                and sum(a[1] for a in r["reads"]) > sum(w[1] for w in r["writes"]):
            # narrowing: duplicated where it fuses on all paths; a product's
            # copy computes it from its operands even where it is written
            groups |= copies
            mat = mat or bool(others) or (len(groups) > 1 and not _fused_on_all_paths(
                cons, ids, records, roles, written, c))
            if not mat and len(groups) > 1:
                narrowing.add(k)
            written[k] = mat
            roots[k] = copies if mat else groups
            continue
        mat = mat or bool(rest) or (len(groups) > 1 and expensive)
        # a pad whose chain is duplicated is written by its own fusion
        if _name(r) == "constant_pad_nd" and any(j in narrowing for j in cons):
            mat = True
        written[k] = mat
        roots[k] = set() if mat else groups

    def computed(k):
        return roles[k] in fusible and written[k]
    phantoms = {k for k, r in enumerate(records)
                if computed(k) and _name(r) == "_to_copy" and r["in"][0][1] in _NARROW
                and r["out"][0][1] == "float32"
                and not (producer.get(c(r["reads"][0][0])) in roots
                         and not written[producer[c(r["reads"][0][0])]])}

    def fused(k, accesses, force=None):
        """The producers a fusion rooted at record ``k`` computes to make
        ``accesses`` ((access, (shape, dtype)) pairs), each through the
        views it reads them by, and the external tensors it reads (``force``:
        a producer computed even though it is written, as a product's copy
        computes its operand's)."""
        members, reads, stack, seen = [], [], [(accesses, 1.0, ())], set()
        while stack:
            acc, frac, path = stack.pop()
            for a, d in acc:
                i = c(a[0])
                p = producer.get(i)
                if p is not None and p < k and roles[p] in fusible and (not written[p]
                                                                        or p == force):
                    sub = path + (a[3],) if a[1] < a[2] else path
                    if (p, sub) not in seen:
                        seen.add((p, sub))
                        members.append(p)
                        stack.append((list(zip(records[p]["reads"], records[p]["in"])),
                                      frac * a[1] / max(a[2], 1), sub))
                else:
                    x = _f32((i,) + a[1:], d[1])
                    reads.append((x[0], x[1] * frac, x[2], (x[3], path)))
        return members, reads

    copy_roots = {x for gs in roots.values() for x in gs if isinstance(x, tuple)}
    out, copied = [], set()
    carried, copied_stacks, fused_in = {i: i for i in args}, set(), set()
    for k, (r, role) in enumerate(zip(records, roles)):
        if role in ("none", "pass", "collective") or k in phantoms \
                or (role in fusible and not written[k]):
            continue
        if role == "alone":
            for n in (n for n in (0, 1) if (k, n) in copy_roots):
                a, d = r["reads"][n], r["in"][n]
                members, reads = fused(k, [(a, d)], producer.get(c(a[0])))
                out.append(("layout", sorted(set(members)), _read_bytes(reads), _f32(a, d[1])[1]))
            out += _copies_for_product(k, r, records, c, producer, roles, carried, copied,
                                       {v[3] for v in stacked.values()}, fused_in)
            prod = r["kind"] == "product"
            targets = set(r["targets"])
            reads = []
            for n, (a, d) in enumerate(zip(r["reads"], r["in"])):
                if n in targets or (k, n) in fused_in:
                    continue
                x = (c(a[0]),) + a[1:]
                x = x if prod else _f32(x, d[1])
                if producer.get(x[0]) in phantoms:
                    x = (x[0], x[1] // 2, x[2], x[3])     # the bf16 original
                reads.append(x)
            wb = sum(_f32(w, d[1])[1] for w, d in zip(r["writes"], r["out"]))
            if _name(r) in _LOOKUPS and reads:
                reads[0] = (reads[0][0], min(reads[0][1], wb), reads[0][2], reads[0][3])
            if targets:
                wb = min(wb, _read_bytes(reads))
                for n in targets:
                    a = r["reads"][n]
                    root = carried.get(c(a[0]))
                    if root is None:
                        continue
                    carried.update((c(w[0]), root) for w in r["writes"])
                    if a[1] < a[2]:
                        wb += a[2] + (2 * a[2] if root not in copied_stacks else 0)
                        copied_stacks.add(root)
            out.append(("alone", [k], _read_bytes(reads), wb))
            continue
        # a fusion: k and the producers it computes
        members, reads = fused(k, list(zip(r["reads"], r["in"])))
        rb = _read_bytes(reads)
        wb = sum(_f32(w, d[1])[1] for w, d in zip(r["writes"], r["out"]))
        passes, temps = _PASSES.get(_name(r), (1, 0))
        out.append((role, sorted(set(members + [k])), passes * rb + temps * wb, wb))
    for i, (k, nb, levels, _) in stacked.items():
        out += [("stack", [k], nb, nb)] * (2 * levels - 1)
    return out


# the phases whose reads make a loop step's tensor a residual, by the phase
# the step runs in: the forward's are read by the whole backward, the
# recompute's by the gradients
_LATER = {"F": ("R", "G"), "R": ("G",)}


def _scan_residuals(records, roles, c, args) -> dict:
    """The residuals of XLA's scanned loops: {id: (the record that makes it,
    its bytes at the CPU module's width, the loops that stack it, its stable
    id)}.

    The JAX package runs the layer units and the WKV's chunks as
    ``lax.scan``; a scan's forward writes each step's residuals, what
    autograd saves for the backward under the remat policy (the outputs of
    the kept products and the step's carry under "dots", only the carry
    under "full"), into a stack by a dynamic-update-slice, which reads the
    slice and writes it in place (``hloanalysis._fusion_io_bytes``).  Here
    a residual of a step of a scanned loop (``layers.scan_steps``) is a
    tensor that the backward reads (for a step of the recompute, the
    gradients), through any alias (the records' stable ids), and that the
    step makes, or that the step alone of its loop reads, made before the
    loop (the carry into the first step; what every step reads, as the
    weights, is the loop's invariant); never an argument.  A step nested in
    another (the chunks in a unit) is stacked at each level.  The loop's
    body ends at the stack, so a residual is written by its step and read
    from memory by the backward, as a slice of the stack."""
    readers, steps, made = defaultdict(set), defaultdict(set), {}
    for j, r in enumerate(records):
        if roles[j] in ("none", "pass"):
            continue
        for i in r["sreads"]:
            readers[i].add(r["phase"])
            steps[i].update((x, r["phase"]) for x in r["scope"])
        for w, d, si in zip(r["writes"], r["out"], r["swrites"]):
            made.setdefault(si, (j, w, d))
    out: dict = {}
    for si, (k, w, d) in made.items():
        i, r = c(w[0]), records[k]
        if i in args:
            continue
        levels = {x[:2]: r["phase"] for x in r["scope"]}
        runs = defaultdict(list)
        for (loop, run, step), phase in steps.get(si, ()):
            runs[(loop, run)].append(phase)
        for run, phases in runs.items():
            if run not in levels and len({x for x, _ in steps[si] if x[:2] == run}) == 1:
                levels[run] = phases[0]
        n = sum(1 for phase in levels.values()
                if any(p in readers[si] for p in _LATER.get(phase, ())))
        if n:
            out[i] = (k, _f32(w, d[1])[1], n, si)
    return out


def _copy_consumers(rest, ids, records, c):
    """({(j, n)}, [j]): of the consumers ``rest`` of tensors ``ids`` that
    stand alone, the products that read such a tensor as operand ``n`` in
    another layout than XLA's CPU dot takes, through a copy (a transpose,
    which XLA moves above an elementwise op: its fusion computes the op from
    its operands), and the others, which read it from memory."""
    copies, others = set(), []
    for j in rest:
        r = records[j]
        reads = [(n, a) for n, a in enumerate(r["reads"]) if c(a[0]) in ids]
        if "eqn" not in r or not reads or any(n > 1 or _dot_layout_ok(r["eqn"], n, a[3])
                                              for n, a in reads):
            others.append(j)
        else:
            copies |= {(j, n) for n, _ in reads}
    return copies, others


# a reduction over more elements than this is split by XLA's CPU backend into
# a reduce-window and a reduce (its tree-reduction rewrite), which fuse
# nothing: the producer of such a reduction is read from memory
_TREE_REDUCTION = 32


def _takes_fused(r) -> bool:
    """Whether XLA fuses a producer into record ``r``'s fusion (see
    ``fusion_groups``): an elementwise op does, and a reduction over at most
    ``_TREE_REDUCTION`` elements, or of a bf16 input (upcast to f32 by a
    fusion before the reduction)."""
    if r["kind"] != "reduction":
        return True
    (shape, dtype), out = r["in"][0], r["out"][0][0]
    n, m = math.prod(shape), math.prod(out)
    reduced = n // m if m and m < n else (shape[-1] if shape else 1)
    return reduced <= _TREE_REDUCTION or dtype in _NARROW


def _fused_on_all_paths(cons, ids, records, roles, written, c) -> bool:
    """XLA's condition for duplicating a producer (tensors ``ids``) that
    reads more bytes than it writes into several fusions (``InstructionFusion
    ::ComputeGloballyUnfusible``): it fuses into every consumer ``cons``, on
    every path.  A consumer that stands alone is a product's copy
    (``_copy_consumers``); one that fuses takes it (``_takes_fused``); and a
    consumer that also reads another consumer of the producer, a path of two
    steps, needs that one computed in its fusion, not written."""
    for j in cons:
        if roles[j] not in ("fuse", "reduce"):
            continue
        if not _takes_fused(records[j]):
            return False
        for a in records[j]["reads"]:
            i = c(a[0])
            if i in ids:
                continue
            q = next((q for q in cons if q != j and any(c(w[0]) == i for w in records[q]["writes"])),
                     None)
            if q is not None and (roles[q] not in ("fuse", "reduce") or written[q]):
                return False
    return True


def _copies_for_product(k, r, records, c, producer, roles, carried, copied, residuals,
                        fused_in) -> list:
    """The copies XLA's CPU module makes of product ``k``'s operands (see
    ``fusion_groups``): [("copy", [k], bytes read, bytes written)].  The
    backward reads a residual through the dynamic-slice of its stack, which
    writes the layout the product takes.  A copy of a layer's slice of an
    argument (a weight out of the stacked params, a cache's layer, carried
    by the loop) reads the slice twice: the reference's analyzer counts a
    fusion's dynamic-slice once for the operand it slices and once more for
    the loop index it reads (``hloanalysis._fusion_io_bytes``).  Where the
    product has no batch dims and the other operand is a single row (a
    weight against a decode step's one token a rank), XLA fuses the product
    with the copy's convert (a matrix-vector fusion): the copy is not
    written, and the product does not read it again ((k, the operand's
    index) is added to ``fused_in``)."""
    if "eqn" not in r:
        return []
    out = []
    lhs, eo = r["eqn"].split("->")
    letters = lhs.split(",")
    size = dict(zip(letters[0], r["in"][0][0]))
    size.update(zip(letters[1], r["in"][1][0]))
    batched = any(size[ch] > 1 for ch in letters[0] if ch in letters[1] and ch in eo)
    for n, (a, d, si) in enumerate(zip(r["reads"][:2], r["in"][:2], r["sreads"])):
        i = c(a[0])
        p = producer.get(i)
        if p is not None and roles[p] in ("fuse", "reduce") \
                or (si in residuals and r["phase"] != "F"):
            continue                     # the fusion writes the layout the product takes
        sliced = a[1] < a[2] and i in carried
        need = not _dot_layout_ok(r["eqn"], n, a[3]) or (p is None and sliced)
        if p is not None and "eqn" in records[p]:
            need |= not _dot_layout_ok(records[p]["eqn"], 2, None)
        key = (i, a[3], r["eqn"], n)
        if need and key not in copied:
            copied.add(key)
            nb = _f32(a, d[1])[1]
            gemv = not batched and math.prod(size[ch] for ch in letters[1 - n]
                                             if ch not in letters[n]) == 1
            if gemv:
                fused_in.add((k, n))
            out.append(("copy", [k], nb * (2 if sliced else 1), 0 if gemv else nb))
    return out


def xla_collectives(records, moe_ranks: int = 0) -> list:
    """The trace's collectives as XLA's CPU module runs them: [(kind, operand
    bytes, group size as the reference's analyzer reads it)].

    * XLA's CPU backend holds every bf16 array in f32, a collective's
      operands included: a bf16 operand is counted at f32 width.
    * GSPMD all-reduces a partial sum over several mesh axes once, over the
      joint replica group; DTensor reduces it one mesh dim at a time, each
      all-reduce taking the previous one's result.  Such a chain is counted
      as one all-reduce whose group is the product of the chain's groups.
    * The reference's analyzer reads a group's size from XLA's iota form of
      the replica groups ``[n,p]<=[...]`` and takes 2 where XLA writes them
      out as a list (``hloanalysis._GROUPS_RE``).  In a model with MoE
      layers on ``moe_ranks`` ranks, XLA writes as a list the groups of the
      all-reduce into which its combiner merges a layer unit's bf16 weight
      gradients (each a product that sums over the rows) where they are
      reduced over part of the mesh, the weights sharded over the rest (the
      HLO of the mixtral train steps under tp and ep; under dp, reduced
      over every rank, and in the dense archs, whose combined gradients
      lead with a bias's or a norm's, in the iota form).  Such an all-reduce
      is given the group 2.
    """
    out, src, chained, made = [], {}, {}, {}
    for r in records:
        for si in r["swrites"]:
            made.setdefault(si, r)
        if r["op"].startswith("_c10d_functional.wait_tensor") and r["reads"] and r["writes"]:
            src[r["writes"][0][0]] = src.get(r["reads"][0][0], r["reads"][0][0])
            continue
        if r["kind"] != "collective":
            continue
        nb = sum(_nbytes_of(shape, dtype) * (2 if dtype in _NARROW else 1)
                 for shape, dtype in r["in"])
        i = src.get(r["reads"][0][0], r["reads"][0][0]) if r["reads"] else None
        j = chained.get(i) if r["coll"] == "all-reduce" else None
        if j is not None:
            kind, nb0, group, grad = out[j]
            out[j] = (kind, nb0, group * r["group"], grad)
        else:
            j = len(out)
            p = made.get(r["sreads"][0]) if moe_ranks and r["coll"] == "all-reduce" else None
            grad = p is not None and _weight_gradient(p) and p["out"][0][1] in _NARROW
            out.append((r["coll"], nb, r["group"], grad))
        if r["coll"] == "all-reduce":
            for w in r["writes"]:
                chained[w[0]] = j
    return [(kind, nb, 2 if grad and group < moe_ranks else group)
            for kind, nb, group, grad in out]


def _weight_gradient(r) -> bool:
    """Whether record ``r`` is a product that sums over its first operand's
    leading dim (the rows), as a weight's gradient does; an activation's
    product keeps it."""
    if "eqn" not in r:
        return False
    ins, res = r["eqn"].split("->")
    return ins[:1] not in res


def _nbytes_of(shape, dtype: str) -> int:
    return math.prod(shape) * getattr(torch, dtype).itemsize


_PHASE_NAMES = {"F": "forward", "R": "recompute", "G": "backward"}


def analyze(records, arg_bytes: int = 0, out_new_bytes: int = 0,
            donated_bytes: int = 0, max_live: int = 0, arg_ids=(), out_ids=(),
            moe_ranks: int = 0) -> dict:
    """Counters of one traced step (see the module docstring); ``moe_ranks``:
    the mesh's ranks where the model has MoE layers, else 0."""
    flops = remat = 0.0
    coll_bytes, coll_wire, coll_count = defaultdict(float), defaultdict(float), defaultdict(int)
    hist = defaultdict(int)
    for r in records:
        hist[r["op"]] += 1
        flops += r["flops"]
        if r["remat"]:
            remat += r["flops"]
    for kind, nb, group in xla_collectives(records, moe_ranks):
        coll_bytes[kind] += nb
        coll_wire[kind] += nb * _WIRE_FACTOR[kind](max(group, 2))
        coll_count[kind] += 1
    groups = fusion_groups(records, out_ids, arg_ids)
    phases = defaultdict(float)
    for g in groups:
        r = records[max(g[1])]
        phases[_PHASE_NAMES[r["phase"]] + (" in loops" if r["scope"] and r["phase"] == "F"
                                           else "")] += g[2] + g[3]
    return {
        "flops": flops,
        "remat_flops": remat,
        "bytes_hbm": sum(g[2] + g[3] for g in groups),
        "bytes_by_phase": dict(phases),
        "transpose_bytes": sum(g[2] + g[3] for g in groups if g[0] == "copy" or (
            g[0] == "alone" and records[g[1][0]].get("transpose"))),
        "collective_bytes": dict(coll_bytes),
        "collective_bytes_total": sum(coll_bytes.values()),
        "collective_wire": dict(coll_wire),
        "collective_wire_total": sum(coll_wire.values()),
        "collective_count": dict(coll_count),
        "peak_bytes": max(arg_bytes + max_live - min(donated_bytes, out_new_bytes),
                          arg_bytes),
        "op_hist": dict(sorted(hist.items(), key=lambda kv: -kv[1])[:20]),
        "n_ops": len(records),
    }


def canonical_log(records) -> str:
    """The op log as text, one op a line: what the fingerprint hashes."""
    return "\n".join(f"{r['op']}({r['in']})->({r['out']})" for r in records)
