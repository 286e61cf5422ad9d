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
* ``bytes_hbm``       — an eager trace has no fusion, so summing every op's
                        inputs and outputs would overstate memory traffic
                        several-fold (2.8x the reference's on the parity
                        points).  The approximation: products, kernels,
                        reductions (softmax and norms included),
                        gathers/scatters, copies and concatenations count
                        their inputs and outputs once; elementwise and
                        factory ops count only their output, written once,
                        and read nothing (standing for XLA's fusion of a
                        chain into its producers and consumers); views count
                        nothing; the step's own arguments are read once and
                        its new outputs written once;
* ``transpose_bytes`` — bytes of copies whose output layout differs from
                        their input's (the reference's transpose/copy bytes);
* ``collective_count``, ``collective_bytes``, ``collective_wire`` — per kind
                        (the reference's names), from the local operand
                        bytes and the group size, with the reference's
                        ring-model ``_WIRE_FACTOR``;
* ``peak_bytes``      — the step's arguments plus the most bytes of local
                        storages alive at once over the trace, less the
                        donated arguments whose outputs are new storages
                        (XLA's argument + temp + output - alias);
* ``op_hist``         — the 20 most frequent ops.
"""
from __future__ import annotations

import contextlib
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


def _group_size(kind, args) -> int:
    if kind in ("all-gather", "reduce-scatter"):
        return int(args[1] if kind == "all-gather" else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


class Recorder(TorchDispatchMode):
    """Records every op run on tensors of ``fake_mode`` (local shards or
    global fake tensors) while active.  ``recomputing`` is a callable that
    says whether the checkpoint recompute is running."""

    def __init__(self, fake_mode, recomputing=lambda: False):
        super().__init__()
        self.fake_mode = fake_mode
        self.recomputing = recomputing
        self.records = []
        self.muted = 0               # > 0 inside DTensor's shape inference
        self.replicated = {}         # op -> times DTensor found no placement
        self._live = 0
        self.max_live = 0
        self._storages = {}          # storage key -> [bytes, tensors alive]

    # ---- live storages
    def _release(self, key):
        ent = self._storages.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self._live -= ent[0]
            del self._storages[key]

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
        self.records.append(rec)
        for o in outs:
            if _storage_key(o) not in in_keys:
                self._track(o)
        return out

    def _record(self, func, args, kwargs, ins, outs, out):
        packet = func._overloadpacket
        name = str(func)
        rec = {"op": name, "in": [(tuple(t.shape), str(t.dtype)[6:]) for t in ins],
               "out": [(tuple(t.shape), str(t.dtype)[6:]) for t in outs],
               "in_bytes": sum(_nbytes(t) for t in ins),
               "out_bytes": sum(_nbytes(t) for t in outs),
               "flops": 0.0, "remat": False, "kind": "other"}
        kernel = name.startswith(_KERNELS)
        if packet in _PRODUCTS or kernel:
            fn = flop_registry.get(packet)
            if fn is not None:       # takes the tensors, reads their shapes
                rec["flops"] = float(fn(*args, out_val=out, **kwargs))
            rec["remat"] = bool(self.recomputing())
            rec["kind"] = "product"
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
        elif name.startswith("_c10d_functional."):
            kind = _FUNCTIONAL.get(name.split(".")[1])
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


@contextlib.contextmanager
def dtensor_hooks(recorder: Recorder):
    """While a step is traced on DTensors:

    * DTensor's shape inference (its op on fake global-shaped arguments,
      once per op signature, in the trace's own fake mode) is muted in
      ``recorder``: it is not part of any device's program;
    * an op DTensor refuses for an uneven split, or has no strategy for, is
      run replicated and counted (``_replicating``); any other refusal
      raises.
    """
    from torch.distributed.tensor import DTensor

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
    try:
        for n in prop_names:
            setattr(prop, n, _wrap(getattr(prop, n), mute))
        for n in fallback_names:
            setattr(prop, n, _replicating(getattr(prop, n), recorder))
        yield
    finally:
        for n in prop_names + fallback_names:
            if n in vars(prop):
                delattr(prop, n)      # the instance attribute; the class's returns


def analyze(records, arg_bytes: int = 0, out_new_bytes: int = 0,
            donated_bytes: int = 0, max_live: int = 0) -> dict:
    """Counters of one traced step (see the module docstring)."""
    flops = remat = bytes_hbm = transpose = 0.0
    coll_bytes, coll_wire, coll_count = defaultdict(float), defaultdict(float), defaultdict(int)
    hist = defaultdict(int)
    for r in records:
        hist[r["op"]] += 1
        flops += r["flops"]
        if r["remat"]:
            remat += r["flops"]
        kind = r["kind"]
        if kind == "collective":
            p = max(r["group"], 2)
            coll_bytes[r["coll"]] += r["in_bytes"]
            coll_wire[r["coll"]] += r["in_bytes"] * _WIRE_FACTOR[r["coll"]](p)
            coll_count[r["coll"]] += 1
        elif kind != "other":
            b = r["in_bytes"] + r["out_bytes"]
            bytes_hbm += b
            if r.get("transpose"):
                transpose += b
        elif not r["view"]:
            bytes_hbm += r["out_bytes"]      # a fusion's output, written once
    bytes_hbm += arg_bytes + out_new_bytes
    return {
        "flops": flops,
        "remat_flops": remat,
        "bytes_hbm": bytes_hbm,
        "transpose_bytes": transpose,
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
