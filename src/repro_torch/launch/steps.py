"""Cell builder: (arch x shape x policy x mesh) -> a traceable step.

Assembles the abstract params, optimizer state, inputs and decode state
((shape, dtype) leaves, no allocation), their specs and DTensor placements
from the logical-axis rules, and the step function with its donated
arguments.  ``Cell.trace`` runs the step once on DTensors of fake tensors on
the mesh's ranks (the per-device program, which the "compile" phase of the
measurement reads); ``Cell.lower`` runs it once on global fake tensors with
no mesh (the counterpart of the JAX package's lowered, un-partitioned
module), kept as an op log.  Both run in the forms XLA partitions
(``xlaforms.XlaForms``).  PyTorch runs eagerly, so ``scan_layers`` has no
structural meaning here: both values give the same trace.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..configs.base import ModelConfig, RunPolicy, ShapeSpec
from ..models import api
from ..models import layers
from ..models import transformer as tfm
from ..models.module import tree_map
from ..train.optimizer import OptConfig, opt_state_axes
from ..train.train_step import (make_decode_step, make_init_opt, make_prefill_step,
                                make_train_step)
from . import traceanalysis, xlaforms
from .sharding import (ZERO1, FallbackStats, placements_for, spec_for, tree_specs,
                       use_rules, zero1_spec)


def _zero1_specs(mesh, shapes, axes_tree, rules, stats=None):
    """Param-like specs with an extra 'data'-axis shard on the first
    still-replicated, divisible dim (ZeRO-1 optimizer-state sharding)."""
    def walk(shapes, axes):
        if isinstance(shapes, dict):
            return {k: walk(shapes[k], axes[k]) for k in shapes}
        shape = shapes[0]
        return zero1_spec(shape, spec_for(shape, axes, rules, mesh, stats=stats), mesh)
    return walk(shapes, axes_tree)


def _shape_tree(tree):
    """(shape, dtype) leaves of a tree of tensors or (shape, dtype) pairs."""
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return (tuple(tree[0]), tree[1])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


@dataclasses.dataclass
class Trace:
    """One traced run of a cell's step: the recorder's op records, the
    resolved spec of every ``maybe_constrain`` call, and the byte totals the
    analysis needs."""
    records: list
    constraints: list
    arg_bytes: int
    out_new_bytes: int
    donated_bytes: int
    max_live: int
    replicated: dict          # op -> times DTensor found no placement for it
    arg_ids: set              # the recorder's ids of the arguments' storages
    out_ids: set              # and of the outputs'
    moe_ranks: int = 0        # the mesh's ranks, for a model with MoE layers

    def analyze(self) -> dict:
        out = traceanalysis.analyze(self.records, self.arg_bytes, self.out_new_bytes,
                                    self.donated_bytes, self.max_live, self.arg_ids,
                                    self.out_ids, self.moe_ranks)
        out["replicated_ops"] = dict(self.replicated)
        return out


@dataclasses.dataclass
class Cell:
    cfg: ModelConfig
    shape: ShapeSpec
    policy: RunPolicy
    mesh: Any
    opt: OptConfig
    fn: Any                   # python callable
    arg_shapes: tuple         # trees of (shape, dtype) leaves
    in_specs: tuple           # trees of specs (mesh-axis names per dim)
    donate_argnums: tuple
    rules: dict
    stats: FallbackStats
    _lowered: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def _run(self, device, sharded: bool) -> Trace:
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake = FakeTensorMode()
        dev = torch.device(device)
        dm = self.mesh.device_mesh(dev.type) if sharded else None

        def make(leaf, spec):
            shape, dtype = leaf
            if not sharded:
                return torch.empty(shape, dtype=dtype, device=dev)
            from torch.distributed.tensor import DTensor
            placements = placements_for(spec, self.mesh)
            local = list(shape)
            for name, pl in zip(self.mesh.axis_names, placements):
                if pl.is_shard():
                    local[pl.dim] //= self.mesh.shape[name]
            t = torch.empty(local, dtype=dtype, device=dev)
            stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
            return DTensor.from_local(t, dm, placements, run_check=False,
                                      shape=torch.Size(shape), stride=stride)

        with fake:
            args = tuple(_map2(make, a, s) for a, s in zip(self.arg_shapes, self.in_specs))
        flat = [_leaves(a) for a in args]
        local = lambda t: getattr(t, "_local_tensor", t)
        arg_keys = {local(t).untyped_storage()._cdata for leaves in flat for t in leaves}
        arg_bytes = sum(local(t).numel() * local(t).element_size()
                        for leaves in flat for t in leaves)
        donated = sum(local(t).numel() * local(t).element_size()
                      for i in self.donate_argnums for t in flat[i])
        rec = traceanalysis.Recorder(fake, tfm.recomputing, layers.scan_scope)
        arg_ids = {rec.id_of(local(t)) for leaves in flat for t in leaves}
        log: list = []
        ctx = [xlaforms.XlaForms()]
        if sharded:
            from torch.distributed.tensor.experimental import implicit_replication
            xlaforms.register_strategies()
            ctx += [implicit_replication(), traceanalysis.dtensor_hooks(rec)]
        with fake, use_rules(self.mesh, self.rules, log), rec:
            for c in ctx:
                c.__enter__()
            try:
                out = self.fn(*args)
            finally:
                for c in reversed(ctx):
                    c.__exit__(None, None, None)
        outs = [o for o in torch.utils._pytree.tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        out_new = sum(local(o).numel() * local(o).element_size() for o in outs
                      if local(o).untyped_storage()._cdata not in arg_keys)
        out_ids = {rec.id_of(local(o)) for o in outs}
        trace = Trace(rec.records, log, arg_bytes, out_new, donated, rec.max_live,
                      rec.replicated, arg_ids, out_ids,
                      self.mesh.size if self.cfg.n_experts and sharded else 0)
        del out, outs, args, flat
        return trace

    def trace(self, device="cuda") -> Trace:
        """The step once on DTensors of fake ``device`` tensors over the
        mesh's ranks: what each device runs, with the collectives."""
        return self._run(device, sharded=True)

    def lower(self, device="cuda") -> Trace:
        """The step once on global fake ``device`` tensors, no mesh (memoized
        per device; ``release_lowered`` drops it)."""
        if device not in self._lowered:
            self._lowered[device] = self._run(device, sharded=False)
        return self._lowered[device]

    def release_lowered(self):
        self._lowered = {}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, policy: RunPolicy,
               mesh, opt: OptConfig | None = None) -> Cell:
    opt = opt or OptConfig(name=policy.optimizer)
    rules = dict(policy.rules_dict())
    rules.setdefault("pod_stack", (("pod",),))
    stats = FallbackStats()
    compute_dtype = torch.bfloat16 if policy.dtype == "bf16" else torch.float32
    pdtype = torch.float32 if policy.params_f32 else compute_dtype

    pshapes = _shape_tree(api.abstract_params(cfg, pdtype))
    paxes = api.axes(cfg)
    pspec = tree_specs(mesh, pshapes, paxes, rules, stats)
    bshapes, baxes = api.input_specs(cfg, shape, compute_dtype)
    bshapes = _shape_tree(bshapes)
    bspec = tree_specs(mesh, bshapes, baxes, rules, stats)

    if shape.kind == "train":
        if policy.zero1 and "data" in mesh.shape:
            rules[ZERO1] = (("data",),)
        init_opt = make_init_opt(cfg, policy, opt, mesh)
        oshapes = _shape_tree(init_opt(api.abstract_params(cfg, pdtype)))
        oaxes = {"mom": opt_state_axes(opt, paxes)["mom"], "step": ()}
        if policy.zero1:
            mom_spec = _zero1_specs(mesh, oshapes["mom"], oaxes["mom"], rules, stats)
        else:
            mom_spec = tree_specs(mesh, oshapes["mom"], oaxes["mom"], rules, stats)
        ospec = {"mom": mom_spec, "step": ()}
        if "ef" in oshapes:
            # each pod's error-feedback buffers: (n_pods, ...) on "pod"
            ef_axes = tree_map(lambda a: ("pod_stack",) + tuple(a), paxes)
            ospec["ef"] = tree_specs(mesh, oshapes["ef"], ef_axes, rules, stats)
        fn = make_train_step(cfg, policy, opt, mesh)
        return Cell(cfg, shape, policy, mesh, opt, fn, (pshapes, oshapes, bshapes),
                    (pspec, ospec, bspec), (0, 1), rules, stats)

    if shape.kind == "prefill":
        fn = make_prefill_step(cfg, policy, cache_len=shape.seq_len)
        return Cell(cfg, shape, policy, mesh, opt, _no_grad(fn), (pshapes, bshapes),
                    (pspec, bspec), (), rules, stats)

    if shape.kind == "decode":
        sshapes, saxes = api.state_specs(cfg, shape, compute_dtype)
        sshapes = _shape_tree(sshapes)
        sspec = tree_specs(mesh, sshapes, saxes, rules, stats)
        fn = make_decode_step(cfg, policy)
        return Cell(cfg, shape, policy, mesh, opt, _no_grad(fn),
                    (pshapes, sshapes, bshapes), (pspec, sspec, bspec), (1,), rules, stats)

    raise ValueError(shape.kind)


def _no_grad(fn):
    """Serving steps run without autograd (``inference_mode`` on the card)."""
    def run(*args):
        with torch.no_grad():
            return fn(*args)
    return run
