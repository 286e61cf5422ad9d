"""Train, prefill and decode step builders.

The train step composes microbatch gradient accumulation (a Python loop),
mixed precision (f32 params, bf16 compute), the remat policy (inside the
model), optional cross-pod compressed gradient reduction (a per-pod body on
the mesh of the other axes, ``train/compression.py``), gradient clipping and
the optimizer update.
"""
from __future__ import annotations

import contextlib

import torch
from torch.overrides import handle_torch_function, has_torch_function_unary

from ..configs.base import ModelConfig, RunPolicy
from ..launch.sharding import manual_axes
from ..models import api
from ..models import moe
from ..models.module import flatten, tree_map, unflatten
from . import compression
from .optimizer import OptConfig, init_opt_state, opt_update

MOE_AUX_COEF = 0.01


def make_loss_fn(cfg: ModelConfig, policy: RunPolicy):
    def loss_fn(params, mb):
        logits, aux = api.forward(params, mb, cfg, policy)
        loss = api.lm_loss(logits, mb["labels"])
        if cfg.n_experts:
            loss = loss + MOE_AUX_COEF * aux[0]
        return loss, aux
    return loss_fn


def microbatches(a, n: int, moe_groups: int = 0):
    """The ``n`` microbatches of a batch leaf: microbatch i is rows
    i*B/n .. (i+1)*B/n, as the JAX package's reshape to (n, B/n, ...) gives
    them to its scan.

    While a cell is traced on a mesh, the trace's forms
    (``launch/xlaforms.py``) cut them from each rank's rows instead, sharded
    as XLA keeps a microbatch; ``moe_groups`` (the MoE layers' group count
    of a microbatch, 0 without MoE) is what that form reads."""
    if has_torch_function_unary(a):
        return handle_torch_function(microbatches, (a,), a, n, moe_groups)
    b = a.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by microbatches {n}")
    return a.reshape((n, b // n) + tuple(a.shape[1:])).unbind(0)


def loop_body(params, mb, axes):
    """The params and the microbatch ``mb`` as the loop over microbatches
    computes with them, as a context (``with loop_body(params, mb, axes) as
    (p, m)``, around the microbatch's forward and backward): themselves.
    ``axes`` is the params' logical-axes tree.  While a train step is
    traced on a mesh, the trace's forms (``launch/xlaforms.py``) put them on
    the mesh and in the layout of XLA's loop."""
    leaf = flatten(mb)[0][1]
    if has_torch_function_unary(leaf):
        return handle_torch_function(loop_body, (leaf,), params, mb, axes)
    return contextlib.nullcontext((params, mb))


def _moe_groups(cfg, batch, n: int) -> int:
    """The MoE layers' group count of one of ``n`` microbatches (0 without
    MoE)."""
    if not cfg.n_experts:
        return 0
    B, S = batch["tokens"].shape[:2]
    return moe.groups_and_capacity(B // n * S, cfg.n_experts, cfg.top_k, 1.0)[0]


def compute_grads(cfg, policy, params, batch):
    """Microbatched value and grad.  Returns (loss, aux, grads), the grads in
    f32, summed over the microbatches and divided by their number, as the JAX
    package's ``compute_grads``."""
    if "unembed_f32" in params:
        raise ValueError("params carry the serving cache 'unembed_f32' (from "
                         "cast_params); the unembedding's gradient would go to it. "
                         "Train the f32 params themselves.")
    loss_fn = make_loss_fn(cfg, policy)
    paths, leaves = zip(*flatten(params))
    leaves = [p.detach().requires_grad_() for p in leaves]
    live = unflatten(zip(paths, leaves))
    n = max(policy.n_microbatch, 1)
    if n > 1:
        groups = _moe_groups(cfg, batch, n)
        parts = tree_map(lambda a: microbatches(a, n, groups), batch)
    axes = api.axes(cfg)
    gsum = lsum = asum = None
    for i in range(n):
        mb = tree_map(lambda t: t[i], parts) if n > 1 else batch
        with loop_body(live, mb, axes) as (body_params, body_mb):
            loss, aux = loss_fn(body_params, body_mb)
            grads = torch.autograd.grad(loss, leaves)
        if gsum is None:
            gsum = [g.float() for g in grads]
            lsum, asum = loss.detach(), aux.detach()
        else:
            for s, g in zip(gsum, grads):
                s.add_(g.float())
            lsum, asum = lsum + loss.detach(), asum + aux.detach()
        del grads, loss, aux
    return lsum / n, asum / n, unflatten(zip(paths, [g.div_(n) for g in gsum]))


def _use_compress(policy: RunPolicy, mesh) -> bool:
    return policy.grad_compress != "none" and mesh is not None and "pod" in mesh.shape


def make_train_step(cfg: ModelConfig, policy: RunPolicy, opt: OptConfig, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    On a mesh the arguments are DTensors and DTensor owns every reduction
    (the SPMD partitioner does in the JAX package).  When
    ``policy.grad_compress != 'none'`` and the mesh has a "pod" axis, the
    cross-pod gradient reduction is explicit and compressed
    (``_pod_train_step``); without a pod axis ``grad_compress`` changes
    nothing, as in the JAX package."""
    if _use_compress(policy, mesh):
        return _pod_train_step(cfg, policy, opt)

    def train_step(params, opt_state, batch):
        loss, aux, grads = compute_grads(cfg, policy, params, batch)
        new_params, new_opt, stats = opt_update(opt, grads, opt_state, params)
        metrics = {"loss": loss, "moe_lb": aux[0], "moe_drop": aux[1], **stats}
        return _map2(_gathered_as, new_params, params), new_opt, metrics
    return train_step


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _gathered_as(new, param):
    """``new`` (a parameter's update) gathered on the mesh dims where the
    parameter is whole and the update sharded: under ZeRO-1 the update is
    made on the optimizer state's data shards, and the JAX package's step
    returns each parameter in its argument's sharding (a donated output),
    which XLA's partitioner all-gathers.  Elsewhere ``new`` itself."""
    from torch.distributed.tensor import DTensor, Replicate
    if not (isinstance(new, DTensor) and isinstance(param, DTensor)):
        return new
    want = [Replicate() if p.is_replicate() and q.is_shard() else q
            for p, q in zip(param.placements, new.placements)]
    return new.redistribute(new.device_mesh, want) if want != list(new.placements) else new


# ------------------------------------------------ the compressed pod reduction

def _without_pod(placements, names, shift=0):
    """The placements of the mesh dims other than "pod", a Shard's dim moved
    by ``shift``."""
    from torch.distributed.tensor import Shard
    return [Shard(p.dim + shift) if p.is_shard() else p
            for n, p in zip(names, placements) if n != "pod"]


def _on(pod_placement, placements, names):
    """``placements`` of the other mesh dims with ``pod_placement`` put in
    the pod dim's place."""
    it = iter(placements)
    return [pod_placement if n == "pod" else next(it) for n in names]


def _local_dtensor(local, sub, placements, shape):
    """``local`` as a DTensor of ``shape`` on ``sub`` (the mesh of the
    dims other than "pod"), or the tensor itself where there is none."""
    import math
    from torch.distributed.tensor import DTensor
    if sub is None:
        return local
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, sub, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def _pod_train_step(cfg, policy, opt):
    """The train step with the cross-pod reduction in our hands, the
    counterpart of the JAX package's partial-manual ``shard_map`` over "pod".

    The params (replicated over "pod"), each pod's slice of the batch (its
    rows, "pod" sharding dim 0 outermost) and each pod's error-feedback
    buffers (``ef``: (n_pods, ...) leaves sharded on "pod") become DTensors
    on the mesh of the other dims, where each pod computes its mean gradient
    as DTensor partitions it, its constraints resolved without "pod"
    (``sharding.manual_axes``).  Each gradient is placed as its param is,
    and ``compression.reduce_grads`` reduces the shards over the pod dim's
    group; loss and aux are averaged over it.  The results are rebuilt on
    the whole mesh, replicated over "pod", and the optimizer updates as
    without compression.

    On plain tensors (the measurement's global trace, the program before it
    is partitioned) the one pod is the whole batch, and its gradients are
    compressed with no collective."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def global_grads(params, batch, ef):
        loss, aux, grads = compute_grads(cfg, policy, params, batch)
        red, new_ef = compression.reduce_grads(
            grads, tree_map(lambda e: e[0], ef) if ef is not None else None,
            policy.grad_compress, None)
        n_pods = flatten(ef)[0][1].shape[0] if ef is not None else 1
        return loss, aux, red, tree_map(
            lambda e: e[None].expand((n_pods,) + tuple(e.shape)), new_ef)

    def pod_grads(params, batch, ef):
        p_flat = flatten(params)
        dm = p_flat[0][1].device_mesh
        names = dm.mesh_dim_names
        others = tuple(n for n in names if n != "pod")
        sub = dm[others] if others else None
        group = dm.get_group("pod")
        n_pods = dm.size(names.index("pod"))
        R = Replicate()

        def into_pod(t, pod_placement, shift=0):
            """t on the whole mesh, with ``pod_placement`` on "pod" (a
            redistribution where it differs), as the pod's DTensor."""
            want = _on(pod_placement, _without_pod(t.placements, names), names)
            if list(t.placements) != want:
                t = t.redistribute(dm, want)
            local = t.to_local()
            shape = list(t.shape)
            if pod_placement.is_shard():
                shape[0] //= n_pods
            if shift:
                local, shape = local[0], shape[1:]
            return _local_dtensor(local, sub, _without_pod(t.placements, names, -shift),
                                  shape)

        def to_mesh(t, shape, pod_placement):
            """The pod's (DTensor or plain) ``t`` of ``shape`` on the whole
            mesh, with ``pod_placement`` on "pod"."""
            local = t.to_local() if isinstance(t, DTensor) else t
            inner = t.placements if isinstance(t, DTensor) else [R] * len(others)
            shift = 1 if pod_placement.is_shard() else 0
            placements = _on(pod_placement,
                             [Shard(p.dim + shift) if p.is_shard() else p for p in inner],
                             names)
            if shift:
                local, shape = local[None], (n_pods,) + tuple(shape)
            return _local_dtensor(local, dm, placements, tuple(shape))

        pp = unflatten((k, into_pod(v, R)) for k, v in p_flat)
        pb = tree_map(lambda t: into_pod(t, Shard(0)), batch)
        pe = tree_map(lambda t: into_pod(t, Shard(0), shift=1), ef) if ef is not None \
            else None
        with manual_axes(("pod",)):
            loss, aux, grads = compute_grads(cfg, policy, pp, pb)
            g_flat = [(k, _placed_as(g, pp_leaf))
                      for (k, g), (_, pp_leaf) in zip(flatten(grads), flatten(pp))]
            red, new_ef = compression.reduce_grads(unflatten(g_flat), pe,
                                                   policy.grad_compress, group)
            loss = compression._all_reduce(loss, "sum", group) / n_pods
            aux = compression._all_reduce(aux, "sum", group) / n_pods
        shapes = dict((k, p.shape) for k, p in p_flat)
        return (to_mesh(loss, loss.shape, R), to_mesh(aux, aux.shape, R),
                unflatten((k, to_mesh(g, shapes[k], R)) for k, g in flatten(red)),
                unflatten((k, to_mesh(e, shapes[k], Shard(0))) for k, e in flatten(new_ef)))

    def train_step(params, opt_state, batch):
        ef = opt_state.get("ef")
        dtensors = isinstance(flatten(params)[0][1], DTensor)
        loss, aux, grads, new_ef = (pod_grads if dtensors else global_grads)(
            params, batch, ef)
        new_params, new_opt, stats = opt_update(
            opt, grads, {k: v for k, v in opt_state.items() if k != "ef"}, params)
        new_opt["ef"] = new_ef
        metrics = {"loss": loss, "moe_lb": aux[0], "moe_drop": aux[1], **stats}
        return new_params, new_opt, metrics
    return train_step


def _placed_as(g, p):
    """The gradient ``g`` redistributed to its param's placements."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_init_opt(cfg: ModelConfig, policy: RunPolicy, opt: OptConfig, mesh=None):
    """The optimizer state's init; with a compressed pod reduction it also
    holds ``ef``, each pod's error-feedback buffers: (n_pods, ...) f32 zeros
    a param."""
    def init(params):
        st = init_opt_state(opt, params)
        if _use_compress(policy, mesh):
            n_pods = mesh.shape["pod"]
            st["ef"] = tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                                      dtype=torch.float32, device=p.device),
                                params)
        return st
    return init


# ------------------------------------------------------------------- serving

def make_prefill_step(cfg: ModelConfig, policy: RunPolicy, cache_len: int):
    def prefill_step(params, batch):
        logits, aux, state = api.forward(params, batch, cfg, policy,
                                         return_cache=True, cache_len=cache_len)
        return logits, state
    return prefill_step


def make_decode_step(cfg: ModelConfig, policy: RunPolicy):
    def dstep(params, state, batch):
        return api.decode_step(params, state, batch, cfg, policy)
    return dstep
