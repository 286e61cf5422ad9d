"""The step traced in the forms that XLA partitions.

The JAX package's step reaches XLA as primitives that GSPMD partitions
whole: ``dot_general`` keeps every dim of its operands, ``log_softmax`` is a
chain of reductions, a row lookup is a ``gather``.  torch's eager
decompositions of the same functions are not all placeable by DTensor: a
matmul of a (B,S,D) activation flattens (B,S) into one dim, which DTensor
can place only with strided shards (a torch release without them refuses
the view), and its ``log_softmax`` replicates the dim it reduces.  While a
cell is traced, ``XlaForms`` (a ``TorchFunctionMode``) rewrites those calls
into the forms the reference's program has:

* ``a @ b``, ``matmul`` and two-operand ``einsum`` become one
  ``repro_trace::dot_general`` op (a fake implementation, a FLOP formula,
  a DTensor sharding rule over its letters, and a backward of two more
  ``dot_general`` ops).  On every mesh dim a letter shared by both operands
  and the output is sharded in all three, a free letter with its operand
  and the output, a contracted letter in both operands with a partial-sum
  output, summed at once as XLA's partitioner sums a dot's partial result
  (DTensor's own rule for ``mm`` and ``bmm`` over any letters, less the
  partial-sum operands it lets through: XLA never carries one into a dot);
* ``log_softmax`` of a DTensor sharded along the reduced dim becomes
  ``x - max - log(sum(exp(x - max)))``, whose reductions DTensor partitions
  (partial results, all-reduced where they are made);
* ``gather`` of one element along a sharded dim (the label's log-prob)
  becomes a masked sum over that dim, a partial sum that is all-reduced
  (DTensor's masked partial loses its mask through the view that follows);
  a gather of many along a sharded dim (MoE's combine) all-gathers that dim
  first and keeps the other dims' shards;
* ``table[idx]`` of a 2-D table and an integer index becomes ``embedding``
  (XLA's gather; DTensor masks a vocab-sharded table);
* ``pad`` of a DTensor becomes a concatenation of filled slices (DTensor's
  ``constant_pad_nd`` fails inside a redistribution in some releases);
* GQA's grouping of H query heads as (KV, G), where the mesh splits the
  heads unevenly over the KV groups (qwen2's 12 heads over 2 KV heads on 4
  ranks), keeps each head its own group (``attention.group_heads``), and
  the K/V heads are repeated to the query heads (``attention.kv_for``):
  attention stays sharded on the heads, as XLA tiles (KV, G) jointly.  A
  single decode token is gathered instead, and attends sharded on the
  cache's sequence.

``register_strategies`` adds ``dot_general``'s rule, and a rule for
``index_put`` that models GSPMD where DTensor's own differs or fails
between releases: a scatter into a dim that is sharded, each shard applying
the updates that fall in its range, as XLA partitions a scatter.  It also
gives ``gather``, ``scatter_add`` and the stable ``sort`` of MoE's batched
dispatch one rule on every release: local wherever a dim other than the
one gathered, scattered or sorted is sharded alike in every operand.

Nothing here runs outside a trace: serving and training call torch's ops.
"""
from __future__ import annotations

import functools
import string
from typing import Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import register_flop_formula

from ..models import attention as attn
from ..models import transformer as tfm

# ------------------------------------------------------------ dot_general


def _parse(eqn: str):
    lhs, out = eqn.split("->")
    a, b = lhs.split(",")
    return a, b, out


def _out_shape(eqn, a_shape, b_shape):
    a, b, out = _parse(eqn)
    size = dict(zip(a, a_shape))
    size.update(zip(b, b_shape))
    return [size[c] for c in out]


@torch.library.custom_op("repro_trace::dot_general", mutates_args=())
def _dot_general(a: torch.Tensor, b: torch.Tensor, rank: int, eqn: str) -> torch.Tensor:
    return torch.einsum(eqn, a, b)


def dot_general(a, b, eqn: str):
    """``einsum(eqn, a, b)`` as one op: the trace's form of every product.
    A DTensor result that holds partial sums is summed at once, as XLA's
    partitioner all-reduces a dot's output where it makes it.  (The op also
    takes the output's rank: an int argument, so that DTensor's sharding
    cache, which keys on the arguments from the first int on, tells
    equations apart.)"""
    return _summed(_dot_general(a, b, len(_parse(eqn)[2]), eqn))


def _summed(x):
    """``x`` with its partial-sum placements all-reduced to replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in x.placements])
    return x


@_dot_general.register_fake
def _(a, b, rank, eqn):
    return a.new_empty(_out_shape(eqn, a.shape, b.shape))


def _sharded_like(primal, ep, operands):
    """``operands`` ((tensor, letters) pairs of a gradient's product),
    each replicated mesh dim of one of them that ``primal`` (letters
    ``ep``) shards along a letter the operand holds sharded there too: a
    local slice, so that the gradient is made in its primal's placement, as
    XLA's partitioner makes it, and not whole on every rank of that dim."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(primal, DTensor):
        return [t for t, _ in operands]
    out = []
    for t, et in operands:
        if not isinstance(t, DTensor):
            out.append(t)
            continue
        pl = list(t.placements)
        for i, p in enumerate(primal.placements):
            j = et.find(ep[p.dim]) if p.is_shard() else -1
            if j >= 0 and pl[i].is_replicate() and not any(q.is_shard(j) for q in pl) \
                    and t.shape[j] % t.device_mesh.size(i) == 0:
                pl[i] = Shard(j)
        out.append(t.redistribute(t.device_mesh, pl) if pl != list(t.placements) else t)
    return out


def _dot_backward(ctx, g):
    a, b = ctx.saved_tensors
    ea, eb, eo = _parse(ctx.eqn)
    ga = gb = None
    if ctx.needs_input_grad[0]:
        g_, b_ = _sharded_like(a, ea, [(g, eo), (b, eb)])
        ga = dot_general(g_, b_, f"{eo},{eb}->{ea}")
    if ctx.needs_input_grad[1]:
        g_, a_ = _sharded_like(b, eb, [(g, eo), (a, ea)])
        gb = dot_general(g_, a_, f"{eo},{ea}->{eb}")
    return ga, gb, None, None


def _dot_setup(ctx, inputs, output):
    a, b, rank, eqn = inputs
    ctx.save_for_backward(a, b)
    ctx.eqn = eqn


_dot_general.register_autograd(_dot_backward, setup_context=_dot_setup)
dot_general_op = torch.ops.repro_trace.dot_general


def _no_batch_letters(a, b, rank, eqn):
    ea, eb, eo = _parse(eqn)
    return not any(c in eb and c in eo for c in ea)


# remat "dots" keeps a product with no batch letters, as it keeps an mm
tfm.SAVED_PRODUCTS[dot_general_op.default] = _no_batch_letters


@register_flop_formula(torch.ops.repro_trace.dot_general)
def _(a_shape, b_shape, rank, eqn, *args, out_shape=None, **kw):
    """2 per multiply-add: twice the product of every letter's size."""
    a, b, _ = _parse(eqn)
    size = dict(zip(a, a_shape))
    size.update(zip(b, b_shape))
    n = 2
    for s in size.values():
        n *= s
    return n


def _dot_strategies(a, b, rank, eqn):
    """([out], [a, b]) placements on one mesh dim (DTensor's einsum rule)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ea, eb, eo = _parse(eqn)
    R = Replicate()
    out = [([R], [R, R])]
    for c in sorted(set(ea + eb)):
        ia, ib, io = ea.find(c), eb.find(c), eo.find(c)
        if io >= 0:
            out.append(([Shard(io)], [Shard(ia) if ia >= 0 else R, Shard(ib) if ib >= 0 else R]))
        elif ia >= 0 and ib >= 0:
            out.append(([Partial()], [Shard(ia), Shard(ib)]))
    return out


def _as_eqn(eqn: str, a, b) -> Optional[str]:
    """``eqn`` with its ellipsis spelled out in letters, or None where
    ``dot_general`` does not take it (a letter repeated in one operand, an
    operand letter missing from both the other operand and the output, or
    sizes that broadcast)."""
    eqn = eqn.replace(" ", "")
    if "->" not in eqn or eqn.count(",") != 1:
        return None
    ea, eb, eo = _parse(eqn)
    if "..." in eqn:
        used = set(eqn) - set(".,->")
        free = [c for c in string.ascii_letters if c not in used]
        na = a.dim() - len(ea.replace("...", ""))
        nb = b.dim() - len(eb.replace("...", ""))
        n = max(na, nb)
        if na not in (0, n) or nb not in (0, n) or n > len(free):
            return None
        ell = "".join(free[:n])
        ea = ea.replace("...", ell if na else "")
        eb = eb.replace("...", ell if nb else "")
        eo = eo.replace("...", ell)
    if len(ea) != a.dim() or len(eb) != b.dim():
        return None
    if len(set(ea)) != len(ea) or len(set(eb)) != len(eb) or len(set(eo)) != len(eo):
        return None
    if any(c not in eb + eo for c in ea) or any(c not in ea + eo for c in eb):
        return None
    if any(c not in ea + eb for c in eo):
        return None
    size = {}
    for letters, shape in ((ea, a.shape), (eb, b.shape)):
        for c, s in zip(letters, shape):
            if size.setdefault(c, s) != s:
                return None
    return f"{ea},{eb}->{eo}"


def _matmul_eqn(a, b) -> Optional[str]:
    """The einsum equation of ``a @ b`` where it has no broadcasting: b is a
    matrix, or both have the same batch dims."""
    if a.dim() < 1 or b.dim() < 2:
        return None
    letters = string.ascii_lowercase
    if b.dim() == 2:
        lead = letters[:a.dim() - 1]
        return f"{lead}y,yz->{lead}z"
    if a.dim() == b.dim() and a.shape[:-2] == b.shape[:-2]:
        lead = letters[:a.dim() - 2]
        return f"{lead}xy,{lead}yz->{lead}xz"
    return None


# ------------------------------------------------------------- the rewrites

def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _sharded_on(x, dim) -> bool:
    dim = dim % x.dim()
    return any(p.is_shard(dim) for p in x.placements)


def _einsum(eqn, *operands):
    if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
        operands = tuple(operands[0])
    if len(operands) == 2:
        a, b = operands
        e = _as_eqn(eqn, a, b)
        if e is not None and a.dtype == b.dtype:
            return dot_general(a, b, e)
    return NotImplemented


def _matmul(a, b, *, out=None):
    if out is None and isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
            and a.dtype == b.dtype:
        e = _matmul_eqn(a, b)
        if e is not None:
            return dot_general(a, b, e)
    return NotImplemented


def _log_softmax(x, dim=None, dtype=None, *args, **kwargs):
    if dim is None or args or kwargs or not _dtensor(x) or not _sharded_on(x, dim):
        return NotImplemented
    if dtype is not None:
        x = x.to(dtype)
    # each reduction's partial result all-reduced where it is made, as XLA's
    # partitioner does (a torch release's DTensor may reduce-scatter it onto
    # another dim instead, and the whole loss follows that dim)
    m = _summed(x.detach().amax(dim=dim, keepdim=True))
    return x - m - torch.log(_summed(torch.exp(x - m).sum(dim=dim, keepdim=True)))


def _gather(x, dim, index, *, sparse_grad=False, out=None):
    if out is not None or not _dtensor(x) or not _sharded_on(x, dim):
        return NotImplemented
    dim = dim % x.dim()
    if index.shape[dim] != 1:
        # a gather of many rows along a sharded dim (MoE's combine): the
        # operand is all-gathered on that dim, its other dims keep their
        # shards (DTensor would move a batch dim's shard onto the gathered
        # dim's mesh axes instead, which XLA does not do)
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim) else p
                                           for p in x.placements])
        return torch.gather(x, dim, index)
    pos = torch.arange(x.shape[dim], device=x.device)
    pos = pos.view([-1 if d == dim else 1 for d in range(x.dim())])
    return torch.where(pos == index, x, torch.zeros((), dtype=x.dtype, device=x.device)) \
        .sum(dim, keepdim=True)


def _getitem(table, idx):
    if isinstance(idx, torch.Tensor) and table.dim() == 2 and not idx.is_floating_point() \
            and idx.dtype != torch.bool:
        # a vocab-sharded table's masked partial rows are summed at once (the
        # mask lives only as long as the op that made it)
        return _summed(F.embedding(idx, table))
    return NotImplemented


def _pad(x, pad, mode="constant", value=None):
    if not _dtensor(x) or mode != "constant":
        return NotImplemented
    value = 0.0 if value is None else value
    for i in range(len(pad) // 2):
        dim = x.dim() - 1 - i
        before, after = pad[2 * i], pad[2 * i + 1]
        if before < 0 or after < 0:
            return NotImplemented
        if before == 0 and after == 0:
            continue
        edge = x.narrow(dim, 0, 1)

        def fill(n):
            shape = list(edge.shape)
            shape[dim] = n
            return torch.full_like(edge, value).expand(shape)
        x = torch.cat(([fill(before)] if before else []) + [x] + ([fill(after)] if after else []),
                      dim)
    return x


def _group_heads(q, n_kv):
    """The query heads of a DTensor q (B,S,H,dh) whose mesh splits H over
    more ranks than there are KV heads, unevenly for a (KV, G) view: as
    (B,S,H,1,dh), each head its own group, sharded as q is (XLA tiles (KV, G)
    jointly, H/n heads a rank; DTensor cannot place that view); a single
    decode token is gathered and grouped as (KV, G)."""
    if not _dtensor(q):
        return NotImplemented
    n = 1
    for size, p in zip(q.device_mesh.shape, q.placements):
        if p.is_shard(2):
            n *= size
    if n == 1 or n_kv % n == 0:
        return NotImplemented
    if q.shape[1] == 1:
        # one decode token: gathered whole (a few KB) and grouped as (KV, G),
        # so its attention runs sharded on the cache's sequence
        from torch.distributed.tensor import Replicate
        q = q.redistribute(q.device_mesh, [Replicate() if p.is_shard(2) else p
                                           for p in q.placements])
        return attn.group_heads(q, n_kv)
    return q.unsqueeze(3)


_REWRITES = {
    torch.matmul: _matmul, torch.Tensor.matmul: _matmul, torch.Tensor.__matmul__: _matmul,
    torch.einsum: _einsum,
    torch.log_softmax: _log_softmax, torch.Tensor.log_softmax: _log_softmax,
    torch.gather: _gather, torch.Tensor.gather: _gather,
    torch.Tensor.__getitem__: _getitem, F.pad: _pad,
    attn.group_heads: _group_heads,
}


class XlaForms(TorchFunctionMode):
    """While active, the calls of ``_REWRITES`` run in XLA's forms (see the
    module docstring); every other call runs as it is."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        rewrite = _REWRITES.get(func)
        if rewrite is not None:
            out = rewrite(*args, **kwargs)
            if out is not NotImplemented:
                return out
        return func(*args, **kwargs)


# ----------------------------------------------------- DTensor strategies

def _index_put_strategies(self, indices, values, *args):
    """([out], [self, *index tensors, values]): replicated; sharded
    on a dim the indices do not address (values sharded on its counterpart,
    as DTensor's own rule); or sharded on an addressed dim with the indices
    and values replicated (each shard applies the updates in its range)."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    idx = [i for i, t in enumerate(indices) if t is not None]
    n_idx = len(idx)
    shapes = [tuple(indices[i].shape) for i in idx]
    bcast = len(torch.broadcast_shapes(*shapes)) if shapes else 0
    nd, nv = len(self.shape), len(values.shape)
    contiguous = not idx or idx[-1] - idx[0] + 1 == n_idx
    out = [([R], [R] + [R] * n_idx + [R])]
    free = [d for d in range(nd) if d not in idx]
    for j, d in enumerate(free):
        vd = (d if d < idx[0] else d - n_idx + bcast) if contiguous and idx else bcast + j
        vd -= (bcast + len(free)) - nv
        vp = Shard(vd) if vd >= 0 and values.shape[vd] != 1 else R
        out.append(([Shard(d)], [Shard(d)] + [R] * n_idx + [vp]))
    for d in idx:
        out.append(([Shard(d)], [Shard(d)] + [R] * n_idx + [R]))
    return out


def _gather_strategies(x, dim, index, *args, **kwargs):
    """([out], [self, index]) of ``gather``: replicated; sharded on a dim
    other than ``dim`` where the operand and the index agree in size (each
    shard gathers its own rows, as MoE's batched dispatch does over its
    groups); or the index sharded on ``dim`` with the operand replicated."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    dim = dim % len(x.shape)
    out = [([R], [R, R]), ([Shard(dim)], [R, Shard(dim)])]
    if len(x.shape) == len(index.shape):
        out += [([Shard(d)], [Shard(d), Shard(d)]) for d in range(len(x.shape))
                if d != dim and x.shape[d] == index.shape[d]]
    return out


def _scatter_add_strategies(x, dim, index, src, *args):
    """([out], [self, index, src]) of ``scatter_add``: replicated, or sharded
    on a dim other than ``dim`` where all three agree in size."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    dim = dim % len(x.shape)
    out = [([R], [R, R, R])]
    if len(x.shape) == len(index.shape) == len(src.shape):
        out += [([Shard(d)], [Shard(d)] * 3) for d in range(len(x.shape))
                if d != dim and x.shape[d] == index.shape[d] == src.shape[d]]
    return out


def _sort_strategies(x, *args, dim=-1, **kwargs):
    """([values, indices], [self]) of a stable sort: replicated, or sharded
    on a dim other than the sorted one."""
    from torch.distributed.tensor import Replicate, Shard
    R = Replicate()
    dim = dim % len(x.shape)
    return [([R, R], [R])] + [([Shard(d), Shard(d)], [Shard(d)])
                              for d in range(len(x.shape)) if d != dim]


@functools.lru_cache(maxsize=None)
def register_strategies():
    """Register the DTensor rules of this module (once per process; they
    hold only for DTensors, which only the measurement makes)."""
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten
    register_sharding(torch.ops.repro_trace.dot_general.default)(_dot_strategies)
    puts = [aten.index_put.default, aten.index_put_.default, aten._index_put_impl_.default]
    register_sharding(puts)(_index_put_strategies)
    # MoE's batched dispatch and combine (torch releases differ in their own
    # rules for these, or have none)
    register_sharding(aten.gather.default)(_gather_strategies)
    register_sharding(aten.scatter_add.default)(_scatter_add_strategies)
    register_sharding(aten.sort.stable)(_sort_strategies)
    # a release that keeps per-mesh-dim rules apart looks them up first, so
    # the registration above overrides its own rule only once that is gone
    from torch.distributed.tensor import DTensor
    single = getattr(DTensor._op_dispatcher.sharding_propagator,
                     "op_single_dim_strategy_funcs", {})
    for op in puts + [aten.gather.default, aten.scatter_add.default, aten.sort.stable]:
        single.pop(op, None)
