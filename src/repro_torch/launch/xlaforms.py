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
  where an activation keeps its sequence shard on a mesh axis on which the
  other, smaller operand is sharded too (FSDP's weight on its input dim,
  the keys and values), that operand is gathered first, as XLA gathers it,
  not both moved onto a contracted dim (``_gathered_for_kept_shards``);
* ``log_softmax`` of a DTensor sharded along the reduced dim becomes
  ``x - max - log(sum(exp(x - max)))``, whose reductions DTensor partitions
  (partial results, all-reduced where they are made, the backward's too:
  ``_GradSummed``), and ``softmax`` there ``exp(x - max) / sum(...)`` (a
  decode step's scores over a sequence-sharded cache);
* ``gather`` of one element along a sharded dim (the label's log-prob)
  becomes a sum over that dim masked on each rank's own shard, its
  backward a scatter of the gradient into the shard (``_Picked``);
  a gather of many along a sharded dim (MoE's combine) all-gathers that dim
  first and keeps the other dims' shards;
* ``table[idx]`` of a 2-D table and an integer index becomes ``embedding``
  (XLA's gather; DTensor masks a vocab-sharded table);
* ``pad`` of a DTensor becomes a concatenation of filled slices (DTensor's
  ``constant_pad_nd`` fails inside a redistribution in some releases);
* ``layers.shift`` along a sequence that one mesh dim shards (rwkv6's token
  shift, the RG-LRU's causal conv) becomes a halo exchange, as GSPMD
  partitions the pad and slice back (``_shift``): each shard shifted, its
  first rows the previous rank's last, by one collective-permute, where
  DTensor's concatenation would all-gather the sequence;
* ``cumsum`` of a DTensor along a dim no mesh dim shards runs on each
  rank's shard, its backward too (``_Cumsum``: torch 2.11's DTensor would
  gather the gradient for the flip of cumsum's backward);
* a select of one entry of a sharded dim (the chunked WKV's loop over its
  chunks) gathers the dim once for every select into the tensor and
  copies the entry out, as XLA hoists the loop-invariant all-gather and
  slices in its loop (``_hoisted_select``; its backward gathers the
  tensor again, as XLA's does from the sharded residual its layer loop
  keeps: ``_Regathered``), and ``stack`` of DTensors gathers its gradient
  once before splitting it (``_Stacked``);
* rwkv6's split of its five mixed streams (``rwkv6.split_streams``) backs
  up as the reference's five slices do in XLA: five pads and their sum,
  and, where the streams are sharded on the sequence, the gathers and
  all-to-alls of the gradients XLA computes with the sequence whole
  (``_Streams``);
* GQA's grouping of H query heads as (KV, G), where the mesh splits the
  heads unevenly over the KV groups (qwen2's 12 heads over 2 KV heads on 4
  ranks), keeps each head its own group (``attention.group_heads``), and
  the K/V heads are repeated to the query heads (``attention.kv_for``):
  attention stays sharded on the heads, as XLA tiles (KV, G) jointly.  A
  single decode token is gathered instead where the cache's sequence is
  sharded on the heads' mesh axes, and attends sharded on it; against a
  replicated cache it keeps its heads sharded and each rank reads its own
  heads' KV heads (``_kv_for``);
* local attention's view of a sharded sequence as chunks
  (``attention.chunk_view``) keeps each rank's positions as a block of
  queries, each block's window of keys and values gathered over the mesh
  dims within a chunk and the chunk before by a halo exchange
  (``_chunk_view``, ``_chunk_unview``);
* the train step's split of a batch into microbatches
  (``train_step.microbatches``) keeps each microbatch sharded as XLA's
  loop does, from one redistribution of the batch (``_microbatches``),
  where DTensor's view of a batch sharded over more ranks than a
  microbatch has rows would run replicated; where XLA's loop holds a
  microbatch on other ranks than the constraints put its rows on, the
  tokens' embedding and the logits (``transformer.from_batch``) move
  between the two by a collective-permute each way (``_from_batch``);
  a dense microbatch of rows that no whole mesh axis divides runs in the
  loop body XLA's loop runs (``train_step.loop_body``, ``_Body``): its rows
  on part of the last batch axis, a mesh dim of the body's finer mesh over
  the same ranks, and, under ZeRO-1, each weight split over the ZeRO-1
  axis, its gradient gathered back into the optimizer state's layout;
* the logits' product of a train step under ZeRO-1 with the table whole
  (``transformer.unembed``) makes the table's gradient as GSPMD makes it
  in the optimizer state's layout: split over an idle mesh axis, reduced,
  and moved onto the ZeRO-1 axis (``_unembed``);
* the RG-LRU gates' view of a width sharded over more ranks than divide
  its blocks gathers the width first and slices the gates' outputs back
  (``_block_view``, ``_block_unview``), so that only the gates, not the
  block after them, run whole on each rank;
* rwkv6's fold of a sequence-parallel WKV's shards into rows, where both
  the rows and the shards are sharded, keeps each rank's rows in place
  (``_fold_shards``, ``_unfold_shards``), as XLA's reshape does; and
  MoE's views of a microbatch whose sequence is sharded as groups and
  back, each rank's tokens its own groups (``_group_tokens``), the groups
  gathered back only on the mesh dims that shard them and not the rows or
  sequence (``_ungroup``).

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

import contextlib
import functools
import math
import string
import weakref
from typing import Optional

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.flop_counter import register_flop_formula

from ..models import attention as attn
from ..models import layers
from ..models import moe
from ..models import rglru
from ..models import rwkv6 as rwkv
from ..models import transformer as tfm
from ..train import train_step
from . import sharding

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
    # contiguous, as the fake implementation's output (DTensor views a
    # local result by the strides that one gives)
    return torch.einsum(eqn, a, b).contiguous()


def dot_general(a, b, eqn: str):
    """``einsum(eqn, a, b)`` as one op: the trace's form of every product.
    A DTensor result that holds partial sums is summed at once, as XLA's
    partitioner all-reduces a dot's output where it makes it.  (The op also
    takes the output's rank: an int argument, so that DTensor's sharding
    cache, which keys on the arguments from the first int on, tells
    equations apart.)"""
    return _summed(_dot_general(*_gathered_for_kept_shards(a, b, eqn), len(_parse(eqn)[2]),
                                eqn))


def _grad_product(a, b, eqn):
    """A gradient's product: ``dot_general`` with the operands as DTensor
    places them (``_sharded_like`` has put them in their primal's
    placement)."""
    return _summed(_dot_general(a, b, len(_parse(eqn)[2]), eqn))


def _gathered_for_kept_shards(a, b, eqn):
    """``a`` and ``b``, where ``a`` (an activation) shards a letter of its
    own that the output keeps (its sequence) on a mesh dim on which ``b``
    shards a contracted letter (FSDP's weight, sharded on its input dim, or
    the values against sequence-sharded probabilities) or a letter of its
    own while sharing a batch letter with ``a`` (the keys against
    sequence-sharded queries), and ``b`` is no larger than ``a``: ``b``
    gathered on that mesh dim, so that the output keeps ``a``'s shard, as
    XLA's partitioner all-gathers the weight or the keys and values, the
    smaller operand.  DTensor weighs only its operands' redistribution:
    where moving both shards onto a contracted dim costs less than
    gathering a wide weight or many KV heads, it would contract a partial
    sum and leave the output, and all that follows, unsharded on that mesh
    dim.  (A weight sharded on its output dim, the tensor- or
    vocab-parallel case, and a decode step's one-token query against its
    cache are left to DTensor.)"""
    from torch.distributed.tensor import DTensor, Replicate
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) \
            or a.device_mesh != b.device_mesh:
        return a, b
    ea, eb, eo = _parse(eqn)
    contracted = set(ea) & set(eb) - set(eo)
    batch = set(ea) & set(eb) & set(eo)
    if _IN_BODY[0]:
        # in a microbatch loop's body (``_Body``), ``a`` split over the ZeRO-1
        # axis on a contracted letter where ``b`` (the table looked up in,
        # split on its vocab) shards a letter of its own there: ``a``
        # gathered, as XLA gathers the embedding's split for the logits,
        # where DTensor would move both
        pa = [Replicate() if x.is_shard() and y.is_shard() and ea[x.dim] in contracted
              and eb[y.dim] in eo and eb[y.dim] not in ea else x
              for x, y in zip(a.placements, b.placements)]
        if pa != list(a.placements):
            a = a.redistribute(a.device_mesh, pa)
    if b.numel() > a.numel():
        return a, b
    pb = list(b.placements)
    for i, (x, y) in enumerate(zip(a.placements, pb)):
        if not (x.is_shard() and y.is_shard()):
            continue
        la, lb = ea[x.dim], eb[y.dim]
        if la in eo and la not in eb and la != lb and \
                (lb in contracted or (batch and lb in eo and lb not in ea)):
            pb[i] = Replicate()
    if pb != list(b.placements):
        b = b.redistribute(b.device_mesh, pb)
    return a, b


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
        ga = _grad_product(g_, b_, f"{eo},{eb}->{ea}")
    if ctx.needs_input_grad[1]:
        g_, a_ = _sharded_like(b, eb, [(g, eo), (a, ea)])
        gb = _grad_product(g_, a_, f"{eo},{ea}->{eb}")
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
    # (and the backward's partial sum of the gradient over the dim too,
    # before it is broadcast back over the shards: ``_GradSummed``)
    m = _summed(x.detach().amax(dim=dim, keepdim=True))
    s = _GradSummed.apply(torch.exp(x - m).sum(dim=dim, keepdim=True))
    return x - m - torch.log(_summed(s))


def _mean(x, dim=None, keepdim=False, *, dtype=None, out=None):
    """``mean`` of a DTensor along a dim the mesh shards, in a microbatch
    loop's body (``_Body``: a norm over the embedding that the weights'
    split puts on data): the partial sums all-reduced at once, as XLA's
    partitioner all-reduces a reduction's partial result where it makes it.
    DTensor would reduce-scatter them onto the sequence and carry that split
    into the backward, making the output projections' weight gradients on
    sequence shards, all-reduced over data."""
    if out is not None or dtype is not None or dim is None or not _dtensor(x) \
            or not _IN_BODY[0]:
        return NotImplemented
    dims = [dim] if isinstance(dim, int) else list(dim)
    if not any(_sharded_on(x, d % x.dim()) for d in dims):
        return NotImplemented
    return _summed(torch.sum(x, dim, keepdim)) / math.prod(x.shape[d] for d in dims)


def _softmax(x, dim=None, dtype=None, *args, **kwargs):
    if dim is None or args or kwargs or not _dtensor(x) or not _sharded_on(x, dim):
        return NotImplemented
    if dtype is not None:
        x = x.to(dtype)
    # each rank's exponentials of its own shard, the max and the sum over
    # the dim all-reduced where they are made, as XLA's partitioner reduces
    # (a decode step's scores over a cache whose sequence is sharded: DTensor
    # would gather the scores and compute the softmax whole on every rank)
    m = _summed(x.detach().amax(dim=dim, keepdim=True))
    e = torch.exp(x - m)
    return e / _summed(_GradSummed.apply(e.sum(dim=dim, keepdim=True)))


class _GradSummed(torch.autograd.Function):
    """The identity, whose backward all-reduces a partial-sum gradient where
    it is made, as XLA's partitioner does (DTensor would broadcast it over
    the sharded dim first and reduce-scatter the broadcast)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


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
    return _Picked.apply(x, dim, index)


class _Picked(torch.autograd.Function):
    """One entry of ``x`` along ``dim``, a dim that the mesh shards (the
    label's log-probability over a vocab-sharded dim), at ``index`` (of size
    1 along ``dim``), as GSPMD partitions the gather and its transpose: each
    rank selects from the positions its shard holds, a partial sum over the
    mesh dims that shard ``dim``, and the backward scatters the gradient
    into zeros of its shard, as XLA's transpose of the gather scatters it.
    (DTensor would place a mask by its own pointwise rules, which differ
    between torch releases: torch 2.11 gathers the index over the rows and
    then the backward's whole gradient.)"""

    @staticmethod
    def forward(ctx, x, dim, index):
        from torch.distributed.tensor import Partial, Replicate
        dm = x.device_mesh
        want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
        if not _dtensor(index):
            index = _from_local(index, dm, [Replicate()] * dm.ndim, tuple(index.shape))
        idx = index.redistribute(dm, want).to_local()
        n, start = x.shape[dim], 0
        for i, p in enumerate(x.placements):
            if p.is_shard(dim):
                n //= dm.size(i)
                start += dm.get_local_rank(i) * n
        local = x.to_local()
        pos = torch.arange(start, start + n, device=local.device)
        mask = pos.view([-1 if d == dim else 1 for d in range(x.dim())]) == idx
        ctx.save_for_backward((idx - start).clamp(0, n - 1), (idx >= start) & (idx < start + n))
        ctx.like = (dm, tuple(x.placements), tuple(x.shape), want, dim, tuple(local.shape))
        out = torch.where(mask, local, torch.zeros((), dtype=local.dtype, device=local.device))
        shape = tuple(1 if d == dim else size for d, size in enumerate(x.shape))
        return _from_local(out.sum(dim, keepdim=True), dm,
                           [Partial() if p.is_shard(dim) else p for p in x.placements], shape)

    @staticmethod
    def backward(ctx, g):
        at, inside = ctx.saved_tensors
        dm, placements, shape, want, dim, local_shape = ctx.like
        gl = g.redistribute(dm, want).to_local()
        out = torch.zeros(local_shape, dtype=gl.dtype, device=gl.device).scatter_add(
            dim, at, gl * inside)
        return _from_local(out, dm, list(placements), shape), None, None


def _getitem(table, idx):
    if isinstance(idx, torch.Tensor) and table.dim() == 2 \
            and not idx.is_floating_point() and idx.dtype != torch.bool:
        if _dtensor(table) and _dtensor(idx) and _sharded_on(table, 0) \
                and torch.is_grad_enabled() and table.requires_grad:
            return _Lookup.apply(table, idx)
        # a vocab-sharded table's masked partial rows are summed at once (the
        # mask lives only as long as the op that made it)
        return _summed(F.embedding(idx, table))
    if _dtensor(table):
        return _hoisted_select(table, idx)
    return NotImplemented


class _Lookup(torch.autograd.Function):
    """The rows of a table sharded on its rows (a vocab-sharded
    embedding), as GSPMD partitions the gather and its transpose: each rank
    looks up the rows its shard holds and the masked lookups are summed at
    once; the backward scatters the gradient into the rank's own rows only,
    a sum partial over the mesh dims that shard the indices, where
    DTensor's rule makes the whole table's gradient on every rank and
    reduces it whole."""

    @staticmethod
    def forward(ctx, table, idx):
        from torch.distributed.tensor import Replicate
        dm, placements = table.device_mesh, table.placements
        rows = table.to_local().shape[0]
        want = [Replicate() if p.is_shard(0) else q for p, q in zip(placements, idx.placements)]
        # the rank's own rows (its block of the mesh dims that shard them,
        # in order); the others' ids to one more row, which the backward drops
        block, coord = 0, dm.get_coordinate()
        for i, p in enumerate(placements):
            if p.is_shard(0):
                block = block * dm.size(i) + coord[i]
        local = idx.redistribute(dm, want).to_local() - block * rows
        ctx.save_for_backward(torch.where((local >= 0) & (local < rows), local, rows))
        ctx.table = (dm, tuple(placements), tuple(table.shape), rows, want)
        return _summed(F.embedding(idx, table))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Partial, Replicate, Shard
        (local,) = ctx.saved_tensors
        dm, placements, shape, rows, want = ctx.table
        g = g.redistribute(dm, want)
        local = torch.ops.aten.embedding_dense_backward(g.to_local(), local, rows + 1, rows,
                                                        False)[:rows]
        out = [Shard(0) if p.is_shard(0) else Partial() if q.is_shard() else Replicate()
               for p, q in zip(placements, want)]
        return _from_local(local, dm, out, shape), None


def _hoisted_select(x, idx):
    """``x[idx]`` where ``idx`` takes one entry of a dim that the mesh
    shards (the chunked WKV's ``rc[:, ci]`` in its loop over chunks): the
    dim is all-gathered once for every such index into this tensor, not
    once a select, as XLA hoists a loop-invariant all-gather out of its
    loop over the chunks, and the entry is copied out of it, as the loop's
    dynamic-slice copies its slice."""
    from torch.distributed.tensor import Replicate
    items = idx if isinstance(idx, tuple) else (idx,)
    dims = [d for d, i in enumerate(items) if isinstance(i, int)]
    if len(dims) != 1 or any(not isinstance(i, (int, slice)) for i in items) \
            or not _sharded_on(x, dims[0]):
        return NotImplemented
    key = (id(x), dims[0], x._version)
    hit = _GATHERED.get(key)
    if hit is None or hit[0]() is not x:
        if torch.is_grad_enabled() and x.requires_grad and not tfm.checkpointed() \
                and not tfm.recomputing():
            g = _Regathered.apply(x, dims[0])
        else:
            g = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dims[0]) else p
                                               for p in x.placements])
        hit = _GATHERED[key] = (weakref.ref(x, lambda _, k=key: _GATHERED.pop(k, None)), g)
    return hit[1][idx].contiguous()


class _Regathered(torch.autograd.Function):
    """``x`` all-gathered on ``dim`` (``_hoisted_select``), whose backward
    gathers ``x`` again: XLA's layer loop keeps the sharded ``x`` as its
    residual and its backward all-gathers it for the loop over the chunks,
    as the forward did (the HLO of the rwkv6-7b fsdp train step: two of the
    three chunked streams a layer, besides the WKV's output gradient; the
    trace gathers all three it hoists, k, v and the decay).  The trace's
    backward reads the chunks the forward kept, so the gather is a record
    only (``_recorded``: no data moves); the gradient is sliced back to
    ``x``'s shards, as DTensor's own backward of the gather does.  (Where
    the unit is checkpointed, its recompute gathers ``x`` again, as XLA's
    does, and nothing more is recorded.)"""

    @staticmethod
    def forward(ctx, x, dim):
        from torch.distributed.tensor import Replicate
        ctx.save_for_backward(x)
        ctx.dim = dim
        return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim) else p
                                              for p in x.placements])

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        _recorded(x.to_local(), "all-gather", x.device_mesh,
                  [i for i, p in enumerate(x.placements) if p.is_shard(ctx.dim)])
        return g.redistribute(x.device_mesh, x.placements), None


@torch.library.custom_op("repro_trace::wire", mutates_args=())
def _wire(t: torch.Tensor, kind: str, group: int, shape: list[int]) -> torch.Tensor:
    return t.new_empty(shape)


@_wire.register_fake
def _(t, kind, group, shape):
    return t.new_empty(shape)


wire_op = torch.ops.repro_trace.wire


def _recorded(t, kind, dm, axes):
    """A collective of ``kind`` ("all-gather", "all-to-all") of ``t``, a
    local shard, over each of mesh dims ``axes`` in turn, as a record only:
    the trace counts its operand and wire bytes (``traceanalysis``), and no
    data moves; its output, uninitialised, is not to be read.  For what XLA
    communicates where the trace computes the same values in another
    layout."""
    for axis in axes:
        n = dm.size(axis)
        shape = list(t.shape)
        if kind == "all-gather":
            shape[0] *= n
        t = wire_op(t.contiguous(), kind, n, shape)
    return t


# (id(x), the dim, x's version) -> (weakref to x, x gathered on that dim)
_GATHERED: dict = {}


def _stack(tensors, dim=0, *, out=None):
    if out is not None or not tensors or not all(_dtensor(t) for t in tensors):
        return NotImplemented
    return _Stacked.apply(dim, *tensors)


class _Stacked(torch.autograd.Function):
    """``torch.stack`` of DTensors (the chunked WKV's outputs), whose
    gradient is gathered once on the mesh dims that shard the stacked dim
    and then split: torch's backward of ``stack`` selects each entry of the
    gradient, which DTensor gathers once a select where the gradient
    arrives sharded on that dim (XLA's loop reads its slices of the
    gathered gradient, the gather hoisted out of it)."""

    @staticmethod
    def forward(ctx, dim, *tensors):
        ctx.dim = dim
        return torch.stack(tensors, dim)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        d = ctx.dim % g.dim()
        if _dtensor(g) and _sharded_on(g, d):
            g = g.redistribute(g.device_mesh, [Replicate() if p.is_shard(d) else p
                                               for p in g.placements])
        return (None,) + tuple(g.unbind(d))


def _cumsum(x, dim, *, dtype=None, out=None):
    if out is not None or dtype is not None or not _dtensor(x) or _sharded_on(x, dim) \
            or not (torch.is_grad_enabled() and x.requires_grad):
        return NotImplemented
    return _Cumsum.apply(x, dim)


class _Cumsum(torch.autograd.Function):
    """``cumsum`` of a DTensor along a dim no mesh dim shards (the WKV's
    decays within a chunk or a shard), as XLA partitions it: each rank sums
    its own shard, and the backward's reversed sum too.  torch 2.11's
    DTensor has no rule for the flip of cumsum's backward and runs it
    replicated, all-gathering the gradient once a chunk (the rwkv6-7b fsdp
    witness on the card: 64 gathers, 25 MB of wire); torch 2.13's keeps it
    local, as here."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.like = (x.device_mesh, tuple(x.placements), tuple(x.shape), dim % x.dim())
        return _from_local(x.to_local().cumsum(dim), x.device_mesh, list(x.placements),
                           tuple(x.shape))

    @staticmethod
    def backward(ctx, g):
        dm, placements, shape, dim = ctx.like
        if tuple(g.placements) != placements:
            g = g.redistribute(dm, placements)
        local = g.to_local().flip(dim).cumsum(dim).flip(dim)
        return _from_local(local, dm, list(placements), shape), None


def _split_streams(mixed):
    return _Streams.apply(mixed)


# the streams (w, k, v, r, g) whose input gradients XLA computes with the
# sequence whole where the mixed streams are sharded on it: the three the WKV
# reads whole (r, k, v), and of those the two whose gradients its loop over
# the chunks leaves on the sequence's shards, which it all-gathers first
_WHOLE_SEQ_STREAMS = (1, 2, 3)
_GATHERED_GRADS = (1, 2)


class _Streams(torch.autograd.Function):
    """rwkv6's split of its (B,S,5,D) mixed streams into five (B,S,D), as
    the reference writes it (``[mixed[:, :, i] for i in range(5)]``) and XLA
    transposes it: each stream's gradient padded back to (B,S,5,D) and the
    five pads summed, an ``add`` chain that reads five times what it writes
    (``traceanalysis.fusion_groups`` duplicates it into each fusion that
    consumes it, and writes each pad once).  The gradients are summed on
    each rank's shards, in the placement of ``mixed``; no product, so no
    FLOP, is added.

    Where ``mixed`` is sharded on the sequence (fsdp), XLA computes the
    input gradients of the streams the WKV reads whole (r, k, v) with the
    sequence whole and the embedding dim split (each rank's shard of the
    FSDP weights): it all-gathers the gradients of k and v along the
    sequence, pads the three in that layout and all-to-alls the pads onto
    the sequence's shards (the HLO of the rwkv6-7b fsdp train step).  The
    trace computes them on the sequence's shards with the gathered weights,
    the same FLOPs, and records those collectives (``_recorded``: no data
    moves, and the gradient is the plain split's)."""

    @staticmethod
    def forward(ctx, mixed):
        ctx.like = (mixed.device_mesh, tuple(mixed.placements), tuple(mixed.shape)) \
            if _dtensor(mixed) else None
        ctx.n = mixed.shape[2]
        return mixed.unbind(2)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import Shard
        n = ctx.n
        seq = []
        if ctx.like is not None:
            dm, placements, shape = ctx.like
            want = [Shard(p.dim - (p.dim > 2)) if p.is_shard() else p for p in placements]
            grads = [g.redistribute(dm, want).to_local() for g in grads]
            seq = [i for i, p in enumerate(placements) if p.is_shard(1)]
        for i in _GATHERED_GRADS if seq else ():
            _recorded(grads[i], "all-gather", dm, seq)
        pads = [torch.constant_pad_nd(g.unsqueeze(2), (0, 0, i, n - 1 - i))
                for i, g in enumerate(grads)]
        for i in _WHOLE_SEQ_STREAMS if seq else ():
            _recorded(pads[i], "all-to-all", dm, seq)
        out = pads[0]
        for p in pads[1:]:
            out = out + p
        if ctx.like is not None:
            out = _from_local(out, dm, list(placements), shape)
        return out


def _pad(x, pad, mode="constant", value=None):
    if not _dtensor(x) or mode != "constant":
        return NotImplemented
    return _pad_cat(x, pad, 0.0 if value is None else value)


def _pad_cat(x, pad, value):
    """A DTensor's constant pad as a concatenation of filled slices."""
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


def _shift(x, k):
    """``layers.shift`` of a DTensor by ``k`` steps along a sequence that one
    mesh dim shards (rwkv6's token shift, the RG-LRU's causal conv), as
    GSPMD partitions the pad and the slice back to the sequence's length: a
    halo exchange.  Each rank's shard is shifted by ``k``, the ``k`` steps
    before it taken from the previous rank by one collective-permute
    (``_Halo``; zeros on the first rank), where DTensor's concatenation
    would all-gather the sequence.  Elsewhere the pad's concatenation."""
    if not _dtensor(x):
        return NotImplemented
    axes = [i for i, p in enumerate(x.placements) if p.is_shard(1)]
    local = x.to_local()
    if k <= 0 or len(axes) != 1 or local.shape[1] < k \
            or x.shape[1] % x.device_mesh.size(axes[0]):
        return _pad_cat(x, (0, 0, k, 0), 0.0)[:, :x.shape[1]]
    y = _Halo.apply(local, 1, k, x.device_mesh, axes[0])
    return _from_local(y, x.device_mesh, list(x.placements), tuple(x.shape))


class _Halo(torch.autograd.Function):
    """A local shard shifted by ``k`` entries along ``dim``: its first ``k``
    the previous rank's last ``k`` along mesh dim ``axis`` (zeros on the
    first rank), by one collective-permute; the backward sends the
    gradient's first ``k`` back to the previous rank the same way."""

    @staticmethod
    def forward(ctx, x, dim, k, dm, axis):
        ctx.args = (dim, k, dm, axis)
        edge = _permuted(x.narrow(dim, x.shape[dim] - k, k), dm, axis, 1)
        if dm.get_local_rank(axis) == 0:
            edge = torch.zeros_like(edge)
        return torch.cat([edge, x.narrow(dim, 0, x.shape[dim] - k)], dim)

    @staticmethod
    def backward(ctx, g):
        dim, k, dm, axis = ctx.args
        n, rank = dm.size(axis), dm.get_local_rank(axis)
        back = _permuted(g.narrow(dim, 0, k), dm, axis, -1)
        if rank == n - 1:
            back = torch.zeros_like(back)
        return torch.cat([g.narrow(dim, k, g.shape[dim] - k), back], dim), \
            None, None, None, None


def _permuted(t, dm, axis, step):
    """``t`` from the rank ``step`` before along mesh dim ``axis`` (cyclic)."""
    import torch.distributed._functional_collectives as funcol
    n = dm.size(axis)
    flat = t.contiguous().view(-1)       # permute_tensor splits its first dim by numel
    out = funcol.permute_tensor(flat, [(i + step) % n for i in range(n)], (dm, axis))
    return funcol.wait_tensor(out).view(t.shape)


def _group_heads(q, n_kv):
    """The query heads of a DTensor q (B,S,H,dh) whose mesh splits H over
    more ranks than there are KV heads, unevenly for a (KV, G) view: as
    (B,S,H,1,dh), each head its own group, sharded as q is (XLA tiles (KV, G)
    jointly, H/n heads a rank; DTensor cannot place that view).  A single
    decode token against a cache whose sequence the heads' mesh axes shard
    is gathered and grouped as (KV, G), so that its attention runs sharded
    on the cache; against a replicated cache it keeps its heads sharded,
    and each rank reads the KV heads of its own query heads
    (``attention.kv_for``), as XLA does."""
    if not _dtensor(q):
        return NotImplemented
    axes = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    n = math.prod(q.device_mesh.size(i) for i in axes)
    if n == 1 or n_kv % n == 0:
        return NotImplemented
    if q.shape[1] == 1 and _cache_seq_sharded_on(
            [q.device_mesh.mesh_dim_names[i] for i in axes]):
        # one decode token: gathered whole (a few KB) and grouped as (KV, G)
        from torch.distributed.tensor import Replicate
        q = q.redistribute(q.device_mesh, [Replicate() if p.is_shard(2) else p
                                           for p in q.placements])
        return attn.group_heads(q, n_kv)
    return q.unsqueeze(3)


def _kv_for(q, k):
    """A decode token's K or V heads where ``_group_heads`` kept its H
    query heads sharded (q (B,1,H,1,dh)) against a cache whose KV heads
    are whole on those mesh axes: each rank's own query heads' KV heads,
    read from its replica of the cache, as XLA slices them (a view where
    the rank's heads share one KV head), and not the cache repeated to all
    H heads on every rank."""
    axes = [i for i, p in enumerate(q.placements) if p.is_shard(2)] if _dtensor(q) else []
    if not _dtensor(k) or q.shape[1] != 1 or q.shape[2] == k.shape[2] or _sharded_on(k, 2) \
            or not axes or any(k.placements[i].is_shard() for i in axes):
        with XlaForms():             # the repeat, its products in their forms
            return attn.repeat_kv(q, k)
    n_q, n_kv = q.shape[2], k.shape[2]
    local_q = q.to_local().shape[2]
    rank = 0
    for i in axes:
        rank = rank * q.device_mesh.size(i) + q.device_mesh.get_local_rank(i)
    heads = [h * n_kv // n_q for h in range(rank * local_q, (rank + 1) * local_q)]
    kl = k.to_local()
    if len(set(heads)) == 1:
        kl = kl.narrow(2, heads[0], 1).expand(kl.shape[:2] + (local_q,) + kl.shape[3:])
    else:
        kl = kl.index_select(2, torch.tensor(heads, device=kl.device))
    pl = [q.placements[i] if i in axes else p for i, p in enumerate(k.placements)]
    return _from_local(kl, k.device_mesh, pl, tuple(k.shape[:2]) + (n_q,) + tuple(k.shape[3:]))


def _cache_seq_sharded_on(names) -> bool:
    """Whether the active rules shard a decode cache's sequence on one of
    the mesh axes ``names``."""
    _, rules = sharding.active()
    return any(m in names for cand in (rules or {}).get("cache_seq", ()) for m in cand)


def _unembed(x, table):
    """The logits' product ``x @ table.T`` of a train step under ZeRO-1
    (``sharding.ZERO1``), where the table is whole on every rank and the
    rows of ``x`` are sharded over the ZeRO-1 axis: the table's gradient as
    GSPMD makes it (``_Unembed``).  The optimizer state shards the table's
    rows over that axis, and GSPMD makes the gradient in that layout; the
    axis is busy with the rows' partial sums, so it splits the rows over an
    idle mesh axis of the same size (one on which both operands are whole),
    each rank computing its block of the table's rows, all-reduces the
    block over the rows' axes, and moves it onto the ZeRO-1 axis by a
    collective-permute (the HLO of a train step under ep with the table
    unsharded).  Without ZeRO-1 the whole gradient is all-reduced, as
    DTensor does."""
    _, rules = sharding.active()
    zero = [m for cand in (rules or {}).get(sharding.ZERO1, ()) for m in cand]
    if _dtensor(x) and _dtensor(table) and torch.is_grad_enabled() and table.requires_grad \
            and len(zero) == 1 and zero[0] in table.device_mesh.mesh_dim_names \
            and not any(p.is_shard() for p in table.placements):
        dm = table.device_mesh
        z = dm.mesh_dim_names.index(zero[0])
        idle = [i for i, p in enumerate(x.placements) if not p.is_shard() and i != z
                and dm.size(i) == dm.size(z)]
        if x.placements[z].is_shard() and not _sharded_on(x, -1) and idle \
                and table.shape[0] % dm.size(z) == 0:
            return _Unembed.apply(x, table, idle[0], z)
    return _matmul(x, table.T)


class _Unembed(torch.autograd.Function):
    """``x @ table.T``, whose backward makes the table's gradient as
    ``_unembed`` says: each rank's block of the table's rows along mesh dim
    ``idle`` from its own rows, all-reduced over the mesh dims that shard the
    rows, moved onto mesh dim ``zero`` by one collective-permute (recorded
    as such: the trace needs its bytes, not its pairs), and returned sharded
    on that dim."""

    @staticmethod
    def forward(ctx, x, table, idle, zero):
        ctx.save_for_backward(x, table)
        ctx.dims = (idle, zero)
        lead = string.ascii_lowercase[:x.dim() - 1]
        return dot_general(x, table, f"{lead}y,zy->{lead}z")

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        from torch.distributed.tensor import Replicate, Shard
        x, table = ctx.saved_tensors
        idle, zero = ctx.dims
        lead = string.ascii_lowercase[:x.dim() - 1]
        gx = dot_general(g, table, f"{lead}z,zy->{lead}y")
        dm = table.device_mesh
        block = table.shape[0] // dm.size(idle)
        gl = g.redistribute(dm, x.placements).to_local()
        gl = gl.narrow(-1, dm.get_local_rank(idle) * block, block)
        gt = _dot_general(gl, x.to_local(), 2, f"{lead}z,{lead}y->zy")
        for i, p in enumerate(x.placements):
            if p.is_shard():
                gt = funcol.wait_tensor(funcol.all_reduce(gt, "sum", (dm, i)))
        gt = _permuted(gt, dm, idle, 0)
        placements = [Shard(0) if i == zero else Replicate() for i in range(dm.ndim)]
        return gx, _from_local(gt, dm, placements, tuple(table.shape)), None, None


def _microbatches(a, n, moe_groups=0):
    """The ``n`` microbatches of a batch DTensor, as XLA keeps each in the
    loop over microbatches: the rows sharded over the batch axes that the
    rules resolve for a microbatch (the axes that divide its rows), and the
    batch's other ranks either moved onto the sequence or replicated.

    XLA tiles the (n, B/n) reshape of a batch on R ranks as R_n ranks on n
    and R/R_n on the rows, all-gathers n before its loop slices it, and
    lets the loop body reshard each slice to what the step's constraints
    ask for: the rows on the axes that divide them, the rest replicated
    (a dense step computes each microbatch on the spare ranks again).  With
    MoE, the layers' groups (B/n·S tokens in ``moe_groups`` groups) are
    constrained over the batch axes; where those begin with the rows'
    axes, XLA carries the others back through the (B, S) -> groups reshape
    onto the sequence, and the whole microbatch stays sharded on every
    rank.  Rows that no whole mesh axis divides (a dense step's 1-2 rows)
    stay on the R/n minor ranks of the reshape where R > n: the low part of
    the last batch axis, a mesh axis of its own on the loop body's finer
    mesh (``_Body``).  Here: one redistribution of the batch to that
    layout (the spare axes gathered, or moved onto the sequence by an
    all-to-all), then each rank's own slices of its rows.  (Each rank's
    i-th block of rows, where XLA takes rows i·B/n onward: the same
    partition of the batch into n microbatches for every rank at once, as
    a data-parallel program splits its local batch; only shapes and
    collectives enter the counters.)"""
    from torch.distributed.tensor import Replicate, Shard
    mesh, rules = sharding.active()
    if not _dtensor(a) or mesh is None:
        return NotImplemented
    rows = a.shape[0] // n
    row_axes = sharding.entry_axes(sharding.spec_for((rows,), ("batch",), rules, mesh)[0])
    seq_axes: tuple = ()
    if moe_groups and a.dim() > 1:
        group_axes = sharding.entry_axes(
            sharding.spec_for((moe_groups,), ("batch",), rules, mesh)[0])
        rest = group_axes[len(row_axes):]
        if group_axes[:len(row_axes)] == row_axes and a.shape[1] % math.prod(
                mesh.shape[m] for m in rest) == 0:
            seq_axes = rest
    body = None if row_axes or moe_groups else _Body.of(a, n, mesh, rules)
    if body is not None and body.split:
        a = body.onto_fine(a)
        row_axes = (body.halves[1],)
    dm = a.device_mesh
    want = [Shard(0) if m in row_axes else Shard(1) if m in seq_axes else Replicate()
            for m in dm.mesh_dim_names]
    resliced = _resliced(a, n, row_axes)
    if list(a.placements) != want:
        a = a.redistribute(dm, want)
    local = a.to_local()
    out = tuple(_from_local(part, dm, want, (rows,) + tuple(a.shape[1:]))
                for part in local.reshape((n, local.shape[0] // n)
                                          + tuple(local.shape[1:])).unbind(0))
    for t in out:
        t.resliced = resliced
        t.body = body
    return out


def _resliced(a, n, row_axes) -> bool:
    """Whether XLA's loop holds each of the ``n`` microbatches of batch
    ``a`` with its rows on other ranks than the step's constraints put them
    on: XLA tiles the rows of the (n, B/n) reshape over the minor B's ranks
    (R/n of the R that shard the batch, or none where R <= n), which the
    rows' axes match only where they are the batch's trailing axes.  (Rows
    that no whole mesh axis divides are on those minor ranks already, or
    whole where R <= n: ``_Body``.)"""
    dm = a.device_mesh
    axes = [m for m, p in zip(dm.mesh_dim_names, a.placements) if p.is_shard(0)]
    ranks = math.prod(dm.size(dm.mesh_dim_names.index(m)) for m in axes)
    if ranks <= n or ranks % n or not row_axes:
        return False
    return tuple(axes[len(axes) - len(row_axes):]) != tuple(row_axes) \
        or math.prod(dm.size(dm.mesh_dim_names.index(m)) for m in row_axes) != ranks // n


class _Body:
    """How XLA's loop over microbatches computes a dense step's microbatch
    of rows that no whole mesh axis divides (the HLO of qwen2-1.5b-bench's
    and rwkv6-7b-bench's train steps in 16 or 32 microbatches).

    * The rows sit on the R/n minor ranks of the batch's R (``_microbatches``,
      where R > n): ``lo`` = R/n ranks of the last batch axis ``split``, which
      the body's mesh ``fine`` splits into ``split_hi`` x ``split_lo`` over
      the same ranks (``launch.mesh.Mesh.split``).  The batch's other axes
      (``spare``) compute the microbatch again: where every tensor that
      enters the body is replicated on them, the body runs on the sub-mesh
      of the rest, which holds the same local work and collectives (and
      leaves DTensor no spare axis to shard a product on where XLA does
      not).  ``rules`` name ``split`` as both halves.
    * Under ZeRO-1 (the rules' ``sharding.ZERO1`` axis ``zero``, "data"),
      each weight enters the body split over that axis on its embedding
      dim, and the table the tokens are looked up in on its vocab, the dim
      its optimizer state is split on (``split_dim``; ZeRO-1 splits the
      stacked layers' dim, which the layer loop slices): the body's
      products contract a quarter of the width and all-reduce their partial
      sums over ``zero``, and each weight's gradient, made on that split, is
      all-gathered and kept in its optimizer state's layout
      (``_IntoBody``).  (XLA also splits rwkv6-7b's untied unembedding
      table's vocab over idle ranks; here it stays whole.)
    """

    def __init__(self, mesh, split, lo, zero, rules, spare):
        self.mesh, self.split, self.zero = mesh, split, zero
        self.fine = mesh.split(split, lo) if split else mesh
        self.halves = (f"{split}_hi", f"{split}_lo") if split else ()
        self.rules = sharding.split_rules(rules, split, self.halves) if split else rules
        self.spare = tuple(spare) + self.halves[:1]

    @classmethod
    def of(cls, a, n, mesh, rules):
        """The body of batch ``a``'s ``n`` microbatches, or None where it is
        the step's own (a per-pod body's mesh, no rows on part of an axis
        and no ZeRO-1)."""
        if not hasattr(mesh, "split"):
            return None
        dm = a.device_mesh
        names = dm.mesh_dim_names
        axes = [m for m, p in zip(names, a.placements) if p.is_shard(0)]
        ranks = math.prod(dm.size(names.index(m)) for m in axes)
        zero = [m for cand in rules.get(sharding.ZERO1, ()) for m in cand]
        zero = zero[0] if len(zero) == 1 and zero[0] in names else None
        split, lo = None, ranks // n
        if axes and ranks > n and ranks % n == 0 and axes[-1] != zero \
                and dm.size(names.index(axes[-1])) % lo == 0:
            split = axes[-1]
        if split is None and zero is None:
            return None
        return cls(mesh, split, lo, zero, rules, [m for m in axes if m not in (zero, split)])

    def onto_fine(self, t):
        """DTensor ``t`` of the step's mesh on ``fine``: no data moves."""
        if not self.split:
            return t
        return _from_local(t.to_local(), self.fine.device_mesh(t.device_mesh.device_type),
                           self.fine_placements(t.placements), tuple(t.shape))

    def fine_placements(self, placements):
        """Placements on the step's mesh as ``fine``'s (``split``'s twice)."""
        return [q for m, p in zip(self.mesh.axis_names, placements)
                for q in ((p, p) if m == self.split else (p,))]

    def split_dim(self, t, axes, looked_up):
        """The dim of weight ``t`` (logical ``axes``) that the body splits over
        ``zero``, or None: its embedding dim, or, for the table the tokens
        are looked up in (``looked_up``) and a weight without one, the dim its
        optimizer state is split on, unless that is the stacked layers' dim
        that the layer loop slices.  A product's weight only, not a vector
        (a norm's scale, a bias), which a split leaves no product to save and
        which torch 2.11's DTensor aligns the activation it scales to,
        gathering its rows."""
        if self.zero is None or t.dim() - (axes[:1] == ("layers",)) < 2 or not t.placements[
                self.mesh.axis_names.index(self.zero)].is_replicate():
            return None
        spec = _spec_of(t)
        size = self.mesh.shape[self.zero]
        embed = next((i for i, ax in enumerate(axes) if ax == "embed" and spec[i] is None
                      and t.shape[i] % size == 0), None)
        if embed is not None and not looked_up:
            return embed
        z = sharding.zero1_spec(tuple(t.shape), spec, self.mesh)
        d = next((i for i, (p, q) in enumerate(zip(spec, z)) if p != q), None)
        return None if d is None or axes[d] == "layers" else d

    def state_placements(self, t):
        """The placements of ``t``'s ZeRO-1 optimizer state on the step's
        mesh (``t``'s own without ZeRO-1)."""
        spec = _spec_of(t)
        if self.zero is not None:
            spec = sharding.zero1_spec(tuple(t.shape), spec, self.mesh)
        return list(sharding.placements_for(spec, self.mesh))


def _spec_of(t) -> tuple:
    """DTensor ``t``'s spec: per dim, the mesh axes that shard it, or None."""
    names = t.device_mesh.mesh_dim_names
    return tuple(tuple(m for m, p in zip(names, t.placements) if p.is_shard(d)) or None
                 for d in range(t.dim()))


def _loop_body(params, mb, axes):
    """``train_step.loop_body``: where ``_microbatches`` marked the
    microbatch with a ``_Body``, the params and the microbatch on its mesh,
    the params split as it says, with its rules active while the
    microbatch's forward and backward run."""
    from ..models.module import flatten
    body = getattr(flatten(mb)[0][1], "body", None)
    if body is None:
        return NotImplemented
    return _in_body(body, params, mb, axes)


# how many microbatch loop bodies the trace is in (``_in_body``; autograd's
# recompute may run on another thread)
_IN_BODY = [0]


@contextlib.contextmanager
def _in_body(body, params, mb, axes):
    from ..models.module import flatten, unflatten
    paths, leaves = zip(*flatten(params))
    logical = dict(flatten(axes))
    batch = flatten(mb)
    names = body.fine.axis_names
    placed = [body.fine_placements(t.placements) for t in leaves if _dtensor(t)] \
        + [t.placements for _, t in batch]
    kept = tuple(m for i, m in enumerate(names) if m not in body.spare
                 or not all(pl[i].is_replicate() for pl in placed))
    dm = body.fine.device_mesh(batch[0][1].device_mesh.device_type,
                               kept if kept != names else None)
    # (the tokens' embedding looks rows up in params["embed"]["table"])
    moved = _IntoBody.apply(body, dm, kept, [(logical[p], p[:1] == ("embed",)) for p in paths],
                            *leaves)
    batch = [(p, _from_local(t.to_local(), dm, [q for m, q in zip(names, t.placements)
                                                if m in kept], tuple(t.shape)))
             for p, t in batch]
    view = sharding.SubMesh(kept, tuple(body.fine.shape[m] for m in kept))
    _IN_BODY[0] += 1
    try:
        with sharding.resolving_on(view, body.rules):
            yield unflatten(zip(paths, moved)), unflatten(batch)
    finally:
        _IN_BODY[0] -= 1


class _IntoBody(torch.autograd.Function):
    """The step's params as a ``_Body`` computes with them (``axes``: each
    one's logical axes, and whether the tokens are looked up in it): each
    on the body's mesh ``dm`` (the fine mesh's dims ``kept``), its local
    shard kept (no data moves), and split over the ZeRO-1 axis on
    ``_Body.split_dim`` by a local slice.  The backward brings each
    gradient into its optimizer state's layout on the step's mesh: partial
    sums all-reduced, a split other than the state's all-gathered (XLA
    gathers each layer's weight gradients over the ZeRO-1 axis in its layer
    loop's backward and keeps its own layer), then sliced to the state's
    shards."""

    @staticmethod
    def forward(ctx, body, dm, kept, axes, *params):
        from torch.distributed.tensor import Shard
        names = body.fine.axis_names
        ctx.set_materialize_grads(False)
        ctx.like = []
        out = []
        for t, (ax, looked_up) in zip(params, axes):
            if not _dtensor(t):
                ctx.like.append(None)
                out.append(t)
                continue
            placements = body.fine_placements(t.placements)
            local = t.to_local()
            d = body.split_dim(t, ax, looked_up)
            if d is not None:
                z = dm.mesh_dim_names.index(body.zero)
                size = t.shape[d] // dm.size(z)
                local = local.narrow(d, dm.get_local_rank(z) * size, size).contiguous()
                placements[names.index(body.zero)] = Shard(d)
            state = body.state_placements(t)
            ctx.like.append((t.device_mesh, state, tuple(t.shape),
                             [p for m, p in zip(names, body.fine_placements(state))
                              if m in kept]))
            out.append(_from_local(local, dm, [p for m, p in zip(names, placements)
                                               if m in kept], tuple(t.shape)))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        from torch.distributed.tensor import Replicate
        out = []
        for g, like in zip(grads, ctx.like):
            if like is None or g is None:
                out.append(g)
                continue
            dm, state, shape, want = like
            mid = [Replicate() if p.is_partial() or (p.is_shard() and p != q) else p
                   for p, q in zip(g.placements, want)]
            if mid != list(g.placements):
                g = g.redistribute(g.device_mesh, mid)
            if mid != want:
                g = g.redistribute(g.device_mesh, want)
            out.append(_from_local(g.to_local(), dm, state, shape))
        return (None, None, None, None) + tuple(out)


def _from_batch(x, leaf):
    """``x``, made from the batch leaf ``leaf`` (the embedding of the
    tokens; the logits against the labels): where XLA's loop holds the
    microbatch's leaf on other ranks than the constraints hold ``x``
    (``_resliced``, marked on the microbatch's leaves by
    ``_microbatches``), GSPMD moves ``x`` between the two by a
    collective-permute each way, in the forward and in the backward: the
    tokens' embedding to the constrained layout, the logits to the labels'
    (the HLO of a microbatched dp train step on the multi mesh)."""
    if getattr(leaf, "resliced", False) and _dtensor(x):
        return _Moved.apply(x)
    return x


class _Moved(torch.autograd.Function):
    """The identity, whose forward and backward each move the local shard
    by one collective-permute (recorded as such; the trace needs its bytes,
    not its pairs)."""

    @staticmethod
    def forward(ctx, x):
        return _moved(x)

    @staticmethod
    def backward(ctx, g):
        return _moved(g) if _dtensor(g) else g


def _moved(x):
    axis = next((i for i, p in enumerate(x.placements) if p.is_shard()), 0)
    local = _permuted(x.to_local(), x.device_mesh, axis, 0)
    return _from_local(local, x.device_mesh, list(x.placements), tuple(x.shape))


def _block_view(xb, n_blocks):
    """The RG-LRU gates' view of a DTensor's width W as (n_blocks, W /
    n_blocks), where the mesh splits W over more ranks than divide the
    blocks (recurrentgemma-2b's 10 blocks on 16 model ranks): W gathered on
    those mesh dims first, so the block-diagonal gates run whole on each
    rank and their outputs, sliced back where they meet the sharded width,
    leave the rest of the block sharded.  (XLA splits the 16 ranks 2 x 8
    over blocks and width and computes half the blocks a rank, twice as
    few gate products as here; DTensor cannot split one mesh dim over two
    tensor dims, and would run the view, and all that follows it,
    replicated.)"""
    from torch.distributed.tensor import Replicate
    if not _dtensor(xb):
        return NotImplemented
    last = xb.dim() - 1
    ways = math.prod(size for size, p in zip(xb.device_mesh.shape, xb.placements)
                     if p.is_shard(last))
    if ways == 1 or n_blocks % ways == 0:
        return NotImplemented
    xb = xb.redistribute(xb.device_mesh, [Replicate() if p.is_shard(last) else p
                                          for p in xb.placements])
    return xb.reshape(xb.shape[:-1] + (n_blocks, xb.shape[-1] // n_blocks))


def _block_unview(g, like):
    """The gates' output back to the width of ``like``, laid out as
    ``like`` is: where ``_block_view`` gathered the width, the (replicated)
    output is sliced back to ``like``'s shards, so that the gradient reaching
    the gates is gathered (its view back into blocks would otherwise run
    replicated)."""
    if not (_dtensor(g) and _dtensor(like)):
        return NotImplemented
    last = like.dim() - 1
    gathered = [p.is_shard(last) and q.is_replicate()
                for p, q in zip(like.placements, g.placements)]
    if not any(gathered):
        return NotImplemented
    out = g.reshape(like.shape)
    return out.redistribute(out.device_mesh, like.placements)


def _fold_shards(x):
    """rwkv6's fold of (B, G, ...) into (B*G, ...) where both B and G are
    sharded (fsdp: B on the data axes, the sequence shards G on the model
    axis): each rank's local rows folded in place, the merged dim sharded on
    both sets of mesh dims.  XLA's reshape is free there (it permutes the
    device order of the merged dim's tiles); DTensor cannot order one dim's
    shards so, and would run the view replicated.  (The merged dim's global
    order is each rank's (b, g) rows, not b·G + g: only shapes and
    collectives enter the counters, and ``_unfold_shards`` undoes it.)"""
    from torch.distributed.tensor import Shard
    if not _dtensor(x) or x.dim() < 3 or not (_sharded_on(x, 0) and _sharded_on(x, 1)):
        return NotImplemented
    pl = [Shard(0) if p.is_shard(0) or p.is_shard(1) else
          Shard(p.dim - 1) if p.is_shard() else p for p in x.placements]
    local = x.to_local()
    local = local.reshape((local.shape[0] * local.shape[1],) + tuple(local.shape[2:]))
    return _from_local(local, x.device_mesh, pl,
                       (x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _unfold_shards(x, like):
    """The inverse of ``_fold_shards``: (B*G, ...) back to (B, G, ...) as
    ``like`` (the tensor that was folded) shards B and G."""
    from torch.distributed.tensor import Shard
    if not (_dtensor(x) and _dtensor(like)) or not (_sharded_on(like, 0)
                                                     and _sharded_on(like, 1)):
        return NotImplemented
    folded = [p.is_shard(0) or p.is_shard(1) for p in like.placements]
    if [p.is_shard(0) for p in x.placements] != folded:
        return NotImplemented
    pl = [Shard(1) if q.is_shard(1) else Shard(0) if q.is_shard(0) else
          Shard(p.dim + 1) if p.is_shard() else p
          for p, q in zip(x.placements, like.placements)]
    lb, lg = like.to_local().shape[:2]
    local = x.to_local()
    local = local.reshape((lb, lg) + tuple(local.shape[1:]))
    return _from_local(local, x.device_mesh, pl, tuple(like.shape[:2]) + tuple(x.shape[1:]))


def _group_tokens(x, n_groups):
    """MoE's view of (B, S, D) tokens as (G, Tg, D) groups where the
    sequence is sharded too (the rows' mesh dims first, whole groups in
    each rank's sequence block): each rank's tokens are its own groups
    (rank (d, m) holds the groups of row block d and sequence block m,
    which is G sharded over (d, m) in mesh order), so the view is local,
    as XLA's reshape is.  DTensor flattens a dim sharded behind another
    only strided, or refuses it (torch 2.11)."""
    from torch.distributed.tensor import Replicate, Shard
    if not _dtensor(x) or x.dim() != 3 or not _sharded_on(x, 1):
        return NotImplemented
    dims = [p.dim for p in x.placements if p.is_shard()]
    lb, ls, d = x.to_local().shape
    tg = x.shape[0] * x.shape[1] // n_groups
    if dims != sorted(dims) or any(k > 1 for k in dims) or ls % tg:
        return NotImplemented
    pl = [Shard(0) if p.is_shard() else Replicate() for p in x.placements]
    return _from_local(x.to_local().reshape(lb * ls // tg, tg, d), x.device_mesh, pl,
                       (n_groups, tg, x.shape[2]))


def _ungroup(y, x):
    """MoE's groups (G, Tg, D), G sharded over mesh dims, back to the
    (B, S, D) layout of ``x``, whose rows and sequence are sharded (the
    rows' mesh dims first) with whole groups in each rank's sequence block:
    G resharded onto the mesh dims that shard ``x`` (gathered on the others,
    and moved off the embedding dim where the groups come back with it
    sharded there, fsdp's layout), then each rank's groups are
    its own rows' sequence block (rank (d, m) holds the groups of row block
    d and sequence block m) and the view is local, as XLA's reshape is.  An
    embedding dim sharded on a mesh dim that shards neither ``x``'s rows nor
    its sequence stays sharded.  DTensor cannot split G's shards over two
    dims, and would run the view replicated.  (Where the embedding is
    sharded and G's shards fall on whole rows, or on the steps of one row,
    DTensor's own view places them.)"""
    from torch.distributed.tensor import Replicate, Shard
    if not (_dtensor(y) and _dtensor(x)) or x.dim() != 3 or not _sharded_on(y, 0):
        return NotImplemented
    dims = [p.dim for p in x.placements if p.is_shard()]
    lb, ls, _ = x.to_local().shape
    if dims != sorted(dims) or any(d > 1 for d in dims) or ls % y.shape[1] \
            or any(p.is_shard(1) or p.is_partial() for p in y.placements):
        return NotImplemented
    want = [Shard(0) if p.is_shard() else q if q.is_shard(2) else Replicate()
            for p, q in zip(x.placements, y.placements)]
    if any(q.is_shard(2) for q in y.placements):
        ways = math.prod(n for n, q in zip(y.device_mesh.shape, y.placements) if q.is_shard(0))
        if x.shape[0] % ways == 0 or x.shape[0] == 1:
            return NotImplemented        # DTensor's view puts G's shards on the rows or steps
    elif any(w.is_shard() and not q.is_shard(0) for w, q in zip(want, y.placements)):
        return NotImplemented
    if list(y.placements) != want:
        y = y.redistribute(y.device_mesh, want)
    local = y.to_local()
    return _from_local(local.reshape(lb, ls, local.shape[-1]), x.device_mesh,
                       [p if p.is_shard() else w for p, w in zip(x.placements, want)],
                       tuple(x.shape))


def _chunk_view(q, k, v, positions_q, positions_kv, C):
    """``attention.chunk_view`` where the sequence of q is sharded (a
    microbatch of 1-2 rows whose sequence carries the batch's ranks, or a
    sequence-sharded one), and that of k and v on those mesh dims or on
    none (the keys' constraint gathers them): each rank's L positions stay
    in place, as XLA's reshape keeps them.  The queries are viewed as blocks of
    min(L, C), the block dim sharded as the sequence was (where a chunk
    spans several ranks, each holds its part of it: DTensor cannot split
    one mesh dim's shards between the chunk and the step dims).  Each
    block's window, the chunk before its chunk and the chunk, is cut from
    the keys and values gathered over the inner mesh dims that split a chunk
    (their gradient reduce-scattered back), and the chunk before the first
    that a rank's span holds comes from the previous rank of the outer mesh
    dim that still splits them by a halo exchange (``_Halo``), as GSPMD
    exchanges it.  Each rank's score product is then its L queries against
    2C keys, XLA's per-device FLOPs, where DTensor would run the views
    replicated and attention whole on every rank.  (The positions are plain
    tensors, replicated: the windows' positions are cut from them for every
    block.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not (_dtensor(q) and _dtensor(k) and _dtensor(v)) or _dtensor(positions_q) \
            or _dtensor(positions_kv):
        return NotImplemented
    dm = q.device_mesh
    axes = [i for i, p in enumerate(q.placements) if p.is_shard(1)]
    if not axes or any(type(p) is not Shard and p.is_shard()
                       for t in (q, k, v) for p in t.placements) \
            or any(p.is_shard(1) and i not in axes or p.is_partial()
                   for t in (k, v) for i, p in enumerate(t.placements)):
        return NotImplemented
    B, S = q.shape[:2]
    ways = math.prod(dm.size(i) for i in axes)
    L = S // ways
    Lb = min(L, C)
    if S % ways or (L % C if L >= C else C % L):
        return NotImplemented
    inner, g = [], 1
    for i in reversed(axes):
        if g * L >= C:
            break
        inner.insert(0, i)
        g *= dm.size(i)
    at = 0
    for i in axes:
        at = at * dm.size(i) + dm.get_local_rank(i)
    starts = [(at * L + b * Lb) // C * C for b in range(L // Lb)]

    def shifted(placements):
        return [Shard(p.dim + 1) if p.is_shard() and p.dim > 1 else p for p in placements]

    def windows(x):
        # each rank's windows are its own blocks': the block dim sharded as
        # the queries', whether x was sharded on those mesh dims or whole
        pl = [Shard(1) if i in axes else p for i, p in enumerate(shifted(x.placements))]
        gathered = [Replicate() if i in inner else p for i, p in enumerate(x.placements)]
        split = [i for i, p in enumerate(gathered) if p.is_shard(1)]
        span_len = S // math.prod(dm.size(i) for i in split)
        if len(split) > 1 or span_len % C:
            return None
        x = x.redistribute(dm, gathered)
        span = x.to_local(grad_placements=[Partial() if i in axes and p.is_replicate() else p
                                           for i, p in enumerate(x.placements)])
        if split:
            prev = _Halo.apply(span, 1, C, dm, split[0]).narrow(1, 0, C)
            first = dm.get_local_rank(split[0]) * span_len
        else:
            prev, first = torch.zeros_like(span.narrow(1, 0, C)), 0
        ext = torch.cat([prev, span], 1)
        local = torch.stack([ext.narrow(1, s - first, 2 * C) for s in starts], 1)
        return _from_local(local, dm, pl, (B, S // Lb, 2 * C) + tuple(x.shape[2:]))

    kk, vv = windows(k), windows(v)
    if kk is None or vv is None:
        return NotImplemented
    ql = q.to_local()
    qc = _from_local(ql.reshape((ql.shape[0], L // Lb, Lb) + tuple(ql.shape[2:])), dm,
                     shifted(q.placements), (B, S // Lb, Lb) + tuple(q.shape[2:]))
    pk = F.pad(positions_kv, (C, 0), value=2**30)
    cut = (torch.arange(S // Lb, device=pk.device) * Lb // C * C)[:, None] \
        + torch.arange(2 * C, device=pk.device)
    return qc, kk, vv, positions_q.reshape(B, S // Lb, Lb), pk[:, cut]


def _chunk_unview(y):
    """``attention.chunk_unview`` of a DTensor whose step dim is whole on
    every rank: each rank's blocks merged in place (the blocks' dim sharded
    in mesh order, as ``_chunk_view`` lays them out)."""
    from torch.distributed.tensor import Shard
    if not _dtensor(y) or _sharded_on(y, 2) \
            or any(p.is_partial() or (p.is_shard() and type(p) is not Shard)
                   for p in y.placements):
        return NotImplemented
    local = y.to_local()
    pl = [Shard(p.dim - 1) if p.is_shard() and p.dim > 2 else p for p in y.placements]
    return _from_local(local.reshape((local.shape[0], local.shape[1] * local.shape[2])
                                     + tuple(local.shape[3:])), y.device_mesh, pl,
                       (y.shape[0], y.shape[1] * y.shape[2]) + tuple(y.shape[3:]))


def _from_local(local, dm, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    return DTensor.from_local(local, dm, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


_REWRITES = {
    torch.matmul: _matmul, torch.Tensor.matmul: _matmul, torch.Tensor.__matmul__: _matmul,
    torch.einsum: _einsum,
    torch.log_softmax: _log_softmax, torch.Tensor.log_softmax: _log_softmax,
    torch.softmax: _softmax, torch.Tensor.softmax: _softmax,
    torch.mean: _mean, torch.Tensor.mean: _mean,
    torch.gather: _gather, torch.Tensor.gather: _gather,
    torch.Tensor.__getitem__: _getitem, F.pad: _pad,
    torch.cumsum: _cumsum, torch.Tensor.cumsum: _cumsum,
    torch.stack: _stack,
    attn.group_heads: _group_heads, attn.kv_for: _kv_for,
    train_step.microbatches: _microbatches, train_step.loop_body: _loop_body,
    tfm.unembed: _unembed, tfm.from_batch: _from_batch,
    layers.shift: _shift, attn.chunk_view: _chunk_view, attn.chunk_unview: _chunk_unview,
    rglru.block_view: _block_view, rglru.block_unview: _block_unview,
    rwkv.fold_shards: _fold_shards, rwkv.split_streams: _split_streams,
    rwkv.unfold_shards: _unfold_shards, moe.group_tokens: _group_tokens,
    moe.ungroup: _ungroup,
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
