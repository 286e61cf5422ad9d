"""Public model API: specs, init, parameter transfer, forward and decode.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; asking
for ``cuda`` on a machine without a GPU raises instead of running on the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeSpec
from . import transformer as tfm
from .module import (count_params, init_params, is_spec, param_axes, param_shapes,
                     tree_paths)


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if it is a GPU that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no GPU is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


@functools.lru_cache(maxsize=64)
def specs(cfg: ModelConfig):
    return tfm.build_specs(cfg)


def init(cfg: ModelConfig, seed: int = 0, device="cuda",
         param_dtype=torch.float32):
    """Random parameters drawn on ``device`` from per-path seeded generators."""
    return init_params(specs(cfg), seed, resolve_device(device), param_dtype)


def abstract_params(cfg: ModelConfig, param_dtype=torch.float32):
    return param_shapes(specs(cfg), param_dtype)


def axes(cfg: ModelConfig):
    return param_axes(specs(cfg))


def n_params(cfg: ModelConfig) -> int:
    return count_params(specs(cfg))


def n_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of n_experts)."""
    total = count_params(specs(cfg))
    if not cfg.n_experts:
        return total
    expert_p = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
    active = expert_p * cfg.top_k // cfg.n_experts
    return total - expert_p + active


def matmul_active_params(cfg: ModelConfig) -> int:
    """Params that participate in per-token matmuls (MoE at top_k/E).

    Excludes the input-embedding gather (no FLOPs) but includes the unembed
    projection once (tied or untied) — the stable numerator for the
    useful-FLOPs anomaly check at any model scale.
    """
    total = 0
    for path, s in tree_paths(specs(cfg)):
        if len(s.shape) < 2:
            continue
        n = int(np.prod(s.shape))
        if path[0] == "embed":
            if not cfg.tie_embeddings:
                continue                       # gather only
        if path[0] == "units" and len(s.axes) > 1 and s.axes[1] == "expert":
            n = n * cfg.top_k // max(cfg.n_experts, 1)   # routed experts
        total += n
    return total


# ----------------------------------------------------------------- input specs

def _tok_shape(cfg: ModelConfig, B: int, S: int):
    if cfg.frontend == "encodec":
        return (B, S, cfg.n_codebooks)
    return (B, S)


def _batch_axes(shape):
    return ("batch",) + (None,) * (len(shape) - 1)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, compute_dtype=torch.bfloat16):
    """(batch_shapes, batch_axes) for the step function of this cell: leaves
    are (shape, dtype) pairs.  encodec tokens and labels carry the K
    codebooks last; the vit's text tokens are S - n_prefix long, after its
    ``patch_embeds`` (B, n_prefix, d_frontend), and its labels S long."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        s_text = S - cfg.n_prefix if cfg.frontend == "vit" else S
        tok = _tok_shape(cfg, B, s_text)
        shapes = {"tokens": (tok, i32)}
        axes_ = {"tokens": _batch_axes(tok)}
        if cfg.frontend == "vit":
            shapes["patch_embeds"] = ((B, cfg.n_prefix, cfg.d_frontend), compute_dtype)
            axes_["patch_embeds"] = ("batch", None, None)
        if shape.kind == "train":
            lab = _tok_shape(cfg, B, S)
            shapes["labels"] = (lab, i32)
            axes_["labels"] = _batch_axes(lab)
        return shapes, axes_
    if shape.kind == "decode":
        tok = _tok_shape(cfg, B, 1)
        return ({"tokens": (tok, i32), "position": ((B,), i32)},
                {"tokens": _batch_axes(tok), "position": ("batch",)})
    raise ValueError(shape.kind)


def state_specs(cfg: ModelConfig, shape: ShapeSpec, compute_dtype=torch.bfloat16):
    """KV-cache / recurrent-state (shape, dtype) leaves and logical axes for
    decode."""
    B, S = shape.global_batch, shape.seq_len
    return (tfm.model_state_shapes(cfg, B, S, compute_dtype),
            tfm.model_state_axes(cfg))


def from_numpy_params(cfg: ModelConfig, tree, device="cuda"):
    """Carry weights across from the JAX package.

    ``tree`` is that package's param tree as nested dicts of numpy arrays
    (what ``jax.tree.map(np.asarray, params)`` gives).  The tree must have
    exactly the port's structure and shapes; dtypes are kept (bf16 arrays,
    as numpy holds them through ml_dtypes, arrive as bf16 tensors).
    """
    dev = resolve_device(device)

    def walk(spec_tree, node, path):
        if is_spec(spec_tree):
            arr = np.asarray(node)
            if tuple(arr.shape) != tuple(spec_tree.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                                 f"{spec_tree.shape}")
            if arr.dtype.name == "bfloat16":
                t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))   # a writable copy
            return t.to(dev)
        if not isinstance(node, dict) or set(node) != set(spec_tree):
            got = sorted(node) if isinstance(node, dict) else type(node).__name__
            raise ValueError(f"{'/'.join(path) or '<root>'}: keys {got} != "
                             f"{sorted(spec_tree)}")
        return {k: walk(spec_tree[k], node[k], path + (k,)) for k in spec_tree}
    return walk(specs(cfg), tree, ())


def init_state(cfg: ModelConfig, batch: int, cache_len: int,
               compute_dtype=torch.bfloat16, device="cuda"):
    """Empty decode state: zero K/V with pos -1 (every slot empty) for the
    attention blocks; zero recurrent state for the others (``h`` and ``wkv``
    in f32, ``conv``, ``tm_x`` and ``cm_x`` in ``compute_dtype``)."""
    dev = resolve_device(device)

    def make(leaf):
        shape, dtype = leaf
        if dtype == torch.int32:
            return torch.full(shape, -1, dtype=dtype, device=dev)
        return torch.zeros(shape, dtype=dtype, device=dev)

    def walk(node):
        if isinstance(node, tuple):
            return make(node)
        return {k: walk(v) for k, v in node.items()}
    return walk(tfm.model_state_shapes(cfg, batch, cache_len, compute_dtype))


cast_params = tfm.cast_params
forward = tfm.forward
decode_step = tfm.decode_step
lm_loss = tfm.lm_loss
