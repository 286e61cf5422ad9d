"""Flash-decode: the CUDA kernel in ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py:_decode_kernel``.
Layouts: q (B,H,D); k, v (B,KVH,T,D), which may be strided views (the model
passes a transposed view of its (B,T,KVH,D) cache, read in place); pos (B,T)
int32 with -1 for an empty slot; qpos (B,) int32.

One launch per call: a cluster of blocks per (b, KV head) walks the visible
tiles of the cache and merges its partial softmax states in distributed
shared memory (the source's header says how).  ``decode_plan`` chooses the
cluster size and each block's range of slots; it mirrors the kernel's tile
and shared-memory sizes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build
from .ref import flash_decode_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
MAX_GROUP = 16          # query heads per KV head (MAXG in the source)
MAX_CLUSTER = 16        # blocks per cluster, the most Hopper schedules
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on the H100


def kernel_shape(D, element_size):
    """(tile, stages, shared-memory bytes) of the kernel instantiation for
    head dim D: slots per tile, ring stages and dynamic shared memory, as
    ``Cfg`` in the source computes them."""
    mma = element_size == 2
    tile = (64 if D <= 64 else 32) if mma else (32 if D <= 64 else 16)
    stage = 2 * tile * (D * element_size + 16)     # K and V rows, 16-byte padded
    stages = 8 if stage <= 12288 else 4
    q_bytes = MAX_GROUP * (2 * D + 16 if mma else 4 * D)
    merge_bytes = 4 * (2 * MAX_CLUSTER * MAX_GROUP + MAX_CLUSTER + MAX_GROUP * D + 4 * MAX_CLUSTER)
    return tile, stages, stages * stage + q_bytes + 2048 + merge_bytes


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    tile: int           # cache slots per tile
    stages: int         # ring stages
    smem: int           # dynamic shared memory per block, bytes
    cluster: int        # blocks per (b, KV head), one cluster
    slots: int          # cache slots per block (a multiple of tile)

    def ranges(self, T):
        """[lo, hi) of the cache slots of each block of a cluster."""
        return [(min(T, r * self.slots), min(T, (r + 1) * self.slots))
                for r in range(self.cluster)]


def decode_plan(B, KVH, T, D, element_size, n_sm, max_clusters=None):
    """The launch plan: the largest power-of-two cluster (<= 16, at most one
    block per tile) with which B * KVH clusters reach about one block per SM,
    shrunk while the card cannot hold all B * KVH clusters at once
    (``max_clusters(c)``, the device's count for clusters of c blocks; None
    on the CPU).  Each block gets an equal share of whole tiles."""
    tile, stages, smem = kernel_shape(D, element_size)
    n_tiles = -(-T // tile)
    pairs = B * KVH
    cluster = 1
    while cluster < MAX_CLUSTER and 2 * cluster <= n_tiles and pairs * cluster < n_sm:
        cluster *= 2
    if max_clusters is not None:
        while cluster > 1 and max_clusters(cluster) < pairs:
            cluster //= 2
    return DecodePlan(tile, stages, smem, cluster, -(-n_tiles // cluster) * tile)


def _bind():
    lib = build.load("decode_attention")
    fn = lib.flash_decode
    if fn.argtypes is None:
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P] * 6 + [I] * 8 + [L] * 9 + [I, I, P]
        fn.restype = ctypes.c_int
        lib.flash_decode_max_clusters.argtypes = [I, I, I]
        lib.flash_decode_max_clusters.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def max_clusters(device_index, D, dtype_code, cluster):
    """How many clusters of ``cluster`` blocks of the (D, dtype) kernel the
    card holds at once (the occupancy query, once per device and shape)."""
    with torch.cuda.device(device_index):
        return _bind().flash_decode_max_clusters(D, dtype_code, cluster)


@functools.lru_cache(maxsize=None)
def _plan(device_index, B, KVH, T, D, dtype_code, element_size):
    n_sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return decode_plan(B, KVH, T, D, element_size, n_sm,
                       lambda c: max_clusters(device_index, D, dtype_code, c))


def flash_decode(q, k, v, pos, qpos, *, window=None):
    """Attention of one query token per (b, h) over the cache.  Returns (B,H,D).

    A CPU tensor goes to the plain version; a CUDA tensor launches the
    kernel (and counts the launch in ``flash_decode.launches``) or raises.
    """
    if q.device.type == "cpu":
        return flash_decode_ref(q, k, v, pos, qpos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    KVH, T = k.shape[1], k.shape[2]
    if H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"flash_decode: H={H}, KVH={KVH}: need KVH | H and "
                         f"H/KVH <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype} {k.dtype} {v.dtype}")
    if pos.shape != (B, T) or pos.dtype != torch.int32 or pos.stride(-1) != 1:
        raise ValueError(f"flash_decode: pos must be (B,T) int32 with contiguous rows")
    if qpos.shape != (B,) or qpos.dtype != torch.int32 or not qpos.is_contiguous():
        raise ValueError("flash_decode: qpos must be a contiguous (B,) int32")
    if any(t.device != q.device for t in (k, v, pos, qpos)):
        raise ValueError("flash_decode: inputs on different devices")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window {window} < 1")
    if q.stride(-1) != 1:
        raise ValueError("flash_decode: q last dim must be contiguous")
    vec = 16 // q.element_size()          # K/V rows are copied as 16-byte aligned rows
    for name, t in (("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:-1]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must have a contiguous last dim, "
                             f"strides that are multiples of {vec} and 16-byte "
                             f"aligned data; strides {t.stride()}")
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan = _plan(dev, B, KVH, T, D, _DTYPES[q.dtype], q.element_size())
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    fn = _bind().flash_decode
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                 qpos.data_ptr(), o.data_ptr(),
                 B, H, KVH, T, D, plan.tile, plan.cluster, plan.slots,
                 *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], pos.stride(0),
                 0 if window is None else int(window), _DTYPES[q.dtype],
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed (error {err})")
    flash_decode.launches += 1
    return o


flash_decode.launches = 0
