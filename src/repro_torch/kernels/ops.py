"""Launch counts of the CUDA kernels' wrappers.

The models call the wrappers (``flash_attention`` through its autograd
Function, ``flash_decode``, ``rglru_scan``, ``rwkv6_wkv``) directly: a CPU
tensor goes to the plain version, a CUDA tensor launches the kernel or
raises.  Each wrapper adds one to its
``launches`` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

from .decode_attention import flash_decode
from .flash_attention import (flash_attention_bwd_dkv, flash_attention_bwd_dq,
                              flash_attention_fwd)
from .rglru_scan import rglru_scan
from .rwkv6_kernel import rwkv6_wkv

_WRAPPERS = (flash_attention_fwd, flash_attention_bwd_dq, flash_attention_bwd_dkv,
             flash_decode, rglru_scan, rwkv6_wkv)


def launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in _WRAPPERS}


def reset_launch_counts() -> None:
    for w in _WRAPPERS:
        w.launches = 0
