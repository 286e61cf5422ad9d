"""Launch counts of the CUDA kernels' wrappers.

The models call the wrappers (``flash_attention_fwd``, ``flash_decode``)
directly: a CPU tensor goes to the plain version, a CUDA tensor launches the
kernel or raises.  Each wrapper adds one to its ``launches`` where it launches
its kernel, and nowhere else.
"""
from __future__ import annotations

from .decode_attention import flash_decode
from .flash_attention import flash_attention_fwd


def launch_counts() -> dict[str, int]:
    return {"flash_attention_fwd": flash_attention_fwd.launches,
            "flash_decode": flash_decode.launches}


def reset_launch_counts() -> None:
    flash_attention_fwd.launches = 0
    flash_decode.launches = 0
