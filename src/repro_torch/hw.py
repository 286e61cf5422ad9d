"""Hardware descriptors used by the roofline and the anomaly monitor.

``V5E`` (the JAX package's target chip, copied exactly) stays the default of
every measurement, so that the floors and the A1 verdict are the reference's.
``H100`` describes the card the port runs on; it is used only where a caller
asks for it.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12  # FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s per chip
    ici_bw: float = 50e9             # bytes/s per link (charged per chip, conservative)
    hbm_bytes: float = 16 * 1024**3  # HBM capacity per chip
    vmem_bytes: float = 128 * 1024**2


V5E = ChipSpec()

# NVIDIA H100 SXM5 80GB, from NVIDIA's H100 datasheet: 989 TFLOP/s dense bf16
# tensor-core rate, 3.35 TB/s HBM3, 80 GB HBM3, NVLink 4 at 900 GB/s per GPU
# (both directions; 450 GB/s each way, the rate charged here), 50 MB L2 in
# the place of the TPU's VMEM.
H100 = ChipSpec(name="h100-sxm5-80gb", peak_flops_bf16=989e12, hbm_bw=3.35e12,
                ici_bw=450e9, hbm_bytes=80e9, vmem_bytes=50 * 1024**2)

