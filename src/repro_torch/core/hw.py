"""The NVIDIA H100 SXM figures the tile rule and the roofline bounds need.

Sources: NVIDIA H100 Tensor Core GPU data sheet (SXM5 part, dense rates
without sparsity, at the 700 W power limit) and the NVIDIA Hopper
architecture white paper / CUDA C++ Programming Guide ("Compute
Capability 9.0" table) for the per-SM and per-block limits.  A card set
below 700 W (``nvidia-smi --query-gpu=power.limit``) reaches less than
these peaks; every measurement is reported beside that limit.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HopperSpec:
    name: str = "H100-SXM5-80GB"
    sms: int = 132                       # white paper: 132 SMs on SXM5
    smem_per_block: int = 232_448        # 227 KiB opt-in dynamic smem per block
    regs_per_sm: int = 65_536            # 32-bit registers per SM
    l2_bytes: int = 50 * 1024**2         # 50 MB L2
    hbm_bw: float = 3.35e12              # bytes/s
    peak_fp32_flops: float = 67e12       # CUDA cores, FP32 (FMA = 2 flops)
    peak_tf32_flops: float = 495e12      # tensor cores, TF32, dense
    peak_bf16_flops: float = 989e12      # tensor cores, BF16/FP16, dense


H100_SXM = HopperSpec()
