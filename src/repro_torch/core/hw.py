"""Hardware constants: the card the port runs on, and the FPGA the paper
prices its resources on.

``HopperSpec`` holds the NVIDIA H100 SXM figures the tile rule and the
roofline bounds need.

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


@dataclasses.dataclass(frozen=True)
class FPGASpec:
    """xcvu37p resources (the paper's device, AMD/Xilinx Virtex
    UltraScale+ xcvu37p-fsvh2892-3-e) + mapping constants, as the JAX
    package's ``core/hw_specs.py`` gives them; only the analytical
    resource model (``core.resource_model``) reads them.

    The mapping constants are calibrated once against the paper's own
    tables and documented here:

    * ``dsp_pack``   — int8 multiplications packed per DSP48E2 when a
      shared operand allows it (classic 2x packing for 8-bit).
    * ``dw_mult_in_lut`` — depthwise multipliers are small and numerous;
      the paper's DSP counts are only consistent with dw mults in LUTs.
    * ``lut_per_8x8_mult`` — soft-logic int8 multiplier cost.
    * ``compressor_alpha`` — LUTs per partial-product bit in a
      compressor tree [13]; ``binary_alpha`` for naive binary adder trees
      (the [11] baseline uses smaller trees, less compressor-friendly).
    """

    name: str = "xcvu37p-fsvh2892-3-e"
    luts: int = 1_303_680
    ffs: int = 2_607_360
    bram36: int = 2_016
    uram: int = 960
    dsps: int = 9_024
    bram36_kbits: int = 36
    bram_width: int = 72                # SDP max width
    bram_depth: int = 512               # at width 72
    # calibration constants (fit once, never per-experiment):
    dsp_pack: int = 2
    dw_mult_in_lut: bool = True
    lut_per_8x8_mult: float = 58.0
    compressor_alpha: float = 0.62      # LUT / operand-bit, compressor tree
    binary_alpha: float = 1.0           # LUT / operand-bit, binary adder tree
    acc_bits: int = 16                  # partial-product width entering trees
    ctrl_lut_per_unit: float = 34.0     # mux/counter/padding control per unit
    ctrl_lut_invalid_filter: float = 55.0  # [11]-style invalid-data filtering
    ff_per_mult: float = 26.0           # pipeline regs around each multiplier
    ff_per_unit: float = 120.0          # config counters, select lines
    ff_input_buffer_per_tap: float = 9.0  # non-transposed KPU input delay regs


XCVU37P = FPGASpec()
