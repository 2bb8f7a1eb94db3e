"""Int8 activation links: the port's copy of the link half of the JAX
package's ``nn/quant.py``.

One activation tensor crossing a pipeline-stage cut becomes
``{"__q__": int8 tensor, "__s__": 0-d f32 tensor}`` — per-tensor dynamic
symmetric, the ``core.stage_partition.StreamBuffer`` int8 wire format, so
the staged executor moves 8 bits per feature between stages.
``fake_quant_link`` is the quantize-dequantize round trip in one call:
the monolithic reference applies it in place so the staged int8 path can
be compared bit for bit.

The arithmetic is the reference's step for step, in f32: s = max(amax,
1e-12) / 127, q = clip(round(x / s), -127, 127) with ``torch.round``'s
half-to-even ties (``jnp.round``'s) and true quotients on the CPU and on
the card (``exact_divisor``), so both packages give the same bits.
One scale spans the whole tensor, so a frame's int8 payload depends on
the other frames of its micro-batch, as in the reference.
"""
from __future__ import annotations

from typing import Dict

import torch


def exact_divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device.  A CUDA
    tensor divided by a Python number (or a 0-d CPU tensor) is multiplied
    by its reciprocal, one rounding more than the true quotient the JAX
    package and the CPU take; a divisor on the same device is divided."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def quantize_link(x: torch.Tensor, *, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Per-tensor dynamic symmetric int8 for one cut-crossing activation:
    s = amax/127, q = clip(round(x/s)).  ``bits`` != 8 is rejected: the
    stream-buffer widths this mirrors are priced per ``LINK_DTYPE_BITS``,
    and only the int8 entry has a quantizer (bf16 is a cast)."""
    if bits != 8:
        raise ValueError(f"quantize_link only implements int8, got {bits} bits")
    xf = x.float()
    s = torch.clamp(xf.abs().max(), min=1e-12) / exact_divisor(127.0, xf)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return {"__q__": q, "__s__": s}


def dequantize_link(payload: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_link`` on the consuming stage: f32 product,
    then a cast to ``dtype``."""
    return (payload["__q__"].float() * payload["__s__"]).to(dtype)


def fake_quant_link(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Quantize-dequantize round trip in one call — what the monolithic
    reference applies at each would-be cut."""
    return dequantize_link(quantize_link(x), dtype=dtype)
