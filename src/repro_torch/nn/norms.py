"""Normalization layers (f32 inside regardless of the tensors' dtype);
the port's copy of the JAX package's ``nn/norms.py``."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm; ``zero_centered`` uses (1+scale) (gemma convention)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    g = scale.float()
    if zero_centered:
        g = 1.0 + g
    return (y * g).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


def init_rms(d: int, dtype=torch.float32, zero_centered: bool = False,
             device=None) -> torch.Tensor:
    fill = torch.zeros if zero_centered else torch.ones
    return fill((d,), dtype=dtype, device=device)


def init_ln(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}
