"""FFN variants + shared initializers; the port's copy of the JAX
package's ``nn/layers.py``."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dense_init(generator, shape, dtype, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def init_ffn(generator: torch.Generator, d_model: int, d_ff: int, *,
             kind: str = "swiglu", dtype=torch.float32, device=None) -> dict:
    """kind: swiglu | geglu (gated, 3 matrices) or gelu (plain, 2)."""
    p = {
        "w_up": _dense_init(generator, (d_model, d_ff), dtype, device),
        "w_down": _dense_init(generator, (d_ff, d_model), dtype, device),
    }
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(generator, (d_model, d_ff), dtype, device)
    return p


def ffn(params: dict, x: torch.Tensor, *, kind: str = "swiglu") -> torch.Tensor:
    """``jax.nn.gelu`` is the tanh approximation by default, hence
    ``approximate="tanh"`` (``F.gelu``'s default is the exact form)."""
    up = x @ params["w_up"]
    if kind == "swiglu":
        act = F.silu(x @ params["w_gate"]) * up
    elif kind == "geglu":
        act = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif kind == "gelu":
        act = F.gelu(up, approximate="tanh")
    else:
        raise ValueError(kind)
    return act @ params["w_down"]


def dense(generator: torch.Generator, d_in: int, d_out: int, *,
          dtype=torch.float32, bias: bool = False, device=None) -> dict:
    p = {"w": _dense_init(generator, (d_in, d_out), dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def apply_dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
