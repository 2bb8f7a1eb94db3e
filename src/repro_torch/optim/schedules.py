"""Learning-rate schedules (the cosine one is wired into AdamW); the port's
copy of the JAX package's ``optim/schedules.py``.

``step`` is a number or a tensor; the arithmetic is in f32 tensors, as
the JAX package's ``jnp`` arithmetic is, so that a schedule gives the
reference's f32 values and not Python doubles.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _warm(step, warmup_steps: int) -> torch.Tensor:
    return torch.clamp(_f32(step) / max(warmup_steps, 1), max=1.0)


def _progress(step, warmup_steps: int, total_steps: int) -> torch.Tensor:
    return torch.clamp((_f32(step) - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)


def warmup_cosine(step, *, lr: float, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    cos = 0.5 * (1 + torch.cos(math.pi * _progress(step, warmup_steps, total_steps)))
    return lr * _warm(step, warmup_steps) * (min_ratio + (1 - min_ratio) * cos)


def warmup_linear(step, *, lr: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    decay = 1.0 - _progress(step, warmup_steps, total_steps)
    return lr * _warm(step, warmup_steps) * decay


def constant(step, *, lr: float, warmup_steps: int = 0, **_) -> torch.Tensor:
    warm = _warm(step, warmup_steps) if warmup_steps else _f32(1.0)
    return lr * warm
