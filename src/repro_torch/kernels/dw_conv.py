"""Depthwise KPU — MobileNet's k x k depthwise conv, channel multiplier 1.

Replaces the Pallas TPU kernel ``kernels/dw_conv/dw_conv.py::dw_conv_p``
(adapter ``kernels/dw_conv/ops.py::dw_conv_impl``) with the CUDA kernel
``csrc/dw_conv.cu``: a CUDA-core kernel blocked over output rows, one
block per (frame, run of output rows, planned channel tile bc), threads
laid out channel-fastest.  On an H100 HBM bytes bound it (9 MACs per
output); a shared-memory halo of the block's input rows is left for a
later change.

``dw_conv_plain`` repeats the Pallas body's arithmetic in plain
PyTorch: per tap a strided window times ``w[dy, dx]``, accumulated in
f32.  The wrapper runs it only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises.  ``dw_conv.launches`` counts
kernel launches.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable, Optional

import torch

from repro_torch.core.hw import H100_SXM
from repro_torch.core.rate import divisors
from repro_torch.core.tiles import TileChoice, dw_rows
from repro_torch.kernels import _build


def dw_conv_plain(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """x [N, H, W, C] (unpadded), w [kh, kw, C]."""
    kh, kw, c = w.shape
    ho = -(-x.shape[1] // stride)
    wo = -(-x.shape[2] // stride)
    acc = torch.zeros((x.shape[0], ho, wo, c), dtype=torch.float32,
                      device=x.device)
    for dy, dx, win in _build.windows(x.float(), kh, kw, stride):
        acc += win * w[dy, dx].float()
    return acc.to(x.dtype)


def dwconv_plain(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The executor's grouped-conv layout: w HWIO ``[kh, kw, 1, C*cm]``;
    output channel o reads input channel o // cm (any multiplier cm)."""
    cm = w.shape[-1] // x.shape[-1]
    if cm > 1:
        x = x.repeat_interleave(cm, dim=-1)
    return dw_conv_plain(x, w[:, :, 0, :], stride)


def dw_conv(
    x: torch.Tensor, w: torch.Tensor, *, stride: int, bm: int, bc: int
) -> torch.Tensor:
    """SAME depthwise conv of NHWC ``x`` by ``w [kh, kw, C]``; ``bm`` is
    whole output rows (a multiple of Wo), ``bc`` the channel tile."""
    if x.dim() != 4 or w.dim() != 3 or x.shape[3] != w.shape[2]:
        raise ValueError(f"dw_conv: shapes {tuple(x.shape)}, {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"dw_conv: stride {stride}")
    _build.check_operands("dw_conv", x, w)
    n, h, wd, c = x.shape
    kh, kw, _ = w.shape
    ho, (pt, _) = _build.same_pads(h, kh, stride)
    wo, (pl, _) = _build.same_pads(wd, kw, stride)
    if bc < 1 or c % bc or bm < wo or bm % wo:
        raise ValueError(
            f"dw_conv: tile (bm={bm}, bc={bc}) must be whole output rows of "
            f"width {wo} and divide C={c}"
        )
    if kh * kw * bc * 4 > H100_SXM.smem_per_block:
        raise ValueError(f"dw_conv: {kh}x{kw}x{bc} weights exceed a block")
    if not _build.on_card(x):
        return dw_conv_plain(x, w, stride)
    lib = _build.library()
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    err = lib.dw_conv_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, c, ho, wo, kh, kw,
        stride, pt, pl, bm // wo, bc,
        _build.raw_stream(x.device),
    )
    _build.check_launch("dw_conv", err)
    dw_conv.launches += 1
    return y


dw_conv.launches = 0


def _pick_bc(c: int, rate: Optional[Fraction]) -> int:
    """The uniform path's channel tile: smallest divisor covering the
    stream rate (default 128)."""
    want = 128 if rate is None else max(1, int(rate))
    cands = [d for d in divisors(c) if d >= want]
    return min(cands) if cands else c


def dw_conv_impl(
    *,
    rate: Optional[Fraction] = None,
    tile: Optional[TileChoice] = None,
    record: Optional[Callable[..., None]] = None,
):
    """Adapter to the executor's 'dwconv' signature (models/cnn.py).

    The executor stores depthwise weights HWIO with I=1 (``[kh, kw, 1,
    C]``); the kernel wants ``[kh, kw, C]`` and channel multiplier 1.
    ``tile`` pins the plan's channel tile ``bk`` and row block ``bm``;
    ``record`` receives ``bk`` = the executed channel tile and ``bn=1``.
    """
    def impl(x, w, stride):
        if w.shape[-1] != x.shape[-1]:
            raise NotImplementedError(
                f"dw_conv kernel supports channel_multiplier == 1 only "
                f"(got weights for {w.shape[-1]} outputs on "
                f"{x.shape[-1]} channels); use the plain dwconv impl"
            )
        c = x.shape[-1]
        if tile is not None:
            bc, bm = tile.bk, tile.bm
        else:
            ho, wo = -(-x.shape[1] // stride), -(-x.shape[2] // stride)
            bc = _pick_bc(c, rate)
            bm = dw_rows(ho, wo, bc) * wo
        y = dw_conv(x.contiguous(), w[:, :, 0, :], stride=stride, bm=bm, bc=bc)
        if record is not None:
            record(bk=bc, bn=1, bm=bm, d_in=c, d_out=c)
        return y

    return impl
