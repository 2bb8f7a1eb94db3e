"""KPU — the paper's kernel processing unit: a SAME-padded NHWC conv.

Replaces the Pallas TPU kernel ``kernels/kpu_conv/kpu_conv.py::
kpu_conv_p`` (adapter ``kernels/kpu_conv/ops.py::conv_impl``) with the
CUDA kernel ``csrc/kpu_conv.cu``: an implicit GEMM over M = N*Ho*Wo
output pixels, one block per planned (bm pixels x bco channels) tile,
walking the planned input-channel tile bci and the kh*kw taps.  Only
surviving strided windows are read, and the asymmetric SAME padding is
zero-fill in the kernel's index math.  On an H100 the CUDA-core FMA loop
bounds it; wgmma on TMA-staged tiles is left for a later change.

``kpu_conv_plain`` repeats the Pallas body's arithmetic in plain
PyTorch: per (dy, dx) tap a strided window of the padded input times
``w[dy, dx]``, accumulated in f32.  The wrapper runs it only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``kpu_conv.launches`` counts kernel launches.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable, Optional

import torch

from repro_torch.core.tiles import TileChoice, select_tile
from repro_torch.kernels import _build


def kpu_conv_plain(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """x [N, H, W, d_in] (unpadded), w HWIO [kh, kw, d_in, d_out]."""
    kh, kw, _, d_out = w.shape
    ho = -(-x.shape[1] // stride)
    wo = -(-x.shape[2] // stride)
    acc = torch.zeros((x.shape[0], ho, wo, d_out), dtype=torch.float32,
                      device=x.device)
    for dy, dx, win in _build.windows(x.float(), kh, kw, stride):
        acc += torch.matmul(win, w[dy, dx].float())
    return acc.to(x.dtype)


def kpu_conv(
    x: torch.Tensor, w: torch.Tensor, *, stride: int, bm: int, bci: int, bco: int
) -> torch.Tensor:
    """SAME conv of NHWC ``x`` by HWIO ``w`` with the (bm, bci, bco) tile."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[2]:
        raise ValueError(f"kpu_conv: shapes {tuple(x.shape)}, {tuple(w.shape)}")
    if stride < 1:
        raise ValueError(f"kpu_conv: stride {stride}")
    _build.check_operands("kpu_conv", x, w)
    n, h, wd, d_in = x.shape
    kh, kw, _, d_out = w.shape
    tx, ty, tm, tn, g = _build.check_gemm_tile("kpu_conv", bm, bci, bco, d_in,
                                               d_out, conv=True)
    if not _build.on_card(x):
        return kpu_conv_plain(x, w, stride)
    ho, (pt, _) = _build.same_pads(h, kh, stride)
    wo, (pl, _) = _build.same_pads(wd, kw, stride)
    lib = _build.library()
    y = torch.empty((n, ho, wo, d_out), dtype=x.dtype, device=x.device)
    err = lib.kpu_conv_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, d_in, ho, wo,
        d_out, kh, kw, stride, pt, pl, bm, bci, bco, tx, ty, tm, tn, g,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch("kpu_conv", err)
    kpu_conv.launches += 1
    return y


kpu_conv.launches = 0


def conv_impl(
    *,
    rate: Optional[Fraction] = None,
    tile: Optional[TileChoice] = None,
    record: Optional[Callable[..., None]] = None,
):
    """Adapter to the executor's 'conv' signature (models/cnn.py):
    ``impl(x, w_hwio, stride) -> y`` with the KPU kernel underneath.

    ``tile`` pins the plan's (bm, bci, bco) (rate-matched path); without
    it ``rate`` parameterizes the uniform ``select_tile`` search.
    ``record(bk=, bn=, bm=, d_in=, d_out=)`` receives the executed tile.
    """
    def impl(x, w, stride):
        t = tile
        if t is None:
            ho, wo = -(-x.shape[1] // stride), -(-x.shape[2] // stride)
            t = select_tile(ho * wo, x.shape[-1], w.shape[-1], rate=rate,
                            conv=True)
        y = kpu_conv(x.contiguous(), w, stride=stride, bm=t.bm, bci=t.bk,
                     bco=t.bn)
        if record is not None:
            record(bk=t.bk, bn=t.bn, bm=t.bm, d_in=x.shape[-1], d_out=w.shape[-1])
        return y

    return impl
