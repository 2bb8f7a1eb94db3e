"""Depthwise KPU — MobileNet's k x k depthwise conv, channel multiplier 1.

Replaces the Pallas TPU kernel ``kernels/dw_conv/dw_conv.py::dw_conv_p``
(adapter ``kernels/dw_conv/ops.py::dw_conv_impl``) with the CUDA kernel
``csrc/dw_conv.cu``: one block per (frame, run of output rows, planned
channel tile bc) stages the input rows those outputs read, with the SAME
padding zero-filled in place, once in shared memory by 16-byte cp.async
copies.  Each thread owns a run of outputs along x for 4 neighbouring f32
channels or 8 bf16 channels, keeps their 3 x 3 weights in registers in
f32, applies each staged input vector to every output of its run that
reads it, accumulates in f32 and writes 16 bytes at a time; a channel
tile that is no whole number of 16-byte vectors runs the same kernel an
element at a time.  On an H100 HBM bytes bound it (9 MACs per output
against 4 or 2 bytes an element).  The kernel takes 3 x 3 taps at stride
1 or 2, as every CNN family here has them; the wrapper raises for any
other on the card, and for a 16-byte tile of operands that are not
16-byte aligned.

Both routes take float32 or bfloat16 and write ``x``'s dtype.
``dw_conv_plain`` repeats the Pallas body's arithmetic in plain PyTorch:
per tap a strided window times ``w[dy, dx]``, accumulated in f32.  The
wrapper runs it only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``dw_conv.launches`` counts kernel
launches.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable, Optional

import torch

from repro_torch.core.hw import H100_SXM
from repro_torch.core.rate import divisors
from repro_torch.core.tiles import TileChoice, dw_halo_bytes, dw_rows
from repro_torch.kernels import _build

# The taps and strides the kernel takes (those of every CNN family here).
TAPS = 3
STRIDES = (1, 2)


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
    _build.check_operands("dw_conv", x, w, dtypes=_build.FLOATS)
    n, h, wd, c = x.shape
    kh, kw, _ = w.shape
    ho, (pt, _) = _build.same_pads(h, kh, stride)
    wo, (pl, _) = _build.same_pads(wd, kw, stride)
    if bc < 1 or c % bc or bm < wo or bm % wo:
        raise ValueError(
            f"dw_conv: tile (bm={bm}, bc={bc}) must be whole output rows of "
            f"width {wo} and divide C={c}"
        )
    halo = dw_halo_bytes(min(bm // wo, ho), wo, bc, (kh, kw), stride,
                         x.element_size())
    if halo > H100_SXM.smem_per_block:
        raise ValueError(f"dw_conv: the block's {halo} B of input rows exceed "
                         f"the {H100_SXM.smem_per_block} B of a block")
    if not _build.on_card(x):
        return dw_conv_plain(x, w, stride)
    if (kh, kw) != (TAPS, TAPS) or stride not in STRIDES:
        raise ValueError(f"dw_conv: the kernel takes {TAPS}x{TAPS} taps at stride "
                         f"1 or 2, got {kh}x{kw} at stride {stride}")
    if bc % (16 // x.element_size()) == 0 and (x.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("dw_conv: a channel tile of whole 16-byte vectors needs "
                         "x and w 16-byte aligned")
    lib = _build.library()
    y = torch.empty((n, ho, wo, c), dtype=x.dtype, device=x.device)
    err = getattr(lib, f"dw_conv_{_build.SUFFIX[x.dtype]}")(
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
