"""KPU — the paper's kernel processing unit: a SAME-padded NHWC conv.

Replaces the Pallas TPU kernel ``kernels/kpu_conv/kpu_conv.py::
kpu_conv_p`` (adapter ``kernels/kpu_conv/ops.py::conv_impl``) with the
CUDA kernel ``csrc/kpu_conv.cu``: an implicit GEMM over M = N*Ho*Wo
output pixels, walking the planned input-channel tile bci and the kh*kw
taps on the tensor cores (wgmma tf32, three products per step so the
result keeps f32 accuracy; on bf16 operands one wgmma bf16 product a
step) fed by a cp.async ring (``csrc/tile_mma.cuh``).  An f32 block runs
a group of the planned (bm pixels x bco channels) tiles: adjacent column
tiles up to a wgmma width of 256, and two atoms' worth of pixel tiles
where bm <= 64, so that one gathered window feeds all of them (narrower
where the cluster split would leave a block fewer than 3 steps); a bf16
block one column tile; each tile keeps its own steps in the same order
(``block_group`` reads the group).  Only surviving strided windows are read, and the asymmetric
SAME padding is zero-fill in the kernel's index math.  Where the blocks
leave SMs idle the kernel's plan splits the (bci, tap) steps over a
thread-block cluster (``cluster_split`` reads its choice).
On an H100 the 3xTF32 products at 495 TFLOP/s bound it (bf16: one product
at 989 TFLOP/s).  Both take float32 or bfloat16 and write ``x``'s dtype,
accumulating in f32, as the Pallas kernel does.

``kpu_conv_plain`` repeats the Pallas body's arithmetic in plain
PyTorch: per (dy, dx) tap a strided window of the padded input times
``w[dy, dx]``, accumulated in f32.  The wrapper runs it only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
``kpu_conv.launches`` counts kernel launches, ``kpu_conv.grouped_launches``
those whose blocks ran more than one of the plan's tiles, as the
kernel's host plan reports them.
"""
from __future__ import annotations

import ctypes
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
    _build.check_operands("kpu_conv", x, w, dtypes=_build.FLOATS)
    _build.check_mma_tile("kpu_conv", bm, bci, bco, x.shape[3], w.shape[3])
    if not _build.on_card(x):
        return kpu_conv_plain(x, w, stride)
    return _launch(x, w, stride, bm, bci, bco, 0)


def _launch(x, w, stride: int, bm: int, bci: int, bco: int, split: int,
            group: tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Launch the kernel on operands ``kpu_conv`` has checked: ``split``
    blocks a tile along a cluster, 0 for the kernel's rule (the card
    tests and ``tools/cluster_split_times.py`` run 1 beside it); the
    plan's (pixel, column) tiles a block, 0 for the rule's (the card tests
    run (1, 1) beside it)."""
    lib = _build.library()
    n, h, wd, d_in = x.shape
    kh, kw, _, d_out = w.shape
    ho, (pt, _) = _build.same_pads(h, kh, stride)
    wo, (pl, _) = _build.same_pads(wd, kw, stride)
    y = torch.empty((n, ho, wo, d_out), dtype=x.dtype, device=x.device)
    took = (ctypes.c_int * 2)()  # the (pixel, column) tiles a block ran
    err = getattr(lib, f"kpu_conv_{_build.SUFFIX[x.dtype]}")(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), n, h, wd, d_in, ho, wo,
        d_out, kh, kw, stride, pt, pl, bm, bci, bco, split, group[0], group[1],
        took, _build.raw_stream(x.device),
    )
    _build.check_launch("kpu_conv", err)
    kpu_conv.launches += 1
    if took[0] * took[1] > 1:
        kpu_conv.grouped_launches += 1
    return y


def _plan(x_shape, w_shape, stride, bm, bci, bco, dtype):
    n, h, wd, d_in = x_shape
    kh, kw, _, d_out = w_shape
    ho, wo = -(-h // stride), -(-wd // stride)
    return _build.mma_plan(n, h, wd, d_in, ho, wo, d_out, kh, kw, bm, bci, bco,
                           dtype.itemsize, kpu=True)


def cluster_split(x_shape, w_shape, *, stride: int, bm: int, bci: int, bco: int,
                  dtype: torch.dtype = torch.float32) -> int:
    """Blocks the kernel splits each block's steps over on the current
    card for NHWC ``x_shape`` and HWIO ``w_shape`` of ``dtype`` at the
    (bm, bci, bco) tile (1: none; 0: a tile it does not take)."""
    return _plan(x_shape, w_shape, stride, bm, bci, bco, dtype)[0]


def block_group(x_shape, w_shape, *, stride: int, bm: int, bci: int, bco: int,
                dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """The plan's (pixel tiles, column tiles) one block of the kernel runs
    on the current card for ``cluster_split``'s call ((0, 0): a tile it
    does not take)."""
    return _plan(x_shape, w_shape, stride, bm, bci, bco, dtype)[1:]


kpu_conv.launches = 0
kpu_conv.grouped_launches = 0


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
