"""FCU — the paper's fully-connected unit: ``[m, d_in] @ [d_in, d_out]``.

Replaces the Pallas TPU kernel ``kernels/fcu_matmul/fcu_matmul.py::
fcu_matmul_p`` (adapters ``kernels/fcu_matmul/ops.py``) with the CUDA
kernel ``csrc/fcu_matmul.cu``: one block per planned (bm x bn) output
tile, looping over d_in in planned bk steps through shared memory with
an f32 register accumulator.  Its roofline bound on an H100 is HBM
bytes for narrow layers and fp32 operations for wide ones; at the plan's
narrow tiles the CUDA-core FMA loop on few blocks sets its time.  wgmma
on TMA-staged tiles is left for a later change.

``fcu_matmul_plain`` is the same function in plain PyTorch (f32
accumulation); the wrapper runs it only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises.  ``fcu_matmul.launches``
counts kernel launches.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Callable, Optional

import torch

from repro_torch.core.tiles import TileChoice, select_tile
from repro_torch.kernels import _build


def fcu_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in f32, cast back to ``x``'s dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def fcu_matmul(
    x: torch.Tensor, w: torch.Tensor, *, bm: int, bk: int, bn: int
) -> torch.Tensor:
    """``x [m, d_in] @ w [d_in, d_out]`` with the (bm, bk, bn) block tile."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fcu_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    _build.check_operands("fcu_matmul", x, w)
    m, d_in = x.shape
    d_out = w.shape[1]
    tx, ty, tm, tn, g = _build.check_gemm_tile("fcu_matmul", bm, bk, bn, d_in,
                                               d_out)
    if not _build.on_card(x):
        return fcu_matmul_plain(x, w)
    lib = _build.library()
    y = torch.empty((m, d_out), dtype=x.dtype, device=x.device)
    err = lib.fcu_matmul_f32(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), m, d_in, d_out, bm, bk, bn,
        tx, ty, tm, tn, g, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch("fcu_matmul", err)
    fcu_matmul.launches += 1
    return y


fcu_matmul.launches = 0


def pointwise_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv / dense layer: ``[..., d_in] @ [d_in, d_out]``."""
    lead = x.shape[:-1]
    y = fcu_matmul_plain(x.reshape(-1, x.shape[-1]), w)
    return y.reshape(*lead, w.shape[-1])


def _pick_bm(m: int, want: int) -> int:
    bm = min(want, m)
    while m % bm:
        bm -= 1
    return max(1, bm)


def _fcu_impl(
    rate: Optional[Fraction],
    tile: Optional[TileChoice],
    record: Optional[Callable[..., None]],
):
    def impl(x, w):
        lead = x.shape[:-1]
        d_in, d_out = x.shape[-1], w.shape[-1]
        m = 1
        for s in lead:
            m *= s
        t = tile
        if t is None:
            t = select_tile(m, d_in, d_out, rate=rate)
        bm = _pick_bm(m, t.bm)
        y = fcu_matmul(x.reshape(m, d_in).contiguous(), w, bm=bm, bk=t.bk, bn=t.bn)
        if record is not None:
            record(bk=t.bk, bn=t.bn, bm=bm, d_in=d_in, d_out=d_out, m=m)
        return y.reshape(*lead, d_out)

    return impl


def pointwise_impl(
    *,
    rate: Optional[Fraction] = None,
    tile: Optional[TileChoice] = None,
    record: Optional[Callable[..., None]] = None,
):
    """Adapter to the executor's 'pointwise' signature (models/cnn.py):
    a 1x1 conv is the FCU matmul over the flattened pixel axis.  ``tile``
    pins the plan's (bk, bn); bm re-fits the runtime m (``_pick_bm``);
    ``record`` receives the executed tile."""
    return _fcu_impl(rate, tile, record)


def dense_impl(
    *,
    rate: Optional[Fraction] = None,
    tile: Optional[TileChoice] = None,
    record: Optional[Callable[..., None]] = None,
):
    """Adapter to the executor's 'dense' signature (models/cnn.py)."""
    return _fcu_impl(rate, tile, record)
