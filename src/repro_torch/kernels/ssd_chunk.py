"""Mamba-2 SSD chunked scan — the SSM path's prefill kernel.

Replaces the Pallas TPU kernel ``kernels/ssd_chunk/ssd_chunk.py::
ssd_chunk_p`` (body ``_ssd_kernel``; adapter ``kernels/ssd_chunk/ops.py::
ssd_chunk``) with the CUDA kernel ``csrc/ssd_chunk.cu``: one block per
(batch, head, slice of the head dim P) walks the chunks itself with the
[P-slice, N] state in f32 registers.  B and C are read at group width
(head h reads group h // (H/G)); the JAX adapter's repeat to H heads would
materialise 48x the tensor for mamba2.  At mamba2's prefill shapes the
scan is bound by operations (67 TFLOP/s f32 on the CUDA cores); this first
design runs its three products on the CUDA cores from shared memory, and
tensor cores and TMA staging are left for a later change.

``ssd_chunk_plain`` is the same function in plain PyTorch: the streaming
scan over chunks of the JAX package's ``nn/ssm.py::ssd_chunked_streaming``
in f32.  The wrapper runs it only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel or raises.  ``ssd_chunk.launches`` counts
kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.hw import H100_SXM
from repro_torch.kernels import _build

P_BLOCKS = (16, 32, 64)   # the kernel's instantiations: head-dim columns a block owns
MAX_CHUNK = 128           # score columns: 16 threads x 8
MAX_STATE = 128           # state columns: 16 threads x 8


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD as a streaming scan over chunks: x ``[B, L, H, P]``, dt
    ``[B, L, H]``, a ``[H]`` (negative), b, c ``[B, L, G, N]`` (G | H),
    ``L % chunk == 0``.  Returns y ``[B, L, H, P]`` and the final state
    ``[B, H, P, N]``, both f32.  B/C are repeated to heads one chunk at a
    time."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc, q, rep = l // chunk, chunk, h // g
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    ad = (dt * a[None, None, :]).reshape(bsz, nc, q, h)
    xd = (x * dt[..., None]).reshape(bsz, nc, q, h, p)
    bc = b.reshape(bsz, nc, q, g, n)
    cc = c.reshape(bsz, nc, q, g, n)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    s = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    ys = []
    for i in range(nc):
        b_i = bc[:, i].repeat_interleave(rep, dim=2)               # [B,Q,H,N]
        c_i = cc[:, i].repeat_interleave(rep, dim=2)
        x_i = xd[:, i]                                             # [B,Q,H,P]
        a_cum = torch.cumsum(ad[:, i], dim=1)                      # [B,Q,H]
        diff = a_cum[:, :, None, :] - a_cum[:, None, :, :]         # [B,Qi,Qj,H]
        lmask = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        scores = torch.einsum("bihs,bjhs->bijh", c_i, b_i)
        y_diag = torch.einsum("bijh,bjhp->bihp", scores * lmask, x_i)
        decay_to_end = torch.exp(a_cum[:, -1:, :] - a_cum)         # [B,Q,H]
        y_off = torch.einsum("bqhs,bqh,bhps->bqhp", c_i, torch.exp(a_cum), s)
        s = (s * torch.exp(a_cum[:, -1, :])[..., None, None]
             + torch.einsum("bqhs,bqh,bqhp->bhps", b_i, decay_to_end, x_i))
        ys.append(y_diag + y_off)
    return torch.stack(ys, dim=1).reshape(bsz, l, h, p), s


def ssd_p_block(bh: int, p: int, n: int, chunk: int) -> int:
    """The card's slice of the head dim for ``bh`` (batch, head) pairs.
    Each slice recomputes the chunk's C·Bᵀ scores but owns its columns of
    y and the state, so narrower slices put more blocks on the 132 SMs
    for more total work.  Picks the slice with the least work on the
    busiest SM: waves of blocks times one block's multiply-adds per
    chunk.  Every slice fits a block's shared memory at ``n`` and
    ``chunk`` up to 128 (at most 199 KB of the 227 KB)."""
    def cost(pb):
        blocks = bh * -(-p // pb)
        per_block = chunk * chunk * (n + pb) / 2 + 2 * chunk * n * pb
        return -(-blocks // H100_SXM.sms) * per_block, -pb

    return min(P_BLOCKS, key=cost)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``ssd_chunk_plain``'s contract, f32, with
    ``chunk <= 128`` and ``N <= 128``."""
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"ssd_chunk: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(dt.shape) != (bsz, l, h) or tuple(a.shape) != (h,)
            or tuple(b.shape[:2]) != (bsz, l) or g < 1 or h % g):
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)} against dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b/c {tuple(b.shape)}: need one batch and "
                         "length, H heads, groups dividing the heads")
    if not 1 <= chunk <= MAX_CHUNK or l % chunk or l == 0:
        raise ValueError(f"ssd_chunk: length {l} must be a positive multiple of the "
                         f"chunk {chunk}, and 1 <= chunk <= {MAX_CHUNK} (callers pad)")
    if not 1 <= n <= MAX_STATE or p < 1:
        raise ValueError(f"ssd_chunk: state dim {n} must be in 1..{MAX_STATE}, "
                         f"head dim {p} positive")
    _build.check_operands("ssd_chunk", x, dt, a, b, c)
    if not _build.on_card(x):
        return ssd_chunk_plain(x, dt, a, b, c, chunk=chunk)
    p_block = ssd_p_block(bsz * h, p, n, chunk)
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    err = _build.library().ssd_chunk_f32(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), state.data_ptr(), bsz, l, h, g, p, n, chunk, p_block,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check_launch("ssd_chunk", err)
    ssd_chunk.launches += 1
    return y, state


ssd_chunk.launches = 0
