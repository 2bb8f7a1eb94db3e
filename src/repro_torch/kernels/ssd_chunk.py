"""Mamba-2 SSD chunked scan — the SSM path's prefill kernel.

Replaces the Pallas TPU kernel ``kernels/ssd_chunk/ssd_chunk.py::
ssd_chunk_p`` (body ``_ssd_kernel``; adapter ``kernels/ssd_chunk/ops.py::
ssd_chunk``) with the CUDA kernels of ``csrc/ssd_chunk.cu``, three phases
on one stream after the block decomposition of the SSD paper (Mamba-2,
arXiv:2405.21060), so that no block walks the chunks' heavy work in
order:

1. chunk states, every chunk at once: for each (batch, chunk, head) the
   state a chunk adds, ``sum_j exp(a_cum_end - a_cum_j) xd_j^T B_j``
   ``[P, N]``, into an f32 workspace ``[B, nc, H, P, N]``;
2. state passing, a short elementwise walk over the chunks for each
   (batch, head): ``S_c = exp(a_cum_end,c) S_{c-1} + dS_c``, leaving in
   the workspace the state entering each chunk, and the final state;
3. chunk outputs, every chunk at once: for each (batch, chunk, run of
   ``ssd_head_run`` heads of one group) the scores C·Bᵀ once, then per
   head ``(L o scores) xd + exp(a_cum) o (C S_{c-1}^T)``.

The products run on the tensor cores (``mma.sync`` m16n8k8 tf32) in
3xTF32, three products a step, so the result keeps f32 accuracy.  B and C
are read at group width (head h reads group h // (H/G)); the JAX adapter's
repeat to H heads would materialise 48x the tensor for mamba2.

``ssd_chunk_plain`` is the same function in plain PyTorch: the streaming
scan over chunks of the JAX package's ``nn/ssm.py::ssd_chunked_streaming``
in f32.  Both take x, dt, B and C in float32 or bfloat16 (a in float32 or
their dtype), compute in f32 and return y in x's dtype and the state in
f32, as the Pallas kernel does.  The wrapper runs the plain version only
for a tensor on the CPU.  For a CUDA tensor it launches the kernels or
raises.  ``ssd_chunk.launches`` counts calls that launched them (one a
call, for the three phases).

A fake CUDA tensor (``FakeTensorMode``: the dry run's trace,
``launch.dryrun``) goes to the custom op ``torch.ops.repro_torch.ssd_chunk``
instead, whose fake implementation gives the outputs' shapes and whose
FLOP formula (``torch.utils.flop_counter``) gives the scan's terms of the
analytic model (``core.flops._ssm_layer_flops``: the chunk-quadratic term
2·T·Q·H·(N + P) and the states' 4·T·H·P·N, T = B·L tokens).  A real
tensor launches directly, as before.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.hw import H100_SXM
from repro_torch.core.rate import divisors
from repro_torch.kernels import _build

MAX_CHUNK = 128           # the kernels' shared-memory tiles: Q <= 128
MAX_STATE = 128           # and N <= 128


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, *, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD as a streaming scan over chunks: x ``[B, L, H, P]``, dt
    ``[B, L, H]``, a ``[H]`` (negative), b, c ``[B, L, G, N]`` (G | H),
    ``L % chunk == 0``.  Returns y ``[B, L, H, P]`` in x's dtype and the
    final state ``[B, H, P, N]`` in f32, computed in f32.  B/C are
    repeated to heads one chunk at a time."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc, q, rep = l // chunk, chunk, h // g
    y_dtype = x.dtype
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
    return torch.stack(ys, dim=1).reshape(bsz, l, h, p).to(y_dtype), s


def ssd_head_run(batch: int, nc: int, h: int, g: int, p: int, n: int,
                 chunk: int) -> int:
    """Heads of one group that a chunk-state and a chunk-output block
    take together (a divisor of H / G).  A block forms its chunk's C·Bᵀ
    scores once for all of them, so longer runs form them fewer times but
    leave fewer blocks for the 132 SMs (one an SM: up to 207 KB of shared
    memory).  Picks the run with the least work on the busiest SM: waves
    of blocks times one block's multiply-adds, the causal scores once and
    each head's diagonal output and two state products."""
    per_group = h // g

    def cost(run):
        blocks = batch * nc * g * (per_group // run)
        per_block = chunk * chunk * n / 2 + run * (chunk * chunk * p / 2
                                                   + 2 * chunk * n * p)
        return math.ceil(blocks / H100_SXM.sms) * per_block, -run

    return min(divisors(per_group), key=cost)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor, *, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``ssd_chunk_plain``'s contract, with ``chunk <=
    128`` and ``N <= 128``."""
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
    _build.check_operands("ssd_chunk", x, dt, b, c, dtypes=_build.FLOATS)
    _build.check_operands("ssd_chunk", a, dtypes=(torch.float32, x.dtype))
    if a.device != x.device:
        raise ValueError(f"ssd_chunk: operands on {x.device} and {a.device}")
    if not _build.on_card(x):
        return ssd_chunk_plain(x, dt, a, b, c, chunk=chunk)
    if isinstance(x, FakeTensor):
        work = _workspace(x, b, chunk)   # held while the op runs, as a launch holds it
        out = tuple(torch.ops.repro_torch.ssd_chunk(x, dt, a, b, c, chunk))
        del work
        return out
    return _launch(x, dt, a, b, c, chunk)


ssd_chunk.launches = 0


def _launch(x, dt, a, b, c, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    run = ssd_head_run(bsz, nc, h, g, p, n, chunk)
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    work = _workspace(x, b, chunk)
    a = a.float()
    err = getattr(_build.library(), f"ssd_chunk_{_build.SUFFIX[x.dtype]}")(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        y.data_ptr(), state.data_ptr(), work.data_ptr(), bsz, l, h, g, p, n,
        chunk, run, _build.raw_stream(x.device),
    )
    _build.check_launch("ssd_chunk", err)
    ssd_chunk.launches += 1
    return y, state


def _workspace(x, b, chunk: int) -> torch.Tensor:
    """The state each chunk adds, then the state entering it; then each
    chunk's sum of dt * a: f32 ``[B, nc, H, P * N + 1]``."""
    bsz, l, h, p = x.shape
    return torch.empty(bsz * (l // chunk) * h * (p * b.shape[3] + 1), dtype=torch.float32,
                       device=x.device)


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=())
def _ssd_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels as an op, for traced calls (module note)."""
    return _launch(x, dt, a, b, c, chunk)


@_ssd_op.register_fake
def _(x, dt, a, b, c, chunk):
    bsz, _, h, p = x.shape
    return torch.empty_like(x), x.new_empty((bsz, h, p, b.shape[3]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _ssd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, chunk, *args,
               out_shape=None, **kwargs) -> int:
    bsz, l, h, p = x_shape
    tokens, n = bsz * l, b_shape[3]
    return 2 * tokens * chunk * h * (n + p) + 4 * tokens * h * p * n
