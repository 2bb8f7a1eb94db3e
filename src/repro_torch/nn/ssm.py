"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060]; the port's
copy of the JAX package's ``nn/ssm.py``.

Prefill runs the chunked SSD on the CUDA kernel
(``kernels/ssd_chunk.py``) where the JAX package computes the same
function in plain jnp (``ssd_chunked_streaming`` or ``ssd_chunked``, by
``SSMSpec.streaming``); the port keeps both plain forms and has one
route, so its ``SSMSpec`` carries neither that choice nor the mesh
route's ``seq_parallel``.  Decode is the dual recurrent form, one
state update per token, in plain tensor ops as in the JAX package:
  S' = exp(dt*A) * S + dt * B x^T ;  y = C S' + D x.

Shapes follow the Mamba2 convention:
  x  : [B, L, H, P]   (H heads, P head dim; d_inner = H*P)
  dt : [B, L, H]
  B,C: [B, L, G, N]   (G groups, N state dim; broadcast G -> H)

``ssd_seq_parallel`` (the sequence-parallel scan over a device mesh) is
not ported yet (ROADMAP Queue 1: training and infrastructure); on one
device the JAX package takes the single-device route as well.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain
from repro_torch.nn.layers import _dense_init

# The streaming scan over chunks is the SSD kernel's plain version.
ssd_chunked_streaming = ssd_chunk_plain


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_ssm(generator: torch.Generator, spec: SSMSpec, dtype=torch.float32,
             device=None) -> dict:
    """Random weights of the JAX package's shapes and constants, drawn on
    ``device`` from ``generator``."""
    d, di = spec.d_model, spec.d_inner
    proj_out = 2 * di + 2 * spec.n_groups * spec.d_state + spec.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((spec.n_heads,), generator=generator, **f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    conv_w = torch.randn((spec.d_conv, spec.conv_dim), generator=generator, **f32)
    return {
        "in_proj": _dense_init(generator, (d, proj_out), dtype, device),
        "conv_w": (conv_w / math.sqrt(spec.d_conv)).to(dtype),
        "conv_b": torch.zeros((spec.conv_dim,), dtype=dtype, device=device),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(torch.arange(1, spec.n_heads + 1, **f32)),
        "d_skip": torch.ones((spec.n_heads,), **f32),
        "out_proj": _dense_init(generator, (di, d), dtype, device),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: [..., T] -> [..., T, T] lower-tri cumulative sums (exclusive)."""
    t = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x, dt, a, b, c, *, chunk: int):
    """SSD scan, vectorised over chunks (every chunk's decay mask and
    scores at once; the recurrence over chunk states is a loop).
    x: [B, L, H, P]; dt: [B, L, H]; a: [H] (negative); b, c: [B, L, G, N].
    Returns y [B, L, H, P] and the final state [B, H, P, N], f32.  L must
    be a multiple of ``chunk`` (models pad)."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = l // chunk
    rep = h // g

    ad = dt * a[None, None, :]                                 # [B, L, H]
    xd = x * dt[..., None]
    adc = ad.reshape(bsz, nc, chunk, h).permute(0, 3, 1, 2)    # [B,H,nc,Q]
    xc = xd.reshape(bsz, nc, chunk, h, p).float()
    bch = b.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()
    cch = c.reshape(bsz, nc, chunk, g, n).repeat_interleave(rep, dim=3).float()

    # intra-chunk (quadratic, attention-like)
    lmask = torch.exp(_segsum(adc))                            # [B,H,nc,Q,Q]
    scores = torch.einsum("bnihs,bnjhs->bhnij", cch, bch)
    y_diag = torch.einsum("bhnij,bnjhp->bnihp", scores * lmask, xc)

    # chunk states
    a_cum = torch.cumsum(adc, dim=-1)                          # [B,H,nc,Q]
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bnqhs,bhnq,bnqhp->bnhps", bch, decay_to_end, xc)

    # inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(a_cum[..., -1])                    # [B,H,nc]
    s = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    s_prev = []
    for i in range(nc):
        s_prev.append(s)
        s = s * chunk_decay[..., i, None, None] + states[:, i]
    s_prev = torch.stack(s_prev, dim=1)                        # [B,nc,H,P,N]

    # state -> output within chunk
    y_off = torch.einsum("bnqhs,bhnq,bnhps->bnqhp", cch, torch.exp(a_cum), s_prev)
    return (y_diag + y_off).reshape(bsz, l, h, p), s


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over time in f32: xbc [B, L, C], w [K, C] ->
    (conv [B, L, C] f32, the last K-1 inputs [B, K-1, C] in xbc's dtype).
    The JAX package gathers the K windows and contracts them; here the K
    shifted views are summed in the same order."""
    bsz, l, cdim = xbc.shape
    xpad = torch.cat([xbc.new_zeros((bsz, k - 1, cdim)), xbc], dim=1)
    xf, wf = xpad.float(), w.float()
    out = xf[:, 0:l] * wf[0]
    for i in range(1, k):
        out = out + xf[:, i:i + l] * wf[i]
    return out + bias.float(), xpad[:, -(k - 1):]


def ssm_forward(
    params: dict,
    u: torch.Tensor,                # [B, L, d_model]
    spec: SSMSpec,
    *,
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (ssm [B,H,P,N], conv [B,K-1,convdim])
    decode: bool = False,
    ssd: Optional[Callable] = None,
):
    """Returns (y [B, L, d_model], new_state).  ``decode=True`` requires
    L == 1 and a state; prefill ignores ``state`` and starts from zero, as
    in the JAX package.  ``ssd`` replaces the SSD kernel at prefill
    (default ``kernels.ssd_chunk.ssd_chunk``; same contract)."""
    bsz, l, _ = u.shape
    h, p, n, g = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    di = spec.d_inner

    proj = u @ params["in_proj"]
    # split: [d_inner gate | conv_dim (x,B,C) | n_heads dt]
    z = proj[..., :di]
    xbc = proj[..., di:di + spec.conv_dim]
    dt_raw = proj[..., di + spec.conv_dim:]

    k = spec.d_conv
    if decode:
        window = torch.cat([state[1], xbc], dim=1)             # [B, K, convdim]
        conv_out = torch.einsum("bkc,kc->bc", window.float(), params["conv_w"].float())
        conv_out = (conv_out + params["conv_b"].float())[:, None]
        new_conv = window[:, 1:]
    else:
        conv_out, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"], k)
    xbc = F.silu(conv_out)

    xs = xbc[..., :di].reshape(bsz, l, h, p)
    bmat = xbc[..., di:di + g * n].reshape(bsz, l, g, n)
    cmat = xbc[..., di + g * n:].reshape(bsz, l, g, n)
    dt = F.softplus(dt_raw.float() + params["dt_bias"][None, None, :])   # [B, L, H]
    a = -torch.exp(params["a_log"])                                      # [H]

    if decode:
        s_prev = state[0]                                      # [B,H,P,N]
        ad = torch.exp(dt[:, 0, :] * a[None, :])               # [B,H]
        bg = bmat[:, 0].repeat_interleave(h // g, dim=1)       # [B,H,N]
        cg = cmat[:, 0].repeat_interleave(h // g, dim=1)
        bx = torch.einsum("bhp,bhn,bh->bhpn", xs[:, 0].float(), bg.float(), dt[:, 0])
        s_new = s_prev * ad[..., None, None] + bx
        y = torch.einsum("bhn,bhpn->bhp", cg.float(), s_new)
        y = y + params["d_skip"][None, :, None] * xs[:, 0].float()
        y = y.reshape(bsz, 1, di)
        new_state = (s_new, new_conv)
    else:
        pad_to = (-l) % spec.chunk
        xs_p, dt_p, b_p, c_p = (
            F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_to)).contiguous()
            for t in (xs, dt, bmat, cmat))
        y, s_final = (ssd or ssd_chunk)(xs_p, dt_p, a, b_p, c_p, chunk=spec.chunk)
        y = y[:, :l] + params["d_skip"][None, None, :, None] * xs.float()
        y = y.reshape(bsz, l, di)
        new_state = (s_final, new_conv)

    # gated RMSNorm (mamba2's norm-before-out-proj)
    yz = y * F.silu(z.float())
    var = yz.square().mean(dim=-1, keepdim=True)
    yz = yz * torch.rsqrt(var + 1e-6) * params["norm_scale"].float()
    out = yz.to(u.dtype) @ params["out_proj"]
    return out, new_state


def init_ssm_state(bsz: int, spec: SSMSpec, dtype=torch.float32, device=None):
    return (
        torch.zeros((bsz, spec.n_heads, spec.head_dim, spec.d_state),
                    dtype=torch.float32, device=device),
        torch.zeros((bsz, spec.d_conv - 1, spec.conv_dim), dtype=dtype, device=device),
    )
