"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060]; the port's
copy of the JAX package's ``nn/ssm.py``.

Prefill runs the chunked SSD on the CUDA kernel
(``kernels/ssd_chunk.py``) where the JAX package computes the same
function in plain jnp (``ssd_chunked_streaming`` or ``ssd_chunked``, by
``SSMSpec.streaming``); the port keeps both plain forms and has one
route, so its ``SSMSpec`` does not carry that choice.  Under autograd (grad enabled and an operand of
the scan requiring grad: a train step) the scan is ``ssd_chunked``, the
JAX package's vectorized plain form (``SSMSpec.streaming=False``; the
same function as its default streaming form), which autograd
differentiates: the kernel has no backward
(``kernels/_build.check_operands`` refuses a call that autograd would
record).  The choice is made from the call's structure; serving calls,
whose params do not require grad, keep the kernel.  The vectorized form
records a few ops a layer where the streaming form records some 25 a
chunk, which held a mamba2 train step on the host; and it masks its
decay before the exp (``_segsum``), where the streaming form's
``where(tri, exp(diff), 0)`` has a NaN gradient (0 x inf) wherever exp
overflows above the diagonal.  Decode is the dual recurrent form, one
state update per token, in plain tensor ops as in the JAX package:
  S' = exp(dt*A) * S + dt * B x^T ;  y = C S' + D x.

Shapes follow the Mamba2 convention:
  x  : [B, L, H, P]   (H heads, P head dim; d_inner = H*P)
  dt : [B, L, H]
  B,C: [B, L, G, N]   (G groups, N state dim; broadcast G -> H)

**Sequence parallelism** (``ssd_seq_parallel``): inside a ``with mesh:``
block whose 'model' axis has K > 1 ranks, a prefill whose padded length
divides into K slices of whole chunks is scanned a slice a rank, on the
SSD kernel, and corrected by the states the ranks exchange; elsewhere
the scan runs on one device.  The route depends on the mesh and the
length alone: the JAX package's ``SSMSpec.seq_parallel``, which no
config or caller sets, is left out as ``streaming`` is.  The JAX
package's residual stream is sequence-sharded there, so its scan takes
each rank's slice as it lies and gives back a sequence-sharded output.
The port's residual is sharded only when it is a DTensor (a sharded train
step, through ``constrain``), and then the same holds: each rank scans its
local shard and the output stays a sequence-sharded DTensor (the in and
out projections multiply each rank's rows by the gathered weight,
``distributed.sharding.rows_matmul``).  For plain
tensors (every rank holds the whole sequence) each rank scans its own
slice and the output is all-gathered along the sequence, a gather the
JAX package's sharded residual avoids.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import (placed_like, replicate_dim, row_placements,
                                              rows_matmul)
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain
from repro_torch.launch.mesh import ambient_mesh
from repro_torch.nn.layers import _dense_init
from repro_torch.tree import records_grad

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


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` stacked ``[K, ...]`` on every rank of ``group``;
    the backward sums the ranks' grads of the rank's own entry (an
    all-reduce of the stacked grad, then the rank's entry).
    ``torch.distributed.nn.functional.all_gather`` does the same, but its
    backward on gloo stands in for reduce-scatter with scatters from global
    rank numbers, which fail on a sub-group such as the 'model' axis of a
    (2, 2) mesh ("Global rank 0 is not part of group", torch 2.13)."""

    @staticmethod
    def forward(ctx, x, k, group):
        ctx.k, ctx.group = k, group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.k], None, None


class _SumGrad(torch.autograd.Function):
    """The identity on a tensor every rank of ``group`` holds whole and
    uses for its own slice; the backward sums the ranks' grads (one
    all-reduce).  ``torch.distributed.nn.functional`` has no such
    function: its all-reduce also sums the forward's values."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the grad by ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def ssd_seq_parallel(x, dt, a, b, c, *, chunk: int, mesh, axis: str = "model",
                     scan: Optional[Callable] = None):
    """Sequence-parallel SSD over the ``axis`` ranks of ``mesh``: the SSD
    scan of ``ssd_chunked`` 's contract, the length a multiple of K·chunk
    for the K ranks of ``axis``.

      1. each rank scans its sequence slice from a zero state on the SSD
         kernel (``scan``, default ``kernels.ssd_chunk.ssd_chunk``; under
         autograd ``ssd_chunked``) -> (y0, s_loc), in f32 operands, so
         that y0 is not rounded before the correction is added;
      2. the ranks of ``axis`` exchange their final local states s_loc
         [B, H, P, N] and total decays D [B, H] in one all_gather, whose
         backward sums the ranks' grads of each rank's entry;
      3. each rank forms its incoming state s_in by the K-term prefix
         recurrence and corrects its outputs: y += C · exp(a_cum) · s_in.

    Exact (the recurrence is linear).  Plain tensors: every rank holds the
    whole operands, scans its slice, and returns y whole (all-gathered
    along the sequence) and the final state; the collectives are
    ``dist.all_gather`` and ``dist.all_reduce``, which gloo also runs on
    CUDA tensors (DTensor's functional collectives crashed a gloo rank on
    CUDA).
    DTensors: each operand is redistributed to batch over the mesh's data
    axes (where they divide it) and the sequence over ``axis``; y comes
    back sequence-sharded and the final state replicated over ``axis``.
    Returns (y [B, L, H, P] in x's dtype, final state [B, H, P, N] f32)."""
    names = list(mesh.mesh_dim_names)
    kdim = names.index(axis)
    n = mesh.shape[kdim]
    k = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    sharded = isinstance(x, DTensor)
    if sharded:
        pl = row_placements(mesh, x.shape[0])[0]
        pl[kdim] = Shard(1)
        xl, dtl, bl, cl = (t.redistribute(mesh, pl).to_local() for t in (x, dt, b, c))
        # a is whole on every rank, and each rank's grad is its shard's
        # part: a partial sum over the mesh dims that split the scan
        al = a.redistribute(mesh, [Replicate()] * len(names)).to_local(
            grad_placements=[Partial() if p.is_shard() else Replicate() for p in pl])
    else:
        l_loc = x.shape[1] // n
        xl, dtl, bl, cl = (_SumGrad.apply(t, group)[:, k * l_loc:(k + 1) * l_loc]
                           for t in (x, dt, b, c))
        al = _SumGrad.apply(a, group)
    grad = records_grad(xl, dtl, al, bl, cl)
    run = ssd_chunked if grad else (scan or ssd_chunk)
    y0, s_loc = run(*(t.float().contiguous() for t in (xl, dtl)), al,
                    *(t.float().contiguous() for t in (bl, cl)), chunk=chunk)
    acum = torch.cumsum(dtl.float() * al.float()[None, None, :], dim=1)  # [B, Lloc, H]
    d_shard = torch.exp(acum[:, -1, :])                                   # [B, H]
    both = _Gather.apply(torch.cat([s_loc.flatten(), d_shard.flatten()]),
                         k, group)                                        # [K, BHPN + BH]
    gs = both[:, :s_loc.numel()].reshape((n,) + s_loc.shape)
    gd = both[:, s_loc.numel():].reshape((n,) + d_shard.shape)
    # the same graph on every rank: every prefix state, then this rank's
    # row of their stack, so that each rank's backward reaches the gather
    # (whose backward every rank must join) by the same path
    s_run, prefix = torch.zeros_like(s_loc), []
    for j in range(n):
        prefix.append(s_run)
        s_run = gs[j] + gd[j][..., None, None] * s_run
    s_in = torch.stack(prefix)[k]
    rep = xl.shape[2] // cl.shape[2]
    c_h = cl.float().repeat_interleave(rep, dim=2)                        # [B, Lloc, H, N]
    y = y0 + torch.einsum("blhs,blh,bhps->blhp", c_h, torch.exp(acum), s_in)
    y = y.to(x.dtype)
    # an output whole on every rank of ``axis`` gets its whole grad on each,
    # which the gathers' backward sums over the ranks: a 1/K share a rank
    s_fin = _ScaleGrad.apply(s_run, 1.0 / n)
    if not sharded:
        y = _Gather.apply(y, k, group).movedim(0, 1).flatten(1, 2)      # [B, L, H, P]
        return _ScaleGrad.apply(y, 1.0 / n), s_fin
    state_pl = list(pl)
    state_pl[kdim] = Replicate()
    return DTensor.from_local(y, mesh, pl), DTensor.from_local(s_fin, mesh, state_pl)


def _seq_parallel_mesh(spec: SSMSpec, length: int):
    """The ambient mesh where ``ssm_forward``'s prefill runs
    ``ssd_seq_parallel``: a 'model' axis of K > 1 ranks and a padded
    length of whole K·chunk slices; else None."""
    mesh = ambient_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    n_model = mesh.shape[list(mesh.mesh_dim_names).index("model")]
    return mesh if n_model > 1 and length % (n_model * spec.chunk) == 0 else None


def _decode_update(s_prev, x, bg, cg, dt, a, d_skip):
    """One token of the recurrence: s_prev [B,H,P,N] f32, x [B,H,P], bg/cg
    [B,H,N], dt [B,H], a and d_skip [H] -> (y [B,H,P] f32, S' [B,H,P,N])."""
    ad = torch.exp(dt * a[None, :])                            # [B,H]
    bx = torch.einsum("bhp,bhn,bh->bhpn", x.float(), bg.float(), dt)
    s_new = s_prev * ad[..., None, None] + bx
    y = torch.einsum("bhn,bhpn->bhp", cg.float(), s_new)
    return y + d_skip[None, :, None] * x.float(), s_new


# each operand of ``_decode_update``: (its heads dim, whether dim 0 is the batch)
_DECODE_DIMS = ((1, True), (1, True), (1, True), (1, True), (1, True), (0, False),
                (0, False))


def _decode_local(ops):
    """``_decode_update`` on each rank's rows (batch over the mesh's data
    axes) and heads (over 'model'), where those divide them, on its local
    shards: the recurrence is independent across both, so no collective
    runs inside.  DTensor's own einsums merge a data-sharded batch with
    model-sharded heads into one strided dim, which its propagation
    refuses.  Plain operands are whole on every rank."""
    mesh = ops[0].device_mesh
    names = list(mesh.mesh_dim_names)
    rows, _, _ = row_placements(mesh, ops[0].shape[0])
    heads = ("model" in names and ops[0].shape[1] % mesh.shape[names.index("model")] == 0)
    local = []
    for t, (hd, batched) in zip(ops, _DECODE_DIMS):
        pl = [p if batched else Replicate() for p in rows]
        if heads:
            pl[names.index("model")] = Shard(hd)
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        local.append(t.redistribute(mesh, pl).to_local())
    y, s_new = _decode_update(*local)
    pl = list(rows)
    if heads:
        pl[names.index("model")] = Shard(1)
    return DTensor.from_local(y, mesh, pl), DTensor.from_local(s_new, mesh, pl)


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
    (default ``kernels.ssd_chunk.ssd_chunk``; same contract); under
    autograd the scan is ``ssd_chunked``.  Inside a mesh the prefill may
    run ``ssd_seq_parallel`` (module note)."""
    bsz, l, _ = u.shape
    h, p, n, g = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    di = spec.d_inner
    u_in = u
    if not decode and _seq_parallel_mesh(spec, l + (-l) % spec.chunk) is None:
        # a sequence-sharded residual that the sequence-parallel scan does
        # not take (its shards are no whole chunks a rank) is gathered whole
        # at the block's entry, and the output goes back on its sharding
        u = replicate_dim(u, 1)

    proj = rows_matmul(u, params["in_proj"])
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
        bg = bmat[:, 0].repeat_interleave(h // g, dim=1)       # [B,H,N]
        cg = cmat[:, 0].repeat_interleave(h // g, dim=1)
        ops = (state[0], xs[:, 0], bg, cg, dt[:, 0], a, params["d_skip"])
        if isinstance(state[0], DTensor):
            y, s_new = _decode_local(ops)
        else:
            y, s_new = _decode_update(*ops)
        y = y.reshape(bsz, 1, di)
        new_state = (s_new, new_conv)
    else:
        pad_to = (-l) % spec.chunk       # (a DTensor is padded only if it must be)
        xs_p, dt_p, b_p, c_p = (
            (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad_to)) if pad_to else t).contiguous()
            for t in (xs, dt, bmat, cmat))
        mesh = _seq_parallel_mesh(spec, xs_p.shape[1])
        if mesh is not None:
            y, s_final = ssd_seq_parallel(xs_p, dt_p, a, b_p, c_p, chunk=spec.chunk,
                                          mesh=mesh, scan=ssd)
        else:
            scan = ssd_chunked if records_grad(xs_p, dt_p, a, b_p, c_p) else (ssd or ssd_chunk)
            y, s_final = scan(xs_p, dt_p, a, b_p, c_p, chunk=spec.chunk)
        y = (y[:, :l] if pad_to else y) + params["d_skip"][None, None, :, None] * xs.float()
        y = y.reshape(bsz, l, di)
        new_state = (s_final, new_conv)

    # gated RMSNorm (mamba2's norm-before-out-proj)
    yz = y * F.silu(z.float())
    var = yz.square().mean(dim=-1, keepdim=True)
    yz = yz * torch.rsqrt(var + 1e-6) * params["norm_scale"].float()
    out = rows_matmul(yz.to(u.dtype), params["out_proj"])
    return placed_like(out, u_in), new_state


def init_ssm_state(bsz: int, spec: SSMSpec, dtype=torch.float32, device=None):
    return (
        torch.zeros((bsz, spec.n_heads, spec.head_dim, spec.d_state),
                    dtype=torch.float32, device=device),
        torch.zeros((bsz, spec.d_conv - 1, spec.conv_dim), dtype=dtype, device=device),
    )
