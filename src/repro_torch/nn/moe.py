"""Mixture-of-experts FFN (grok-1: 8 experts top-2; llama4: 128 top-1 plus
a shared expert); the port's copy of the JAX package's ``nn/moe.py``.

Three dispatch forms, selected by ``MoESpec.impl`` (``moe_impl``):

* ``"einsum"`` (the configs' default): GShard one-hot dispatch over
  token groups of ``g <= group_size`` (halved until it divides the
  sequence), ``C(g)`` buffer slots an expert a group.
* ``"scatter"``: one group a batch row; every routed copy is written into
  its expert's buffer at its position, overflow into a bucket at index
  ``C`` that reads back zero.
* ``"ragged"``: dropless; the routed copies sorted by expert (a stable
  sort, as ``jnp.argsort``'s) and one product per expert over its
  ``bincount`` rows, the mixture summed in f32.

Expert capacity is ``C = max(k, ceil(g·k/E·capacity_factor))`` a group of
g tokens; a copy whose position among its expert's copies in the group
(token-major, then k) reaches C is dropped, as in the reference.  The
expert products and the scatter form's buffers carry the JAX package's
``constrain`` sharding hints (``distributed.sharding``), no-ops outside
a mesh and on plain tensors.  Plain functions on tensors, as in
``nn/layers.py``.

**On a mesh** (a DTensor input, ``_moe_on_mesh``) each rank runs the
form on its own rows as plain tensors: the residual is gathered along
the sequence at the entry (``replicate_dim``) and the output handed back
on the input's placements at the exit (``placed_like``), as ``ffn`` does.
Routing, buffer positions, the one-hot dispatch and the scatter are
data-dependent ops that DTensor lacks rules for or plans as strided
shards; they are exact on local rows because a dispatch group never
leaves a batch row (an einsum group is ``g`` consecutive tokens with ``g``
dividing the sequence, a scatter group is one row) and the batch is split
over the data axes by whole rows.  The expert stacks keep the JAX
package's placements: each rank gathers them over 'data' (FSDP) and keeps
its own slice of the hidden width ``f`` over 'model', so no rank computes
another's share of an expert product; the products' partial sums are
added over 'model' where the reference's ``constrain`` hint replicates
them, and the dispatch's grad is added there in the backward.  The
auxiliary loss is a product of two means over *all* tokens: each mean is
summed over the data ranks before the product (``_Ranks.row_mean``).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import constrain, placed_like, replicate_dim
from repro_torch.nn.layers import _dense_init, ffn, init_ffn
from repro_torch.nn.quant import EXPERT_SLAB


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    ffn_kind: str = "swiglu"
    capacity_factor: float = 1.25
    shared_expert: bool = False
    impl: str = "einsum"             # einsum | scatter | ragged
    group_size: int = 256            # tokens per dispatch group (einsum)


def capacity(spec: MoESpec, group_tokens: int) -> int:
    return max(spec.top_k, int(math.ceil(
        group_tokens * spec.top_k / spec.n_experts * spec.capacity_factor)))


def init_moe(generator: torch.Generator, spec: MoESpec, dtype=torch.float32,
             device=None) -> dict:
    """Random expert stacks ``[E, d, f]`` / ``[E, f, d]`` drawn EXPERT_SLAB
    experts at a time (the f32 draw of a whole full-width stack, llama4's
    128 x 5120 x 8192, would be 21.5 GB); the router ``[d, E]`` in f32."""
    e, d, f = spec.n_experts, spec.d_model, spec.d_ff

    def stack(shape, scale):
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(0, e, EXPERT_SLAB):
            n = min(EXPERT_SLAB, e - i)
            w = torch.randn((n,) + shape[1:], generator=generator,
                            dtype=torch.float32, device=device)
            out[i:i + n] = w.mul_(scale)
        return out

    p = {
        "router": _dense_init(generator, (d, e), torch.float32, device),
        "w_up": stack((e, d, f), 1.0 / math.sqrt(d)),
        "w_down": stack((e, f, d), 1.0 / math.sqrt(f)),
    }
    if spec.ffn_kind in ("swiglu", "geglu"):
        p["w_gate"] = stack((e, d, f), 1.0 / math.sqrt(d))
    if spec.shared_expert:
        p["shared"] = init_ffn(generator, d, f, kind=spec.ffn_kind, dtype=dtype,
                               device=device)
    return p


@dataclasses.dataclass(frozen=True)
class _Ranks:
    """Where a rank's local MoE run sits on its mesh: per mesh dim, whether
    it splits the batch rows (``rows``) and whether it splits the experts'
    hidden width (``tp``); ``tokens`` is the whole batch's token count."""

    mesh: object
    rows: tuple
    tp: tuple
    tokens: int

    def _placed(self, tp_placement):
        return [tp_placement if t else Shard(0) if r else Replicate()
                for r, t in zip(self.rows, self.tp)]

    def local(self, w, f_dim=None):
        """Weight ``w`` on this rank: whole, but for its hidden dim
        ``f_dim`` split over the tp dims; its grad is summed over the row
        dims (each rank's rows add their share)."""
        keep = [Shard(f_dim) if t and f_dim is not None else Replicate() for t in self.tp]
        grad = [k if k.is_shard() else Partial() if r else Replicate()
                for k, r in zip(keep, self.rows)]
        return w.redistribute(self.mesh, keep).to_local(grad_placements=grad)

    def row_mean(self, t):
        """The mean over every rank's rows of ``t`` [rows, ...] (this
        rank's): local sums over the whole batch's count, summed over the
        row dims -> a replicated DTensor."""
        part = [Partial() if r else Replicate() for r in self.rows]
        return DTensor.from_local(t.sum(0) / self.tokens, self.mesh, part).redistribute(
            self.mesh, [Replicate()] * self.mesh.ndim)

    def enter(self, t):
        """The expert products' input: itself, its grad (this tp rank's
        share) summed over the tp dims."""
        if not any(self.tp):
            return t
        return DTensor.from_local(t, self.mesh, self._placed(Replicate())).to_local(
            grad_placements=self._placed(Partial()))

    def exit(self, t):
        """The expert products' output, this tp rank's partial sums added
        over the tp dims."""
        if not any(self.tp):
            return t
        return DTensor.from_local(t, self.mesh, self._placed(Partial())).redistribute(
            self.mesh, self._placed(Replicate())).to_local()


def _route(params, x2d, spec: MoESpec, on: _Ranks = None):
    """-> (gates [T, k] f32, idx [T, k], aux loss).  The router may come
    back from ``dequantize_tree`` in the model's dtype: the logits are an
    f32 product all the same, as the JAX package's promotion makes them.
    ``on``: the rows are this rank's; the aux loss's means span every
    rank's rows."""
    logits = x2d.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, spec.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch-style)
    picked = F.one_hot(idx, spec.n_experts).float().sum(1)
    if on is None:
        me, ce = probs.mean(0), picked.mean(0)
    else:
        me, ce = on.row_mean(probs), on.row_mean(picked)
    return gates, idx, spec.n_experts * torch.sum(me * ce)


def buffer_positions(idx: torch.Tensor, n_experts: int, cap: int):
    """idx ``[G, n, k]`` -> (pos, keep), each ``[G, n, k]``: each routed
    copy's position among its group's copies routed to the same expert,
    counted token-major then over k, and whether it lies inside the
    ``cap`` slots.  (The JAX package counts in f32 in ``moe_einsum`` and in
    int32 in ``moe_scatter``: the same integers.)"""
    g, n, k = idx.shape
    flat = idx.reshape(g, n * k)
    onehot = F.one_hot(flat, n_experts)
    pos = (onehot.cumsum(1) - 1).gather(-1, flat[..., None])[..., 0]
    pos = pos.reshape(g, n, k)
    return pos, pos < cap


def _expert_ffn_grouped(p, xe, kind, on: _Ranks = None):
    """xe: [G, E, C, d] -> [G, E, C, d].  The group dim G aligns with the
    batch sharding and the hidden dim f with tensor parallelism (the
    ``constrain`` hints, no-ops outside a mesh and on a rank's local
    tensors, where ``on`` adds the partial sums over 'model')."""
    if on is not None:
        xe = on.enter(xe)
    xe = constrain(xe, ("batch", None, None, None))
    up = constrain(torch.einsum("gecd,edf->gecf", xe, p["w_up"]),
                   ("batch", None, None, "tp"))
    if kind in ("swiglu", "geglu"):
        gate = constrain(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]),
                         ("batch", None, None, "tp"))
        act = (F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")) * up
    else:
        act = F.gelu(up, approximate="tanh")
    out = constrain(torch.einsum("gecf,efd->gecd", act, p["w_down"]),
                    ("batch", None, None, None))
    return out if on is None else on.exit(out)


def _with_shared(params, y, x, spec: MoESpec):
    if spec.shared_expert:
        y = y + ffn(params["shared"], x, kind=spec.ffn_kind)
    return y


def moe_scatter(params: dict, x: torch.Tensor, spec: MoESpec, on: _Ranks = None):
    """x: [B, S, d] -> ([B, S, d], aux).  One group a batch row."""
    b, s, d = x.shape
    k, e = spec.top_k, spec.n_experts
    cap = capacity(spec, s)
    gates, idx, aux = _route(params, x.reshape(b * s, d), spec, on)
    pos, keep = buffer_positions(idx.reshape(b, s, k), e, cap)
    idx_r, pos_c = idx.reshape(b, s * k), torch.where(keep, pos, cap).reshape(b, s * k)
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s * k)
    xr = constrain(x[:, :, None].expand(b, s, k, d).reshape(b, s * k, d),
                   ("batch", None, None))
    xe = torch.zeros((b, e, cap + 1, d), dtype=x.dtype, device=x.device)
    xe.index_put_((rows, idx_r, pos_c), xr, accumulate=True)
    xe = constrain(xe, ("batch", None, None, None))
    ye = _expert_ffn_grouped(params, xe[:, :, :cap], spec.ffn_kind, on)
    ye = constrain(F.pad(ye, (0, 0, 0, 1)),           # the dropped bucket reads 0
                   ("batch", None, None, None))
    yr = constrain(ye[rows, idx_r, pos_c], ("batch", None, None))
    g = (gates.reshape(b, s * k) * keep.reshape(b, s * k)).to(yr.dtype)
    y = (yr * g[..., None]).reshape(b, s, k, d).sum(2)
    return _with_shared(params, y, x, spec).to(x.dtype), aux


def moe_einsum(params: dict, x: torch.Tensor, spec: MoESpec, on: _Ranks = None):
    """One-hot dispatch over token groups: ``disp`` and ``comb`` [G, g, E, C]
    in x's dtype (the gates cast to it before the sum over k)."""
    b, s, d = x.shape
    k, e = spec.top_k, spec.n_experts
    g = min(spec.group_size, s)
    while s % g:
        g //= 2
    g = max(g, 1)
    ng = (b * s) // g
    cap = capacity(spec, g)
    gates, idx, aux = _route(params, x.reshape(-1, d), spec, on)
    idx_r = idx.reshape(ng, g, k)
    pos, keep = buffer_positions(idx_r, e, cap)
    disp = (F.one_hot(idx_r, e)[..., None] * F.one_hot(torch.where(keep, pos, 0), cap)
            [..., None, :] * keep[..., None, None]).to(x.dtype)   # [G, g, k, E, C]
    comb = (disp * gates.reshape(ng, g, k)[..., None, None].to(x.dtype)).sum(2)
    disp = disp.sum(2)
    xe = torch.einsum("gsec,gsd->gecd", disp, x.reshape(ng, g, d))
    ye = _expert_ffn_grouped(params, xe, spec.ffn_kind, on)
    y = torch.einsum("gsec,gecd->gsd", comb, ye).reshape(b, s, d)
    return _with_shared(params, y, x, spec).to(x.dtype), aux


def moe_ragged(params: dict, x: torch.Tensor, spec: MoESpec, on: _Ranks = None):
    """Dropless: the routed copies sorted by expert, one product per
    expert over its rows (the reference's ``lax.ragged_dot``), the mixture
    summed in f32 with ``index_add_``.  One host read of the group sizes."""
    b, s, d = x.shape
    t = b * s
    x2 = x.reshape(t, d)
    gates, idx, aux = _route(params, x2, spec, on)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok = torch.arange(t, device=x.device).repeat_interleave(spec.top_k)[order]
    xg = x2[tok] if on is None else on.enter(x2[tok])
    sizes = torch.bincount(flat_e, minlength=spec.n_experts).tolist()
    yg = torch.empty_like(xg)
    start = 0
    for ex, n in enumerate(sizes):
        if n:
            rows = xg[start:start + n]
            up = rows @ params["w_up"][ex]
            if spec.ffn_kind == "swiglu":
                act = F.silu(rows @ params["w_gate"][ex]) * up
            elif spec.ffn_kind == "geglu":
                act = F.gelu(rows @ params["w_gate"][ex], approximate="tanh") * up
            else:
                act = F.gelu(up, approximate="tanh")
            yg[start:start + n] = act @ params["w_down"][ex]
        start += n
    if on is not None:
        yg = on.exit(yg)
    y = torch.zeros((t, d), dtype=torch.float32, device=x.device).index_add_(
        0, tok, yg.float() * gates.reshape(-1)[order][:, None])
    return _with_shared(params, y.reshape(b, s, d).to(x.dtype), x, spec), aux


def moe(params: dict, x: torch.Tensor, spec: MoESpec):
    form = {"ragged": moe_ragged, "scatter": moe_scatter}.get(spec.impl, moe_einsum)
    if isinstance(x, DTensor):
        return _moe_on_mesh(form, params, x, spec)
    return form(params, x, spec)


def _moe_on_mesh(form, params: dict, x: DTensor, spec: MoESpec):
    """``form`` on each rank's own rows of a (sequence-sharded) DTensor
    ``x`` [B, S, d], with the expert stacks' hidden width ``f`` split over
    the mesh dims that split it in ``w_up`` (module note) -> (y on ``x``'s
    placements, the aux loss as a replicated DTensor).  The shared expert
    runs as a dense FFN on ``x``."""
    x_in, x = x, replicate_dim(x, 1)          # rows over the data axes, or whole
    mesh = x.device_mesh
    on = _Ranks(mesh, tuple(p.is_shard(0) for p in x.placements),
                tuple(p.is_shard(2) for p in params["w_up"].placements),
                x.shape[0] * x.shape[1])
    local = {"router": on.local(params["router"]),
             "w_up": on.local(params["w_up"], 2), "w_down": on.local(params["w_down"], 1)}
    if "w_gate" in params:
        local["w_gate"] = on.local(params["w_gate"], 2)
    y, aux = form(local, x.to_local(), dataclasses.replace(spec, shared_expert=False), on)
    y = DTensor.from_local(y, mesh, x.placements, shape=x.shape, stride=x.stride())
    return _with_shared(params, placed_like(y, x_in), x_in, spec), aux
