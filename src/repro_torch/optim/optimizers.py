"""Optimizers; the port's copy of the JAX package's ``optim/optimizers.py``.

AdamW with:
  * configurable moment dtypes (``bfloat16`` moments halve optimizer
    memory);
  * optional factored second moment (Adafactor-style row/col statistics)
    for a further ~d_model x reduction on matrix parameters;
  * global-norm clipping;
  * decoupled weight decay on leaves of rank >= 2 only.

Params, grads and the moments are the port's trees: dicts and lists of
tensors (``models/lm.py``).  ``apply_updates`` writes the new params and
moments into the given tensors in place under ``torch.no_grad()`` — the
counterpart of the JAX package's donated buffers — and returns them.  The
learning rate and the bias corrections are f32 tensors, as in the JAX
package, and every update is computed in f32 and cast back to the leaf's
dtype.

**Stacked leaves.**  The JAX package stacks a model's layers ``[L, ...]``
(``blocks_dense``, ``blocks_moe``, ``enc``, ``dec``), where the port keeps
a list of per-layer dicts.  Its rank rules (decay and factoring on rank
>= 2) judge the stacked leaf, so a per-layer norm scale or bias ``[d]``
is a rank-2 ``[L, d]`` leaf there: decayed, and factored with row
statistics per layer and column statistics over the layers.  The port
judges a leaf inside a list by that stacked rank, and factors a stack of
per-layer vectors over the layers of one structure (a list's dense and
MoE layers are two stacks, as ``blocks_dense`` and ``blocks_moe`` are),
so that a train step gives the JAX package's numbers.  Outside a list a
leaf's rank is its own.

``accumulate_grads`` runs ``loss_fn`` once per microbatch under autograd
(``torch.autograd.grad`` over the tree's leaves, which must require
grad) and sums the grads divided by the count in an ``acc_dtype``
accumulator, as the JAX package's ``lax.scan`` does.

**On a mesh** the leaves are DTensors (``distributed.sharding``), and
every op here runs on them as it is.  ``accumulate_grads``'
``grad_shardings`` redistributes each grad (and accumulator) to its
sharding, the counterpart of the JAX package's
``with_sharding_constraint``: the partial sums autograd leaves over the
data axes are reduce-scattered onto the FSDP shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import DTYPES, leaves, unflatten

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    mu_dtype: str = "float32"
    nu_dtype: str = "float32"
    factored: bool = False          # factored 2nd moment for rank >= 2 leaves
    momentum: bool = True           # False = Adafactor-style (no mu state)
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the host
    mu: Any
    nu: Any              # per-leaf: full tensor, or (row, col) tuple if factored


def _stack_keys(tree, key=None) -> list:
    """Per leaf, in ``tree.leaves`` order: None for a leaf outside a list,
    else the key of the stacked leaf it is one layer of (the list, the
    layer's top-level keys, the path inside the layer)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _stack_keys(tree[k], None if key is None else key + (k,))]
    if isinstance(tree, (list, tuple)):
        if key is not None:
            return [x for i, v in enumerate(tree) for x in _stack_keys(v, key + (i,))]
        return [x for v in tree for x in _stack_keys(
            v, (id(tree), tuple(sorted(v)) if isinstance(v, dict) else ()))]
    return [key]


def _map_ranked(fn: Callable, tree, stacked: bool = False):
    """``fn(leaf, rank)`` over a tree of dicts and lists, same structure; a
    leaf inside a list has its stacked rank."""
    if isinstance(tree, dict):
        return {k: _map_ranked(fn, v, stacked) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_ranked(fn, v, True) for v in tree)
    return fn(tree, tree.dim() + stacked)


def _lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in f32."""
    return warmup_cosine(step, lr=cfg.lr, warmup_steps=cfg.warmup_steps,
                         total_steps=cfg.total_steps, min_ratio=cfg.min_lr_ratio)


def _use_factored(cfg: AdamWConfig, rank: int) -> bool:
    return cfg.factored and rank >= 2


def init(cfg: AdamWConfig, params) -> AdamWState:
    """Zero moments beside each leaf, on its device.  A factored leaf gets
    row statistics ``p.shape[:-1]`` and column statistics
    ``p.shape[:-2] + p.shape[-1:]`` (a layer of a stacked vector: a scalar
    and its copy of the stack's ``[d]`` columns)."""
    mu_dt, nu_dt = DTYPES[cfg.mu_dtype], DTYPES[cfg.nu_dtype]

    def nu_init(p, rank):
        if _use_factored(cfg, rank):
            return (torch.zeros(p.shape[:-1], dtype=nu_dt, device=p.device),   # rows
                    torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=nu_dt,
                                device=p.device))                             # cols
        return torch.zeros(p.shape, dtype=nu_dt, device=p.device)

    def mu_init(p, rank):
        if not cfg.momentum:
            return torch.zeros((1,), dtype=mu_dt, device=p.device)  # no first moment
        return torch.zeros(p.shape, dtype=mu_dt, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32),
                      mu=_map_ranked(mu_init, params), nu=_map_ranked(nu_init, params))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves(grads)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState
                  ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Params and moments are written in place and
    returned with the new state and ``{"grad_norm", "lr"}``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    stepf = step.float()
    lr = _lr(cfg, step)
    dev = gnorm.device
    lr_d = lr.to(dev)
    b1c = (1 - cfg.b1 ** stepf).to(dev)
    b2c = (1 - cfg.b2 ** stepf).to(dev)

    nus = leaves(state.nu, is_leaf=lambda t: isinstance(t, tuple))
    stacks: Dict[Any, list] = {}
    for p, g, mu, nu, key in zip(leaves(params), leaves(grads),
                                 leaves(state.mu), nus, _stack_keys(params)):
        rank = p.dim() + (key is not None)
        if _use_factored(cfg, rank) and p.dim() < 2:
            stacks.setdefault(key, []).append((p, g, mu, nu))   # a layer of a stacked vector
        elif _use_factored(cfg, rank):
            _factored(cfg, [(p, g, mu, nu)], scale, lr_d, b1c, b2c)
        else:
            _dense(cfg, p, g, mu, nu, rank >= 2, scale, lr_d, b1c, b2c)
    for layers in stacks.values():
        _factored(cfg, layers, scale, lr_d, b1c, b2c)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), \
        {"grad_norm": gnorm, "lr": lr}


def _dense(cfg, p, g, mu, nu, decay: bool, scale, lr, b1c, b2c) -> None:
    g32 = g.float() * scale
    if cfg.momentum:
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
    else:
        mu32 = g32
    nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(g32)
    nu.copy_(nu32)
    upd = (mu32 / (b1c if cfg.momentum else 1.0)) / (torch.sqrt(nu32 / b2c) + cfg.eps)
    if decay:                                # decoupled decay on rank >= 2
        upd = upd + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * upd)
    if cfg.momentum:
        mu.copy_(mu32)


def _factored(cfg, layers, scale, lr, b1c, b2c) -> None:
    """The memory-lean factored path over one leaf of rank >= 2: the one
    ``(p, g, mu, (r, c))`` of a matrix (or a stack of them), or every
    layer's of a stacked vector, stacked here ``[L, d]``, their column
    statistics (a copy in each layer) shared.  The rank-1 second moment
    ``r (x) c / mean(r)`` is never formed; its rsqrt factors are small f32
    vectors broadcast into a multiply in the param's width (f32, or bf16
    for any narrower param), as in the JAX package."""
    one = layers[0][0].dim() >= 2           # a matrix; else layers of a vector, one or more

    def joined(ts):
        return ts[0] if one else torch.stack(ts)

    p = joined([x[0] for x in layers])
    g = joined([x[1] for x in layers])
    r = joined([x[3][0] for x in layers])
    c = layers[0][3][1]
    wide = p.dtype if p.dtype == torch.float32 else torch.bfloat16
    g16 = (g.float() * scale).to(wide)     # an f32 product, as the JAX promotion gives
    if cfg.momentum:
        mu = joined([x[2] for x in layers])
        mu16 = (cfg.b1 * mu.float() + (1 - cfg.b1) * g16.float()).to(wide)
    else:
        mu16 = g16                  # Adafactor: update from the raw grad
    g2 = torch.square(g16.float()) + 1e-30
    r32 = cfg.b2 * r.float() + (1 - cfg.b2) * g2.mean(-1)
    c32 = cfg.b2 * c.float() + (1 - cfg.b2) * g2.mean(-2)
    mean_r = torch.clamp(r32.mean(-1, keepdim=True), min=1e-30)
    row_f = torch.rsqrt(torch.clamp(r32 / b2c, min=1e-30) / mean_r)
    col_f = torch.rsqrt(torch.clamp(c32 / b2c, min=1e-30))
    corr = b1c if cfg.momentum else 1.0
    upd = (mu16.float() / corr * row_f[..., :, None] * col_f[..., None, :]).to(wide)
    decay = (cfg.weight_decay * p.float()).to(wide)
    new_p = p.float() - lr * (upd + decay).float()
    for i, (pi, _, mui, (ri, ci)) in enumerate(layers):
        pi.copy_(new_p if one else new_p[i])
        ri.copy_(r32 if one else r32[i])
        ci.copy_(c32)
        if cfg.momentum:
            mui.copy_(mu16 if one else mu16[i])


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------

def _rows_split(v: DTensor, rows: int) -> list:
    """``v``'s placements for a slice of ``rows`` of its rows: dim 0 stays
    split over the mesh dims that split it, innermost first, as far as
    their sizes' product divides ``rows``; the others hold the slice
    whole (grok-1's microbatches of 16 rows on the 32 data ranks of a
    2 x 16 x 16 mesh: split over 'data', whole on each 'pod', where the
    JAX package pads half the ranks' rows).  Even rows keep the whole
    batch's placements."""
    pl, n = list(v.placements), 1
    for i in reversed(range(len(pl))):
        if pl[i].is_shard(0):
            if rows % (n * v.device_mesh.shape[i]):
                pl[i] = Replicate()
            else:
                n *= v.device_mesh.shape[i]
    return pl


def accumulate_grads(loss_fn: Callable, params, batch, n_micro: int,
                     grad_shardings=None, acc_dtype=torch.float32):
    """Loop over microbatches; returns (mean_loss, metrics, grads).

    ``loss_fn(params, batch) -> (loss, metrics)``; the leaves of ``params``
    require grad.  Batch leaves (tensors or numpy arrays) must have a
    leading dim divisible by ``n_micro``.  ``n_micro <= 1`` takes a single
    grad call, whose grads keep the params' dtypes; otherwise the grads
    accumulate ``g / n_micro`` in f32 into ``acc_dtype`` tensors, as the
    JAX package's scan does, and the loss in an f32 scalar.  A leaf the
    loss does not reach gets a zero grad, as ``jax.grad`` gives it.

    ``grad_shardings`` (a tree of ``NamedSharding`` matching params, for
    DTensor params) pins the grads and the accumulator to those
    placements."""
    ps = leaves(params)
    pins = [s.placements for s in leaves(grad_shardings)] if grad_shardings else None

    def pin(ts):
        if pins is None:
            return list(ts)
        return [t.redistribute(t.device_mesh, pl) for t, pl in zip(ts, pins)]

    if n_micro <= 1:
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps, materialize_grads=True)
        return loss.detach(), _detach(metrics), unflatten(params, pin(grads))

    def micro(i):
        # a DTensor batch's slice comes back replicated whole on every rank
        # (DTensor slices a sharded dim that way): it is put back on the
        # batch's sharding, so each rank computes on its rows alone
        out = {}
        for k, v in batch.items():
            part = v[i * (v.shape[0] // n_micro):(i + 1) * (v.shape[0] // n_micro)]
            out[k] = (part.redistribute(v.device_mesh, _rows_split(v, part.shape[0]))
                      if isinstance(v, DTensor) else part)
        return out

    acc = pin(torch.zeros_like(p, dtype=acc_dtype) for p in ps)
    loss_acc = torch.zeros((), dtype=torch.float32, device=ps[0].device)
    for i in range(n_micro):
        loss, _ = loss_fn(params, micro(i))
        grads = pin(torch.autograd.grad(loss, ps, materialize_grads=True))
        with torch.no_grad():
            for a, g in zip(acc, grads):
                a.copy_(a.float() + g.float() / n_micro)
            loss_acc = loss_acc + loss.detach() / n_micro
    return loss_acc, {"ce": loss_acc}, unflatten(params, acc)


def _detach(metrics: dict) -> dict:
    return {k: v.detach() if torch.is_tensor(v) else v for k, v in metrics.items()}
