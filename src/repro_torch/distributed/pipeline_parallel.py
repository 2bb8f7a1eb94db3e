"""Pipeline parallelism with rate-aware stage balance — the paper's
continuous-flow constraint driving a multi-rank schedule; the port's copy
of the JAX package's ``distributed/pipeline_parallel.py``.

Stages are assigned by ``core.stage_partition`` (min-bottleneck DP =
BestRate for stages).  Execution is the circular pipeline: one rank a
stage along a mesh's 'stage' axis, microbatches streamed around the ring
with ``torch.distributed.batch_isend_irecv`` (the JAX package's
``ppermute`` inside a ``shard_map``), or through host buffers where the
group's backend cannot send the tensors' memory (``shift_route``).  With
M microbatches and S stages, utilization is M/(M+S-1) — the
pipeline-level twin of the paper's j/h >= r utilization bound.  The same
schedule and ``microbatch_utilization`` bound drive the wall-clock
executor for staged CNNs in
``distributed.device_pipeline``, whose stages are heterogeneous subgraphs
placed per device rather than a homogeneous block stack over a mesh axis.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.stage_partition import StagePlan, partition_blocks
from repro_torch.tree import leaves, unflatten


def microbatch_utilization(n_micro: int, n_stages: int) -> float:
    """GPipe bubble math: busy fraction of each stage."""
    return n_micro / (n_micro + n_stages - 1)


def _stage_slice(leaf, stage: int):
    """This stage's ``[layers_per_stage, ...]`` of a ``[S, ...]`` leaf: a
    tensor every rank holds whole, or a DTensor sharded over the stage
    axis on dim 0."""
    if isinstance(leaf, DTensor):
        return leaf.to_local()[0]
    return leaf[stage]


def shift_route(backend: str, device: torch.device) -> str:
    """How the ring shift moves a tick's activations on ``device`` over a
    group of ``backend``: ``"p2p"`` sends and receives the tensors
    themselves (NCCL takes device pointers, gloo host ones); ``"host"``
    stages CUDA tensors through host buffers for gloo, whose send / recv
    fail on a device pointer though its collectives take CUDA tensors
    (through host copies of their own).  NCCL takes one rank a card, so
    ranks that share a card run gloo and take this route."""
    return "host" if backend == "gloo" and device.type == "cuda" else "p2p"


def _p2p_shift(y: torch.Tensor, recv: torch.Tensor, nxt: int, prv: int, group) -> None:
    """Send ``y`` to rank ``nxt`` and receive ``recv`` from rank ``prv``."""
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, y, nxt, group),
                                       dist.P2POp(dist.irecv, recv, prv, group)]):
        req.wait()


def _ring_shift(y: torch.Tensor, nxt: int, prv: int, group, route: str,
                host: dict) -> torch.Tensor:
    """One tick's shift around the ring: ``y`` goes to rank ``nxt``; what
    rank ``prv`` sent comes back, on ``y``'s device.  The ``"host"`` route
    copies ``y`` into a host buffer (the copy waits for ``y``), shifts the
    host buffers, and copies the received one back in one asynchronous
    copy (pinned memory; the next tick's copy out waits for it on the same
    stream before the buffer is received into again)."""
    y = y.contiguous()
    if route == "p2p":
        recv = torch.empty_like(y)
        _p2p_shift(y, recv, nxt, prv, group)
        return recv
    if not host:
        pin = y.is_cuda
        host["send"] = torch.empty(y.shape, dtype=y.dtype, pin_memory=pin)
        host["recv"] = torch.empty(y.shape, dtype=y.dtype, pin_memory=pin)
    host["send"].copy_(y)
    _p2p_shift(host["send"], host["recv"], nxt, prv, group)
    return host["recv"].to(y.device, non_blocking=True)


def pipeline_forward(
    block_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,           # leaves [S, layers_per_stage, ...]
    x_micro: torch.Tensor,       # [M, mb, ...] microbatched input
    mesh,
    *,
    stage_axis: str = "stage",
) -> torch.Tensor:
    """Run M microbatches through S pipeline stages on ``mesh``: this rank
    is the stage of its coordinate on ``stage_axis``.

    ``block_fn(params_slice, x)`` applies one stage's layers.  Every rank
    passes the same ``x_micro``; returns the final-stage outputs as [M,
    mb, ...] on every rank of the stage axis.

    Circular pipeline over T = M + S - 1 ticks.  Each stage holds a
    buffer; every tick it (a) ingests (stage 0 takes the next microbatch;
    the others hold what they received), (b) runs its block, (c) forwards
    its output to the next stage around the ring.  The last stage banks
    its outputs; a final all-reduce over the stage axis hands them to
    every rank.

    The shift's route follows the group's backend and the tensors' device
    (``shift_route``): on the card, ranks that share it run gloo and stage
    each tick's activations through host buffers.  DTensor's collectives
    crash a gloo rank on CUDA tensors, so on the card every rank holds the
    stacked ``[S, L/S, ...]`` leaves whole, as plain tensors; a DTensor
    leaf sharded over the stage axis is for NCCL ranks, a card each."""
    n_stages = mesh.shape[list(mesh.mesh_dim_names).index(stage_axis)]
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    m = x_micro.shape[0]
    params_s = unflatten(stage_params, [_stage_slice(p, stage) for p in leaves(stage_params)])
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    route, host = shift_route(dist.get_backend(group), x_micro.device), {}

    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(m + n_stages - 1):
        if stage == 0 and t < m:
            buf = x_micro[t]
        y = block_fn(params_s, buf)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        if n_stages == 1:
            buf = y
            continue
        buf = _ring_shift(y, nxt, prv, group, route, host)
    # only the last stage's banked outputs are real; sum-select them
    if stage != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs


def plan_stages_for_layers(costs: Sequence[float], n_stages: int,
                           scan_block: int = 1) -> StagePlan:
    """Rate-aware stage boundaries (divisibility-constrained DP)."""
    return partition_blocks(list(costs), n_stages, scan_block)


def stack_stage_params(params_layers: Any, plan: StagePlan) -> Any:
    """Reshape [L, ...] stacked layer params into [S, L/S, ...] when the
    plan is uniform; uneven plans pad to the bottleneck stage size (the
    padding layers are identity — weights zeroed)."""
    bounds = plan.boundaries
    sizes = [bounds[i + 1] - bounds[i] for i in range(len(bounds) - 1)]
    s_max = max(sizes)

    def per_leaf(leaf):
        pieces = []
        for i, size in enumerate(sizes):
            sl = leaf[bounds[i]:bounds[i + 1]]
            if size < s_max:
                pad = leaf.new_zeros((s_max - size,) + tuple(leaf.shape[1:]))
                sl = torch.cat([sl, pad], 0)
            pieces.append(sl)
        return torch.stack(pieces)  # [S, s_max, ...]

    return unflatten(params_layers, [per_leaf(x) for x in leaves(params_layers)])
