"""Sharding rules: name/shape-based partition specs for every tree; the
port's copy of the JAX package's ``distributed/sharding.py``.

Strategy: TP over 'model' for heads / d_ff / vocab, FSDP over 'data'
(+'pod') on the d_model axis of matrices, batch over ('pod','data'),
KV-cache sequence over 'model' (flash-decoding-style split-K).  Rules are
*divisibility-guarded*: a dimension is only sharded by axes whose size
divides it — the paper's Eq. (7)/(8) constraint applied to mesh
partitioning; otherwise the rule degrades to the next candidate and
ultimately replication.

A spec is the port's ``PartitionSpec``: per tensor dim ``None``, an axis
name, or a tuple of names (major to minor), which compares equal to
``tuple(jax.sharding.PartitionSpec(...))``.  ``NamedSharding(mesh,
spec).placements`` gives the DTensor placements of a
``DeviceMesh``: ``Shard(i)`` on every mesh dim whose name appears in
entry ``i``, ``Replicate()`` on the others.  The rules read only a mesh's
axis names and sizes (``mesh_sizes``), so they also run on a stand-in of
a production mesh with no devices behind it.

**Stacked leaves.**  The JAX package stacks a model's layers ``[L, ...]``
and gives every stacked leaf ``len(shape) - 2`` leading replicated dims;
the port keeps a list of per-layer dicts.  ``params_shardings`` and
``opt_state_shardings`` judge a leaf inside a list by its stacked shape
``(L,) + shape`` and drop the stack's (replicated) entry, so that a
per-layer leaf gets the reference's spec of the stacked leaf without its
leading entry.  Batches and serve states have the same structure in both
packages and are judged as they are.

``shard_tree`` places a tree on its shardings as DTensors;
``abstract_with_shardings`` does so for an abstract tree (meta or fake
tensors, the dry run's inputs) without allocating.  ``constrain`` is a
no-op outside a mesh (no ``with mesh:`` block) and on a plain tensor;
inside one it redistributes a DTensor to the logical axes' placements.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch.launch.mesh import ambient_mesh
from repro_torch.tree import leaves, unflatten


class PartitionSpec(tuple):
    """Per tensor dim: None, an axis name, or a tuple of names; a
    one-name tuple is kept as the name, as the JAX package's spec
    canonicalizes it."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1 else f"({self[0]!r})")


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any object with
    ``axis_names`` and ``devices.shape`` (a stand-in mesh)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    s = 1
    for a in axes:
        s *= sizes[a]
    return s


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh_sizes(mesh))


def _fits(dim: int, mesh, axes) -> bool:
    return axes is None or (dim % _axsize(mesh, axes) == 0)


def _guard(shape, mesh, spec_axes) -> P:
    """Zero out sharding on dims the mesh doesn't divide."""
    return P(*(axes if _fits(dim, mesh, axes) else None
               for dim, axes in zip(shape, spec_axes)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements`` are its DTensor placements."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        names = list(mesh_sizes(self.mesh))
        out = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = (entry,) if isinstance(entry, str) else (entry or ())
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"{self.spec}: axes {axes} of dim {dim} are not in "
                                 f"the mesh's major-to-minor order {names}")
            for i in order:
                out[i] = Shard(dim)
        return tuple(out)


# ---------------------------------------------------------------------------
# parameter rules (match on path suffix)
# ---------------------------------------------------------------------------


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> P:
    # int8-serving trees wrap leaves as parent/{__q__,__s__}: __q__ shards
    # like the parent; __s__ (per-output-channel scales, row dim == 1)
    # gets the parent spec with the row axis dropped.
    scale_leaf = path.endswith("__s__")
    path = path.replace("/__q__", "").replace("/__s__", "")
    if scale_leaf and len(shape) >= 2:
        spec = param_spec(path, shape[:-2] + (max(shape[-2], 2), shape[-1]), mesh)
        parts = list(spec) + [None] * (len(shape) - len(spec))
        if len(parts) >= 2:
            parts[-2] = None
        return P(*parts[: len(shape)])
    if len(shape) < 2:
        return P()  # vectors/scalars (incl. optimizer sentinels)
    da = data_axes(mesh)
    lead = (None,) * (len(shape) - 2)  # layer-stack dims

    def rule2(row_axes, col_axes):
        return _guard(shape, mesh, lead + (row_axes, col_axes))

    name = path.lower()
    if re.search(r"(embed|unembed)$", name):
        v, d = shape[-2], shape[-1]
        # vocab over 'model' (keeps the embedding gather and the logits
        # product shard-aligned); d_model deliberately unsharded.
        if _fits(v, mesh, "model"):
            return P("model", None)
        if _fits(d, mesh, "model"):
            return P(None, "model")
        return P()
    if re.search(r"router$", name):
        return rule2(da, None)
    # MoE expert stacks [.., E, d, f] / [.., E, f, d]
    if re.search(r"moe/(w_up|w_gate)$", name):
        return _guard(shape, mesh, (None,) * (len(shape) - 3) + (None, da, "model"))
    if re.search(r"moe/w_down$", name):
        return _guard(shape, mesh, (None,) * (len(shape) - 3) + (None, "model", da))
    if re.search(r"(wq|wk|wv|w_up|w_gate|in_proj)$", name):
        return rule2(da, "model")
    if re.search(r"(wo|w_down|out_proj)$", name):
        return rule2("model", da)
    if re.search(r"conv_w$", name):
        return _guard(shape, mesh, lead + (None, "model"))
    if re.search(r"(\bw\b|/w)$", name):
        return rule2(da, "model")
    return P()  # norms, biases, scalars: replicate


def _walk(tree, prefix: str = "", in_list: bool = False):
    """``(path, leaf, in_list)`` over dicts, lists and tuples in the
    port's walk order (``tree.leaves_with_paths``); ``in_list`` marks a
    leaf inside a list (a layer of a stacked leaf).  A tuple (a
    ``NamedTuple`` state, a factored moment's (row, col) pair) stacks
    nothing."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}" if prefix else str(k), in_list)
    elif isinstance(tree, (list, tuple)):
        inner = in_list or isinstance(tree, list)
        keys = getattr(tree, "_fields", range(len(tree)))
        for k, v in zip(keys, tree):
            yield from _walk(v, f"{prefix}/{k}" if prefix else str(k), inner)
    else:
        yield prefix, tree, in_list


def tree_shardings(tree: Any, mesh, spec_fn, *, stacked: bool = False) -> Any:
    """Map (path, leaf) -> NamedSharding over a tree; ``spec_fn(path,
    shape)``.  With ``stacked``, a leaf inside a list is judged at its
    stacked shape ``(1,) + shape`` and the stack's entry dropped."""
    out = []
    for path, leaf, in_list in _walk(tree):
        shape = tuple(leaf.shape)
        if stacked and in_list:
            spec = P(*spec_fn(path, (1,) + shape)[1:])
        else:
            spec = spec_fn(path, shape)
        out.append(NamedSharding(mesh, spec))
    return unflatten(tree, out)


def params_shardings(params: Any, mesh) -> Any:
    return tree_shardings(params, mesh, lambda p, s: param_spec(p, s, mesh), stacked=True)


def opt_state_shardings(opt_state: Any, params_like: Any, mesh) -> Any:
    """Adam moments follow their parameter's spec; scalars replicate.  A
    moment that is not its parameter's shape (the ``(1,)`` stand-in of a
    state without momentum, a factored moment's row or column
    statistics) is judged by its own path and shape."""

    def spec_fn(path, shape):
        # strip the leading 'mu/' or 'nu/'
        cleaned = re.sub(r"^\.?(mu|nu)[/.]?", "", path)
        if not shape:
            return P()
        return param_spec(cleaned, shape, mesh)

    out = tree_shardings(opt_state, mesh, spec_fn, stacked=True)
    mu = [s if tuple(m.shape) == tuple(p.shape) else NamedSharding(mesh, P())
          for s, m, p in zip(leaves(out.mu), leaves(opt_state.mu), leaves(params_like))]
    return out._replace(mu=unflatten(out.mu, mu))


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` (a tensor or a host array, whole and the same
    on every rank) as a DTensor on its sharding's mesh and placements, in
    storage of its own (the JAX package's ``jax.device_put(tree,
    shardings)``).  A leaf that is already a DTensor is redistributed."""
    out = []
    for x, s in zip(leaves(tree), leaves(shardings)):
        if isinstance(x, DTensor):
            out.append(x.redistribute(s.mesh, s.placements))
            continue
        x = torch.as_tensor(x).detach().to(s.mesh.device_type, copy=True)
        out.append(distribute_tensor(x, s.mesh, s.placements))
    return unflatten(tree, out)


def abstract_with_shardings(tree: Any, shardings: Any) -> Any:
    """Each leaf of an abstract ``tree`` (meta or fake tensors: shapes and
    dtypes) as a DTensor on its sharding's mesh and placements, over fake
    local shards on the mesh's device: the JAX package's
    ``ShapeDtypeStruct(..., sharding=s)``.  Runs under the caller's
    ``FakeTensorMode`` (the tensors are used there), or a new one;
    nothing is allocated."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    with detect_fake_mode() or FakeTensorMode():
        whole = [torch.empty(tuple(x.shape), dtype=x.dtype, device=s.mesh.device_type)
                 for x, s in zip(leaves(tree), leaves(shardings))]
        return shard_tree(unflatten(tree, whole), shardings)


# ---------------------------------------------------------------------------
# batch / serve-state rules
# ---------------------------------------------------------------------------


def batch_specs(batch: Any, mesh) -> Any:
    """Leading dim = global batch -> ('pod','data'); rest unsharded."""
    da = data_axes(mesh)

    def spec_fn(path, shape):
        if not shape:
            return P()
        if _fits(shape[0], mesh, da):
            return P(da)
        return P()

    return tree_shardings(batch, mesh, spec_fn)


def serve_state_specs(state: Any, mesh) -> Any:
    """KV caches [L, B, S, nkv, dh]: batch over data when divisible,
    sequence over 'model' (split-K decode).  Batch-1 long-context shards
    the sequence over (data, model) jointly.  SSM states [L, B, H, P, N]:
    batch over data, heads over model."""
    da = data_axes(mesh)

    def spec_fn(path, shape):
        if len(shape) == 5:
            b = shape[1]
            is_kv = shape[2] >= 256  # seq dim heuristic: caches are long
            if is_kv:
                if _fits(b, mesh, da) and b > 1:
                    return _guard(shape, mesh, (None, da, "model", None, None))
                return _guard(shape, mesh, (None, None, da + ("model",), None, None))
            # ssm state [L, B, H, P, N]
            if _fits(b, mesh, da) and b > 1:
                return _guard(shape, mesh, (None, da, "model", None, None))
            return _guard(shape, mesh, (None, None, "model", None, None))
        if len(shape) == 4:
            # hybrid/ssm conv cache [L, B, K-1, convdim]
            return _guard(shape, mesh, (None, da, None, "model"))
        if len(shape) == 3:
            # encoder memory [B, S, d]
            return _guard(shape, mesh, (da, None, "model"))
        if len(shape) >= 1:
            return _guard(shape, mesh, (da,) + (None,) * (len(shape) - 1))
        return P()

    return tree_shardings(state, mesh, spec_fn)


# ---------------------------------------------------------------------------
# in-model activation constraints (ambient-mesh aware)
# ---------------------------------------------------------------------------

_LOGICAL = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "tp": ("model",),  # tensor-parallel feature dims (d_ff, heads)
    None: None,
}


def logical_spec(shape, logical: Tuple[Optional[str], ...], mesh) -> P:
    """The spec of a logical-axis constraint on ``mesh``: each named dim
    over the mesh's axes of its logical name, where their size divides it
    and the dim is longer than 1."""
    names = mesh_sizes(mesh)
    spec = []
    for dim, log in zip(shape, logical):
        axes = _LOGICAL.get(log)
        axes = tuple(a for a in axes if a in names) if axes else ()
        if axes and dim % _axsize(mesh, axes) == 0 and dim > 1:
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return P(*spec)


def row_placements(mesh, rows: int) -> Tuple[list, int, int]:
    """DTensor placements that split dim 0 (``rows``, a batch) over the
    mesh's data axes where their product divides it and there is more
    than one row (``logical_spec``'s rule: DTensor refuses a view that
    merges a sharded dim of one), with ``Replicate()`` elsewhere; this
    rank's index among the row shards and their count (0 and 1 when the
    rows stay whole)."""
    names = list(mesh.mesh_dim_names)
    data = [i for i, n in enumerate(names) if n in ("pod", "data")]
    pl, index, count = [Replicate()] * len(names), 0, 1
    for i in data:
        count *= mesh.shape[i]
    if rows % count or rows == 1:
        return pl, 0, 1
    for i in data:
        pl[i] = Shard(0)
        index = index * mesh.shape[i] + mesh.get_local_rank(i)
    return pl, index, count


def local_range(x: DTensor, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's shard of DTensor ``x`` along ``dim``:
    the mesh dims that shard it split it in mesh order, each as
    ``torch.chunk`` does (the last chunks shorter, or empty)."""
    lo, size = 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            step = -(-size // x.device_mesh.shape[i])
            c = x.device_mesh.get_local_rank(i)
            lo, size = lo + c * step, max(0, min(step, size - c * step))
    return lo, size


def replicate_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` whole along ``dim`` on every rank: a DTensor sharded there is
    redistributed to replicate it (the mesh dims that shard another dim,
    or hold partial sums, keep their placements); a plain tensor is
    returned as it is.  The sites where DTensor lacks or breaks an op on a
    sharded dim call it on that operand."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    want = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def placed_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` on DTensor ``x``'s placements (``y`` of ``x``'s shape): a
    layer that gathered its sequence-sharded input (``replicate_dim``)
    hands its output back on the input's sharding, a reduce-scatter of its
    partial sums (Megatron-SP's exit).  Its backward gathers the grad
    whole along the sequence before the layer's products, whose backward
    flattens batch and sequence (a view DTensor refuses over a sharded
    sequence).  Plain tensors pass as they are."""
    if not isinstance(x, DTensor) or tuple(y.placements) == tuple(x.placements):
        return y
    return y.redistribute(x.device_mesh, x.placements)


def rows_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` where ``x`` may be a DTensor sharded over its leading
    (row) dims, a sequence-sharded residual among them: ``w`` is gathered
    whole (FSDP's all-gather) and each rank multiplies its own rows, the
    output on ``x``'s row sharding.  DTensor's own product flattens the
    rows first, a view it refuses over a sharded sequence (torch 2.11) or
    plans as strided shards.  ``w``'s grad is a partial sum over the mesh
    dims that split the rows.  Plain tensors: ``x @ w``."""
    if not isinstance(x, DTensor):
        return x @ w
    mesh = x.device_mesh
    last = x.dim() - 1
    px = [Replicate() if p.is_partial() or p.is_shard(last) else p for p in x.placements]
    xl = x.redistribute(mesh, px).to_local()
    wl = w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate() for p in px])
    return DTensor.from_local(xl @ wl, mesh, px)


def constrain(x: torch.Tensor, logical: Tuple[Optional[str], ...]) -> torch.Tensor:
    """Apply a logical-axis sharding constraint against the ambient mesh.

    No-op outside a mesh and on a plain tensor, and per-dim
    divisibility-guarded, so models can call it unconditionally.  The main
    use is the residual stream ('batch','seq',None): seq->model sharding
    (Megatron sequence parallelism) divides the activations a layer keeps
    for its backward by the TP degree.
    """
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = NamedSharding(mesh, logical_spec(x.shape, logical, mesh)).placements
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)
