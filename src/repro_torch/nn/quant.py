"""Int8 quantization for serving: the port's copy of the JAX package's
``nn/quant.py``.  Two facilities share the ``{"__q__", "__s__"}`` format:

* **Weight trees** (``quantize_tree`` / ``dequantize_tree``): matrix
  leaves become ``{"__q__": int8, "__s__": f32 per-output-channel scales}``
  and everything else stays as it is.  The serve passes dequantize one
  layer at a time, so only one layer's weights ever sit in the compute
  dtype and the weights a decode step reads stay int8.  The reference
  decides which leaves to quantize on its *stacked* ``[L, ...]`` leaves;
  the port keeps a list of per-layer dicts, and a leaf inside such a list
  is judged by the stacked shape ``(len(list),) + shape``, so the port
  quantizes exactly the leaves the reference does.
* **Activation links** (``quantize_link`` / ``dequantize_link``): one
  activation tensor crossing a pipeline-stage cut becomes
  ``{"__q__": int8 tensor, "__s__": 0-d f32 tensor}`` — per-tensor dynamic
  symmetric, the ``core.stage_partition.StreamBuffer`` int8 wire format,
  so the staged executor moves 8 bits per feature between stages.
  ``fake_quant_link`` is the quantize-dequantize round trip in one call:
  the monolithic reference applies it in place so the staged int8 path
  can be compared bit for bit.  One scale spans the whole tensor, so a
  frame's int8 payload depends on the other frames of its micro-batch, as
  in the reference.

The arithmetic is the reference's step for step, in f32: s = max(amax,
1e-12) / 127, q = clip(round(x / s), -127, 127) with ``torch.round``'s
half-to-even ties (``jnp.round``'s) and true quotients on the CPU and on
the card (``exact_divisor``), so both packages give the same bits.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Replicate

# Expert stacks ([E, d, f] under a layer) are drawn (``nn.moe.init_moe``),
# quantized and dequantized this many experts at a time: the scale is an amax over dim -2, within
# one expert, so slabs give one pass's bits, and the f32 transient stays a
# slab's (llama4-maverick's full-width stack is 21.5 GB in f32).
EXPERT_SLAB = 16


def exact_divisor(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``like``'s dtype on its device.  A CUDA
    tensor divided by a Python number (or a 0-d CPU tensor) is multiplied
    by its reciprocal, one rounding more than the true quotient the JAX
    package and the CPU take; a divisor on the same device is divided."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def quantize_link(x: torch.Tensor, *, bits: int = 8) -> Dict[str, torch.Tensor]:
    """Per-tensor dynamic symmetric int8 for one cut-crossing activation:
    s = amax/127, q = clip(round(x/s)).  ``bits`` != 8 is rejected: the
    stream-buffer widths this mirrors are priced per ``LINK_DTYPE_BITS``,
    and only the int8 entry has a quantizer (bf16 is a cast)."""
    if bits != 8:
        raise ValueError(f"quantize_link only implements int8, got {bits} bits")
    xf = x.float()
    s = torch.clamp(xf.abs().max(), min=1e-12) / exact_divisor(127.0, xf)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return {"__q__": q, "__s__": s}


def dequantize_link(payload: Dict[str, torch.Tensor], dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_link`` on the consuming stage: f32 product,
    then a cast to ``dtype``."""
    return (payload["__q__"].float() * payload["__s__"]).to(dtype)


def fake_quant_link(x: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Quantize-dequantize round trip in one call — what the monolithic
    reference applies at each would-be cut."""
    return dequantize_link(quantize_link(x), dtype=dtype)


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"__q__", "__s__"}


def _should_quantize(leaf, shape) -> bool:
    """The reference's rule on the leaf's stacked ``shape``: ndim >= 3 (a
    layer's matrix under its L dim) with both last dims >= 16, or ndim 2
    (an embedding table) with both dims >= 1024.  Stacked norms and biases
    (``[L, d]``) and tiny heads stay full precision."""
    if not (torch.is_tensor(leaf) and leaf.is_floating_point()):
        return False
    if len(shape) >= 3:
        return shape[-1] >= 16 and shape[-2] >= 16
    if len(shape) == 2:
        return min(shape) >= 1024
    return False


def _slabs(leaf: torch.Tensor):
    """Index ranges over an expert stack's dim 0 (a leaf of 3 or more dims
    under a layer), EXPERT_SLAB experts each; one range for a matrix."""
    if leaf.dim() < 3:
        return [slice(None)]
    return [slice(i, i + EXPERT_SLAB) for i in range(0, leaf.shape[0], EXPERT_SLAB)]


def quantize_tree(params: Any, **_) -> Any:
    """Per-output-channel symmetric int8 for matmul and embedding weights:
    the scale is the amax over the row dim (-2), one per output column."""
    def quantize(leaf, lead):
        if isinstance(leaf, dict):
            return {k: quantize(v, lead) for k, v in leaf.items()}
        if isinstance(leaf, list):          # per-layer dicts: the stacked L dim
            return [quantize(v, lead + (len(leaf),)) for v in leaf]
        if not _should_quantize(leaf, lead + tuple(leaf.shape)):
            return leaf
        q = torch.empty(leaf.shape, dtype=torch.int8, device=leaf.device)
        s = torch.empty(leaf.shape[:-2] + (1, leaf.shape[-1]), dtype=torch.float32,
                        device=leaf.device)
        for sl in _slabs(leaf):
            x = leaf[sl].float()
            amax = x.abs().amax(dim=-2, keepdim=True)
            s[sl] = torch.clamp(amax, min=1e-12) / exact_divisor(127.0, amax)
            q[sl] = torch.clamp(torch.round(x / s[sl]), -127, 127)
        return {"__q__": q, "__s__": s}

    return quantize(params, ())


def dequantize_tree(tree: Any, dtype=torch.bfloat16) -> Any:
    """Full-precision weights from a (slice of a) quantized tree: an f32
    product, then a cast to ``dtype`` (expert stacks a slab at a time);
    other leaves come back as they are, uncopied.  The serve passes call
    it on one layer at a time.  A leaf whose ``__q__`` is a DTensor
    (params on a mesh) is dequantized shard by shard, each rank's local
    ``__q__`` against its columns of ``__s__``, and comes back a DTensor
    on ``__q__``'s placements: the whole leaf's values, bit for bit."""
    if _is_qleaf(tree):
        q, s = tree["__q__"], tree["__s__"]
        if isinstance(q, DTensor):
            return _dequantize_shards(q, s, dtype)
        return _dequantize(q, s, dtype)
    if isinstance(tree, dict):
        return {k: dequantize_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [dequantize_tree(v, dtype) for v in tree]
    return tree


def _dequantize(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    for sl in _slabs(q):
        out[sl] = q[sl].float() * s[sl]
    return out


def _dequantize_shards(q: DTensor, s: DTensor, dtype) -> DTensor:
    """``__s__`` (row dim 1) is placed by the parent's spec with the row
    axis dropped; where that splits its columns otherwise than ``__q__``'s
    (an embedding table's vocab rows over 'model', its columns whole), it
    is moved to ``__q__``'s column split, so the local shards broadcast."""
    mesh, rows = q.device_mesh, q.dim() - 2
    want = [p if p.is_shard() and p.dim != rows else Replicate() for p in q.placements]
    s = s.redistribute(mesh, want).to_local()
    return DTensor.from_local(_dequantize(q.to_local(), s, dtype), mesh, q.placements,
                              shape=q.shape, stride=q.stride())


def _children(tree) -> list:
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree) if isinstance(tree, list) else []


def is_quantized(tree: Any) -> bool:
    return _is_qleaf(tree) or any(is_quantized(v) for v in _children(tree))


def tree_bytes(tree: Any) -> int:
    if isinstance(tree, (dict, list)):
        return sum(tree_bytes(v) for v in _children(tree))
    return tree.numel() * tree.element_size()
