"""Decoder-only transformer LM; the port's copy of the JAX package's
``models/lm.py``: full causal attention (qwen2, deepseek-coder,
starcoder2), gemma3's 5:1 local:global windows, and MoE layers (grok-1:
every layer; llama4-maverick: dense and MoE in turn, with a shared
expert).

Params are a dict of tensors with one dict per layer under ``"blocks"``,
an ``"ffn"`` or a ``"moe"`` dict each (the JAX package stacks them ``[L,
...]`` per kind, ``blocks_dense`` and ``blocks_moe``, for ``lax.scan``;
here a Python loop runs the layers).  A tree from
``nn.quant.quantize_tree`` (int8 serve weights, ``serve_weight_quant``;
``init(..., quantize=True)``) is served as it is: the serve
passes dequantize one layer's weights at a time, and the embedding table
at each use.  Entry points:

  forward      — tokens [B, S] -> (logits, aux) over every position;
                 with ``cfg.remat``, each layer group (one layer, or a
                 dense and a MoE layer) runs under activation
                 checkpointing while autograd records
  loss_fn      — {"tokens", "labels"} -> (CE + 0.01 aux, metrics)
  prefill      — tokens [B, S] + empty caches -> (last-position logits,
                 caches); attention runs the flash kernel in every layer
                 without a window
  decode_step  — one token per row against the caches, at one position
                 for all rows or one per row (the engine's slots)

The caches, written in place, are one stacked pair ``[L, B, Smax, n_kv,
D]`` in the model's dtype; with ``kv_quant`` (and no window pattern) the
int8 cache ``(ck, cv, sk, sv)``: int8 values and f32 scales ``[L, B, Smax,
n_kv]``; or, for a windowed model whose context outgrows its window
(``global_every > 0``, ``window > 0``, ``max_len > window``), a list of
per-layer pairs ``[B, S_i, n_kv, D]``: local layers get rings of
``min(max_len, window)`` slots, global layers full caches.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, local_range
from repro_torch.launch.mesh import ambient_mesh
from repro_torch.tree import leaves, records_grad
from repro_torch.nn.attention import AttnSpec, attention, init_attention
from repro_torch.nn.embeddings import embed, init_embedding, unembed
from repro_torch.nn.layers import ffn, init_ffn
from repro_torch.nn.moe import MoESpec, init_moe, moe
from repro_torch.nn.norms import init_rms, rms_norm
from repro_torch.nn.quant import dequantize_tree, quantize_tree

Cache = Union[Tuple[torch.Tensor, ...], List[Tuple[torch.Tensor, torch.Tensor]]]


def _attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                    rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias,
                    q_block=cfg.q_block, k_block=cfg.k_block)


def _moe_spec(cfg: ModelConfig) -> MoESpec:
    return MoESpec(n_experts=cfg.moe_experts, top_k=cfg.moe_top_k, d_model=cfg.d_model,
                   d_ff=cfg.d_ff, ffn_kind=cfg.ffn_kind,
                   capacity_factor=cfg.moe_capacity, shared_expert=cfg.moe_shared,
                   impl=cfg.moe_impl)


def _layer_kinds(cfg: ModelConfig):
    """('dense',) | ('moe',) | ('dense', 'moe'): layer i is kinds[i % len]."""
    if cfg.moe_every == 1:
        return ("moe",)
    if cfg.moe_every == 2:
        return ("dense", "moe")
    return ("dense",)


def init(cfg: ModelConfig, generator: torch.Generator, device=None, *,
         quantize: bool = False) -> dict:
    """Random weights drawn on ``device`` from ``generator`` (a generator on
    that device), one tensor at a time.  ``quantize=True`` gives
    ``quantize_tree`` of the same weights bit for bit, each layer
    quantized as soon as it is drawn, so that no more than one layer ever
    sits in the model's dtype (a 4-layer grok-1 is 39 GB in bf16)."""
    dt = cfg.dtype
    q = quantize_tree if quantize else (lambda tree: tree)
    params: Dict = {
        "embed": q(init_embedding(generator, cfg.vocab, cfg.d_model, dt, device)),
        "final_norm": init_rms(cfg.d_model, dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = q(init_embedding(generator, cfg.vocab, cfg.d_model, dt,
                                             device))
    kinds = _layer_kinds(cfg)
    params["blocks"] = []
    for i in range(cfg.n_layers):
        block = {
            "ln1": init_rms(cfg.d_model, dt, device=device),
            "attn": init_attention(generator, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                   cfg.head_dim, qkv_bias=cfg.qkv_bias, dtype=dt,
                                   device=device),
            "ln2": init_rms(cfg.d_model, dt, device=device),
        }
        if kinds[i % len(kinds)] == "moe":
            block["moe"] = init_moe(generator, _moe_spec(cfg), dt, device)
        else:
            block["ffn"] = init_ffn(generator, cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind,
                                    dtype=dt, device=device)
        # a one-layer list: quantize_tree judges its leaves as stacked [L, ...];
        # the layer's bf16 tensors go before the next layer is drawn
        params["blocks"].append(q([block])[0])
        del block
    return params


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def unstack_layers(stacked, n_layers: int, device=None) -> list:
    """A reference tree of stacked ``[L, ...]`` arrays (numpy) as ``n_layers``
    per-layer dicts of tensors on ``device``."""
    def layer(tree, i):
        if isinstance(tree, dict):
            return {k: layer(v, i) for k, v in tree.items()}
        return _to_torch(np.asarray(tree)[i], device)

    return [layer(stacked, i) for i in range(n_layers)]


def tree_to_torch(tree, device=None):
    """A reference tree of numpy arrays as the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    return _to_torch(tree, device)


def params_from_reference(ref: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's param tree (``lm.init``, or ``quantize_tree`` of
    it: stacked ``[L/len(kinds), ...]`` blocks under ``blocks_dense`` and
    ``blocks_moe``, as numpy arrays) as the port's per-layer dicts, the
    kinds interleaved as ``_layer_kinds`` orders them;
    ``{"__q__", "__s__"}`` leaves are unstacked like any other."""
    out = {name: tree_to_torch(ref[name], device)
           for name in ("embed", "unembed", "final_norm") if name in ref}
    kinds = _layer_kinds(cfg)
    n_groups = cfg.n_layers // len(kinds)
    stacks = {kind: unstack_layers(ref[f"blocks_{kind}"], n_groups, device)
              for kind in kinds}
    out["blocks"] = [stacks[kinds[i % len(kinds)]][i // len(kinds)]
                     for i in range(cfg.n_layers)]
    return out


def _block(p: dict, x, positions, cfg: ModelConfig, kv_cache=None,
           cache_len=None, window: int = 0, ring: bool = False, flash=None):
    """-> (x, aux, cache): aux is the MoE layer's load-balancing loss, 0
    for a dense layer."""
    if cfg.shard_activations:
        # residual stream: batch->data, seq->model (Megatron-SP); a no-op
        # outside a mesh and on a plain tensor
        x = constrain(x, ("batch", "seq", None))
    h, new_cache = attention(p["attn"], rms_norm(x, p["ln1"], eps=cfg.norm_eps),
                             positions, _attn_spec(cfg), kv_cache=kv_cache,
                             cache_len=cache_len, window=window, ring=ring,
                             flash=flash)
    x = x + h
    y = rms_norm(x, p["ln2"], eps=cfg.norm_eps)
    if "moe" in p:
        y, aux = moe(p["moe"], y, _moe_spec(cfg))
    else:
        y, aux = ffn(p["ffn"], y, kind=cfg.ffn_kind), torch.zeros((), device=x.device)
    return x + y, aux, new_cache


def _table(params: dict, name: str, cfg: ModelConfig) -> torch.Tensor:
    """An embedding table, dequantized if it is int8."""
    return dequantize_tree(params[name], cfg.dtype)


def _head(params: dict, x, cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return unembed(_table(params, "embed" if cfg.tie_embeddings else "unembed", cfg), x)


def remat(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)`` — one layer group, its input and its params among
    ``args`` — under activation checkpointing where ``cfg.remat`` asks for
    it and autograd records (grad enabled, a tensor among ``args``
    requiring grad): the JAX package's ``jax.checkpoint`` of the scanned
    group body, whose activations the backward recomputes.  A serving
    pass runs ``fn`` as it is.  ``use_reentrant=False`` runs the first
    pass with grad enabled, so that both passes take the same routes
    (``nn.attention``, ``nn.ssm``).  The recomputation runs inside the
    forward's ambient mesh: on the card autograd runs the backward in a
    thread of its own, where the mesh stack (thread-local) is empty, and
    ``constrain`` and the sequence-parallel scan would take other routes."""
    if cfg.remat and records_grad(*filter(torch.is_tensor, leaves(args))):
        mesh = ambient_mesh()
        if mesh is not None:
            fn = functools.partial(_in_mesh, mesh, fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _in_mesh(mesh, fn: Callable, *args):
    with mesh:
        return fn(*args)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            full_logits: bool = True, flash: Optional[Callable] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (f32 logits, aux loss summed over the MoE layers)."""
    x, aux = layer_groups(params, embed(params["embed"], tokens), cfg, flash=flash)
    if not full_logits:
        x = x[:, -1:]
    return _head(params, x, cfg), aux


def layer_groups(params: dict, x: torch.Tensor, cfg: ModelConfig, flash=None):
    """The layers over embeddings ``x`` [B, S, d] at positions 0..S-1, one
    group of ``len(_layer_kinds(cfg))`` layers at a time (``remat``) ->
    (x, aux)."""
    per = len(_layer_kinds(cfg))

    def group(x, aux, first, blocks):
        for i, p in enumerate(blocks, first):
            x, a, _ = _block(p, x, None, cfg, window=cfg.window_for_layer(i), flash=flash)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), device=x.device)
    for first in range(0, cfg.n_layers, per):
        x, aux = remat(cfg, group, x, aux, first, params["blocks"][first:first + per])
    return x, aux


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The JAX package's masked CE: ``logsumexp`` minus the gold logit, in
    the logits' dtype (f32: ``unembed``'s, as the JAX package's
    ``preferred_element_type``), averaged over the labels >= 0.  A masked
    label reads logit 0 (the JAX package's gather wraps it; the mask
    zeroes it either way)."""
    if isinstance(logits, DTensor):
        logz, gold = _logz_gold_sharded(logits, labels)
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = _Pick.apply(logits, labels.clamp(min=0))
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask), min=1.0)


class _Pick(torch.autograd.Function):
    """``torch.gather(x, -1, idx[..., None])[..., 0]`` whose backward keeps
    the index alone: ``torch.gather`` keeps all of ``x`` (the f32 logits,
    [rows, vocab]) alive until its backward runs, beside the CE's own
    [rows, vocab] temporaries."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.like = (x.shape, x.dtype, x.device)
        return torch.gather(x, -1, idx[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        shape, dtype, device = ctx.like
        gx = torch.zeros(shape, dtype=dtype, device=device)
        return gx.scatter_(-1, idx[..., None], g[..., None].to(dtype)), None


def _logz_gold_sharded(logits: DTensor, labels: torch.Tensor):
    """``logsumexp`` and the gold logit of vocab-sharded DTensor logits,
    vocab-parallel (Megatron's CE): each rank reduces its own rows and
    vocab shard, and the mesh dims that split the vocab combine the
    partial results (a max, then sums).  DTensor's own gather over a
    vocab-sharded dim leaves a masked partial its redistribute cannot
    reduce, and gathering the whole vocab on every rank holds [rows,
    vocab] f32 logits a rank (20 GB for qwen2-7b's train_4k on a 16 x 16
    mesh) and their gradient replicated whole (320 GB)."""
    mesh, vdim = logits.device_mesh, logits.dim() - 1
    rows = [Replicate() if p.is_shard(vdim) else p for p in logits.placements]

    def combine(local, op="sum"):
        split = [Partial(op) if p.is_shard(vdim) else p for p in logits.placements]
        return DTensor.from_local(local, mesh, split).redistribute(mesh, rows)

    local = logits.to_local()
    lo, size = local_range(logits, vdim)    # this rank's vocab offset and width
    lab = labels if isinstance(labels, DTensor) else DTensor.from_local(
        labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    idx = lab.redistribute(mesh, rows).to_local().clamp(min=0) - lo
    if size == logits.shape[vdim]:
        # the whole vocab on this rank: the unsharded CE's own ops, bit for bit
        return (DTensor.from_local(torch.logsumexp(local, dim=-1), mesh, rows),
                DTensor.from_local(_Pick.apply(local, idx), mesh, rows))
    m = combine(local.detach().amax(-1), "max").to_local()
    sumexp = combine(torch.exp(local - m[..., None]).sum(-1))
    logz = torch.log(sumexp) + DTensor.from_local(m, mesh, rows)
    here = (idx >= 0) & (idx < local.shape[-1])
    picked = _Pick.apply(local, idx.clamp(0, local.shape[-1] - 1))
    return logz, combine(torch.where(here, picked, torch.zeros_like(picked)))


def loss_fn(params: dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch {"tokens", "labels"} [B, S] -> (CE + 0.01 x MoE aux, {"ce",
    "aux"})."""
    logits, aux = forward(params, batch["tokens"], cfg)
    ce = cross_entropy(logits, batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _per_layer(cfg: ModelConfig, max_len: int) -> bool:
    return cfg.global_every > 0 and cfg.window > 0 and max_len > cfg.window


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Cache:
    """One stacked (k, v) pair ``[L, B, max_len, n_kv, head_dim]``; with
    ``kv_quant`` (the reference's condition: no window pattern) the int8
    cache ``(ck, cv, sk, sv)``, scales ``[L, B, max_len, n_kv]`` in f32;
    or, for a windowed model whose ``max_len`` outgrows its window, a list
    of per-layer pairs: rings of ``min(max_len, window)`` slots for local
    layers, ``max_len`` for global ones (the KV memory a layer that only
    ever reads its last w positions needs)."""
    dtype = dtype or cfg.dtype
    if cfg.kv_quant and not (cfg.global_every > 0 and cfg.window > 0):
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv)
        return tuple(torch.zeros(shape + extra, dtype=dt, device=device)
                     for extra, dt in (((cfg.head_dim,), torch.int8),
                                       ((cfg.head_dim,), torch.int8),
                                       ((), torch.float32), ((), torch.float32)))

    def pair(*shape):
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))

    if _per_layer(cfg, max_len):
        sizes = [min(max_len, w) if w else max_len
                 for w in map(cfg.window_for_layer, range(cfg.n_layers))]
        return [pair(batch, size, cfg.n_kv, cfg.head_dim) for size in sizes]
    return pair(cfg.n_layers, batch, max_len, cfg.n_kv, cfg.head_dim)


def _layer_caches(cache: Cache, cfg: ModelConfig):
    """(kv, ring) of each layer: the stacked caches' slices, (k, v) or the
    int8 (ck, cv, sk, sv), or the per-layer list's pairs, a local layer's
    ring where it holds no more than its window."""
    if isinstance(cache, list):
        for i, kv in enumerate(cache):
            w = cfg.window_for_layer(i)
            yield kv, 0 < w and kv[0].shape[1] <= w
    else:
        for kv in zip(*cache):
            yield kv, False


def cache_positions(cache: Cache, cfg: ModelConfig) -> int:
    """How many positions the caches hold: a ring holds any number, so a
    per-layer list holds its full caches' length (rings alone: any)."""
    if isinstance(cache, list):
        full = [kv[0].shape[1] for kv, ring in _layer_caches(cache, cfg) if not ring]
        return min(full) if full else np.iinfo(np.int64).max // 2
    return cache[0].shape[2]


def _serve_pass(params: dict, x, positions, cache: Cache, cache_len,
                cfg: ModelConfig, flash=None):
    """Run the layers against the caches (layer i writes its own in
    place), each layer's weights dequantized as it runs.  Returns (x,
    cache)."""
    for i, (p, (kv, ring)) in enumerate(zip(params["blocks"], _layer_caches(cache, cfg))):
        x, _, _ = _block(dequantize_tree(p, cfg.dtype), x, positions, cfg,
                         kv_cache=kv, cache_len=cache_len,
                         window=cfg.window_for_layer(i), ring=ring, flash=flash)
    return x, cache


def prefill(params: dict, tokens: torch.Tensor, cfg: ModelConfig, cache: Cache,
            *, flash: Optional[Callable] = None) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, S] + empty caches -> (last-position f32 logits [B, 1, V],
    caches).  ``flash`` replaces the attention kernel in every layer that
    runs it (``nn.attention.attention``)."""
    x = embed(_table(params, "embed", cfg), tokens)
    x, cache = _serve_pass(params, x, None, cache, 0, cfg, flash=flash)  # 0..S-1
    return _head(params, x[:, -1:], cfg), cache


def decode_positions(pos, b: int, s: int, smax: int, device):
    """A decode step's ``pos`` (the current length: one int for every row,
    or one per row on the host, as the engine's slots give it), checked
    against caches of ``smax`` positions -> ``(cache_len, positions
    [b, s])``: an int or a [b] tensor on ``device``."""
    pos = np.asarray(pos.cpu() if torch.is_tensor(pos) else pos, dtype=np.int64)
    if pos.ndim > 1 or (pos.ndim == 1 and pos.shape != (b,)):
        raise ValueError(f"decode_step: positions of shape {pos.shape} for {b} rows")
    if pos.min() < 0 or pos.max() + s > smax:
        raise ValueError(f"decode_step: positions {pos.tolist()} (+{s}) outside "
                         f"the cache's {smax} positions")
    steps = torch.arange(s, device=device)
    if pos.ndim == 0:
        cache_len = int(pos)
        return cache_len, (cache_len + steps).expand(b, s)
    cache_len = torch.as_tensor(pos, device=device)
    return cache_len, cache_len[:, None] + steps


def decode_step(params: dict, cache: Cache, tokens: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """tokens [B, 1] at ``pos``: the current length, one int for every row
    or one per row on the host (the engine's slots), checked here against
    the cache -> (f32 logits [B, 1, V], caches)."""
    b, s = tokens.shape
    cache_len, positions = decode_positions(pos, b, s, cache_positions(cache, cfg),
                                            tokens.device)
    x = embed(_table(params, "embed", cfg), tokens)
    x, cache = _serve_pass(params, x, positions, cache, cache_len, cfg)
    return _head(params, x, cfg), cache
