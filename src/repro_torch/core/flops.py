"""Analytic step FLOPs and HBM bytes; the port's copy of the JAX package's
``core/flops.py``.

The JAX package needs these because XLA's ``cost_analysis()`` counts
loop *bodies once* (its layer stacks run under ``lax.scan``), so its
dry run replaces the raw count by this model.  The port's step runs
eagerly and executes every layer, so a FLOP count of a traced step
(``core.hlo_analysis``) is already the whole step and needs no trip
correction; the dry run records the count beside ``step_flops`` and
their ratio.  ``scan_trips`` is kept for parity with the reference.

Conventions:
  * train counts fwd + bwd + full-remat refwd inside the layers
    (nothing_saveable policy => 2x fwd + bwd ~= 4x fwd); embed/unembed sit
    outside remat => 3x fwd there.  MODEL_FLOPS (6*N*D) stays the
    *useful* reference — the gap IS the remat overhead.
  * attention scores count 2*ctx_eff per (q, kv-pair) with causal 1/2 and
    sliding-window clamping.
  * MoE (scatter impl) experts run at capacity: top_k * capacity_factor
    FFN-equivalents per token + router.
"""
from __future__ import annotations


from repro_torch.configs.base import ModelConfig, param_count
from repro_torch.configs.shapes import ShapeSuite


def _attn_layer_flops(cfg: ModelConfig, q_len: int, ctx: int,
                      window: int) -> float:
    """Per-layer attention FLOPs for q_len query tokens vs ctx context."""
    d = cfg.d_model
    dq = cfg.n_heads * cfg.head_dim
    dkv = cfg.n_kv * cfg.head_dim
    proj = 2.0 * q_len * d * (2 * dq + 2 * dkv)
    eff = ctx if window <= 0 else min(ctx, window)
    if q_len == ctx:            # causal self-attention over the same span
        eff_avg = (eff + 1) / 2.0
    else:
        eff_avg = eff
    scores = 2.0 * q_len * eff_avg * cfg.n_heads * cfg.head_dim * 2.0
    return proj + scores


def _ffn_flops(cfg: ModelConfig, tokens: int) -> float:
    mats = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * mats


def _moe_flops(cfg: ModelConfig, tokens: int) -> float:
    mats = 3 if cfg.ffn_kind in ("swiglu", "geglu") else 2
    router = 2.0 * tokens * cfg.d_model * cfg.moe_experts
    experts = (2.0 * tokens * cfg.d_model * cfg.d_ff * mats
               * cfg.moe_top_k * cfg.moe_capacity)
    # grouped one-hot dispatch + combine einsums (nn/moe.py, g=256)
    g = 256
    dispatch = 2.0 * 2.0 * tokens * g * cfg.moe_top_k * cfg.moe_capacity         * cfg.d_model
    shared = _ffn_flops(cfg, tokens) if cfg.moe_shared else 0.0
    return router + experts + dispatch + shared


def _ssm_layer_flops(cfg: ModelConfig, tokens: int) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    p = cfg.ssm_head_dim
    q = cfg.ssm_chunk
    proj = 2.0 * tokens * d * (2 * di + 2 * n + h)
    conv = 2.0 * tokens * cfg.ssm_conv * (di + 2 * n)
    intra = 2.0 * tokens * q * h * (n + p)        # chunk-quadratic term
    states = 4.0 * tokens * h * p * n             # build + apply states
    out = 2.0 * tokens * di * d
    return proj + conv + intra + states + out


def _lm_fwd_flops(cfg: ModelConfig, q_len: int, ctx: int, batch: int
                  ) -> tuple:
    """-> (scanned_body_flops, outside_flops) for one forward pass."""
    toks = batch * q_len
    inner = 0.0
    for i in range(cfg.n_layers):
        w = cfg.window_for_layer(i)
        inner += batch * 0 + _attn_layer_flops(cfg, q_len, ctx, w) * batch
        is_moe = (cfg.moe_every > 0 and cfg.moe_experts > 0
                  and (i % max(cfg.moe_every, 1)) == cfg.moe_every - 1)
        inner += _moe_flops(cfg, toks) if is_moe else _ffn_flops(cfg, toks)
    outside = 2.0 * toks * cfg.d_model * cfg.vocab    # unembed
    return inner, outside


def _ssm_fwd_flops(cfg: ModelConfig, q_len: int, batch: int) -> tuple:
    toks = batch * q_len
    inner = cfg.n_layers * _ssm_layer_flops(cfg, toks)
    outside = 2.0 * toks * cfg.d_model * cfg.vocab
    return inner, outside


def _hybrid_fwd_flops(cfg: ModelConfig, q_len: int, ctx: int, batch: int
                      ) -> tuple:
    toks = batch * q_len
    inner = cfg.n_layers * _ssm_layer_flops(cfg, toks)
    sites = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
    inner += sites * (_attn_layer_flops(cfg, q_len, ctx, 0) * batch
                      + _ffn_flops(cfg, toks))
    outside = 2.0 * toks * cfg.d_model * cfg.vocab
    return inner, outside


def _encdec_fwd_flops(cfg: ModelConfig, q_len: int, ctx: int, batch: int,
                      enc_len: int, *, run_encoder: bool = True) -> tuple:
    """run_encoder=False for decode: the encoder ran at prefill and its
    memory is reused — decode pays only self+cross attention + FFN."""
    toks_dec = batch * q_len
    enc = 0.0
    if run_encoder:
        enc = cfg.enc_layers * (
            _attn_layer_flops(cfg, enc_len, enc_len, 0) * batch * 2  # bidir
            / 2 + _ffn_flops(cfg, batch * enc_len))
    dec = cfg.dec_layers * (
        _attn_layer_flops(cfg, q_len, ctx, 0) * batch          # self
        + _attn_layer_flops(cfg, q_len, enc_len, 0) * batch * 2 / 2  # cross
        + _ffn_flops(cfg, toks_dec))
    outside = 2.0 * toks_dec * cfg.d_model * cfg.vocab
    return enc + dec, outside


def step_flops(cfg: ModelConfig, shape: ShapeSuite) -> float:
    """Analytic FLOPs of the whole compiled step (all chips)."""
    b = shape.global_batch
    if shape.kind == "train":
        q = ctx = shape.seq_len
    elif shape.kind == "prefill":
        q = ctx = shape.seq_len
    else:
        q, ctx = 1, shape.seq_len

    if cfg.family == "ssm":
        inner, outside = _ssm_fwd_flops(cfg, q, b)
    elif cfg.family == "hybrid":
        inner, outside = _hybrid_fwd_flops(cfg, q, ctx, b)
    elif cfg.family == "encdec":
        inner, outside = _encdec_fwd_flops(
            cfg, q, ctx, b, shape.seq_len,
            run_encoder=(shape.kind != "decode"))
    elif cfg.family == "vlm":
        q_eff = q if shape.kind == "decode" else q  # patches folded into seq
        inner, outside = _lm_fwd_flops(cfg, q_eff, ctx, b)
    else:
        inner, outside = _lm_fwd_flops(cfg, q, ctx, b)

    if shape.kind == "train":
        if not cfg.remat:
            remat = 3.0
        elif cfg.remat_policy == "dots":
            remat = 3.1    # re-fwd recomputes elementwise ops only
        else:
            remat = 4.0
        return remat * inner + 3.0 * outside
    return inner + outside


# ---------------------------------------------------------------------------
# HBM traffic model (per device, per step)
# ---------------------------------------------------------------------------

def step_hbm_bytes(cfg: ModelConfig, shape: ShapeSuite,
                   n_model: int, n_data: int) -> float:
    """Structural per-device HBM byte estimate for the memory roofline term.

    The JAX package's raw ``cost_analysis['bytes accessed']`` suffers the
    loop-bodies-once undercount, and the port's trace counts live bytes,
    not traffic, so both dry runs take the memory term from this
    structural model:

      weights  — FSDP-grouped: each device consumes its model-shard slice
                 of every parameter once per pass; training runs 3 passes
                 (fwd, remat re-fwd, bwd) per microbatch; serving 1.
      states   — optimizer read+write (train); KV/SSM cache read+write
                 (serve).
      acts     — ~10 residual-stream-sized tensors read+written per layer
                 per pass for the local token slice.
      logits   — f32 logits + softmax traffic on the local shard.
    """
    chips = n_model * n_data
    pbytes = 2.0  # bf16 storage
    w_total = param_count(cfg) * pbytes
    w_dev_pass = w_total / n_model            # gathered slice per device
    b = shape.global_batch
    if shape.kind == "train":
        toks_dev = b * shape.seq_len / n_data
        if not cfg.remat:
            w_passes = 2.0
        elif cfg.remat_policy == "dots":
            w_passes = 2.1   # matmuls not recomputed -> weights stream ~2x
        else:
            w_passes = 3.0
        passes = w_passes * cfg.grad_accum
        weights = w_dev_pass * passes
        opt_bytes = (w_total / chips) * (2 + 2 + 4 + 4)   # p rw + states rw
        acts = toks_dev * cfg.d_model * pbytes * 10.0 * cfg.n_layers / max(
            1, n_model if cfg.shard_activations else 1) * (3.0 if cfg.remat else 2.0)
        logits = (b * shape.seq_len / chips) * cfg.vocab * 4.0 * 3.0
        return weights + opt_bytes + acts + logits
    if shape.kind == "prefill":
        toks_dev = b * shape.seq_len / n_data
        if cfg.serve_weight_quant:
            w_dev_pass *= (1.0 + 4.0 / 1024) / 2.0
        weights = w_dev_pass
        acts = toks_dev * cfg.d_model * pbytes * 10.0 * cfg.n_layers / max(
            1, n_model if cfg.shard_activations else 1)
        kv = (2 * b * shape.seq_len * cfg.n_kv * cfg.head_dim
              * cfg.n_layers * pbytes) / chips
        logits = b * cfg.vocab * 4.0 / chips
        return weights + acts + kv + logits
    # decode: weights + full cache read per token
    if cfg.serve_weight_quant:
        w_dev_pass *= (1.0 + 4.0 / 1024) / 2.0   # int8 + channel scales
    weights = w_dev_pass
    if cfg.family == "ssm":
        cache = (cfg.n_layers * b * (cfg.ssm_expand * cfg.d_model)
                 * cfg.ssm_state * 4.0) / chips * 2
    elif cfg.family == "hybrid":
        sites = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
        cache = (cfg.n_layers * b * (cfg.ssm_expand * cfg.d_model)
                 * cfg.ssm_state * 4.0 * 2
                 + 2 * sites * b * shape.seq_len * cfg.n_kv * cfg.head_dim
                 * pbytes) / chips
    else:
        n_kv_layers = cfg.n_layers if cfg.family != "encdec" else cfg.dec_layers
        eff = shape.seq_len
        if cfg.global_every > 0 and cfg.window > 0:
            n_glob = sum(1 for i in range(cfg.n_layers)
                         if cfg.window_for_layer(i) == 0)
            eff = (n_glob * shape.seq_len
                   + (cfg.n_layers - n_glob) * min(cfg.window, shape.seq_len)
                   ) / cfg.n_layers
        kv_bytes = pbytes
        if cfg.kv_quant:
            kv_bytes = 1.0 + 4.0 / cfg.head_dim   # int8 + per-token scale
        cache = 2 * n_kv_layers * b * eff * cfg.n_kv * cfg.head_dim \
            * kv_bytes / chips
    logits = b * cfg.vocab * 4.0 / chips
    return weights + cache + logits


# ---------------------------------------------------------------------------
# CNN workload accounting (LayerSpec chains and LayerGraph DAGs)
# ---------------------------------------------------------------------------

def chain_macs(layers) -> int:
    """Total multiplies to process one frame through a LayerSpec chain."""
    return sum(spec.total_macs for spec in layers)


def graph_macs(graph) -> int:
    """Total multiplies to process one frame through a ``LayerGraph``.

    This is the analytic ground truth the executable CNNs (models/cnn.py)
    assert against layer-by-layer: the graph drives the DSE, the same
    graph is interpreted by ``apply_graph``, and this sum ties the two
    views of the workload together.
    """
    return sum(graph.spec(name).total_macs for name in graph.topo_order())


def graph_weight_count(graph) -> int:
    """Parameters (weights + biases) of a ``LayerGraph`` network."""
    return sum(graph.spec(n).weight_count for n in graph.topo_order())


def scan_trips(cfg: ModelConfig, shape: ShapeSuite) -> int:
    """Trip count of the main layer scan (x grad accumulation for train) —
    the JAX package's loop-body multiplier for in-loop collectives.  The
    port's eager step runs no scans; kept for parity."""
    if cfg.family == "encdec":
        groups = max(cfg.enc_layers, cfg.dec_layers)
    elif cfg.family == "hybrid":
        groups = cfg.n_layers // max(cfg.hybrid_attn_every, 1)
    elif cfg.family == "ssm":
        groups = cfg.n_layers
    else:
        kinds = 2 if cfg.moe_every == 2 else 1
        groups = cfg.n_layers // kinds
        if cfg.global_every > 0 and shape.kind != "train":
            groups = 1          # mixed-window serve path is unrolled
    if shape.kind == "train":
        groups *= max(cfg.grad_accum, 1)
    return max(groups, 1)
