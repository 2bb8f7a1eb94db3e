"""The port's mixture-of-experts layer (``nn/moe.py``) and the MoE LMs
(grok-1: MoE every layer; llama4-maverick: dense and MoE in turn, with a
shared expert) against the JAX package on the CPU.

Weights come from the reference's ``init_moe`` / ``lm.init`` as numpy
arrays; inputs from numpy seeds.  The three dispatch forms (einsum,
scatter, ragged) are held at 1e-4 of their output's scale in f32, with a
capacity that drops copies (``capacity_factor=0.25``) and one that keeps
most; routing is held exactly (the experts picked and the copies kept),
the gates at 1e-6 and the aux loss at rel 1e-5; a bf16 case at 3e-2 of
scale.  Reduced grok-1 and maverick go through ``forward``, ``prefill``,
``decode_step`` (1e-4) and the engine on 2 slots (the JAX engine's
tokens).  ``quantize_tree`` of an MoE tree is the reference's bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.nn import moe as ref_moe  # noqa: E402
from repro.nn import quant as ref_quant  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.nn import moe, quant  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

TOL = 1e-4
BF16_TOL = 3e-2
SMALL = dict(layers=2, d_model=64, vocab=128)
ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
FORMS = ("einsum", "scatter", "ragged")
# (ffn kind, top k, shared expert): grok-1's and llama4's layers
LAYERS = {"geglu-top2": ("geglu", 2, False), "swiglu-top1-shared": ("swiglu", 1, True)}


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _specs(layer, form, cf):
    kind, k, shared = LAYERS[layer]
    kw = dict(n_experts=4, top_k=k, d_model=32, d_ff=64, ffn_kind=kind,
              capacity_factor=cf, shared_expert=shared, impl=form, group_size=8)
    return ref_moe.MoESpec(**kw), moe.MoESpec(**kw)


@pytest.fixture(scope="module")
def weights():
    """Each layer's reference weights as numpy, and a [2, 16, 32] input."""
    out = {}
    for layer in LAYERS:
        spec, _ = _specs(layer, "einsum", 1.0)
        p = _tree(ref_moe.init_moe(jax.random.key(0), spec), np.asarray)
        out[layer] = p
    x = np.random.default_rng(0).standard_normal((2, 16, 32)).astype(np.float32)
    return out, x


@pytest.mark.parametrize("cf", [1.0, 0.25])
@pytest.mark.parametrize("layer", sorted(LAYERS))
@pytest.mark.parametrize("form", FORMS)
def test_moe_forms_match_jax(weights, form, layer, cf):
    p, x = weights[0][layer], weights[1]
    spec_r, spec_p = _specs(layer, form, cf)
    want, want_aux = ref_moe.moe(_tree(p, jnp.asarray), jnp.asarray(x), spec_r)
    got, aux = moe.moe(_tree(p, torch.from_numpy), torch.from_numpy(x), spec_p)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    if cf < 1 and form != "ragged" and not LAYERS[layer][2]:
        # both drop the same copies: the same rows come back exactly zero
        zero = np.abs(np.asarray(want)).max(-1) == 0
        assert zero.any()
        assert np.array_equal(got.abs().amax(-1).numpy() == 0, zero)


def _kept(idx, n_experts, cap):
    """The reference's keep rule, counted plainly: copy (t, j) of a group
    is kept while fewer than ``cap`` earlier copies (token-major, then j)
    went to its expert."""
    keep = np.zeros(idx.shape, bool)
    for gi, group in enumerate(idx):
        seen = [0] * n_experts
        for t, row in enumerate(group):
            for j, e in enumerate(row):
                keep[gi, t, j] = seen[e] < cap
                seen[e] += 1
    return keep


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_routing_is_the_references_exactly(weights, layer):
    p, x = weights[0][layer], weights[1]
    spec_r, spec_p = _specs(layer, "einsum", 0.25)
    x2 = x.reshape(-1, 32)
    gates_r, idx_r, aux_r = ref_moe._route(_tree(p, jnp.asarray), jnp.asarray(x2), spec_r)
    gates, idx, aux = moe._route(_tree(p, torch.from_numpy), torch.from_numpy(x2), spec_p)
    assert np.array_equal(idx.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(gates.numpy(), np.asarray(gates_r), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(aux), float(aux_r), rtol=1e-5)
    for groups in (2, 4):              # scatter: batch rows; einsum: groups of 8
        grouped = np.asarray(idx_r).reshape(groups, -1, spec_p.top_k)
        cap = moe.capacity(spec_p, grouped.shape[1])
        _, keep = moe.buffer_positions(torch.from_numpy(grouped).long(), 4, cap)
        want = _kept(grouped, 4, cap)
        assert np.array_equal(keep.numpy(), want) and not want.all()


@pytest.mark.parametrize("form", FORMS)
def test_bf16_moe_matches_jax(weights, form):
    """bf16 weights and input on both sides: catches a cast in the wrong
    place, which the f32 cases cannot see."""
    p, x = weights[0]["geglu-top2"], weights[1]
    spec_r, spec_p = _specs("geglu-top2", form, 1.0)
    p_r = _tree(p, lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    p_r["router"] = jnp.asarray(p["router"])              # the router stays f32
    want, _ = ref_moe.moe(p_r, jnp.asarray(x).astype(jnp.bfloat16), spec_r)
    p_t = _tree(p, lambda a: torch.from_numpy(a).to(torch.bfloat16))
    p_t["router"] = torch.from_numpy(p["router"])
    got, _ = moe.moe(p_t, torch.from_numpy(x).to(torch.bfloat16), spec_p)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


def test_init_moe_shapes_and_dtypes():
    spec = moe.MoESpec(n_experts=20, top_k=1, d_model=8, d_ff=16, shared_expert=True)
    p = moe.init_moe(torch.Generator().manual_seed(0), spec, torch.bfloat16)
    assert p["router"].dtype == torch.float32 and p["router"].shape == (8, 20)
    assert p["w_up"].shape == (20, 8, 16) and p["w_down"].shape == (20, 16, 8)
    assert p["w_gate"].dtype == torch.bfloat16 and set(p["shared"]) == {
        "w_up", "w_gate", "w_down"}
    # drawn in slabs of EXPERT_SLAB: every expert is drawn, none repeats
    assert float(p["w_up"][16:].float().abs().sum()) > 0
    assert not torch.equal(p["w_up"][0], p["w_up"][16])


# -- the MoE LMs ----------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    ref_cfg = ref_reduced(ref_get_config(arch), **SMALL)
    cfg = reduced(get_config(arch), **SMALL)
    params = jax.tree.map(np.asarray, ref_lm.init(ref_cfg, jax.random.key(0)))
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, params), lm.params_from_reference(
        params, cfg, "cpu")


def test_moe_lm_forward_prefill_and_decode_match_jax(model):
    ref_cfg, cfg, ref_params, params = model
    kinds = [("moe" in p) for p in params["blocks"]]
    assert kinds == ([True, True] if cfg.moe_every == 1 else [False, True])
    toks = np.random.default_rng(1).integers(0, 128, (2, 19)).astype(np.int32)
    want, want_aux = ref_lm.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, aux = lm.forward(params, torch.from_numpy(toks).long(), cfg)
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)

    ref_cache = ref_lm.init_cache(ref_cfg, 2, 32)
    want, ref_cache = ref_lm.prefill(ref_params, jnp.asarray(toks), ref_cfg, ref_cache)
    cache = lm.init_cache(cfg, 2, 32, device="cpu")
    got, cache = lm.prefill(params, torch.from_numpy(toks).long(), cfg, cache)
    _close(got, want)
    pos = toks.shape[1]
    for _ in range(3):
        nxt = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        want, ref_cache = ref_lm.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                             jnp.asarray(pos, jnp.int32), ref_cfg)
        got, cache = lm.decode_step(params, cache, torch.from_numpy(nxt).long(), pos, cfg)
        _close(got, want)
        pos += 1
    for g, w in zip(cache, ref_cache):
        _close(g, w)


def test_moe_engine_on_two_slots_gives_the_jax_engines_tokens(model):
    """Capacity drops depend on which tokens share a group, so the engines
    run the same slots: 4 requests on 2, slot reuse included."""
    ref_cfg, cfg, ref_params, params = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=5 + 2 * i).astype(np.int32) for i in range(4)]
    ref_eng = RefEngine(ref_cfg, ref_params, slots=2, max_len=48)
    eng = Engine(cfg, params, slots=2, max_len=48, device="cpu")
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(prompts)]
    for r, rr in zip(reqs, ref_reqs):
        eng.submit(r)
        ref_eng.submit(rr)
    eng.run_until_drained()
    ref_eng.run_until_drained()
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]


# -- int8 serve weights of an MoE tree --------------------------------------------

@pytest.fixture(scope="module")
def maverick16():
    """Reduced maverick with 16 experts: its router [64, 16] is int8 in
    both packages (both last dims >= 16), as the full-width [5120, 128] is.
    -> (ref cfg, cfg, the reference's weights and its quantize_tree of
    them, as numpy)."""
    change = dict(moe_experts=16)
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(ARCHS[1]), **SMALL), **change)
    cfg = dataclasses.replace(reduced(get_config(ARCHS[1]), **SMALL), **change)
    params = ref_lm.init(ref_cfg, jax.random.key(0))
    ref_q = ref_quant.quantize_tree(params)
    return (ref_cfg, cfg, jax.tree.map(np.asarray, params),
            jax.tree.map(np.asarray, ref_q))


@pytest.mark.parametrize("slab", [16, 3])
def test_quantize_moe_tree_is_the_references_bit_for_bit(monkeypatch, maverick16, slab):
    """At 16 experts the expert stacks are one slab or six (3 a slab): the
    same bits either way."""
    monkeypatch.setattr(quant, "EXPERT_SLAB", slab)
    ref_cfg, cfg, params, ref_q = maverick16
    got = quant.quantize_tree(lm.params_from_reference(params, cfg, "cpu"))
    want = lm.params_from_reference(ref_q, cfg, "cpu")
    assert quant._is_qleaf(got["blocks"][1]["moe"]["router"])

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, list):
            for u, v in zip(a, b):
                same(u, v)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)

    same(got, want)
    ref_dq = ref_quant.dequantize_tree(jax.tree.map(jnp.asarray, ref_q["blocks_moe"]),
                                       jnp.float32)
    dq = quant.dequantize_tree(got["blocks"][1]["moe"], torch.float32)
    for name in ("w_up", "w_gate", "w_down", "router"):
        assert np.array_equal(dq[name].numpy(), np.asarray(ref_dq["moe"][name])[0])


def test_int8_moe_prefill_matches_jax(maverick16):
    """Served from int8 trees (router int8 at 16 experts) at 1e-4."""
    ref_cfg, cfg, params, ref_q = maverick16
    ref_q = jax.tree.map(jnp.asarray, ref_q)
    q = quant.quantize_tree(lm.params_from_reference(params, cfg, "cpu"))
    toks = np.random.default_rng(4).integers(0, 128, (1, 23)).astype(np.int32)
    want, _ = ref_lm.prefill(ref_q, jnp.asarray(toks), ref_cfg, ref_lm.init_cache(ref_cfg, 1, 32))
    got, _ = lm.prefill(q, torch.from_numpy(toks).long(), cfg,
                        lm.init_cache(cfg, 1, 32, device="cpu"))
    _close(got, want)


def test_init_quantize_is_quantize_tree_of_init():
    """``lm.init(quantize=True)`` quantizes each layer as it is drawn: the
    same bits as ``quantize_tree`` of the whole tree from the same seed."""
    cfg = dataclasses.replace(reduced(get_config(ARCHS[1]), layers=2, d_model=64,
                                      vocab=1024), moe_experts=16)
    whole = quant.quantize_tree(lm.init(cfg, torch.Generator().manual_seed(3), "cpu"))
    layered = lm.init(cfg, torch.Generator().manual_seed(3), "cpu", quantize=True)
    assert quant._is_qleaf(layered["embed"]) is False      # 1024 x 64: below 1024
    flat_w = jax.tree_util.tree_leaves(whole)
    flat_l = jax.tree_util.tree_leaves(layered)
    assert len(flat_w) == len(flat_l) and all(torch.equal(a, b) for a, b in zip(flat_w, flat_l))
    api = registry.get_api(cfg, device="cpu")
    logits, _ = api.prefill(layered, {"tokens": np.ones((1, 9), np.int32)},
                            api.make_serve_state(cfg, 1, 16), cfg)
    assert bool(torch.isfinite(logits).all())
