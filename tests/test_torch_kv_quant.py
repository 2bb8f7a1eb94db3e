"""The port's int8 KV cache (``kv_quant``: int8 k and v, one f32 scale a
token and kv head) against the JAX package on the CPU.

At one position for every row, as the reference computes it: the cache's
bytes are the reference's bit for bit where both sides see the same k and
v (integer-valued inputs, no RoPE, so the projections are exact in f32),
and the outputs within 1e-4 of their scale; with random weights and RoPE
the int8 values may differ by one step where the two frameworks' k differ
in their last bit.  qwen2-7b, deepseek-coder-33b and starcoder2-15b are
served as shipped (``kv_quant=True``) at the reduced size.  At one
position per row (the engine's slots), where the reference raises, the
port is held against itself: each row of a batched decode against the
same request decoded alone, and the engine on 2 slots against each
request served alone.
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
from repro.nn import attention as ref_attn  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import attention_impl  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.nn import attention as port_attn  # noqa: E402
from repro_torch.serving.engine import Engine, Request, _write_slot  # noqa: E402

TOL = 1e-4
SMALL = dict(layers=2, d_model=64, vocab=128)
H, HKV, DH, D_MODEL = 4, 2, 16, 64
SHIPPED = ("qwen2-7b", "deepseek-coder-33b", "starcoder2-15b")


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _caches(shape=(2, 16)):
    b, s = shape
    return ((np.zeros((b, s, HKV, DH), np.int8),) * 2
            + (np.zeros((b, s, HKV), np.float32),) * 2)


def _run_both(p, xs, starts, *, use_rope, flash=None):
    """The same int8 cache written by successive calls at scalar starts on
    both sides -> (port cache, reference cache), each call's outputs held
    at TOL."""
    kw = dict(n_heads=H, n_kv=HKV, head_dim=DH, rope_theta=1e6, qkv_bias=True,
              use_rope=use_rope)
    spec_r, spec_p = ref_attn.AttnSpec(**kw), port_attn.AttnSpec(**kw)
    ref_cache = tuple(map(jnp.asarray, _caches()))
    cache = tuple(torch.from_numpy(c.copy()) for c in _caches())
    for x, start in zip(xs, starts):
        pos = np.broadcast_to(np.arange(start, start + x.shape[1]), x.shape[:2]).copy()
        want, ref_cache = ref_attn.attention(
            {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jnp.asarray(pos),
            spec_r, kv_cache=ref_cache, cache_len=jnp.asarray(start, jnp.int32))
        got, cache = port_attn.attention(
            {n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
            torch.from_numpy(pos), spec_p, kv_cache=cache, cache_len=start, flash=flash)
        _close(got, want)
    return [c.numpy() for c in cache], [np.asarray(c) for c in ref_cache]


def test_int8_cache_bytes_are_the_references_bit_for_bit():
    """Integer-valued x and weights in eighths: the projections are exact
    in f32 on both sides, so the quantizer sees the same k and v.  A
    prefill of 7 tokens, a decode step at 7, then 3 tokens at 8."""
    rng = np.random.default_rng(0)
    p = {n: (rng.integers(-4, 5, shape) / 8).astype(np.float32) for n, shape in (
        ("wq", (D_MODEL, H * DH)), ("wk", (D_MODEL, HKV * DH)), ("wv", (D_MODEL, HKV * DH)),
        ("wo", (H * DH, D_MODEL)), ("bq", (H * DH,)), ("bk", (HKV * DH,)),
        ("bv", (HKV * DH,)))}
    xs = [rng.integers(-3, 4, (2, n, D_MODEL)).astype(np.float32) for n in (7, 1, 3)]
    got, want = _run_both(p, xs, (0, 7, 8), use_rope=False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.abs(got[0][:, :11]).max() == 127 and not got[0][:, 11:].any()


def _attn_params():
    p = ref_attn.init_attention(jax.random.key(0), D_MODEL, H, HKV, DH, qkv_bias=True)
    p = {n: np.asarray(a) for n, a in p.items()}
    rng = np.random.default_rng(30)
    for n in ("bq", "bk", "bv"):   # the reference inits them to 0
        p[n] = rng.normal(0, 0.3, p[n].shape).astype(np.float32)
    return p


@pytest.mark.parametrize("starts", [(0, 9), (5,)])
def test_int8_cache_attention_matches_jax(starts):
    """With RoPE and random weights: a prefill from 0 runs the kernel route
    over the dequantized first S keys; from 5 the dense masked path."""
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal((2, n, D_MODEL)).astype(np.float32) for n in (9, 1)][
        :len(starts)]
    seen = []
    impl = attention_impl(causal=True, record=lambda **kw: seen.append(kw))
    got, want = _run_both(_attn_params(), xs, starts, use_rope=True, flash=impl)
    assert len(seen) == (starts[0] == 0)
    for g, w in zip(got[:2], want[:2]):
        assert np.abs(g.astype(np.int32) - w).max() <= 1
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


@pytest.fixture(scope="module", params=SHIPPED)
def shipped(request):
    """A config as shipped (``kv_quant=True``) at the reduced size, the
    reference's weights, and the port's copy of them."""
    arch = request.param
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch), **SMALL), kv_quant=True)
    cfg = dataclasses.replace(reduced(get_config(arch), **SMALL), kv_quant=True)
    assert ref_get_config(arch).kv_quant and get_config(arch).kv_quant
    params = jax.tree.map(np.asarray, ref_lm.init(ref_cfg, jax.random.key(0)))
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, params), lm.params_from_reference(
        params, cfg, "cpu")


def test_shipped_kv_quant_configs_match_jax(shipped):
    """Prefill and 4 greedy decode steps at one position for both rows:
    logits at TOL, int8 values within one step, scales at 1e-5."""
    ref_cfg, cfg, ref_params, params = shipped
    toks = np.random.default_rng(2).integers(0, 128, (2, 13)).astype(np.int32)
    ref_cache = ref_lm.init_cache(ref_cfg, 2, 32)
    cache = registry.get_api(cfg, device="cpu").make_serve_state(cfg, 2, 32)
    assert [c.dtype for c in cache] == [torch.int8] * 2 + [torch.float32] * 2
    assert [tuple(c.shape) for c in cache] == [tuple(c.shape) for c in ref_cache]
    want, ref_cache = ref_lm.prefill(ref_params, jnp.asarray(toks), ref_cfg, ref_cache)
    got, cache = lm.prefill(params, torch.from_numpy(toks).long(), cfg, cache)
    _close(got, want)
    pos = toks.shape[1]
    for _ in range(4):
        nxt = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        want, ref_cache = ref_lm.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                             jnp.asarray(pos, jnp.int32), ref_cfg)
        got, cache = lm.decode_step(params, cache, torch.from_numpy(nxt).long(), pos, cfg)
        _close(got, want)
        pos += 1
    for g, w in zip(cache[:2], ref_cache[:2]):
        assert np.abs(g.numpy().astype(np.int32) - np.asarray(w)).max() <= 1
    for g, w in zip(cache[2:], ref_cache[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)


def test_per_slot_decode_equals_each_row_alone(shipped):
    """Two requests prefilled alone (11 and 4 tokens), written into a pool
    of 2 slots and decoded in one step at their own positions: each row
    matches the request decoded alone, and so does each row's cache (the
    batched projections may round k and v differently in the last bit:
    int8 values within one step, scales at 1e-6)."""
    _, cfg, _, params = shipped
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, (1, n)) for n in (11, 4)]
    pool = lm.init_cache(cfg, 2, 24, device="cpu")
    alone, toks = [], []
    for slot, p in enumerate(prompts):
        one = lm.init_cache(cfg, 1, 24, device="cpu")
        logits, one = lm.prefill(params, torch.from_numpy(p), cfg, one)
        _write_slot(pool, one, slot)
        alone.append(one)
        toks.append(int(torch.argmax(logits[0, -1])))
    got, pool = lm.decode_step(params, pool, torch.tensor([[t] for t in toks]),
                               np.asarray([11, 4]), cfg)
    for slot, (one, t) in enumerate(zip(alone, toks)):
        want, one = lm.decode_step(params, one, torch.tensor([[t]]), prompts[slot].shape[1],
                                   cfg)
        _close(got[slot:slot + 1], want.numpy(), 1e-5)
        for c_pool, c_one in zip(pool[:2], one[:2]):
            assert (c_pool[:, slot].int() - c_one[:, 0].int()).abs().max() <= 1
        for c_pool, c_one in zip(pool[2:], one[2:]):
            np.testing.assert_allclose(c_pool[:, slot].numpy(), c_one[:, 0].numpy(),
                                       rtol=1e-6, atol=0)


def test_engine_on_two_slots_equals_each_request_alone(shipped):
    """The JAX engine's int8 cache raises at per-slot positions; the port's
    engine on 2 slots gives each request the tokens it gets alone."""
    _, cfg, _, params = shipped
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, size=5 + 3 * i).astype(np.int32) for i in range(3)]

    def serve(slots, batch):
        eng = Engine(cfg, params, slots=slots, max_len=40, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new=5) for i, p in enumerate(batch)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        return [r.out for r in reqs]

    assert serve(2, prompts) == [serve(1, [p])[0] for p in prompts]


def test_windowed_kv_quant_keeps_its_rings():
    """gemma3 with ``kv_quant``: the reference's condition keeps its rings
    (and its bf16 pair where the window covers the context)."""
    cfg = dataclasses.replace(reduced(get_config("gemma3-1b"), **SMALL), kv_quant=True)
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config("gemma3-1b"), **SMALL),
                                  kv_quant=True)
    for max_len in (32, 8):
        got, want = lm.init_cache(cfg, 1, max_len, device="cpu"), ref_lm.init_cache(
            ref_cfg, 1, max_len)
        assert isinstance(got, list) == isinstance(want, list) == (max_len > cfg.window)
        flat = [c for pair in got for c in pair] if isinstance(got, list) else list(got)
        assert len(flat) == len(jax.tree_util.tree_leaves(want))
        assert all(c.dtype == torch.float32 for c in flat)
