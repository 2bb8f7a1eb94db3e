"""The port's LM path (configs, ``models/lm.py``, ``get_api``, the token
engine) against the JAX package on the CPU.

The JAX package's ``lm.init`` draws the weights (biases and norm scales
then set from numpy, since it inits them to constants); the port loads
the same arrays through ``params_from_reference``.  fp32 at the
``reduced(qwen2-7b, layers=2, d_model=64, vocab=128)`` size; logits are
held at 1e-4 of their scale, and the engines' greedy tokens must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import attention_impl  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

TOL = 1e-4
SMALL = dict(layers=2, d_model=64, vocab=128)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_reduced(ref_get_config("qwen2-7b"), **SMALL)
    cfg = reduced(get_config("qwen2-7b"), **SMALL)
    params = jax.tree.map(np.asarray, ref_lm.init(ref_cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    blocks = params["blocks_dense"]
    for name in ("bq", "bk", "bv"):
        blocks["attn"][name] = rng.normal(0, 0.3, blocks["attn"][name].shape).astype(np.float32)
    for name in ("ln1", "ln2"):
        blocks[name] = rng.normal(1, 0.2, blocks[name].shape).astype(np.float32)
    params["final_norm"] = rng.normal(1, 0.2, params["final_norm"].shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, params)
    return ref_cfg, cfg, ref_params, lm.params_from_reference(params, cfg, "cpu")


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_are_the_reference_configs(arch):
    ref, cfg = REF_ARCHS[arch], ARCHS[arch]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert base.param_count(cfg) == ref_base.param_count(ref)
    assert base.active_param_count(cfg) == ref_base.active_param_count(ref)
    assert cfg.dtype == getattr(torch, ref.dtype.name)
    assert dataclasses.asdict(reduced(cfg, **SMALL)) == dataclasses.asdict(
        ref_reduced(ref, **SMALL))


def test_qwen2_7b_size():
    cfg = get_config("qwen2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim) == (
        28, 3584, 28, 4, 128)
    assert round(base.param_count(cfg) / 1e9, 2) == 7.62


def test_forward_matches_jax(setup):
    ref_cfg, cfg, ref_params, params = setup
    toks = np.random.default_rng(1).integers(0, 128, (2, 19)).astype(np.int32)
    want, _ = ref_lm.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, aux = lm.forward(params, torch.from_numpy(toks).long(), cfg)
    _close(got, want)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_jax(setup):
    """Prefill logits and 5 greedy decode steps (one position for all rows)."""
    ref_cfg, cfg, ref_params, params = setup
    toks = np.random.default_rng(2).integers(0, 128, (2, 13)).astype(np.int32)
    ref_cache = ref_lm.init_cache(ref_cfg, 2, 32)
    want, ref_cache = ref_lm.prefill(ref_params, jnp.asarray(toks), ref_cfg, ref_cache)
    cache = lm.init_cache(cfg, 2, 32, device="cpu")
    got, cache = lm.prefill(params, torch.from_numpy(toks).long(), cfg, cache)
    _close(got, want)
    for g, w in zip(cache, ref_cache):
        _close(g, w)
    pos = toks.shape[1]
    for _ in range(5):
        nxt = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(torch.argmax(got[:, -1], dim=-1).numpy()[:, None], nxt)
        want, ref_cache = ref_lm.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                             jnp.asarray(pos, jnp.int32), ref_cfg)
        got, cache = lm.decode_step(params, cache, torch.from_numpy(nxt).long(), pos, cfg)
        _close(got, want)
        pos += 1
    for g, w in zip(cache, ref_cache):
        _close(g, w)


def test_decode_at_per_slot_positions_matches_jax(setup):
    ref_cfg, cfg, ref_params, params = setup
    rng = np.random.default_rng(3)
    cache_np = [rng.normal(0, 1, (2, 3, 32, 2, 16)).astype(np.float32) for _ in range(2)]
    toks = rng.integers(0, 128, (3, 1)).astype(np.int32)
    pos = np.asarray([4, 20, 0], np.int32)
    want, want_cache = ref_lm.decode_step(ref_params, tuple(map(jnp.asarray, cache_np)),
                                          jnp.asarray(toks), jnp.asarray(pos), ref_cfg)
    cache = tuple(torch.from_numpy(c.copy()) for c in cache_np)
    got, cache = lm.decode_step(params, cache, torch.from_numpy(toks).long(), pos, cfg)
    _close(got, want)
    for g, w in zip(cache, want_cache):
        _close(g, w)


def test_prefill_runs_the_flash_kernel_once_per_layer(setup):
    _, cfg, _, params = setup
    seen = []
    impl = attention_impl(causal=True, record=lambda **kw: seen.append(kw))
    cache = lm.init_cache(cfg, 1, 32, device="cpu")
    lm.prefill(params, torch.arange(9)[None], cfg, cache, flash=impl)
    assert [kw["seq"] for kw in seen] == [9] * cfg.n_layers
    seen.clear()
    lm.decode_step(params, cache, torch.tensor([[3]]), 9, cfg)
    assert seen == []


def _drain_both(ref_cfg, cfg, ref_params, params, slots, requests):
    ref_eng = RefEngine(ref_cfg, ref_params, slots=slots, max_len=64)
    eng = Engine(cfg, params, slots=slots, max_len=64, device="cpu")
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(requests)]
    reqs = [Request(rid=i, prompt=p, max_new=m) for i, (p, m) in enumerate(requests)]
    for r, rr in zip(reqs, ref_reqs):
        eng.submit(r)
        ref_eng.submit(rr)
    eng.run_until_drained()
    ref_eng.run_until_drained()
    assert all(r.done for r in reqs)
    return [r.out for r in reqs], [r.out for r in ref_reqs]


def test_engine_drains_burst_like_jax(setup):
    """5 requests on 2 slots (slot reuse): the same tokens as the JAX engine."""
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, 128, size=4 + i).astype(np.int32), 6) for i in range(5)]
    got, want = _drain_both(*setup, slots=2, requests=requests)
    assert got == want
    assert all(len(o) >= 6 for o in got)


def test_engine_target_among_distractors_like_jax(setup):
    rng = np.random.default_rng(1)
    requests = [(rng.integers(0, 128, size=7).astype(np.int32), 6),
                (np.asarray([3, 14, 15, 9, 2], np.int32), 6)]
    got, want = _drain_both(*setup, slots=3, requests=requests)
    assert got == want


def test_engine_refuses_a_prompt_past_max_len(setup):
    """The JAX engine's cache write would clamp; the port raises."""
    _, cfg, _, params = setup
    eng = Engine(cfg, params, slots=1, max_len=8, device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(9, dtype=np.int32)))
    with pytest.raises(ValueError, match="outside the cache"):
        eng.step()
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="outside the cache"):
        lm.decode_step(params, cache, torch.tensor([[1]]), 8, cfg)


@pytest.mark.parametrize("arch,change", [
    ("qwen2-7b", {"kv_quant": True}),
    ("gemma3-1b", {}),                 # sliding-window layers
    ("grok-1-314b", {}),               # MoE every layer
    ("llama4-maverick-400b-a17b", {}), # MoE every other layer
    ("deepseek-coder-33b", {"serve_weight_quant": True}),
])
def test_unported_configs_raise(arch, change):
    cfg = dataclasses.replace(reduced(get_config(arch), **SMALL), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-2b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_api(reduced(get_config(arch)), device="cpu")


def test_get_api_needs_cuda_by_default(monkeypatch):
    cfg = reduced(get_config("qwen2-7b"), **SMALL)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.get_api(cfg)
    api = registry.get_api(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.loss_fn({}, {}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, {}, slots=1)


def test_engine_rejects_non_text_configs():
    from repro_torch.models.registry import get_cnn_api

    with pytest.raises(ValueError, match="frames"):
        Engine(get_cnn_api("resnet18", device="cpu").make_config(), {}, slots=1)
    with pytest.raises(ValueError, match="encdec"):
        Engine(reduced(get_config("seamless-m4t-medium")), {}, slots=1)
