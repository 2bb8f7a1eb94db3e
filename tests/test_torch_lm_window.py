"""gemma3's windowed layers and their ring caches in the port, against the
JAX package on the CPU.

``reduced(gemma3-1b, layers=4, d_model=64, vocab=128)`` keeps gemma3's
pattern at window 8 with every second layer global, so a ``max_len`` of
32 gives layers 0 and 2 rings of 8 slots and layers 1 and 3 full caches.
The JAX package's ``init`` draws the weights (the norm scales then set
from numpy, since it inits them to ones); the port loads them through
``params_from_reference``.  fp32; logits and caches are held at 1e-4 of
their scale.

The JAX package writes and masks every row of a batched ring decode at
the batch's largest position (``models/lm.py::_serve_pass_per_layer``),
so the port is held against it only where every row sits at one
position; at per-slot positions the port is held against itself, each
row decoded alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.nn import attention as ref_attn  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import attention_impl  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import attention as port_attn  # noqa: E402
from repro_torch.serving.engine import Engine, Request, _write_slot  # noqa: E402

TOL = 1e-4
SMALL = dict(layers=4, d_model=64, vocab=128)
MAX_LEN = 32


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _close_caches(got, want):
    assert isinstance(got, list) and len(got) == len(want)
    for (gk, gv), (wk, wv) in zip(got, want):
        _close(gk, wk)
        _close(gv, wv)


@pytest.fixture(scope="module")
def setup():
    ref_cfg = ref_reduced(ref_get_config("gemma3-1b"), **SMALL)
    cfg = reduced(get_config("gemma3-1b"), **SMALL)
    assert (cfg.window, cfg.global_every) == (8, 2)
    params = jax.tree.map(np.asarray, ref_lm.init(ref_cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    blocks = params["blocks_dense"]
    for name in ("ln1", "ln2"):
        blocks[name] = rng.normal(1, 0.2, blocks[name].shape).astype(np.float32)
    params["final_norm"] = rng.normal(1, 0.2, params["final_norm"].shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, params)
    return ref_cfg, cfg, ref_params, lm.params_from_reference(params, cfg, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, 128, (b, s)).astype(np.int32)


def test_init_cache_gives_rings_to_local_layers(setup):
    ref_cfg, cfg, _, _ = setup
    got, want = lm.init_cache(cfg, 2, MAX_LEN, device="cpu"), ref_lm.init_cache(ref_cfg, 2, MAX_LEN)
    assert [tuple(k.shape) for k, _ in got] == [tuple(k.shape) for k, _ in want]
    assert [k.shape[1] for k, _ in got] == [8, MAX_LEN, 8, MAX_LEN]
    stacked = lm.init_cache(cfg, 2, 8, device="cpu")     # within the window
    assert isinstance(stacked, tuple) and stacked[0].shape == (4, 2, 8, 1, 16)


def test_forward_matches_jax(setup):
    """Every position of a 19-token sequence, local layers under the
    window mask."""
    ref_cfg, cfg, ref_params, params = setup
    toks = _tokens(1, 2, 19)
    want, _ = ref_lm.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, _ = lm.forward(params, torch.from_numpy(toks).long(), cfg)
    _close(got, want)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("s", [5, 13])
def test_prefill_and_decode_match_jax(setup, s, per_row):
    """Prompts shorter (5) and longer (13) than the window, then 6 greedy
    decode steps, the ring wrapping; every row at one position, given as
    one int or one per row."""
    ref_cfg, cfg, ref_params, params = setup
    toks = _tokens(2 + s, 2, s)
    ref_cache = ref_lm.init_cache(ref_cfg, 2, MAX_LEN)
    want, ref_cache = ref_lm.prefill(ref_params, jnp.asarray(toks), ref_cfg, ref_cache)
    cache = lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    got, cache = lm.prefill(params, torch.from_numpy(toks).long(), cfg, cache)
    _close(got, want)
    _close_caches(cache, ref_cache)
    for pos in range(s, s + 6):
        nxt = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(torch.argmax(got[:, -1], dim=-1).numpy()[:, None], nxt)
        at = np.full(2, pos, np.int32) if per_row else pos
        want, ref_cache = ref_lm.decode_step(ref_params, ref_cache, jnp.asarray(nxt),
                                             jnp.asarray(at, jnp.int32), ref_cfg)
        got, cache = lm.decode_step(params, cache, torch.from_numpy(nxt).long(), at, cfg)
        _close(got, want)
    _close_caches(cache, ref_cache)


def test_per_slot_decode_equals_each_row_alone(setup):
    """Two requests of 6 and 13 tokens prefilled alone, written into a
    two-row pool and decoded together at positions (6, 13) for 5 steps:
    each row's logits and caches are the row decoded alone."""
    _, cfg, _, params = setup
    prompts = [_tokens(7, 1, 6), _tokens(8, 1, 13)]
    pool = lm.init_cache(cfg, 2, MAX_LEN, device="cpu")
    alone, last = [], []
    for slot, p in enumerate(prompts):
        one = lm.init_cache(cfg, 1, MAX_LEN, device="cpu")
        logits, one = lm.prefill(params, torch.from_numpy(p).long(), cfg, one)
        _write_slot(pool, one, slot)
        alone.append(one)
        last.append(int(torch.argmax(logits[0, -1])))
    pos = np.asarray([6, 13])
    for _ in range(5):
        toks = torch.tensor(last)[:, None]
        got, pool = lm.decode_step(params, pool, toks, pos, cfg)
        for row in range(2):
            want, alone[row] = lm.decode_step(params, alone[row], toks[row:row + 1],
                                              int(pos[row]), cfg)
            _close(got[row:row + 1], want)
            for (gk, gv), (wk, wv) in zip(pool, alone[row]):
                _close(gk[row:row + 1], wk)
                _close(gv[row:row + 1], wv)
        last = torch.argmax(got[:, -1], dim=-1).tolist()
        pos = pos + 1


def test_prefill_runs_the_flash_kernel_in_global_layers_only(setup):
    _, cfg, _, params = setup
    seen = []
    impl = attention_impl(causal=True, record=lambda **kw: seen.append(kw))
    cache = lm.init_cache(cfg, 1, MAX_LEN, device="cpu")
    lm.prefill(params, torch.arange(11)[None], cfg, cache, flash=impl)
    globals_ = [i for i in range(cfg.n_layers) if cfg.window_for_layer(i) == 0]
    assert [kw["seq"] for kw in seen] == [11] * len(globals_) == [11, 11]
    seen.clear()
    lm.decode_step(params, cache, torch.tensor([[3]]), 11, cfg)
    assert seen == []


def test_engine_on_two_slots_gives_the_jax_engines_tokens_on_one(setup):
    """4 prompts of 5-17 tokens, 7 new tokens each: the port's engine on 2
    slots (per-slot ring decode) against the JAX engine on 1 slot (where
    its one position per batch is the row's own)."""
    ref_cfg, cfg, ref_params, params = setup
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 128, size=n).astype(np.int32) for n in (5, 17, 9, 12)]
    ref_eng = RefEngine(ref_cfg, ref_params, slots=1, max_len=MAX_LEN)
    eng = Engine(cfg, params, slots=2, max_len=MAX_LEN, device="cpu")
    assert isinstance(eng.state, list)
    reqs = [Request(rid=i, prompt=p, max_new=7) for i, p in enumerate(prompts)]
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=7) for i, p in enumerate(prompts)]
    for r, rr in zip(reqs, ref_reqs):
        eng.submit(r)
        ref_eng.submit(rr)
    eng.run_until_drained()
    ref_eng.run_until_drained()
    assert all(r.done and len(r.out) == 7 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]


@pytest.mark.parametrize("s,start", [(13, 0), (5, 0), (1, 11), (1, 3)])
def test_ring_attention_matches_jax(s, start):
    """One layer on a ring of 8 slots: a prefill of 13 (longer than the
    ring) or 5 tokens, and one-token decodes past and within the ring."""
    h, hkv, dh, d = 4, 2, 16, 64
    p = {n: np.asarray(a) for n, a in ref_attn.init_attention(
        jax.random.key(1), d, h, hkv, dh).items()}
    rng = np.random.default_rng(s + start)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    cache = [rng.standard_normal((2, 8, hkv, dh)).astype(np.float32) for _ in range(2)]
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (2, s)).copy()
    spec_r = ref_attn.AttnSpec(n_heads=h, n_kv=hkv, head_dim=dh, rope_theta=1e6)
    spec_p = port_attn.AttnSpec(n_heads=h, n_kv=hkv, head_dim=dh, rope_theta=1e6)
    want, want_cache = ref_attn.attention(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jnp.asarray(pos),
        spec_r, kv_cache=tuple(map(jnp.asarray, cache)),
        cache_len=jnp.asarray(start, jnp.int32), window=jnp.asarray(8, jnp.int32),
        ring=True)
    got, got_cache = port_attn.attention(
        {n: torch.from_numpy(a.copy()) for n, a in p.items()}, torch.from_numpy(x),
        torch.from_numpy(pos), spec_p,
        kv_cache=tuple(torch.from_numpy(c.copy()) for c in cache), cache_len=start,
        window=8, ring=True)
    _close(got, want)
    for g, w in zip(got_cache, want_cache):
        _close(g, w)
