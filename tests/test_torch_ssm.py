"""The port's SSM path (the SSD kernel module, ``nn/ssm.py``, mamba2 and
zamba2, ``get_api`` and the token engine) against the JAX package on the
CPU.

The same numpy inputs go through the JAX function and the port's
counterpart, where the SSD kernel wrapper runs its plain PyTorch version.
The JAX package's SSD kernel runs in Pallas interpret mode, as
``tests/kernels/test_ssd_chunk.py`` runs it, and is held at that test's
2e-4.  Layers and models, fp32 at ``reduced(..., layers=4, d_model=64,
vocab=128)``, are held at 1e-4 of their output's scale (the two sides sum
in different orders); the engines' greedy tokens must be equal.  The JAX
``init`` draws the weights; norm scales, biases and the skip and dt
parameters are then set from numpy, since it inits them to constants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk as ref_ssd_chunk  # noqa: E402
from repro.models import hybrid as ref_hybrid  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.nn import ssm as ref_ssm  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain, ssd_head_run  # noqa: E402
from repro_torch.models import hybrid, mamba, registry  # noqa: E402
from repro_torch.nn import ssm  # noqa: E402
from repro_torch.serving.engine import Engine, Request  # noqa: E402

SSD_TOL = 2e-4
TOL = 1e-4
SMALL = dict(layers=4, d_model=64, vocab=128)
MODELS = {"mamba2-780m": (mamba, ref_mamba), "zamba2-1.2b": (hybrid, ref_hybrid)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _ssd_inputs(seed, b, l, h, p, g, n):
    """The JAX kernel test's distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    a = -np.exp(rng.standard_normal(h))
    bb = rng.standard_normal((b, l, g, n)) * 0.3
    cc = rng.standard_normal((b, l, g, n)) * 0.3
    return [np.asarray(t, np.float32) for t in (x, dt, a, bb, cc)]


# -- the SSD kernel module ---------------------------------------------------

@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("h", [4, 8])
@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("l", [32, 64])
def test_ssd_chunk_matches_the_pallas_kernel(l, chunk, h, g):
    """B/C at group width on the port's side; the JAX adapter repeats them."""
    ins = _ssd_inputs(l + chunk + h + g, 2, l, h, 8, g, 16)
    want_y, want_s = ref_ssd_chunk(*map(jnp.asarray, ins), chunk=chunk, head_block=4)
    y, s = ssd_chunk(*map(_t, ins), chunk=chunk)
    assert y.shape == (2, l, h, 8) and s.shape == (2, h, 8, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=SSD_TOL, atol=SSD_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=SSD_TOL, atol=SSD_TOL)


@pytest.mark.parametrize("form", ["streaming", "vectorised"])
def test_plain_ssd_forms_match_jax(form):
    ins = _ssd_inputs(7, 2, 48, 6, 8, 3, 16)
    ref = ref_ssm.ssd_chunked_streaming if form == "streaming" else ref_ssm.ssd_chunked
    port = ssm.ssd_chunked_streaming if form == "streaming" else ssm.ssd_chunked
    want_y, want_s = ref(*map(jnp.asarray, ins), chunk=16)
    y, s = port(*map(_t, ins), chunk=16)
    _close(y, want_y)
    _close(s, want_s)


def test_ssd_at_mamba2_decay_rates():
    """a = -(1..H) as the model inits it, dt from its dt_bias range: a_cum
    reaches hundreds below zero within a chunk; exp of differences only."""
    rng = np.random.default_rng(3)
    b, l, h, p, n = 1, 64, 16, 8, 16
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 3.0)).astype(np.float32)
    a = -np.arange(1, h + 1, dtype=np.float32) * 8.0
    x, _, _, bb, cc = _ssd_inputs(4, b, l, h, p, 1, n)
    want_y, want_s = ref_ssm.ssd_chunked_streaming(
        *map(jnp.asarray, (x, dt, a, bb, cc)), chunk=32)
    y, s = ssd_chunk(*map(_t, (x, dt, a, bb, cc)), chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close(y, want_y)
    _close(s, want_s)


def test_ssd_chunk_rejects_what_the_kernel_does_not_take():
    x, dt, a, b, c = map(_t, _ssd_inputs(0, 1, 32, 4, 8, 2, 16))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_chunk(x, dt, a, b, c, chunk=24)
    with pytest.raises(ValueError, match="chunk"):
        ssd_chunk(x, dt, a, b, c, chunk=256)
    with pytest.raises(ValueError, match="groups dividing"):
        ssd_chunk(x, dt, a, b[:, :, :1].repeat(1, 1, 3, 1), c[:, :, :1].repeat(1, 1, 3, 1),
                  chunk=16)
    with pytest.raises(ValueError, match="state dim"):
        big = torch.zeros((1, 32, 2, 136))
        ssd_chunk(x, dt, a, big, big, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x.double(), dt.double(), a.double(), b.double(), c.double(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a, b, c, chunk=16)


@pytest.mark.parametrize(
    "arch,tokens,run",
    [("mamba2-780m", 2048, 6), ("mamba2-780m", 512, 2), ("zamba2-1.2b", 2048, 8),
     ("zamba2-1.2b", 1536, 2)],
)
def test_ssd_head_run_fills_the_card(arch, tokens, run):
    """The chunk blocks' run of heads at the served models' shapes (one
    group): at 2048 tokens one wave of 128 blocks on the 132 SMs (16
    chunks x 48 heads / 6 for mamba2, 16 x 64 / 8 for zamba2), so each
    chunk's scores are formed 8 times, not once a head."""
    cfg = get_config(arch)
    h = cfg.d_model * cfg.ssm_expand // cfg.ssm_head_dim
    got = ssd_head_run(1, tokens // 128, h, 1, cfg.ssm_head_dim, cfg.ssm_state, 128)
    assert got == run and h % got == 0
    if tokens == 2048:
        assert 16 * h // got == 128


def test_ssd_head_run_divides_a_groups_heads():
    """A single head runs alone; a run never spans two groups."""
    assert ssd_head_run(1, 1, 1, 1, 64, 128, 128) == 1
    for g in (1, 2, 4):
        assert (8 // g) % ssd_head_run(2, 4, 8, g, 64, 64, 128) == 0


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunk_takes_bf16_like_the_pallas_kernel(chunk, g):
    """bf16 x, dt, B and C (a in f32): y in bf16 and the state in f32, as
    ``ssd_chunk_p`` gives them.  Both sides compute in f32; the f32 state
    is held at the JAX kernel test's 2e-4, the bf16 y, rounded once from
    f32 on each side, at 2^-7 relative (one bf16 rounding) and 2e-4
    absolute."""
    x, dt, a, bb, cc = _ssd_inputs(chunk + g, 2, 64, 8, 8, g, 16)
    bf = [np.asarray(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32)) for t in (x, dt, bb, cc)]
    want_y, want_s = ref_ssd_chunk(*(jnp.asarray(t, jnp.bfloat16) for t in (x, dt)),
                                   jnp.asarray(a),
                                   *(jnp.asarray(t, jnp.bfloat16) for t in (bb, cc)),
                                   chunk=chunk, head_block=4)
    y, s = ssd_chunk(_t(bf[0]).bfloat16(), _t(bf[1]).bfloat16(), _t(a),
                     _t(bf[2]).bfloat16(), _t(bf[3]).bfloat16(), chunk=chunk)
    assert want_y.dtype == jnp.bfloat16 and want_s.dtype == jnp.float32
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want_y, np.float32),
                               rtol=2.0 ** -7, atol=SSD_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), rtol=SSD_TOL, atol=SSD_TOL)


# -- nn/ssm.py ---------------------------------------------------------------

SPEC = dict(d_model=32, d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=2)


def _ssm_params(chunk, seed=0):
    ref_spec = ref_ssm.SSMSpec(**SPEC, chunk=chunk)
    params = jax.tree.map(np.asarray, ref_ssm.init_ssm(jax.random.key(seed), ref_spec))
    rng = np.random.default_rng(seed)
    params["conv_b"] = rng.normal(0, 0.3, params["conv_b"].shape).astype(np.float32)
    params["norm_scale"] = rng.normal(1, 0.2, params["norm_scale"].shape).astype(np.float32)
    params["d_skip"] = rng.normal(1, 0.3, params["d_skip"].shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, params)
    return ref_spec, ssm.SSMSpec(**SPEC, chunk=chunk), ref_params, {
        k: _t(v) for k, v in params.items()}


def test_init_ssm_matches_the_reference_shapes_and_constants():
    ref_spec, spec, _, _ = _ssm_params(16)
    want = ref_ssm.init_ssm(jax.random.key(0), ref_spec)
    got = ssm.init_ssm(torch.Generator().manual_seed(0), spec)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and str(got[k].dtype) == f"torch.{w.dtype}"
    for k in ("conv_b", "a_log", "d_skip", "norm_scale"):
        _close(got[k], np.asarray(want[k]))
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert bool(((dt >= 0.001 * 0.999) & (dt <= 0.1 * 1.001)).all())


@pytest.mark.parametrize("l,chunk", [(21, 8), (40, 16), (16, 16)])
def test_ssm_forward_prefill_matches_jax(l, chunk):
    """L not a multiple of the chunk pads, as the JAX package does."""
    ref_spec, spec, ref_params, params = _ssm_params(chunk)
    u = np.random.default_rng(l).standard_normal((2, l, 32)).astype(np.float32) * 0.5
    want, (want_s, want_c) = ref_ssm.ssm_forward(ref_params, jnp.asarray(u), ref_spec)
    got, (s, c) = ssm.ssm_forward(params, _t(u), spec)
    _close(got, want)
    _close(s, want_s)
    _close(c, want_c)


def test_ssm_forward_decode_matches_jax():
    ref_spec, spec, ref_params, params = _ssm_params(8)
    u = np.random.default_rng(5).standard_normal((2, 6, 32)).astype(np.float32) * 0.5
    rng = np.random.default_rng(6)
    st = [rng.standard_normal(t.shape).astype(np.float32) * 0.3
          for t in ref_ssm.init_ssm_state(2, ref_spec)]
    ref_state, state = tuple(map(jnp.asarray, st)), tuple(map(_t, st))
    for i in range(u.shape[1]):
        want, ref_state = ref_ssm.ssm_forward(ref_params, jnp.asarray(u[:, i:i + 1]),
                                              ref_spec, state=ref_state, decode=True)
        got, state = ssm.ssm_forward(params, _t(u[:, i:i + 1]), spec, state=state,
                                     decode=True)
        _close(got, want)
    for g, w in zip(state, ref_state):
        _close(g, w)


@pytest.mark.parametrize("chunk,seq", [(4, 16), (8, 32), (16, 32)])
def test_chunked_prefill_equals_decode_recurrence(chunk, seq):
    """The port's prefill (the kernel's plain version) against its own
    token-by-token decode, as tests/models/test_nn_consistency.py holds
    the JAX package's."""
    spec = ssm.SSMSpec(d_model=16, d_state=8, d_conv=4, expand=2, head_dim=8,
                       chunk=chunk)
    params = ssm.init_ssm(torch.Generator().manual_seed(0), spec)
    u = torch.randn((2, seq, 16), generator=torch.Generator().manual_seed(1)) * 0.5
    y_par, (s_par, conv_par) = ssm.ssm_forward(params, u, spec)
    state = ssm.init_ssm_state(2, spec)
    ys = []
    for i in range(seq):
        y, state = ssm.ssm_forward(params, u[:, i:i + 1], spec, state=state, decode=True)
        ys.append(y)
    np.testing.assert_allclose(y_par.numpy(), torch.cat(ys, 1).numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(s_par.numpy(), state[0].numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(conv_par.numpy(), state[1].numpy(), rtol=1e-5, atol=1e-5)


def test_prefill_runs_the_ssd_kernel_with_group_width_b_c():
    _, spec, _, params = _ssm_params(8)
    seen = []

    def record(x, dt, a, b, c, *, chunk):
        seen.append((tuple(x.shape), tuple(b.shape), chunk, x.is_contiguous()))
        return ssd_chunk_plain(x, dt, a, b, c, chunk=chunk)

    ssm.ssm_forward(params, torch.zeros((1, 13, 32)), spec, ssd=record)
    assert seen == [((1, 16, 4, 16), (1, 16, 2, 16), 8, True)]


# -- mamba2 and zamba2 -------------------------------------------------------

@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    arch = request.param
    mod, ref_mod = MODELS[arch]
    ref_cfg = ref_reduced(ref_get_config(arch), **SMALL)
    cfg = reduced(get_config(arch), **SMALL)
    params = jax.tree.map(np.asarray, ref_mod.init(ref_cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    blocks = params["blocks"]
    blocks["ln"] = rng.normal(1, 0.2, blocks["ln"].shape).astype(np.float32)
    for name, mean, sd in (("conv_b", 0, 0.3), ("norm_scale", 1, 0.2), ("d_skip", 1, 0.3)):
        blocks["ssm"][name] = rng.normal(mean, sd, blocks["ssm"][name].shape).astype(np.float32)
    params["final_norm"] = rng.normal(1, 0.2, params["final_norm"].shape).astype(np.float32)
    if "shared" in params:
        for name in ("ln1", "ln2"):
            params["shared"][name] = rng.normal(
                1, 0.2, params["shared"][name].shape).astype(np.float32)
    ref_params = jax.tree.map(jnp.asarray, params)
    return (arch, mod, ref_mod, ref_cfg, cfg, ref_params,
            mod.params_from_reference(params, cfg, "cpu"))


def _state(arch, mod, ref_mod, ref_cfg, cfg, b, max_len):
    if arch == "mamba2-780m":
        return ref_mod.init_state(ref_cfg, b), mod.init_state(cfg, b, "cpu")
    return (ref_mod.init_state(ref_cfg, b, max_len),
            mod.init_state(cfg, b, max_len, device="cpu"))


def _leaves(state):
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _leaves(state[k])]
    return list(state)


def test_forward_matches_jax(model):
    arch, mod, ref_mod, ref_cfg, cfg, ref_params, params = model
    toks = np.random.default_rng(1).integers(0, 128, (2, 37)).astype(np.int32)
    want, _ = ref_mod.forward(ref_params, jnp.asarray(toks), ref_cfg)
    got, aux = mod.forward(params, torch.from_numpy(toks).long(), cfg)
    _close(got, want)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_jax(model):
    """Prefill logits and state, then 5 greedy decode steps (one position
    for all rows)."""
    arch, mod, ref_mod, ref_cfg, cfg, ref_params, params = model
    toks = np.random.default_rng(2).integers(0, 128, (2, 21)).astype(np.int32)
    ref_state, state = _state(arch, mod, ref_mod, ref_cfg, cfg, 2, 32)
    want, ref_state = ref_mod.prefill(ref_params, jnp.asarray(toks), ref_cfg, ref_state)
    got, state = mod.prefill(params, torch.from_numpy(toks).long(), cfg, state)
    _close(got, want)
    for g, w in zip(_leaves(state), _leaves(ref_state)):
        _close(g, w)
    pos = toks.shape[1]
    for _ in range(5):
        nxt = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(torch.argmax(got[:, -1], dim=-1).numpy()[:, None], nxt)
        want, ref_state = ref_mod.decode_step(ref_params, ref_state, jnp.asarray(nxt),
                                              jnp.asarray(pos, jnp.int32), ref_cfg)
        got, state = mod.decode_step(params, state, torch.from_numpy(nxt).long(), pos, cfg)
        _close(got, want)
        pos += 1
    for g, w in zip(_leaves(state), _leaves(ref_state)):
        _close(g, w)


def test_prefill_launches_one_ssd_per_layer_and_one_flash_per_site(model):
    from repro_torch.kernels.flash_attention import flash_attention_plain

    arch, mod, ref_mod, ref_cfg, cfg, _, params = model
    seen = []

    def ssd(*args, chunk):
        seen.append("ssd")
        return ssd_chunk_plain(*args, chunk=chunk)

    def flash(q, k, v):
        seen.append("flash")
        return flash_attention_plain(q, k, v)

    _, state = _state(arch, mod, ref_mod, ref_cfg, cfg, 1, 32)
    kw = {"ssd": ssd} if arch == "mamba2-780m" else {"ssd": ssd, "flash": flash}
    mod.prefill(params, torch.arange(9)[None], cfg, state, **kw)
    sites = 0 if arch == "mamba2-780m" else hybrid.n_sites(cfg)
    assert seen.count("ssd") == cfg.n_layers and seen.count("flash") == sites
    seen.clear()
    mod.decode_step(params, state, torch.tensor([[3]]), 9, cfg)
    assert seen == []


def test_engine_gives_the_jax_engines_tokens(model):
    """3 prompts of 5, 17 and 33 tokens on 2 slots, 4 new tokens each: the
    one-row state (a tuple for mamba2, a dict of tuples for zamba2) is
    written into its slot of the pool."""
    arch, mod, ref_mod, ref_cfg, cfg, ref_params, params = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=n).astype(np.int32) for n in (5, 17, 33)]
    ref_eng = RefEngine(ref_cfg, ref_params, slots=2, max_len=64)
    eng = Engine(cfg, params, slots=2, max_len=64, device="cpu")
    ref_reqs = [RefRequest(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    reqs = [Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    for r, rr in zip(reqs, ref_reqs):
        eng.submit(r)
        ref_eng.submit(rr)
    eng.run_until_drained()
    ref_eng.run_until_drained()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert [r.out for r in reqs] == [r.out for r in ref_reqs]


@pytest.mark.parametrize("arch", sorted(MODELS))
def test_get_api_serves_the_ssm_families(arch, monkeypatch):
    cfg = reduced(get_config(arch), **SMALL)
    api = registry.get_api(cfg, device="cpu")
    params = api.init(cfg, torch.Generator().manual_seed(0))
    state = api.make_serve_state(cfg, 2, 16)
    logits, state = api.prefill(params, {"tokens": np.ones((2, 5), np.int32)}, state, cfg)
    logits, state = api.decode(params, state, {"tokens": np.ones((2, 1), np.int32)},
                               np.array([5, 5]), cfg)
    assert logits.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(logits).all())
    loss, _ = api.loss_fn(params, {"tokens": np.ones((2, 5), np.int32),
                                   "labels": np.ones((2, 5), np.int32)}, cfg)
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.get_api(cfg)


def test_full_size_configs():
    """The configurations the chip run serves, at full width and depth."""
    from repro_torch.configs.base import param_count

    m = mamba.spec(get_config("mamba2-780m"))
    assert (m.n_heads, m.head_dim, m.d_state, m.n_groups, m.chunk) == (48, 64, 128, 1, 128)
    z = get_config("zamba2-1.2b")
    assert (mamba.spec(z).n_heads, mamba.spec(z).d_state, hybrid.n_sites(z)) == (64, 64, 2)
    assert round(param_count(get_config("mamba2-780m")) / 1e6) == 780
