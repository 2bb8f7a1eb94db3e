"""The port's encdec (seamless-m4t-medium) and vlm (internvl2-2b) families
against the JAX package on the CPU, through ``get_api(..., device="cpu")``.

The JAX package's ``init`` draws the weights (norm scales then set from
numpy, since it inits them to ones); the port loads them through each
family's ``params_from_reference``.  fp32 at ``reduced(..., layers=4,
d_model=64, vocab=128)`` (seamless: 2 encoder and 2 decoder layers;
internvl2: 8 patches); a prefill and 3 greedy decode steps, logits and
serve state held at 1e-4 of their scale.  A recording ``flash`` stand-in
counts the kernel route's calls per prefill and per decode step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.models.registry import get_api as ref_get_api  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.models import encdec, registry, vlm  # noqa: E402

TOL = 1e-4
SMALL = dict(layers=4, d_model=64, vocab=128)
MAX_LEN = 24
ARCHS = {"seamless-m4t-medium": encdec, "internvl2-2b": vlm}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _norms_from_numpy(tree, rng):
    """Norm scales (every leaf named ln*, *_norm) drawn around 1."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _norms_from_numpy(leaf, rng)
        elif name.startswith("ln") or name.endswith("_norm"):
            tree[name] = rng.normal(1, 0.2, leaf.shape).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    arch = request.param
    ref_cfg = ref_reduced(ref_get_config(arch), **SMALL)
    cfg = reduced(get_config(arch), **SMALL)
    params = jax.tree.map(np.asarray, ref_get_api(ref_cfg).init(ref_cfg, jax.random.key(0)))
    _norms_from_numpy(params, np.random.default_rng(0))
    port = ARCHS[arch].params_from_reference(params, cfg, "cpu")
    return arch, ref_cfg, cfg, jax.tree.map(jnp.asarray, params), port


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, 13, cfg.d_model)).astype(np.float32)
    else:
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return batch


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_prefill_and_decode_match_jax(model):
    """get_api's prefill (the frames' encoding or the patch prefix) and 3
    greedy decode steps, at the positions the JAX package's arch smoke test
    gives them (vlm: after the patches)."""
    arch, ref_cfg, cfg, ref_params, params = model
    ref_api, api = ref_get_api(ref_cfg), registry.get_api(cfg, device="cpu")
    batch = _batch(cfg, 2, 7, 1)
    ref_state = ref_api.make_serve_state(ref_cfg, 2, MAX_LEN)
    want, ref_state = ref_api.prefill(ref_params, jax.tree.map(jnp.asarray, batch),
                                      ref_state, ref_cfg)
    state = api.make_serve_state(cfg, 2, MAX_LEN)
    got, state = api.prefill(params, batch, state, cfg)
    assert got.shape == (2, 1, cfg.vocab) and got.dtype == torch.float32
    _close(got, want)
    pos = 7 + (cfg.n_patches if cfg.family == "vlm" else 0)
    for step in range(3):
        tok = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        assert np.array_equal(torch.argmax(got[:, -1], dim=-1).numpy()[:, None], tok)
        want, ref_state = ref_api.decode(ref_params, ref_state, {"tokens": jnp.asarray(tok)},
                                         jnp.asarray(pos + step, jnp.int32), ref_cfg)
        got, state = api.decode(params, state, {"tokens": tok}, pos + step, cfg)
        _close(got, want)
    got_leaves, want_leaves = _leaves(state), _leaves(ref_state)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        _close(g, w)


def test_decode_at_per_slot_positions_equals_each_row_alone(model):
    """Rows at different positions in one decode step (prompts of 5 and 9
    tokens, each prefilled alone): each row's logits are the row's own."""
    arch, _, cfg, _, params = model
    api = registry.get_api(cfg, device="cpu")
    rows, logits_alone, states = [], [], []
    for s, seed in ((5, 2), (9, 3)):
        batch = _batch(cfg, 1, s, seed)
        st = api.make_serve_state(cfg, 1, MAX_LEN)
        logits, st = api.prefill(params, batch, st, cfg)
        rows.append((s + (cfg.n_patches if cfg.family == "vlm" else 0),
                     int(torch.argmax(logits[0, -1]))))
        states.append(st)
    for st, (pos, tok) in zip(states, rows):
        logits, _ = api.decode(params, st, {"tokens": [[tok]]}, pos, cfg)
        logits_alone.append(logits)
    if cfg.family == "encdec":   # one memory per row: same length T, stacked
        pool = {"cache": tuple(torch.cat(p, dim=1)
                               for p in zip(*(st["cache"] for st in states))),
                "memory": torch.cat([st["memory"] for st in states])}
    else:
        pool = tuple(torch.cat(p, dim=1) for p in zip(*states))
    # the single-row decodes above advanced each row's cache by one entry,
    # which the batched step overwrites with the same values
    got, _ = api.decode(params, pool, {"tokens": [[t] for _, t in rows]},
                        np.asarray([p for p, _ in rows]), cfg)
    for row, want in enumerate(logits_alone):
        _close(got[row:row + 1], want)


def test_kernel_route_launches(model):
    """The flash kernel's calls: encdec, 3 a layer pair a prefill (encoder
    self-attention, decoder self-attention, cross-attention to T keys)
    and one a decode step (cross-attention, one query against T keys);
    vlm, one a layer a prefill and none a decode step."""
    arch, _, cfg, _, params = model
    seen = []

    def flash(q, k, v, causal=True):
        seen.append((causal, q.shape[2], k.shape[2]))
        return flash_attention_plain(q, k, v, causal=causal)

    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1, 6, 4).items()}
    toks = batch["tokens"].long()
    if cfg.family == "encdec":
        cache = encdec.init_cache(cfg, 1, MAX_LEN, device="cpu")
        _, cache, memory = encdec.prefill(params, toks, batch["frames"], cfg, cache,
                                          flash=flash)
        t = batch["frames"].shape[1]
        assert sorted(seen) == sorted([(False, t, t)] * cfg.enc_layers
                                      + [(True, 6, 6)] * cfg.dec_layers
                                      + [(False, 6, t)] * cfg.dec_layers)
        seen.clear()
        encdec.decode_step(params, cache, memory, toks[:, :1], 6, cfg, flash=flash)
        assert seen == [(False, 1, t)] * cfg.dec_layers
    else:
        cache = vlm.init_cache(cfg, 1, MAX_LEN, device="cpu")
        _, cache = vlm.prefill(params, toks, batch["patches"], cfg, cache, flash=flash)
        s = 6 + cfg.n_patches
        assert seen == [(True, s, s)] * cfg.n_layers
        seen.clear()
        vlm.decode_step(params, cache, toks[:, :1], s, cfg)
        assert seen == []


def test_encdec_state_memory_is_zeros_until_prefill():
    cfg = reduced(get_config("seamless-m4t-medium"), **SMALL)
    api = registry.get_api(cfg, device="cpu")
    params = api.init(cfg, torch.Generator().manual_seed(0))
    st = api.make_serve_state(cfg, 2, MAX_LEN)
    assert st["memory"].shape == (2, MAX_LEN, cfg.d_model) and not st["memory"].any()
    _, st = api.prefill(params, _batch(cfg, 2, 4, 5), st, cfg)
    assert st["memory"].shape == (2, 13, cfg.d_model) and bool(st["memory"].isfinite().all())
