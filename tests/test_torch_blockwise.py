"""The port's blockwise attention route (``nn/attention.py::_attend_blockwise``,
``AttnSpec.impl``) against the JAX package on the CPU.

The grid of the reference's own ``test_blockwise_equals_dense`` (sequence
32 / 64 / 96, window 0 / 8 / 16, 1 / 2 / 4 kv heads, 4 heads of 8, q and k
blocks of 16): the port's blockwise layer within 1e-4 of the reference's
and within the reference test's 2e-5 of the port's dense one.  The
``auto`` rule picks the route the reference picks for each (Sq, Sk,
dense_max), and gemma3's prefill through the blockwise route matches the
reference's and the port's dense route.  fp32.
"""
import dataclasses
import functools
import itertools

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
from repro_torch.models import lm  # noqa: E402
from repro_torch.nn import attention as port_attn  # noqa: E402

TOL = 1e-4
D_MODEL, HEADS, DH = 32, 4, 8


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _params(nkv):
    p = ref_attn.init_attention(jax.random.key(0), D_MODEL, HEADS, nkv, DH)
    return {n: np.asarray(a) for n, a in p.items()}


@functools.cache
def _ref_blockwise(nkv):
    """The reference's blockwise layer for ``nkv`` kv heads, jitted once
    (the window is traced, as the reference's layer stacks pass it)."""
    spec = ref_attn.AttnSpec(n_heads=HEADS, n_kv=nkv, head_dim=DH, impl="blockwise",
                             q_block=16, k_block=16)
    return jax.jit(lambda p, x, pos, w: ref_attn.attention(p, x, pos, spec, window=w)[0])


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("seq,window,nkv", list(itertools.product((32, 64, 96), (0, 8, 16),
                                                                   (1, 2, 4))))
def test_blockwise_matches_jax_and_dense(monkeypatch, seq, window, nkv):
    p = _params(nkv)
    x = np.random.default_rng(seq + window + nkv).standard_normal(
        (2, seq, D_MODEL)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq), (2, seq)).copy()
    kw = dict(n_heads=HEADS, n_kv=nkv, head_dim=DH, q_block=16, k_block=16)
    want = _ref_blockwise(nkv)({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                               jnp.asarray(pos), jnp.asarray(window, jnp.int32))
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    # positions given on the host and checked: the kernel route stays out
    # of the way only with a window, so hold the masked routes directly
    monkeypatch.setattr(port_attn, "_positions_from_zero", lambda *a: False)
    scored = []
    _spy(monkeypatch, port_attn, "_scores", scored)
    got, _ = port_attn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                                 port_attn.AttnSpec(impl="blockwise", **kw), window=window)
    dense, _ = port_attn.attention(tp, torch.from_numpy(x), torch.from_numpy(pos),
                                   port_attn.AttnSpec(impl="dense", **kw), window=window)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-5, atol=2e-5)
    # key blocks wholly under the causal (and window) mask are skipped
    n = seq // 16
    full = n * (n + 1) // 2 if not window else sum(min(i + 1, 1 + -(-window // 16))
                                                   for i in range(n))
    assert len(scored) == full + 1             # + the dense call's one


@pytest.mark.parametrize("sq,smax,dense_max", [(4, 64, 16), (4, 64, 15), (1, 256, 16),
                                               (1, 257, 16), (8, 32, 16), (8, 33, 16)])
def test_auto_picks_the_references_route(monkeypatch, sq, smax, dense_max):
    """A cached call from position 3 (off the kernel route): dense while
    Sq·Smax <= dense_max², blockwise above, on both sides, same output."""
    p = _params(2)
    rng = np.random.default_rng(sq * smax)
    x = rng.standard_normal((2, sq, D_MODEL)).astype(np.float32)
    cache = [rng.standard_normal((2, smax, 2, DH)).astype(np.float32) for _ in range(2)]
    pos = np.broadcast_to(np.arange(3, 3 + sq), (2, sq)).copy()
    kw = dict(n_heads=HEADS, n_kv=2, head_dim=DH, q_block=4, k_block=16,
              dense_max=dense_max)
    ref_calls, calls = [], []
    for name in ("_attend_dense", "_attend_blockwise"):
        _spy(monkeypatch, ref_attn, name, ref_calls)
        _spy(monkeypatch, port_attn, name, calls)
    want, _ = ref_attn.attention({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                                 jnp.asarray(pos), ref_attn.AttnSpec(**kw),
                                 kv_cache=tuple(map(jnp.asarray, cache)),
                                 cache_len=jnp.asarray(3, jnp.int32))
    got, _ = port_attn.attention({n: torch.from_numpy(a) for n, a in p.items()},
                                 torch.from_numpy(x), torch.from_numpy(pos),
                                 port_attn.AttnSpec(**kw),
                                 kv_cache=tuple(torch.from_numpy(c) for c in cache),
                                 cache_len=3)
    assert calls == ref_calls == [
        "_attend_dense" if sq * smax <= dense_max ** 2 else "_attend_blockwise"]
    _close(got, want)


def test_gemma3_prefill_on_the_blockwise_route_matches_jax(monkeypatch):
    """Reduced gemma3 (window 8; local and global layers in turn) with
    dense_max 16 on both sides: a 48-token prefill takes the blockwise
    route in every local layer (and in the reference's global ones, where
    the port runs its kernel route), against the reference and against
    the port's dense route."""
    small = dict(layers=4, d_model=64, vocab=128)
    ref_cfg = ref_reduced(ref_get_config("gemma3-1b"), **small)
    cfg = reduced(get_config("gemma3-1b"), **small)
    for mod in (ref_lm, lm):
        spec_of = mod._attn_spec
        monkeypatch.setattr(mod, "_attn_spec", lambda c, spec_of=spec_of: dataclasses.replace(
            spec_of(c), dense_max=16, q_block=8, k_block=16))
    params = jax.tree.map(np.asarray, ref_lm.init(ref_cfg, jax.random.key(0)))
    tparams = lm.params_from_reference(params, cfg, "cpu")
    toks = np.random.default_rng(5).integers(0, 128, (1, 48)).astype(np.int32)
    want, _ = ref_lm.prefill(jax.tree.map(jnp.asarray, params), jnp.asarray(toks), ref_cfg,
                             ref_lm.init_cache(ref_cfg, 1, 64))
    calls = []
    _spy(monkeypatch, port_attn, "_attend_blockwise", calls)
    got, _ = lm.prefill(tparams, torch.from_numpy(toks).long(), cfg,
                        lm.init_cache(cfg, 1, 64, device="cpu"))
    assert len(calls) == sum(cfg.window_for_layer(i) > 0 for i in range(cfg.n_layers)) == 2
    _close(got, want)
    spec_of = lm._attn_spec
    monkeypatch.setattr(lm, "_attn_spec", lambda c: dataclasses.replace(spec_of(c),
                                                                        impl="dense"))
    dense, _ = lm.prefill(tparams, torch.from_numpy(toks).long(), cfg,
                          lm.init_cache(cfg, 1, 64, device="cpu"))
    assert len(calls) == 2
    _close(got, dense.numpy())
