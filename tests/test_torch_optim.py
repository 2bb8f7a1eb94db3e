"""The port's optimizer and schedules against the JAX package's.

* the three schedules at steps 0..19, f32, at 1e-6 relative;
* 5 steps of ``apply_updates`` on one random tree (a matrix, a 3-D stack
  and a vector; the same numpy grads each step) in four variants: f32
  moments; bf16 params and moments; factored with ``momentum=False``; and
  clipping active — f32 leaves at 1e-6 relative, bf16 leaves within one
  bf16 ulp;
* a port tree of per-layer dicts against the reference's stacked tree:
  the port judges a leaf in a layer list by its stacked rank (decay on
  per-layer vectors; factored statistics over the layers);
* ``accumulate_grads`` with ``n_micro`` 1 and 2, ``acc_dtype`` f32 and
  bf16;
* the reference's ``test_adamw_converges_quadratic`` on the port.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.optim import optimizers as ref_opt  # noqa: E402
from repro.optim import schedules as ref_sched  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

F32_TOL = 1e-6


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x, np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 bits of mantissa)."""
    x = np.abs(np.asarray(x, np.float32))
    e = np.floor(np.log2(np.maximum(x, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _close(got, want, dtype):
    """bf16: within one bf16 ulp; f32: at 1e-6 relative, and 1e-6 of the
    leaf's scale for elements near zero (sums in another order)."""
    got, want = _np(got), _np(want)
    if dtype == "bfloat16":
        assert np.all(np.abs(got - want) <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want))))
    else:
        np.testing.assert_allclose(got, want, rtol=F32_TOL,
                                   atol=F32_TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear", "constant"])
def test_schedules_match_jax(name):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=17)
    if name == "warmup_cosine":
        kw["min_ratio"] = 0.2
    for step in range(20):
        want = getattr(ref_sched, name)(jnp.asarray(step), **kw)
        got = getattr(schedules, name)(step, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=F32_TOL)


VARIANTS = {
    "f32": dict(),
    "bf16": dict(mu_dtype="bfloat16", nu_dtype="bfloat16"),
    "factored_no_momentum": dict(factored=True, momentum=False),
    "clipped": dict(clip_norm=0.05),
}


def _tree(rng, dtype):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "stack": rng.standard_normal((3, 8, 16)).astype(np.float32),
            "v": rng.standard_normal((16,)).astype(np.float32)}


def _to_jax(tree, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _to_torch(tree, dtype):
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in tree.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_updates_matches_jax(variant):
    dtype = "bfloat16" if variant == "bf16" else "float32"
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **VARIANTS[variant])
    ref_cfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = _tree(rng, dtype)
    rp = _to_jax(p0, jnp.dtype(dtype))
    params = _to_torch(p0, getattr(torch, dtype))
    rs, state = ref_opt.init(ref_cfg, rp), opt.init(cfg, params)
    step = jax.jit(functools.partial(ref_opt.apply_updates, ref_cfg))
    for _ in range(5):
        g = _tree(rng, dtype)
        rp, rs, rm = step(rp, _to_jax(g, jnp.dtype(dtype)), rs)
        params, state, m = opt.apply_updates(cfg, params, _to_torch(g, getattr(torch, dtype)),
                                             state)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]), rtol=F32_TOL)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=F32_TOL)
    assert int(state.step) == int(rs.step) == 5
    for k in p0:
        assert params[k].dtype == getattr(torch, dtype)
        _close(params[k], rp[k], dtype)
        if cfg.momentum:
            _close(state.mu[k], rs.mu[k], kw.get("mu_dtype", "float32"))
        nu, rnu = state.nu[k], rs.nu[k]
        for a, b in zip(nu if isinstance(nu, tuple) else (nu,),
                        rnu if isinstance(rnu, tuple) else (rnu,)):
            assert tuple(a.shape) == tuple(b.shape)
            _close(a, b, kw.get("nu_dtype", "float32"))
    if variant == "clipped":
        assert float(m["grad_norm"]) > 10 * cfg.clip_norm


@pytest.mark.parametrize("factored", [False, True])
def test_layer_lists_follow_the_references_stacked_ranks(factored):
    """A list of per-layer dicts (a dense and a MoE-shaped structure, as
    ``lm``'s blocks interleave them) updates as the reference's stacked
    ``[L, ...]`` leaves, one stack per structure: per-layer vectors are
    rank 2 there (decayed; factored over the layers)."""
    kw = dict(lr=1e-2, warmup_steps=0, factored=factored, momentum=not factored)
    ref_cfg, cfg = ref_opt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    rng = np.random.default_rng(1)
    n = 3

    def stacks(rng):
        return {"blocks_dense": {"ln": rng.standard_normal((n, 8)).astype(np.float32),
                                 "ffn": rng.standard_normal((n, 8, 4)).astype(np.float32)},
                "blocks_moe": {"ln": rng.standard_normal((n, 8)).astype(np.float32),
                               "moe": rng.standard_normal((n, 2, 8, 4)).astype(np.float32)},
                "final_norm": rng.standard_normal((8,)).astype(np.float32)}

    def layers(tree):
        out = {"final_norm": torch.from_numpy(tree["final_norm"].copy())}
        out["blocks"] = [
            {k: torch.from_numpy(np.array(v[i // 2]))
             for k, v in tree["blocks_dense" if i % 2 == 0 else "blocks_moe"].items()}
            for i in range(2 * n)]
        return out

    p0 = stacks(rng)
    rp = jax.tree.map(jnp.asarray, p0)
    params = layers(p0)
    rs, state = ref_opt.init(ref_cfg, rp), opt.init(cfg, params)
    for _ in range(3):
        g = stacks(rng)
        rp, rs, _ = ref_opt.apply_updates(ref_cfg, rp, jax.tree.map(jnp.asarray, g), rs)
        params, state, _ = opt.apply_updates(cfg, params, layers(g), state)
    want = layers(jax.tree.map(np.asarray, rp))
    for got, w in zip(leaves(params), leaves(want)):
        np.testing.assert_allclose(_np(got), _np(w), rtol=F32_TOL, atol=1e-7)


def _lin_loss_jax(params, batch):
    pred = batch["x"] @ params["w"]
    loss = jnp.mean(jnp.square(pred - batch["y"]))
    return loss, {"ce": loss}


def _lin_loss(params, batch):
    pred = torch.as_tensor(batch["x"]) @ params["w"]
    loss = torch.mean(torch.square(pred - torch.as_tensor(batch["y"])))
    return loss, {"ce": loss}


@pytest.mark.parametrize("n_micro,acc", [(1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_accumulate_grads_matches_jax(n_micro, acc):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    batch = {"x": rng.standard_normal((16, 8)).astype(np.float32),
             "y": rng.standard_normal((16, 4)).astype(np.float32)}
    rl, _, rg = ref_opt.accumulate_grads(_lin_loss_jax, {"w": jnp.asarray(w)},
                                         jax.tree.map(jnp.asarray, batch), n_micro,
                                         acc_dtype=jnp.dtype(acc))
    params = {"w": torch.from_numpy(w).requires_grad_(True)}
    loss, metrics, grads = opt.accumulate_grads(_lin_loss, params, batch, n_micro,
                                                acc_dtype=getattr(torch, acc))
    np.testing.assert_allclose(float(loss), float(rl), rtol=F32_TOL)
    assert float(metrics["ce"]) == float(loss)
    want_dtype = "float32" if n_micro == 1 else acc
    assert grads["w"].dtype == getattr(torch, want_dtype)
    _close(grads["w"], rg["w"], want_dtype)


def test_adamw_converges_quadratic():
    cfg = opt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, min_lr_ratio=1.0)
    params = {"w": torch.full((4, 4), 3.0, requires_grad=True),
              "b": torch.ones((4,), requires_grad=True)}
    state = opt.init(cfg, params)

    def quad(p):
        return sum(torch.sum(torch.square(x)) for x in leaves(p))

    for _ in range(200):
        g = dict(zip(sorted(params), torch.autograd.grad(quad(params),
                                                         [params[k] for k in sorted(params)])))
        params, state, _ = opt.apply_updates(cfg, params, g, state)
    assert float(quad(params).detach()) < 1e-2
