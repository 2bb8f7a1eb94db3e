"""The port's training path against the JAX package on the CPU.

For each family — qwen2-style dense LM (qkv bias, untied head),
gemma3-style windowed LM, grok-1-style MoE, mamba2, zamba2, seamless
encdec and internvl2 vlm — ``get_api(cfg, device="cpu").loss_fn`` and
``torch.autograd.grad`` against ``jax.value_and_grad`` of the JAX
package's ``loss_fn`` on the same weights (the reference's ``init``, norm
scales then drawn from numpy, loaded through each family's
``params_from_reference``; the reference's grads converted the same way),
at ``reduced(..., layers=2, d_model=64, vocab=256)``, f32, 2 rows of 32
tokens with some labels masked.  The loss is held at 1e-5 relative and
every gradient leaf at 1e-4 of that leaf's largest magnitude.

Also: remat on and off give the same loss and grads; under autograd no
kernel route is taken (recording ``flash`` / ``ssd`` stand-ins), while
prefill still takes it; the kernel wrappers refuse a call autograd would
record; two ``build_train_step`` steps at ``grad_accum`` 2 against the
reference's; ``loss_fn`` refuses an int8 tree.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.launch import train as ref_train  # noqa: E402
from repro.models.registry import get_api as ref_get_api  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels import dw_conv, fcu_matmul, flash_attention  # noqa: E402
from repro_torch.kernels import kpu_conv, ssd_chunk  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import encdec, hybrid, lm, mamba, registry, vlm  # noqa: E402
from repro_torch.nn import attention as attention_mod  # noqa: E402
from repro_torch.nn import ssm as ssm_mod  # noqa: E402
from repro_torch.nn.embeddings import embed, unembed  # noqa: E402
from repro_torch.nn.norms import rms_norm  # noqa: E402
from repro_torch.nn.quant import quantize_tree  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.tree import leaves, records_grad  # noqa: E402

SMALL = dict(layers=2, d_model=64, vocab=256)
B, S = 2, 32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
FAMILY_MOD = {"lm": lm, "ssm": mamba, "hybrid": hybrid, "encdec": encdec, "vlm": vlm}
ARCHS = ["qwen2-7b", "gemma3-1b", "grok-1-314b", "mamba2-780m", "zamba2-1.2b",
         "seamless-m4t-medium", "internvl2-2b"]


def _norms_from_numpy(tree, rng):
    """Norm scales (every leaf named ln*, *_norm, norm_scale) drawn around 1."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _norms_from_numpy(leaf, rng)
        elif name.startswith("ln") or name.endswith("norm") or name == "norm_scale":
            tree[name] = rng.normal(1, 0.2, leaf.shape).astype(np.float32)


def _batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    st = s - cfg.n_patches if cfg.family == "vlm" else s
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, st)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, st)).astype(np.int32)}
    batch["labels"][0, :3] = -1                      # masked positions
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, 13, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return batch


def _configs(arch, **over):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch), **SMALL), **over)
    cfg = dataclasses.replace(reduced(get_config(arch), **SMALL), **over)
    return ref_cfg, cfg


def _ref_params(ref_cfg):
    params = jax.tree.map(np.asarray, ref_get_api(ref_cfg).init(ref_cfg, jax.random.key(0)))
    _norms_from_numpy(params, np.random.default_rng(0))
    return params


def _port(tree, cfg):
    return FAMILY_MOD[cfg.family].params_from_reference(tree, cfg, "cpu")


def _grads(api, params, batch, cfg):
    loss, metrics = api.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves(params), materialize_grads=True)
    return loss, metrics, grads


def _assert_grads_close(got, want_tree, cfg, tol=GRAD_TOL):
    want = leaves(_port(want_tree, cfg))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = w.numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    ref_cfg, cfg = _configs(request.param)
    ref_params = _ref_params(ref_cfg)
    return ref_cfg, cfg, ref_params


def test_loss_and_grads_match_jax(family):
    ref_cfg, cfg, ref_params = family
    batch = _batch(cfg, 1)
    ref_api = ref_get_api(ref_cfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_api.loss_fn(p, b, ref_cfg), has_aux=True))
    (want_loss, want_metrics), want_grads = fn(jax.tree.map(jnp.asarray, ref_params),
                                               jax.tree.map(jnp.asarray, batch))
    api = registry.get_api(cfg, device="cpu")
    params = train.trainable(_port(ref_params, cfg))
    loss, metrics, grads = _grads(api, params, batch, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(want_metrics["ce"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(metrics["aux"].detach()), float(want_metrics["aux"]),
                               rtol=LOSS_TOL, atol=1e-7)
    _assert_grads_close(grads, jax.tree.map(np.asarray, want_grads), cfg)


def test_remat_on_and_off_agree(family):
    _, cfg, ref_params = family
    batch = _batch(cfg, 2)
    out = {}
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        api = registry.get_api(c, device="cpu")
        out[remat] = _grads(api, train.trainable(_port(ref_params, c)), batch, c)
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(out[True][2], out[False][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-7b", "zamba2-1.2b", "seamless-m4t-medium"])
def test_no_kernel_route_under_autograd(arch, monkeypatch):
    """Stand-ins for the flash and SSD kernels record every call: loss plus
    backward (remat on) calls neither; a prefill on the same params,
    outside autograd, calls them."""
    _, cfg = _configs(arch, remat=True)
    calls = []

    def flash(q, k, v, causal=True):
        calls.append("flash")
        return flash_attention.flash_attention_plain(q, k, v, causal=causal)

    def ssd(*args, **kw):
        calls.append("ssd")
        return ssd_chunk.ssd_chunk_plain(*args, **kw)

    monkeypatch.setattr(attention_mod, "attention_impl", lambda: flash)
    monkeypatch.setattr(ssm_mod, "ssd_chunk", ssd)
    api = registry.get_api(cfg, device="cpu")
    params = api.init(cfg, torch.Generator().manual_seed(0))
    batch = _batch(cfg, 3)
    _, _, grads = _grads(api, train.trainable(params), batch, cfg)
    assert calls == [] and all(bool(g.ne(0).any()) for g in grads)
    state = api.make_serve_state(cfg, B, S)
    with torch.no_grad():
        api.prefill(params, batch, state, cfg)
    want = {"lm": {"flash"}, "hybrid": {"flash", "ssd"}, "encdec": {"flash"}}[cfg.family]
    assert set(calls) == want


KERNEL_CALLS = {
    "fcu_matmul": lambda x: fcu_matmul.fcu_matmul(x, torch.ones(8, 8), bm=4, bk=8, bn=8),
    "kpu_conv": lambda x: kpu_conv.kpu_conv(x.reshape(1, 2, 2, 8), torch.ones(3, 3, 8, 8),
                                            stride=1, bm=4, bci=8, bco=8),
    "dw_conv": lambda x: dw_conv.dw_conv(x.reshape(1, 2, 2, 8), torch.ones(3, 3, 8),
                                         stride=1, bm=2, bc=8),
    "flash_attention": lambda x: flash_attention.flash_attention(
        x.reshape(1, 2, 1, 16), *[torch.ones(1, 1, 1, 16)] * 2, block_q=16, block_k=16),
    "ssd_chunk": lambda x: ssd_chunk.ssd_chunk(
        x.reshape(1, 16, 1, 2), torch.ones(1, 16, 1), -torch.ones(1),
        *[torch.ones(1, 16, 1, 2)] * 2, chunk=16),
}


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_wrappers_refuse_what_autograd_would_record(name):
    """A grad-requiring operand with grad enabled raises, naming the kernel,
    on the CPU before any dispatch; under ``torch.no_grad()`` the same call
    runs (here, the plain version), and a launch counter never moves."""
    x = torch.rand(4, 8, requires_grad=True)
    fn = KERNEL_CALLS[name]
    assert records_grad(x)
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
        fn(x)
    with torch.no_grad():
        assert not records_grad(x)
        out = fn(x)
    want = fn(x.detach())
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (out, want))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma3-1b", "mamba2-780m"])
def test_train_step_matches_jax_at_grad_accum_2(arch):
    """Two ``build_train_step`` steps (2 microbatches of 2 rows each, f32
    accumulator, the configs' AdamW) against the JAX package's jitted
    step: losses at 1e-5 relative, grad norms at 1e-4, every param at
    1e-4 of its scale (the per-layer norm scales and biases decayed as the
    reference's stacked ``[L, d]`` leaves are).  ``eps`` is 1e-3, which
    makes Adam's step Lipschitz in the gradient: at 1e-8 a gradient
    element near zero (qwen2's key bias on the slow RoPE pairs, a few
    elements of gemma3's wk) moves by ±lr on its sign, which the two
    frameworks' last-bit differences decide."""
    ref_cfg, cfg = _configs(arch, grad_accum=2)
    ref_params = _ref_params(ref_cfg)
    adam_kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-3)
    ref_step = jax.jit(ref_train.build_train_step(
        ref_cfg, ref_train.adam_config_for(ref_cfg, **adam_kw)))
    adam = train.adam_config_for(cfg, **adam_kw)
    step = train.build_train_step(cfg, adam, device="cpu")
    rp = jax.tree.map(jnp.asarray, ref_params)
    rs = ref_opt.init(ref_train.adam_config_for(ref_cfg, **adam_kw), rp)
    params = train.trainable(_port(ref_params, cfg))
    state = opt.init(adam, params)
    for i in range(2):
        batch = _batch(cfg, 10 + i, b=4)
        rp, rs, rm = ref_step(rp, rs, jax.tree.map(jnp.asarray, batch))
        params, state, m = step(params, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-4)
        assert int(state.step) == int(rs.step) == i + 1
    _assert_grads_close([p.detach() for p in leaves(params)],
                        jax.tree.map(np.asarray, rp), cfg)


def test_loss_fn_refuses_an_int8_tree():
    cfg = reduced(get_config("internvl2-2b"), **SMALL)
    api = registry.get_api(cfg, device="cpu")
    params = quantize_tree(api.init(cfg, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="int8 serve weights"):
        api.loss_fn(params, _batch(cfg, 4), cfg)


def test_tied_embedding_takes_both_gradients():
    """gemma3's one table gets the gather's gradient and the head's: the
    grad of the tied leaf is the sum of the two, each taken alone."""
    _, cfg = _configs("gemma3-1b")
    api = registry.get_api(cfg, device="cpu")
    params = train.trainable(api.init(cfg, torch.Generator().manual_seed(0)))
    batch = _batch(cfg, 5)
    loss, _ = api.loss_fn(params, batch, cfg)
    (tied,) = torch.autograd.grad(loss, [params["embed"]])
    table = params["embed"]
    split = dict(params, embed=table.detach().clone().requires_grad_(True))
    head = table.detach().clone().requires_grad_(True)
    toks = torch.as_tensor(batch["tokens"]).long()
    x, aux = lm.layer_groups(split, embed(split["embed"], toks), cfg)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = unembed(head, x)
    loss2 = lm.cross_entropy(logits, torch.as_tensor(batch["labels"]).long()) + 0.01 * aux
    g_gather, g_head = torch.autograd.grad(loss2, [split["embed"], head])
    assert bool(g_gather.ne(0).any()) and bool(g_head.ne(0).any())
    np.testing.assert_allclose(tied.numpy(), (g_gather + g_head).numpy(),
                               rtol=1e-5, atol=1e-7)


def test_ssd_scan_gradient_is_finite_where_the_references_is_nan():
    """Past exp's range above the diagonal (dt·a summed over a chunk below
    -88), the JAX package's default streaming scan masks ``exp(diff)``
    after the exp and its gradient is NaN (0 x inf); the scan the port
    trains through (``ssd_chunked``, the reference's vectorized form)
    masks before the exp: the same forward values, a finite gradient."""
    from repro.nn.ssm import ssd_chunked_streaming

    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 32, 2, 4)).astype(np.float32)
    dt = np.full((1, 32, 2), 2.0, np.float32)
    a = np.array([-40.0, -60.0], np.float32)
    b, c = (rng.standard_normal((1, 32, 1, 8)).astype(np.float32) for _ in range(2))
    want, ref_grad = jax.value_and_grad(
        lambda dt: ssd_chunked_streaming(x, dt, a, b, c, chunk=16)[0].sum())(dt)
    assert np.isnan(np.asarray(ref_grad)).any()
    dtt = torch.from_numpy(dt).requires_grad_(True)
    y, _ = ssm_mod.ssd_chunked(torch.from_numpy(x), dtt,
                               *(torch.from_numpy(t) for t in (a, b, c)), chunk=16)
    (g,) = torch.autograd.grad(y.sum(), [dtt])
    assert bool(torch.isfinite(g).all()) and bool(g.ne(0).any())
    np.testing.assert_allclose(float(y.sum().detach()), float(want), rtol=1e-5)
