"""Int8 serve weights (``serve_weight_quant``) in the port, against the JAX
package's ``nn/quant.py`` and its LM / VLM serve paths on the CPU.

``quantize_tree`` runs on the JAX package's stacked tree and on the
port's per-layer tree of the same weights: the int8 values and the
scales must be bit for bit the same, leaf for leaf, and so must
``dequantize_tree``.  At d_model 64 the per-layer matrices are 2-D, which
the reference's 2-D rule (embedding tables: both dims >= 1024) would
skip; the reference quantizes them as stacked ``[L, ...]`` leaves, and so
must the port.  At d_model 1024 with a 1024-token vocabulary the
embedding table is quantized too.  Served from int8 trees, internvl2 and
a dense LM are held at 1e-4 of their logits' scale (fp32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import reduced as ref_reduced  # noqa: E402
from repro.models.registry import get_api as ref_get_api  # noqa: E402
from repro.nn import quant as ref_quant  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.models import lm, registry  # noqa: E402
from repro_torch.nn import quant  # noqa: E402

TOL = 1e-4
SIZES = {"d64": dict(layers=2, d_model=64, vocab=128),
         "d1024": dict(layers=2, d_model=1024, vocab=1024)}


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _ref_tree(arch, size, **change):
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch), **SIZES[size]), **change)
    cfg = dataclasses.replace(reduced(get_config(arch), **SIZES[size]), **change)
    params = jax.tree.map(np.asarray, ref_get_api(ref_cfg).init(ref_cfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    for name in ("ln1", "ln2"):
        leaf = params["blocks_dense"][name]
        params["blocks_dense"][name] = rng.normal(1, 0.2, leaf.shape).astype(np.float32)
    return ref_cfg, cfg, params


def _per_layer(ref_q, i):
    """Layer i of the reference's quantized stacked blocks, as numpy."""
    if isinstance(ref_q, dict):
        return {k: _per_layer(v, i) for k, v in ref_q.items()}
    return np.asarray(ref_q)[i]


def _assert_bits(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_bits(got[k], want[k])
        return
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("size", sorted(SIZES))
def test_quantize_tree_is_the_references_bit_for_bit(size):
    ref_cfg, cfg, params = _ref_tree("internvl2-2b", size)
    want = jax.tree.map(np.asarray, ref_quant.quantize_tree(params))
    got = quant.quantize_tree(lm.params_from_reference(params, cfg, "cpu"))
    for name in ("embed", "final_norm"):
        _assert_bits(got[name], want[name])
    assert quant._is_qleaf(got["embed"]) == (size == "d1024")
    for i, block in enumerate(got["blocks"]):
        _assert_bits(block, _per_layer(want["blocks_dense"], i))
        assert quant._is_qleaf(block["attn"]["wq"]) and not quant._is_qleaf(block["ln1"])
    assert quant.is_quantized(got) and not quant.is_quantized(
        lm.params_from_reference(params, cfg, "cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_dequantize_tree_is_the_references_bit_for_bit(dtype):
    _, cfg, params = _ref_tree("internvl2-2b", "d1024")
    ref_q = ref_quant.quantize_tree(params)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax.tree.map(np.asarray, ref_quant.dequantize_tree(ref_q, jdt))
    got = quant.dequantize_tree(quant.quantize_tree(lm.params_from_reference(params, cfg, "cpu")),
                                dtype)
    assert got["embed"].dtype == dtype
    want_embed = np.asarray(want["embed"], np.float32)
    assert np.array_equal(got["embed"].float().numpy(), want_embed)
    for i, block in enumerate(got["blocks"]):
        ref_block = _per_layer(want["blocks_dense"], i)
        for name in ("wq", "wk", "wv", "wo"):
            assert np.array_equal(block["attn"][name].float().numpy(),
                                  np.asarray(ref_block["attn"][name], np.float32))


def test_tree_bytes_are_the_references():
    _, cfg, params = _ref_tree("internvl2-2b", "d1024")
    port = quant.quantize_tree(lm.params_from_reference(params, cfg, "cpu"))
    assert quant.tree_bytes(port) == ref_quant.tree_bytes(ref_quant.quantize_tree(params))
    assert quant.tree_bytes(port) < 0.3 * quant.tree_bytes(
        lm.params_from_reference(params, cfg, "cpu"))


@pytest.mark.parametrize("arch,size", [("internvl2-2b", "d64"), ("internvl2-2b", "d1024"),
                                       ("deepseek-coder-33b", "d64")])
def test_served_from_int8_weights_like_jax(arch, size):
    """A prefill and 3 greedy decode steps through ``get_api`` on the
    reference's quantized tree (deepseek-coder-33b with
    ``serve_weight_quant`` set)."""
    ref_cfg, cfg, params = _ref_tree(arch, size, serve_weight_quant=True, kv_quant=False)
    ref_q = jax.tree.map(np.asarray, ref_quant.quantize_tree(params))
    port = lm.params_from_reference(ref_q, cfg, "cpu")
    assert quant.is_quantized(port)
    ref_api, api = ref_get_api(ref_cfg), registry.get_api(cfg, device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    ref_params = jax.tree.map(jnp.asarray, ref_q)
    want, ref_state = ref_api.prefill(ref_params, jax.tree.map(jnp.asarray, batch),
                                      ref_api.make_serve_state(ref_cfg, 2, 32), ref_cfg)
    got, state = api.prefill(port, batch, api.make_serve_state(cfg, 2, 32), cfg)
    _close(got, want)
    pos = 9 + cfg.n_patches
    for step in range(3):
        tok = np.array(jnp.argmax(want[:, -1], axis=-1), np.int32)[:, None]
        want, ref_state = ref_api.decode(ref_params, ref_state, {"tokens": jnp.asarray(tok)},
                                         jnp.asarray(pos + step, jnp.int32), ref_cfg)
        got, state = api.decode(port, state, {"tokens": tok}, pos + step, cfg)
        _close(got, want)
