"""The port's int8 arithmetic against the JAX package's.

Link quantize-dequantize (``nn/quant.py``) and the int8 weights of
``quantize_params`` are held bit for bit: both sides compute the same f32
operations and round half to even.  ``apply_int8`` is held at 1e-4 of
the logits' scale against the reference's plain (lax) path, at 32x32 and
10 classes, and the port's staged int8 forward equals its monolithic one
bit for bit.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro.nn import quant as ref_quant  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.nn import quant  # noqa: E402

FAMILIES = ("mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34")
# The cross-framework cases: every layer kind (KPU, depthwise, FCU, dense
# head).  The reference quantizes eagerly, one XLA compile per op and
# weight shape, so MobileNetV1 and ResNet-34 (no new kind) stay port-only.
REF_FAMILIES = ("mobilenet_v2", "resnet18")
HW = (32, 32)
TOL = 1e-4


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _tensors(seed):
    """Cut-sized activations of several scales and signs (post-ReLU
    ones, a wide range, a constant), as numpy f32."""
    rng = np.random.default_rng(seed)
    shapes = [(2, 8, 8, 24), (2, 4, 4, 96), (2, 16, 16, 32), (2, 2, 2, 320), (2, 1000)]
    out = []
    for i, shape in enumerate(shapes):
        x = rng.standard_normal(shape).astype(np.float32) * 10.0 ** rng.uniform(-3, 3)
        if i % 2:
            x = np.maximum(x, 0.0)
        out.append(x.astype(np.float32))
    return out


@pytest.mark.parametrize("seed", range(10))
def test_link_quant_matches_reference_bit_for_bit(seed):
    for x in _tensors(seed):
        want = ref_quant.quantize_link(jnp.asarray(x))
        got = quant.quantize_link(torch.from_numpy(x))
        assert got["__q__"].dtype == torch.int8 and got["__s__"].dtype == torch.float32
        assert got["__s__"].dim() == 0
        assert _bits(got["__q__"]) == _bits(want["__q__"])
        assert _bits(got["__s__"]) == _bits(want["__s__"])
        assert _bits(quant.dequantize_link(got)) == _bits(ref_quant.dequantize_link(want))
        assert _bits(quant.fake_quant_link(torch.from_numpy(x))) == _bits(
            ref_quant.fake_quant_link(jnp.asarray(x)))


def test_link_quant_rounds_ties_to_even():
    """amax = 127 makes the scale exactly 1, so x / s lands on .5 ties:
    both sides round them to the even neighbour."""
    x = np.array([127.0, 2.5, -2.5, 3.5, 0.5, 1.5, -0.5, 126.5], np.float32)
    got = quant.quantize_link(torch.from_numpy(x))
    assert got["__s__"].item() == 1.0
    assert got["__q__"].tolist() == [127, 2, -2, 4, 0, 2, 0, 126]
    assert _bits(got["__q__"]) == _bits(ref_quant.quantize_link(jnp.asarray(x))["__q__"])


def test_link_quant_edges():
    zeros = torch.zeros((2, 3))
    got = quant.quantize_link(zeros)
    assert _bits(got["__s__"]) == _bits(ref_quant.quantize_link(jnp.zeros((2, 3)))["__s__"])
    assert torch.equal(quant.dequantize_link(got), zeros)
    with pytest.raises(ValueError, match="int8"):
        quant.quantize_link(zeros, bits=4)
    x = torch.from_numpy(_tensors(3)[0])
    y = quant.fake_quant_link(x.to(torch.bfloat16), dtype=torch.bfloat16)
    assert y.dtype == torch.bfloat16
    want = ref_quant.fake_quant_link(jnp.asarray(x.numpy()).astype(jnp.bfloat16),
                                     dtype=jnp.bfloat16)
    assert _bits(y.view(torch.int16)) == _bits(np.asarray(want).view(np.int16))


def _pair(family, seed=0):
    """Both packages' API and config, the same weights (drawn by the port,
    carried to the reference as numpy arrays) and the same frames."""
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc = ra.make_config(input_hw=HW, num_classes=10)
    pc = pa.make_config(input_hw=HW, num_classes=10)
    pp = pa.init(pc, torch.Generator().manual_seed(seed))
    rp = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()} for n, p in pp.items()}
    x = np.random.default_rng(seed).standard_normal((2, *HW, 3)).astype(np.float32)
    return ra, rc, rp, pa, pc, pp, x


@pytest.mark.parametrize("family", REF_FAMILIES)
def test_quantize_params_match_reference_bit_for_bit(family):
    ra, rc, rp, pa, pc, pp, x = _pair(family)
    rq, rs = ra.quantize(rp)
    q, s = pa.quantize(pp)
    assert sorted(q) == sorted(rq) == sorted(s)
    for name in q:
        assert q[name]["w"].dtype == torch.int8
        assert _bits(q[name]["w"]) == _bits(rq[name]["w"]), name
        assert _bits(s[name]) == _bits(rs[name]), name
        assert torch.equal(q[name]["b"], pp[name]["b"])
    deq = cnn.dequantize_params(q, s)
    ref_deq = ref_cnn.dequantize_params(rq, rs)
    for name in deq:
        assert _bits(deq[name]["w"]) == _bits(ref_deq[name]["w"]), name


def test_quantize_a_wide_conv_weight_bit_for_bit():
    w = (np.random.default_rng(7).standard_normal((3, 3, 64, 128)) * 0.05).astype(np.float32)
    b = np.zeros((128,), np.float32)
    rq, rs = ref_cnn.quantize_params({"c": {"w": jnp.asarray(w), "b": jnp.asarray(b)}})
    q, s = cnn.quantize_params({"c": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}})
    assert _bits(q["c"]["w"]) == _bits(rq["c"]["w"])
    assert _bits(s["c"]) == _bits(rs["c"])


def test_dequantize_params_hands_the_forward_its_dtype():
    """The reference's bf16 dequantize promotes to f32 (a bf16 array times a
    0-d f32 array); the port takes the same f32 product and casts it to
    the forward's dtype, so its bf16 weights are the reference's rounded
    once to bf16."""
    ra, rc, rp, pa, pc, pp, x = _pair("resnet18")
    rq, rs = ra.quantize(rp)
    q, s = pa.quantize(pp)
    ref_w = ref_cnn.dequantize_params(rq, rs, dtype=jnp.bfloat16)["fc"]["w"]
    assert ref_w.dtype == jnp.float32  # the reference's promotion (ROADMAP Queue 3)
    got = cnn.dequantize_params(q, s, dtype=torch.bfloat16)["fc"]["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.from_numpy(np.array(ref_w)).to(torch.bfloat16))


@pytest.mark.parametrize("family", REF_FAMILIES)
def test_apply_int8_matches_reference(family):
    """The port's planned int8 forward (its kernels' plain versions on the
    CPU) against the reference's plain path, at the kernel tests' 1e-4 of
    the logits' scale."""
    ra, rc, rp, pa, pc, pp, x = _pair(family, seed=1)
    rq, rs = ra.quantize(rp)
    want = np.asarray(ra.apply_int8(rq, rs, jnp.asarray(x), rc))
    q, s = pa.quantize(pp)
    got = pa.apply_int8(q, s, torch.from_numpy(x), pc, plan=pa.plan(pc, Fraction(3)))
    assert tuple(got.shape) == (2, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("family", FAMILIES)
def test_apply_int8_staged_equals_monolithic(family):
    pa = get_cnn_api(family, device="cpu")
    pc = pa.make_config(input_hw=HW, num_classes=10)
    params = pa.init(pc, torch.Generator().manual_seed(4))
    q, s = pa.quantize(params)
    x = torch.randn((3, *HW, 3), generator=torch.Generator().manual_seed(5))
    for n_stages in (2, 3):
        gp = pa.partition(pc, Fraction(3), n_stages)
        kp = gp.kernel_plan(batch=3)
        mono = pa.apply_int8(q, s, x, pc, plan=kp)
        staged = pa.apply_int8(q, s, x, pc, plan=kp, partition=gp)
        assert torch.equal(mono, staged), n_stages
    assert torch.equal(pa.apply_int8(q, s, x, pc),
                       pa.apply(cnn.dequantize_params(q, s), x, pc))
