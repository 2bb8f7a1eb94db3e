"""The port's three kernel modules against the JAX package's Pallas kernels.

Each case builds a node, plans its Hopper tile, and feeds that tile to
the port's adapter (``conv_impl`` / ``dw_conv_impl`` / ``pointwise_impl``
/ ``dense_impl``); on the CPU the wrapper runs the kernel's plain
PyTorch version.  The same numpy inputs go through the JAX package's
kernel ops in interpret mode, as its own kernel tests run them.  fp32
is held at 1e-4 (``tests/kernels/test_kpu_conv.py``): the two sides sum
in different orders.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from benchmarks.table2_mnv2_rates import PAPER_ROWS  # noqa: E402
from repro.kernels.dw_conv import dw_conv as ref_dw_conv  # noqa: E402
from repro.kernels.fcu_matmul import fcu_matmul as ref_fcu_matmul  # noqa: E402
from repro.kernels.kpu_conv import kpu_conv as ref_kpu_conv  # noqa: E402
from repro_torch.core.dse import select_ours  # noqa: E402
from repro_torch.core.tiles import select_tile_for_impl  # noqa: E402
from repro_torch.kernels.dw_conv import dw_conv_impl  # noqa: E402
from repro_torch.kernels.fcu_matmul import dense_impl, pointwise_impl  # noqa: E402
from repro_torch.kernels.kpu_conv import conv_impl  # noqa: E402
from repro_torch.models.topology import conv_spec, dense_spec  # noqa: E402

TOL = 1e-4


def _planned(spec, rate):
    """The node's Hopper tile from its own DSE choice at ``rate``."""
    return select_tile_for_impl(select_ours(spec, Fraction(rate)))


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _recorder():
    rec = {}
    return rec, lambda **tile: rec.update(tile)


@pytest.mark.parametrize(
    "hw,d_in,d_out,k,stride,rate",
    [
        (9, 3, 64, 7, 2, 3),       # ResNet conv1: d_in=3, 7x7/s2, odd size
        (8, 3, 32, 3, 2, 3),       # MobileNetV2 conv1: SAME pads (0, 1)
        (8, 16, 24, 3, 1, 2),      # ragged 24 outputs, stride 1
        (7, 24, 40, 3, 2, 1),      # odd size, stride 2
        (6, 16, 32, 1, 2, 1),      # strided 1x1 downsample
        (5, 144, 24, 3, 1, Fraction(1, 8)),  # ragged 144 in, tiny rate
    ],
)
def test_kpu_conv_matches_reference(hw, d_in, d_out, k, stride, rate):
    spec, out_hw = conv_spec("c", "conv", d_in, d_out, (hw, hw), k, stride)
    tile = _planned(spec, rate)
    rng = np.random.default_rng(hw * 100 + d_in)
    x = rng.standard_normal((2, hw, hw, d_in)).astype(np.float32)
    w = (rng.standard_normal((k, k, d_in, d_out)) / np.sqrt(k * k * d_in)).astype(
        np.float32)
    rec, record = _recorder()
    got = conv_impl(tile=tile, record=record)(
        torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == (2, *out_hw, d_out)
    assert rec == dict(bk=tile.bk, bn=tile.bn, bm=tile.bm, d_in=d_in, d_out=d_out)
    _close(got.numpy(), ref_kpu_conv(jnp.asarray(x), jnp.asarray(w), stride=stride))


@pytest.mark.parametrize(
    "hw,c,stride,rate",
    [
        (8, 24, 2, 3),             # ragged 24 channels, stride 2, even size
        (9, 144, 1, 2),            # ragged 144, odd size
        (7, 960, 1, Fraction(1, 16)),  # MobileNetV2 b15_dw: j=1 -> bc=32, not 1
        (11, 32, 2, 6),            # odd size, stride 2
    ],
)
def test_dw_conv_matches_reference(hw, c, stride, rate):
    spec, out_hw = conv_spec("d", "dwconv", c, c, (hw, hw), 3, stride)
    tile = _planned(spec, rate)
    assert tile.bk % 8 == 0 and c % tile.bk == 0 and tile.bm % out_hw[1] == 0
    rng = np.random.default_rng(hw * 1000 + c)
    x = rng.standard_normal((2, hw, hw, c)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, c)).astype(np.float32) / 3.0
    rec, record = _recorder()
    got = dw_conv_impl(tile=tile, record=record)(
        torch.from_numpy(x), torch.from_numpy(w), stride)
    assert rec == dict(bk=tile.bk, bn=1, bm=tile.bm, d_in=c, d_out=c)
    _close(got.numpy(), ref_dw_conv(jnp.asarray(x), jnp.asarray(w[:, :, 0, :]),
                                    stride=stride))


def test_dw_conv_rejects_channel_multiplier():
    x = torch.zeros((1, 6, 6, 8))
    w = torch.zeros((3, 3, 1, 16))
    with pytest.raises(NotImplementedError, match="channel_multiplier"):
        dw_conv_impl()(x, w, 1)


@pytest.mark.parametrize(
    "kind,lead,d_in,d_out,rate",
    [
        ("pointwise", (2, 7, 7), 24, 144, 3),      # ragged 24 -> 144
        ("pointwise", (2, 5, 5), 144, 24, 1),      # ragged 144 -> 24, odd m
        ("pointwise", (1, 3, 3), 960, 160, Fraction(1, 4)),
        ("dense", (3,), 1280, 1000, Fraction(1, 16)),  # MobileNetV2 fc: bn=8, not 1
        ("dense", (2,), 512, 1000, 1),
    ],
)
def test_fcu_matmul_matches_reference(kind, lead, d_in, d_out, rate):
    if kind == "dense":
        spec = dense_spec("f", d_in, d_out)
        make = dense_impl
    else:
        spec, _ = conv_spec("p", "pointwise", d_in, d_out, lead[1:], 1, 1)
        make = pointwise_impl
    tile = _planned(spec, rate)
    rng = np.random.default_rng(d_in + d_out)
    x = rng.standard_normal((*lead, d_in)).astype(np.float32)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    rec, record = _recorder()
    got = make(tile=tile, record=record)(torch.from_numpy(x), torch.from_numpy(w))
    m = int(np.prod(lead))
    assert tuple(got.shape) == (*lead, d_out)
    assert (rec["bk"], rec["bn"], rec["m"]) == (tile.bk, tile.bn, m)
    assert m % rec["bm"] == 0 and rec["bm"] <= tile.bm
    _close(got.numpy(), ref_fcu_matmul(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("kind", ["conv", "dwconv", "pointwise"])
def test_uniform_tiles_match_reference(kind):
    """The kind-level adapters without a plan (``select_tile`` under one
    global rate) compute the same function."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    xt = torch.from_numpy(x)
    if kind == "conv":
        w = rng.standard_normal((3, 3, 32, 48)).astype(np.float32) / 17.0
        got = conv_impl(rate=Fraction(2))(xt, torch.from_numpy(w), 2)
        want = ref_kpu_conv(jnp.asarray(x), jnp.asarray(w), stride=2)
    elif kind == "dwconv":
        w = rng.standard_normal((3, 3, 1, 32)).astype(np.float32) / 3.0
        got = dw_conv_impl(rate=Fraction(2))(xt, torch.from_numpy(w), 1)
        want = ref_dw_conv(jnp.asarray(x), jnp.asarray(w[:, :, 0, :]), stride=1)
    else:
        w = rng.standard_normal((32, 48)).astype(np.float32) / 6.0
        got = pointwise_impl(rate=Fraction(2))(xt, torch.from_numpy(w))
        want = ref_fcu_matmul(jnp.asarray(x), jnp.asarray(w))
    _close(got.numpy(), want)


PLAN_RATES = sorted({row[0] for row in PAPER_ROWS}
                    | {Fraction(1, 16), Fraction(1, 8), Fraction(2), Fraction(3),
                       Fraction(64)})


@pytest.mark.parametrize("rate", PLAN_RATES, ids=str)
@pytest.mark.parametrize(
    "family", ["mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34"])
def test_planned_mma_tiles_fit_the_block(family, rate):
    """Every FCU / KPU tile the planner gives, at each rate of the paper's
    MobileNetV2 sweep and the rates the repo drives, is one the
    tensor-core block takes (``check_mma_tile`` raises otherwise, on the
    CPU as on the card); the FCU re-fits bm to a runtime m only downward."""
    from repro_torch.core.graph import plan_graph
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_cnn_api

    api = get_cnn_api(family, device="cpu")
    gp = plan_graph(api.graph(api.make_config()), rate)
    checked = 0
    for name, ip in gp.kernel_plan().items():
        spec = gp.graph.spec(name)
        if ip.tile is None or spec.kind == "dwconv":
            continue
        t = ip.tile
        _build.check_mma_tile(name, t.bm, t.bk, t.bn, spec.d_in, spec.d_out)
        checked += 1
    assert checked > 0


@pytest.mark.parametrize("bm,bn", [(513, 8), (64, 512), (512, 64), (256, 128)])
def test_mma_tile_past_the_block_raises(bm, bn):
    """Tiles the tensor-core block cannot hold raise before any launch,
    on the CPU as on the card."""
    from repro_torch.kernels.fcu_matmul import fcu_matmul

    x, w = torch.ones(bm, 32), torch.ones(32, bn)
    with pytest.raises(ValueError, match="past the kernel's block"):
        fcu_matmul(x, w, bm=bm, bk=32, bn=bn)


# The JAX kernel tests' bf16 tolerances (tests/kernels/test_fcu_matmul.py,
# test_kpu_conv.py, test_dw_conv.py), applied as they apply them: rtol =
# atol on the f32-upcast outputs.  Both sides accumulate the same bf16
# inputs in f32 and round once to bf16, so they differ by at most one bf16
# rounding where the f32 sums straddle it.
BF16_TOL = {"fcu": 2e-2, "kpu": 3e-2, "dw": 3e-2}


@pytest.mark.parametrize(
    "kind,shape",
    [
        ("fcu", (64, 48, 24)),               # [m, d_in] x [d_in, d_out]
        ("fcu", (98, 144, 40)),
        ("kpu", (9, 3, 64, 7, 2)),           # ResNet conv1: 3 channels, 7x7/s2
        ("kpu", (8, 16, 24, 3, 1)),          # hw, d_in, d_out, k, stride
        ("kpu", (7, 24, 32, 3, 2)),
        ("dw", (8, 32, 3, 1)),               # hw, c, k, stride
        ("dw", (9, 48, 3, 2)),
        ("dw", (8, 16, 5, 1)),
    ],
)
def test_kernels_take_bf16_like_the_pallas_kernels(kind, shape):
    """bf16 operands give a bf16 output in x's dtype, as the Pallas kernels
    in interpret mode do, within their own bf16 tolerance."""
    rng = np.random.default_rng(sum(shape))
    bf16 = jnp.bfloat16

    def draw(*dims, scale=1.0):
        return (rng.standard_normal(dims) * scale).astype(np.float32)

    if kind == "fcu":
        m, d_in, d_out = shape
        x, w = draw(m, d_in), draw(d_in, d_out, scale=d_in ** -0.5)
        want = ref_fcu_matmul(jnp.asarray(x, bf16), jnp.asarray(w, bf16))
        got = pointwise_impl(rate=Fraction(2))(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    elif kind == "kpu":
        hw, d_in, d_out, k, stride = shape
        x, w = draw(2, hw, hw, d_in), draw(k, k, d_in, d_out, scale=(k * k * d_in) ** -0.5)
        want = ref_kpu_conv(jnp.asarray(x, bf16), jnp.asarray(w, bf16), stride=stride)
        got = conv_impl(rate=Fraction(2))(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), stride)
    else:
        hw, c, k, stride = shape
        x, w = draw(2, hw, hw, c), draw(k, k, 1, c, scale=1 / k)
        want = ref_dw_conv(jnp.asarray(x, bf16), jnp.asarray(w[:, :, 0, :], bf16),
                           stride=stride)
        got = dw_conv_impl(rate=Fraction(2))(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), stride)
    assert want.dtype == bf16 and got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(want.shape)
    tol = BF16_TOL[kind]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
