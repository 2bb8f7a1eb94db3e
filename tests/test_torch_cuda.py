"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no CUDA device is present (decided inside the ``card``
fixture).  On a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels with nvcc.  fp32 against fp32 in
another summation order is held at 1e-4 of the output's scale.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dse import select_ours  # noqa: E402
from repro_torch.core.tiles import select_tile_for_impl  # noqa: E402
from repro_torch.kernels import dw_conv, fcu_matmul, kpu_conv  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.models.topology import conv_spec, dense_spec  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _close(got, want):
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL * scale


def _launched(fn, call):
    before = fn.launches
    y = call()
    assert fn.launches == before + 1
    return y


@pytest.mark.parametrize(
    "hw,d_in,d_out,k,stride,rate",
    [
        (224, 3, 64, 7, 2, 3),     # ResNet conv1: d_in=3, SAME pads (2, 3)
        (224, 3, 32, 3, 2, 3),     # MobileNetV2 conv1: SAME pads (0, 1)
        (17, 24, 40, 3, 2, 1),     # odd size, ragged channels
        (28, 128, 256, 1, 2, 3),   # strided 1x1 downsample
        (7, 960, 160, 3, 1, Fraction(1, 8)),
    ],
)
def test_kpu_conv_kernel_matches_plain(card, hw, d_in, d_out, k, stride, rate):
    spec, _ = conv_spec("c", "conv", d_in, d_out, (hw, hw), k, stride)
    t = select_tile_for_impl(select_ours(spec, Fraction(rate)))
    x = _rand((2, hw, hw, d_in), hw + d_in).to(card)
    w = _rand((k, k, d_in, d_out), d_out, (k * k * d_in) ** -0.5).to(card)
    y = _launched(kpu_conv.kpu_conv, lambda: kpu_conv.kpu_conv(
        x, w, stride=stride, bm=t.bm, bci=t.bk, bco=t.bn))
    _close(y, kpu_conv.kpu_conv_plain(x, w, stride))


@pytest.mark.parametrize(
    "hw,c,stride,rate",
    [(112, 96, 2, 3), (56, 144, 1, 3), (7, 960, 1, 3), (15, 24, 2, 1)],
)
def test_dw_conv_kernel_matches_plain(card, hw, c, stride, rate):
    spec, _ = conv_spec("d", "dwconv", c, c, (hw, hw), 3, stride)
    t = select_tile_for_impl(select_ours(spec, Fraction(rate)))
    x = _rand((2, hw, hw, c), hw + c).to(card)
    w = _rand((3, 3, c), c, 1 / 3).to(card)
    y = _launched(dw_conv.dw_conv, lambda: dw_conv.dw_conv(
        x, w, stride=stride, bm=t.bm, bc=t.bk))
    _close(y, dw_conv.dw_conv_plain(x, w, stride))


@pytest.mark.parametrize(
    "n,hw,d_in,d_out,rate",
    [(2, 56, 24, 144, 3), (2, 7, 960, 160, 3), (3, 1, 1280, 1000, 3),
     (1, 13, 144, 24, 1)],
)
def test_fcu_matmul_kernel_matches_plain(card, n, hw, d_in, d_out, rate):
    if hw == 1:
        spec = dense_spec("f", d_in, d_out)
    else:
        spec, _ = conv_spec("p", "pointwise", d_in, d_out, (hw, hw), 1, 1)
    t = select_tile_for_impl(select_ours(spec, Fraction(rate)))
    m = n * hw * hw
    bm = fcu_matmul._pick_bm(m, t.bm)
    x = _rand((m, d_in), m).to(card)
    w = _rand((d_in, d_out), d_out, d_in ** -0.5).to(card)
    y = _launched(fcu_matmul.fcu_matmul, lambda: fcu_matmul.fcu_matmul(
        x, w, bm=bm, bk=t.bk, bn=t.bn))
    _close(y, fcu_matmul.fcu_matmul_plain(x, w))


@pytest.mark.parametrize(
    "which",
    [
        # 16 threads (8x1 tile, 2 k-groups) stage 32 weight columns
        "kpu: x[1,2,2,3] w[3,3,3,32] s2 bm=1 bci=3 bco=32",
        # 16 threads (1x1 tile, 16 k-groups) stage 24 input features
        "fcu: x[1,24] w[24,4] bm=1 bk=24 bn=4",
    ],
)
def test_block_with_fewer_threads_than_staging_lanes(card, which):
    """A one-row tile can leave a block fewer threads than a staged
    slice is wide; every element must still reach shared memory."""
    if which.startswith("kpu"):
        x = _rand((1, 2, 2, 3), 11).to(card)
        w = _rand((3, 3, 3, 32), 12, 0.2).to(card)
        y = _launched(kpu_conv.kpu_conv, lambda: kpu_conv.kpu_conv(
            x, w, stride=2, bm=1, bci=3, bco=32))
        _close(y, kpu_conv.kpu_conv_plain(x, w, 2))
    else:
        x = _rand((1, 24), 13).to(card)
        w = _rand((24, 4), 14, 0.2).to(card)
        y = _launched(fcu_matmul.fcu_matmul, lambda: fcu_matmul.fcu_matmul(
            x, w, bm=1, bk=24, bn=4))
        _close(y, fcu_matmul.fcu_matmul_plain(x, w))


@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_rate_matched_slice_on_card_matches_cpu(card, family):
    api, cpu = get_cnn_api(family), get_cnn_api(family, device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    params = cpu.init(cfg, torch.Generator().manual_seed(0))
    x = _rand((2, 64, 64, 3), 5)
    kp = api.plan(cfg, Fraction(3))
    executed = {}
    got = api.apply({n: {k: v.to(card) for k, v in p.items()}
                     for n, p in params.items()}, x, cfg, plan=kp,
                    executed=executed)
    want = cpu.apply(params, x, cfg, plan=kp)
    assert sorted(executed) == sorted(n for n, ip in kp.items() if ip.has_kernel)
    _close(got.cpu(), want)
