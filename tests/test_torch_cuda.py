"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no CUDA device is present (decided inside the ``card``
fixture).  On a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels with nvcc.  fp32 against fp32 in
another summation order is held at 1e-4 of the output's scale.  The flash
kernel is held element by element, |y - plain| <= rtol x |plain| + atol:
bf16 outputs, computed in f32 (P in two bf16 terms on the card) and
rounded once each side, at 2^-7 and 1e-4; f32 at 1e-4 and 1e-5.  The SSD
kernel is held element by element against its plain version at the JAX
kernel test's 2e-4, scaled by the element and by the output's RMS:
|y - plain| <= 2e-4 x |plain| + 2e-4 x rms(plain); with bf16 inputs its
bf16 y, rounded once each side from f32, at 2^-7 x |plain| + 2e-4 x
rms(plain).  The bf16 routes of the FCU, KPU and depthwise kernels are held
at the JAX kernel tests' bf16 tolerances of the output's scale: 2e-2 for
the FCU (tests/kernels/test_fcu_matmul.py), 3e-2 for the KPU and the
depthwise conv (test_kpu_conv.py, test_dw_conv.py).
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dse import select_ours  # noqa: E402
from repro_torch.core.tiles import select_tile_for_impl  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels import _build, dw_conv, fcu_matmul, kpu_conv  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import hybrid, lm, mamba  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.nn.embeddings import unembed  # noqa: E402
from repro_torch.models.topology import conv_spec, dense_spec  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4
FLASH_TOL = {torch.bfloat16: (2.0 ** -7, 1e-4), torch.float32: (1e-4, 1e-5)}
SSD_TOL = 2e-4
BF16_TOL = {"fcu_matmul": 2e-2, "kpu_conv": 3e-2, "dw_conv": 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _close(got, want, tol=TOL):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    want = want.float()
    scale = max(1.0, want.abs().max().item())
    assert (got.float() - want).abs().max().item() <= tol * scale


def _tol(kernel, dtype):
    return TOL if dtype == torch.float32 else BF16_TOL[kernel]


def _close_elementwise(got, want, rtol, atol):
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= rtol * want.float().abs() + atol).all())


def _close_rms(got, want, tol=SSD_TOL, rtol=None):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype
    want = want.float()
    limit = (tol if rtol is None else rtol) * want.abs() + tol * want.square().mean().sqrt()
    assert bool(((got.float() - want).abs() <= limit).all())


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


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "hw,c,stride,rate",
    [(112, 96, 2, 3), (56, 144, 1, 3), (7, 960, 1, 3), (15, 24, 2, 1)],
)
def test_dw_conv_kernel_matches_plain(card, hw, c, stride, rate, dtype):
    spec, _ = conv_spec("d", "dwconv", c, c, (hw, hw), 3, stride)
    t = select_tile_for_impl(select_ours(spec, Fraction(rate)))
    x = _rand((2, hw, hw, c), hw + c).to(card, dtype)
    w = _rand((3, 3, c), c, 1 / 3).to(card, dtype)
    y = _launched(dw_conv.dw_conv, lambda: dw_conv.dw_conv(
        x, w, stride=stride, bm=t.bm, bc=t.bk))
    _close(y, dw_conv.dw_conv_plain(x, w, stride), _tol("dw_conv", dtype))


def _dw_main_path_tiles():
    """MobileNetV2's depthwise nodes at 224x224 with the rate-3 plan's
    tiles: (label, hw, c, stride, bm, bc)."""
    api = get_cnn_api("mobilenet_v2", device="cpu")
    cfg = api.make_config()
    graph, kp = api.graph(cfg), api.plan(cfg, Fraction(3))
    return [(n, graph.spec(n).in_hw[0], graph.spec(n).d_in, graph.spec(n).stride[0],
             ip.tile.bm, ip.tile.bk)
            for n, ip in kp.items() if graph.spec(n).kind == "dwconv"]


DW_MAIN_PATH_TILES = _dw_main_path_tiles()
# Odd and even sizes at stride 1 and 2, ragged channel tiles (24, 72: not a
# multiple of 32), one output row a block, and a tile of 8 channels (two f32
# vectors, one bf16 vector); then tiles that are no whole number of 16-byte
# vectors, which the kernel takes an element at a time: 4 channels (one f32
# vector, half a bf16 one), 3 and 1 (the low-rate plans'), and 258, more
# channels than a block has threads.
DW_OTHER_TILES = [
    ("15x15 s2 bc24", 15, 24, 2, 8, 24),
    ("16x16 s2 bc72", 16, 144, 2, 16, 72),
    ("9x9 s1 bc8", 9, 32, 1, 27, 8),
    ("10x10 s1 bc16 rows1", 10, 48, 1, 10, 16),
    ("7x7 s2 bc32", 7, 64, 2, 16, 32),
    ("17x17 s1 bc96", 17, 96, 1, 34, 96),
    ("12x12 s1 bc4", 12, 12, 1, 24, 4),
    ("11x11 s2 bc3", 11, 9, 2, 12, 3),
    ("8x8 s1 bc1", 8, 5, 1, 16, 1),
    ("5x5 s2 bc258", 5, 258, 2, 3, 258),
]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("label,hw,c,stride,bm,bc", DW_MAIN_PATH_TILES + DW_OTHER_TILES,
                         ids=[t[0] for t in DW_MAIN_PATH_TILES + DW_OTHER_TILES])
def test_dw_kernel_at_every_planned_tile(card, label, hw, c, stride, bm, bc, dtype):
    """The depthwise kernel at each of MobileNetV2's planned tiles (batch 2)
    and at odd and even sizes off the main path, in both dtypes."""
    x = _rand((2, hw, hw, c), hw * c).to(card, dtype)
    w = _rand((3, 3, c), c + 1, 1 / 3).to(card, dtype)
    y = _launched(dw_conv.dw_conv, lambda: dw_conv.dw_conv(x, w, stride=stride, bm=bm,
                                                           bc=bc))
    assert y.dtype == dtype
    _close(y, dw_conv.dw_conv_plain(x, w, stride), _tol("dw_conv", dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("hw,c,k,stride,bm,bc", [(9, 16, 5, 1, 18, 16),
                                                 (12, 12, 3, 3, 8, 4)])
def test_dw_kernel_other_taps_and_strides(card, hw, c, k, stride, bm, bc, dtype):
    """The kernel takes 3x3 taps at stride 1 and 2 only: a 5x5 kernel or
    stride 3 on the card raises before any launch (the plain version on
    the CPU takes them)."""
    x = _rand((2, hw, hw, c), hw + k).to(card, dtype)
    w = _rand((k, k, c), c + k, 1 / k).to(card, dtype)
    before = dw_conv.dw_conv.launches
    with pytest.raises(ValueError, match="3x3 taps"):
        dw_conv.dw_conv(x, w, stride=stride, bm=bm, bc=bc)
    assert dw_conv.dw_conv.launches == before
    y = dw_conv.dw_conv(x.cpu(), w.cpu(), stride=stride, bm=bm, bc=bc)
    _close(y.to(card), dw_conv.dw_conv_plain(x, w, stride), _tol("dw_conv", dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_dw_kernel_refuses_unaligned_vectors(card, dtype):
    """A tile of whole 16-byte vectors on an x that starts off a 16-byte
    boundary raises before any launch; a tile the kernel takes an element
    at a time runs on it."""
    shape = (2, 8, 8, 16)
    flat = _rand((int(np.prod(shape)) + 1,), 5).to(card, dtype)
    x = flat[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    w = _rand((3, 3, 16), 6, 1 / 3).to(card, dtype)
    before = dw_conv.dw_conv.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        dw_conv.dw_conv(x, w, stride=1, bm=16, bc=16)
    assert dw_conv.dw_conv.launches == before
    y = _launched(dw_conv.dw_conv, lambda: dw_conv.dw_conv(x, w, stride=1, bm=16, bc=2))
    _close(y, dw_conv.dw_conv_plain(x, w, stride=1), _tol("dw_conv", dtype))


def test_dw_kernel_is_deterministic(card):
    x = _rand((8, 56, 56, 144), 3).to(card)
    w = _rand((3, 3, 144), 4, 1 / 3).to(card)
    first = dw_conv.dw_conv(x, w, stride=1, bm=224, bc=16)
    again = dw_conv.dw_conv(x, w, stride=1, bm=224, bc=16)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


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
        # one live row, 3-channel taps folded a row a step, a cluster of 3
        "kpu: x[1,2,2,3] w[3,3,3,32] s2 bm=1 bci=3 bco=32",
        # one live row, bn = 4 padded to the wgmma width 8
        "fcu: x[1,24] w[24,4] bm=1 bk=24 bn=4",
    ],
)
def test_block_with_fewer_threads_than_staging_lanes(card, which):
    """A one-row tile fills one row of a 64-row wgmma atom: the other 63
    read as zero and are never stored."""
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


# Every distinct (kind, bm, bk, bn) tile of the two CNN main paths (224x224,
# batch 8, the rate-3 plan), at the first node that plans it:
# (label, m or (hw, k, stride), d_in, d_out, bm, bk, bn).
MAIN_PATH_TILES = [
    ("mbv2/b1_project", 100352, 32, 16, 512, 32, 8),
    ("mbv2/b2_expand", 100352, 16, 96, 256, 16, 32),
    ("mbv2/b2_project", 25088, 96, 24, 512, 96, 8),
    ("mbv2/b3_expand", 25088, 24, 144, 512, 24, 16),
    ("mbv2/b3_project", 25088, 144, 24, 512, 72, 8),
    ("mbv2/b4_project", 6272, 144, 32, 224, 72, 32),
    ("mbv2/b5_expand", 6272, 32, 192, 224, 32, 32),
    ("mbv2/b5_project", 6272, 192, 32, 224, 96, 32),
    ("mbv2/b7_project", 1568, 192, 64, 196, 64, 32),
    ("mbv2/b8_expand", 1568, 64, 384, 196, 32, 32),
    ("mbv2/b8_project", 1568, 384, 64, 196, 96, 32),
    ("mbv2/b14_project", 392, 576, 160, 49, 32, 32),
    ("mbv2/b17_project", 392, 960, 320, 49, 64, 32),
    ("mbv2/conv_last", 392, 320, 1280, 49, 160, 32),
    ("mbv2/fc", 8, 1280, 1000, 1, 32, 8),
    ("mbv2/conv1", (224, 3, 2), 3, 32, 256, 3, 32),
    ("resnet18/conv1", (224, 7, 2), 3, 64, 128, 3, 64),
    ("resnet18/l1b1_conv1", (56, 3, 1), 64, 64, 256, 64, 32),
    ("resnet18/l2b1_conv2", (28, 3, 1), 128, 128, 256, 128, 32),
    ("resnet18/l3b1_conv1", (28, 3, 2), 128, 256, 196, 128, 32),
    ("resnet18/l3b1_conv2", (14, 3, 1), 256, 256, 98, 256, 32),
    ("resnet18/l4b1_conv1", (14, 3, 2), 256, 512, 49, 256, 32),
]

# Ragged tiles off the main path: bm 1 and 49 (a part of one 64-row atom),
# bn 4 and 40 (padded to wgmma widths 8 and 64), bk 3 (conv1's 3-channel
# rows: 4-byte copies, one zero-padded k8 step), 24, 72 and 160 (ring
# slots of 24, 24 and 32 channels), and stride 2 at even and odd sizes.
RAGGED_TILES = [
    ("fcu bm1 bk160 bn40", 3, 160, 40, 1, 160, 40),
    ("fcu bm49 bk72 bn4", 98, 144, 4, 49, 72, 4),
    ("fcu bm49 bk24 bn40", 147, 24, 40, 49, 24, 40),
    ("kpu 17x17 s2 bm49 bk24 bn40", (17, 3, 2), 24, 40, 49, 24, 40),
    ("kpu 16x16 s2 bm49 bk72 bn4", (16, 3, 2), 144, 4, 49, 72, 4),
    ("kpu 15x15 s2 bm1 bk3 bn40", (15, 3, 2), 3, 40, 1, 3, 40),
    ("kpu 14x14 s2 bm49 bk160 bn8", (14, 1, 2), 320, 8, 49, 160, 8),
    ("kpu 9x9 s2 bm49 bk3 bn4", (9, 7, 2), 3, 4, 49, 3, 4),
]


# Tiles the planner gives at rates other than 3 only (rates of
# PLAN_RATES below): bn 24, 128, 144 and 200 (wgmma widths 32, 128 and
# 256), bm 32 and 64 beside one consumer warpgroup, and bk 1 for a
# 3-channel conv1 (4-byte copies, 27 steps).
OTHER_RATE_TILES = [
    ("fcu bm1 bk32 bn200", 8, 1280, 1000, 1, 32, 200),
    ("fcu bm64 bk256 bn128", 6272, 256, 256, 64, 256, 128),
    ("fcu bm32 bk24 bn144", 1568, 24, 144, 32, 24, 144),
    ("fcu bm256 bk144 bn24", 6272, 144, 24, 256, 144, 24),
    ("kpu 32x32 s2 bm256 bk1 bn32", (32, 3, 2), 3, 32, 256, 1, 32),
    ("kpu 28x28 s2 bm49 bk128 bn128", (28, 3, 2), 128, 256, 49, 128, 128),
    ("kpu 56x56 s2 bm64 bk64 bn128", (56, 3, 2), 64, 128, 64, 64, 128),
]


def _tile_case(card, shape, d_in, d_out, bm, bk, bn, seed, split=0,
               dtype=torch.float32):
    """The FCU (``shape`` = m) or KPU (``shape`` = (hw, k, stride), batch
    2 off the main path, 8 on it) at one tile on ``dtype`` operands, its
    steps split over ``split`` blocks (0: the kernel's rule): (kernel,
    plain) outputs."""
    if isinstance(shape, int):
        x = _rand((shape, d_in), seed).to(card, dtype)
        w = _rand((d_in, d_out), seed + 1, d_in ** -0.5).to(card, dtype)
        _build.check_mma_tile("fcu_matmul", bm, bk, bn, d_in, d_out)
        y = _launched(fcu_matmul.fcu_matmul, lambda: fcu_matmul._launch(
            x, w, bm, bk, bn, split))
        return y, fcu_matmul.fcu_matmul_plain(x, w)
    hw, k, stride = shape
    n = 8 if hw in (224, 56, 28, 14, 7) and bm > 1 else 2
    x = _rand((n, hw, hw, d_in), seed).to(card, dtype)
    w = _rand((k, k, d_in, d_out), seed + 1, (k * k * d_in) ** -0.5).to(card, dtype)
    _build.check_mma_tile("kpu_conv", bm, bk, bn, d_in, d_out)
    y = _launched(kpu_conv.kpu_conv, lambda: kpu_conv._launch(
        x, w, stride, bm, bk, bn, split))
    return y, kpu_conv.kpu_conv_plain(x, w, stride)


def _split_of(shape, d_in, d_out, bm, bk, bn):
    """The kernel's rule for ``_tile_case``'s call at this tile."""
    if isinstance(shape, int):
        return fcu_matmul.cluster_split(shape, d_in, d_out, bm=bm, bk=bk, bn=bn)
    hw, k, stride = shape
    n = 8 if hw in (224, 56, 28, 14, 7) and bm > 1 else 2
    return kpu_conv.cluster_split((n, hw, hw, d_in), (k, k, d_in, d_out),
                                  stride=stride, bm=bm, bci=bk, bco=bn)


@pytest.mark.parametrize(
    "label,shape,d_in,d_out,bm,bk,bn", MAIN_PATH_TILES + RAGGED_TILES + OTHER_RATE_TILES,
    ids=[t[0] for t in MAIN_PATH_TILES + RAGGED_TILES + OTHER_RATE_TILES])
def test_mma_kernels_match_plain_at_every_tile(card, label, shape, d_in, d_out,
                                               bm, bk, bn):
    """The 3xTF32 tensor-core FCU / KPU at each tile, with the cluster
    split where the rule takes it and without, against the plain version
    with TF32 off."""
    for split in (0, 1):
        y, want = _tile_case(card, shape, d_in, d_out, bm, bk, bn, d_in + bm, split)
        assert y.shape == want.shape
        _close(y, want)


@pytest.mark.parametrize(
    "label,shape,d_in,d_out,bm,bk,bn", MAIN_PATH_TILES + RAGGED_TILES + OTHER_RATE_TILES,
    ids=[t[0] for t in MAIN_PATH_TILES + RAGGED_TILES + OTHER_RATE_TILES])
def test_mma_kernels_bf16_match_plain_at_every_tile(card, label, shape, d_in, d_out,
                                                    bm, bk, bn):
    """The bf16 route (one wgmma bf16 product a step, w MN-major through
    the transpose bit; conv1's 3-channel rows copied 2 bytes at a time) at
    each tile, split where the rule takes it and not, against the plain
    version in f32 rounded to bf16, at the JAX kernel tests' tolerances."""
    kernel = "fcu_matmul" if isinstance(shape, int) else "kpu_conv"
    for split in (0, 1):
        y, want = _tile_case(card, shape, d_in, d_out, bm, bk, bn, d_in + bm, split,
                             torch.bfloat16)
        assert y.shape == want.shape and y.dtype == torch.bfloat16
        _close(y, want, BF16_TOL[kernel])


@pytest.mark.parametrize(
    "shape,d_in,d_out,bm,bk,bn,split",
    [
        (1568, 576, 96, 196, 96, 32, 6),      # b12_project: 24 blocks, 6 steps
        (392, 960, 160, 49, 32, 32, 6),       # b15_project: 40 blocks, 30 steps
        (6272, 144, 32, 224, 72, 32, 2),      # b4_project: 28 blocks, 2 steps
        (1568, 64, 384, 196, 32, 32, 1),      # b8_expand: 96 blocks, 2 steps
        (392, 320, 1280, 49, 160, 32, 1),     # conv_last: 320 blocks fill the SMs
        (8, 1280, 1000, 1, 32, 8, 2),         # fc: 8 one-row tiles a block, 125 blocks
        ((56, 3, 1), 64, 64, 256, 64, 32, 2),     # resnet18 l1: 98 blocks of 2 column
                                                  # tiles, 9 steps
        ((7, 3, 1), 512, 512, 49, 256, 32, 6),    # resnet18 l4: 16 blocks of 2 pixel x
                                                  # 4 column tiles, 18 steps
        ((1, 3, 1), 3, 32, 1, 3, 32, 3),  # 3-channel taps folded: 3 rows, not 9
    ],
)
def test_cluster_split_rule(card, shape, d_in, d_out, bm, bk, bn, split):
    """Where a call's blocks leave the H100's 132 SMs idle, the FCU / KPU
    kernel splits each block's steps over a cluster of up to 8 blocks (two
    an SM at most), as few as give each the fewest steps; down to one
    step a block only where fewer than half the SMs have a block.  The
    KPU's blocks are its groups of plan tiles (``block_group``)."""
    assert torch.cuda.get_device_properties(card).multi_processor_count == 132
    assert _split_of(shape, d_in, d_out, bm, bk, bn) == split


# The rates of the paper's MobileNetV2 sweep
# (benchmarks/table2_mnv2_rates.py::PAPER_ROWS) and the others the repo
# drives; tests/test_torch_kernels.py checks the same plans on the CPU.
PLAN_RATES = [Fraction(1, 16), Fraction(3, 32), Fraction(1, 8), Fraction(3, 16),
              Fraction(3, 8), Fraction(3, 4), Fraction(3, 2), Fraction(2),
              Fraction(3), Fraction(6), Fraction(64)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("rate", PLAN_RATES, ids=str)
@pytest.mark.parametrize(
    "family", ["mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34"])
def test_planned_mma_tiles_plan_on_the_card(card, family, rate, dtype):
    """The kernels' own host plan (``tile_mma.cuh::plan_tile``: the block,
    its shared-memory ring and the cluster split) takes every FCU / KPU
    tile the planner gives at 224x224, batch 8, at each rate, for f32 and
    bf16 operands."""
    from repro_torch.core.graph import plan_graph

    api = get_cnn_api(family, device="cpu")
    gp = plan_graph(api.graph(api.make_config()), rate)
    for name, ip in gp.kernel_plan().items():
        s, t = gp.graph.spec(name), ip.tile
        if t is None or s.kind == "dwconv":
            continue
        if s.kind == "conv":
            split = kpu_conv.cluster_split(
                (8, *s.in_hw, s.d_in), (*s.kernel, s.d_in, s.d_out),
                stride=s.stride[0], bm=t.bm, bci=t.bk, bco=t.bn, dtype=dtype)
        else:
            m = 8 * s.in_hw[0] * s.in_hw[1]
            split = fcu_matmul.cluster_split(
                m, s.d_in, s.d_out, bm=fcu_matmul._pick_bm(m, t.bm), bk=t.bk,
                bn=t.bn, dtype=dtype)
        assert 1 <= split <= 8, (name, t)


@pytest.mark.parametrize("label,shape,d_in,d_out,bm,bk,bn", [
    ("mbv2/b12_project", 1568, 576, 96, 196, 96, 32),
    ("resnet18/l4b2_conv1", (7, 3, 1), 512, 512, 49, 256, 32),
])
def test_mma_kernels_are_deterministic_with_the_cluster_split(card, label, shape,
                                                              d_in, d_out, bm, bk, bn):
    """Two launches give bit-identical outputs: the cluster's ranks sum
    their partial tiles in rank order, with no atomics."""
    assert _split_of(shape, d_in, d_out, bm, bk, bn) > 1
    first, want = _tile_case(card, shape, d_in, d_out, bm, bk, bn, 7)
    again, _ = _tile_case(card, shape, d_in, d_out, bm, bk, bn, 7)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    _close(first, want)


def _resnet18_kpu_tiles():
    """Every distinct KPU call of ResNet-18 at 224x224 in the plans at rate
    3 and 3/32: (label, (hw, k, stride), d_in, d_out, bm, bk, bn)."""
    api = get_cnn_api("resnet18", device="cpu")
    cfg = api.make_config()
    graph, seen = api.graph(cfg), {}
    for rate in (Fraction(3), Fraction(3, 32)):
        for name, ip in api.plan(cfg, rate).items():
            s, t = graph.spec(name), ip.tile
            if t is None or s.kind != "conv":
                continue
            case = ((s.in_hw[0], s.kernel[0], s.stride[0]), s.d_in, s.d_out,
                    t.bm, t.bk, t.bn)
            seen.setdefault(case, f"r{rate}/{name}")
    return [(label, *case) for case, label in seen.items()]


RESNET18_KPU_TILES = _resnet18_kpu_tiles()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("batch", [64, 8])
@pytest.mark.parametrize("label,shape,d_in,d_out,bm,bk,bn", RESNET18_KPU_TILES,
                         ids=[t[0] for t in RESNET18_KPU_TILES])
def test_grouped_kpu_launch_equals_one_tile_a_block(card, label, shape, d_in, d_out,
                                                     bm, bk, bn, batch, dtype):
    """The KPU's f32 block runs a group of the plan's tiles (at batch 64
    at every tile but one whose bn is all of d_out; a bf16 block one
    column tile); every tile keeps its steps in the same order, so the
    grouped launch equals the launch of one plan tile a block bit for
    bit, both unsplit, at every ResNet-18 tile of the benchmark's plans,
    at its batch and at batch 8."""
    (hw, k, stride) = shape
    x = _rand((batch, hw, hw, d_in), hw + d_in).to(card, dtype)
    w = _rand((k, k, d_in, d_out), d_out, (k * k * d_in) ** -0.5).to(card, dtype)
    group = kpu_conv.block_group(x.shape, w.shape, stride=stride, bm=bm, bci=bk,
                                 bco=bn, dtype=dtype)
    if dtype == torch.float32:
        assert group[0] * group[1] > 1 or d_out == bn or batch < 64
    else:
        assert group[1] == 1
    before = kpu_conv.kpu_conv.grouped_launches
    grouped = _launched(kpu_conv.kpu_conv, lambda: kpu_conv._launch(
        x, w, stride, bm, bk, bn, 1))
    assert kpu_conv.kpu_conv.grouped_launches - before == (group[0] * group[1] > 1)
    alone = _launched(kpu_conv.kpu_conv, lambda: kpu_conv._launch(
        x, w, stride, bm, bk, bn, 1, (1, 1)))
    assert kpu_conv.kpu_conv.grouped_launches - before == (group[0] * group[1] > 1)
    torch.cuda.synchronize()
    assert torch.equal(grouped, alone)
    _close(grouped, kpu_conv.kpu_conv_plain(x, w, stride), _tol("kpu_conv", dtype))


def _conv_groups(api, cfg, kp, batch):
    """The (pixel, column) tiles a KPU block runs at each conv node."""
    graph = api.graph(cfg)
    out = {}
    for name, ip in kp.items():
        s = graph.spec(name)
        if ip.has_kernel and s.kind == "conv":
            out[name] = kpu_conv.block_group(
                (batch, *s.in_hw, s.d_in), (*s.kernel, s.d_in, s.d_out),
                stride=s.stride[0], bm=ip.tile.bm, bci=ip.tile.bk, bco=ip.tile.bn)
    return out


def test_grouped_launches_count_resnet18_not_mobilenet_v2_conv1(card):
    """``kpu_conv.grouped_launches`` rises once for every ResNet-18 conv
    whose block groups plan tiles (``block_group``, read from the kernel's
    own plan), at the benchmark's batch all but conv1, and not for
    MobileNetV2's one KPU node, conv1, whose bn = 32 is all of its d_out."""
    batch = 64
    x = _rand((batch, 224, 224, 3), 9)
    for family in ("resnet18", "mobilenet_v2"):
        api, cpu = get_cnn_api(family), get_cnn_api(family, device="cpu")
        cfg = api.make_config()
        kp = api.plan(cfg, Fraction(3))
        groups = _conv_groups(api, cfg, kp, batch)
        params = _card_params(cpu.init(cfg, torch.Generator().manual_seed(0)), card)
        launches = kpu_conv.kpu_conv.launches
        grouped = kpu_conv.kpu_conv.grouped_launches
        api.apply(params, x.to(card), cfg, plan=kp)
        torch.cuda.synchronize()
        assert kpu_conv.kpu_conv.launches - launches == len(groups)
        want = sum(r * c > 1 for r, c in groups.values())
        assert kpu_conv.kpu_conv.grouped_launches - grouped == want
        if family == "resnet18":
            assert want == len(groups) - 1  # all but conv1 (bn = 64 = d_out)
        else:
            assert groups == {"conv1": (1, 1)} and want == 0


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


def _card_params(params, card):
    return {n: {k: v.to(card) for k, v in p.items()} for n, p in params.items()}


def _kernel_launches():
    return (fcu_matmul.fcu_matmul.launches, kpu_conv.kpu_conv.launches,
            dw_conv.dw_conv.launches)


# int8 links on the card against the CPU: activations differ by about 1e-6
# of their scale (other summation orders), so a value on a rounding edge of
# a link lands one int8 step (amax/127) apart; held at 2e-2 of the scale,
# as the CPU tests hold the port against the JAX package.
INT8_LINK_TOL = 2e-2


@pytest.mark.parametrize("link", [None, "int8"])
@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_staged_on_card_matches_cpu(card, family, n_stages, link):
    """``apply_staged`` through the registry's defaults (no ``device=``) on
    the batch-pinned plan: every arithmetic node launches its kernel once,
    staged equals monolithic bit for bit on the card, and the logits match
    the CPU's staged run."""
    api, cpu = get_cnn_api(family), get_cnn_api(family, device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    params = cpu.init(cfg, torch.Generator().manual_seed(1))
    x = _rand((2, 64, 64, 3), 6)
    gp = api.partition(cfg, Fraction(3), n_stages)
    kp = gp.kernel_plan(batch=2)
    on_card = _card_params(params, card)
    arith = [ip for ip in kp.values() if ip.has_kernel]
    want_launches = (sum(ip.kind in ("pointwise", "dense") for ip in arith),
                     sum(ip.kind == "conv" for ip in arith),
                     sum(ip.kind == "dwconv" for ip in arith))
    before = _kernel_launches()
    got = api.apply_staged(on_card, x, cfg, partition=gp, plan=kp, link_quant=link)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_kernel_launches(), before)) == want_launches
    again = api.apply_staged(on_card, x, cfg, partition=gp, plan=kp, link_quant=link,
                             check_monolithic=True)
    assert torch.equal(got, again)
    want = cpu.apply_staged(params, x, cfg, partition=gp, plan=kp, link_quant=link)
    _close(got.cpu(), want, INT8_LINK_TOL if link else TOL)


@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_int8_datapath_on_card(card, family):
    """``quantize`` + ``apply_int8`` on the card: monolithic and staged
    bit-identical, both within 1e-4 of the CPU's and of the plain path."""
    api, cpu = get_cnn_api(family), get_cnn_api(family, device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    params = cpu.init(cfg, torch.Generator().manual_seed(2))
    x = _rand((2, 64, 64, 3), 7)
    q, s = api.quantize(_card_params(params, card))
    assert all(q[n]["w"].dtype == torch.int8 and q[n]["w"].is_cuda for n in q)
    gp = api.partition(cfg, Fraction(3), 3)
    kp = gp.kernel_plan(batch=2)
    mono = api.apply_int8(q, s, x, cfg, plan=kp)
    staged = api.apply_int8(q, s, x, cfg, plan=kp, partition=gp)
    assert torch.equal(mono, staged)
    _close(mono.cpu(), api.apply_int8(q, s, x, cfg).cpu())
    cq, cs = cpu.quantize(params)
    assert all(torch.equal(cq[n]["w"], q[n]["w"].cpu()) for n in q)
    assert all(torch.equal(cs[n], s[n].cpu()) for n in q)
    _close(mono.cpu(), cpu.apply_int8(cq, cs, x, cfg, plan=kp))


def test_link_quant_on_card_is_the_cpus(card):
    """Link quantization on the card gives the CPU's bits (and so the JAX
    package's): the scale is a true quotient there too, not a product by
    the reciprocal of 127."""
    from repro_torch.nn.quant import dequantize_link, quantize_link

    for seed in range(20):
        x = _rand((2, 28, 28, 64), 100 + seed, scale=10.0 ** (seed % 7 - 3))
        got, want = quantize_link(x.to(card)), quantize_link(x)
        assert torch.equal(got["__s__"].cpu(), want["__s__"])
        assert torch.equal(got["__q__"].cpu(), want["__q__"])
        assert torch.equal(dequantize_link(got).cpu(), dequantize_link(want))


def test_replicated_plan_on_card(card):
    """ResNet-18 at S=3 with the replication the DSE picks: its lanes see
    half the batch, so it is held at 1e-4 of the unreplicated forward."""
    from repro_torch.core.graph import plan_graph
    from repro_torch.core.replicate import best_replication, replicate_params

    api, cpu = get_cnn_api("resnet18"), get_cnn_api("resnet18", device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    graph = api.graph(cfg)
    rep = {r.node: r.r for r in best_replication(graph, Fraction(3),
                                                 n_stages=3).replications}
    assert rep
    gp = plan_graph(graph, Fraction(3), n_stages=3, replicate=rep)
    params = _card_params(cpu.init(cfg, torch.Generator().manual_seed(3)), card)
    x = _rand((4, 64, 64, 3), 8)
    got = api.apply_staged(replicate_params(params, gp.replications), x, cfg,
                           graph=gp.graph, partition=gp, plan=gp.kernel_plan(batch=4))
    _close(got.cpu(), api.apply(params, x, cfg, plan=api.plan(cfg, Fraction(3))).cpu())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "h,hkv,sq,sk,d,causal",
    [
        (28, 4, 512, 512, 128, True),    # qwen2-7b's heads: group 7
        (28, 4, 1000, 1000, 128, True),  # ragged: no block divides 1000
        (7, 1, 130, 130, 128, False),    # group 7, non-causal, ragged
        (8, 8, 200, 200, 64, True),      # group 1: flash_attention_p's contract
        (4, 4, 64, 300, 64, False),      # more keys than queries
        (4, 2, 9, 9, 16, True),          # below one block (reduced qwen2)
        (6, 3, 77, 77, 32, False),
        (28, 4, 2048, 2048, 128, True),  # qwen2-7b's full heads, longest prompt
        (32, 32, 1543, 1543, 64, True),  # zamba2's heads, ragged 1536 + 7
        (4, 1, 2048, 2048, 256, True),   # gemma3-1b's global layers: d 256, group 4
        (4, 1, 333, 333, 256, True),     # d 256, ragged
        (4, 2, 100, 260, 256, False),    # d 256, non-causal, Sq != Sk
        (16, 16, 1, 1000, 64, False),    # seamless's cross-attention at decode
        (16, 16, 16, 1500, 64, False),   # and at prefill: 16 tokens, T frames
        (16, 8, 1, 77, 128, False),      # one query, GQA, ragged keys
    ],
)
def test_flash_kernel_matches_plain(card, dtype, h, hkv, sq, sk, d, causal):
    """Every pair of blocks the dtype's kernel takes at the head dim: bf16
    (wgmma) 64 or 128 query rows by 64 or 128 keys (64 at d = 256); f32
    (CUDA cores) tall and wide."""
    q = _rand((2, h, sq, d), sq + d).to(card, dtype)
    k = _rand((2, hkv, sk, d), sk).to(card, dtype)
    v = _rand((2, hkv, sk, d), sk + 1).to(card, dtype)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    pairs = {(64, 64), (128, 64), (64, 128)} if dtype == torch.bfloat16 else {(16, 64), (64, 16)}
    pairs = {p for p in pairs if fa.fits(dtype, d, *p)}
    for block_q, block_k in pairs | {fa.flash_blocks(2 * h, sq, dtype, d)}:
        y = _launched(fa.flash_attention, lambda: fa.flash_attention(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k))
        assert y.dtype == dtype and y.shape == q.shape
        _close_elementwise(y, want, *FLASH_TOL[dtype])


def test_flash_launches_count_only_launches(card):
    """CPU tensors run the plain version, and a block the dtype's kernel
    does not take raises before any launch; neither is counted."""
    q, kv = torch.ones(1, 2, 8, 16), torch.ones(1, 1, 8, 16)
    before = fa.flash_attention.launches
    fa.flash_attention(q, kv, kv, block_q=16, block_k=16)    # CPU: plain version
    with pytest.raises(ValueError):
        fa.flash_attention(q.to(card), kv.to(card), kv.to(card), block_q=8,
                           block_k=16)
    qb, kvb = (t.to(card, torch.bfloat16) for t in (q, kv))
    with pytest.raises(ValueError):     # the f32 kernel's block, not wgmma's
        fa.flash_attention(qb, kvb, kvb, block_q=16, block_k=64)
    assert fa.flash_attention.launches == before
    fa.flash_attention(q.to(card), kv.to(card), kv.to(card), block_q=16, block_k=16)
    assert fa.flash_attention.launches == before + 1
    fa.flash_attention(qb, kvb, kvb, block_q=64, block_k=64)
    assert fa.flash_attention.launches == before + 2


def test_unembed_on_card_matches_the_f32_product(card):
    """bf16 operands, f32 logits: the card's f32-output product against
    the product of f32 copies (a bf16 product is exact in f32)."""
    table = _rand((20_000, 256), 1, 0.02).to(card, torch.bfloat16)
    x = _rand((3, 1, 256), 2).to(card, torch.bfloat16)
    got = unembed(table, x)
    assert got.dtype == torch.float32 and got.shape == (3, 1, 20_000)
    _close(got, (x.float() @ table.float().t()))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_reduced_qwen2_prefill_on_card_matches_cpu(card):
    cfg = reduced(get_config("qwen2-7b"), layers=2, d_model=64, vocab=128)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 37)))
    want, want_cache = lm.prefill(params, toks, cfg, lm.init_cache(cfg, 2, 48))
    before = fa.flash_attention.launches
    got, cache = lm.prefill(_to(params, card), toks.to(card), cfg,
                            lm.init_cache(cfg, 2, 48, device=card))
    assert fa.flash_attention.launches == before + cfg.n_layers
    _close(got.cpu(), want)
    for g, w in zip(cache, want_cache):
        _close(g.cpu(), w)


@pytest.mark.parametrize("arch,launches", [
    ("gemma3-1b", lambda cfg: sum(cfg.window_for_layer(i) == 0 for i in range(cfg.n_layers))),
    ("internvl2-2b", lambda cfg: cfg.n_layers),
    ("seamless-m4t-medium", lambda cfg: cfg.enc_layers + 2 * cfg.dec_layers),
])
def test_reduced_window_vlm_encdec_prefill_on_card_matches_cpu(card, arch, launches):
    """get_api's prefill on the card (gemma3 with ring caches, internvl2
    from int8 weights) against the same prefill on the CPU, f32, the flash
    kernel launched once per layer that runs it; then a decode step."""
    from repro_torch.models import registry
    from repro_torch.nn.quant import quantize_tree

    cfg = reduced(get_config(arch), layers=4, d_model=64, vocab=128)
    params = registry.get_api(cfg, device="cpu").init(cfg, torch.Generator().manual_seed(0))
    if cfg.serve_weight_quant:
        params = quantize_tree(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 128, (2, 37))}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((2, 45, 64)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.n_patches, 64)).astype(np.float32)
    out = {}
    for dev in ("cpu", card):
        api = registry.get_api(cfg, device=dev)
        before = fa.flash_attention.launches
        logits, state = api.prefill(_to(params, dev), batch,
                                    api.make_serve_state(cfg, 2, 48), cfg)
        assert fa.flash_attention.launches == before + (launches(cfg) if dev == card else 0)
        pos = 37 + cfg.n_patches
        step, _ = api.decode(_to(params, dev), state, {"tokens": [[1], [2]]},
                             np.asarray([pos, pos]), cfg)
        out[str(dev)] = (logits.cpu(), step.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want)


@pytest.mark.parametrize("form", ["einsum", "scatter", "ragged"])
def test_moe_layer_on_card_matches_cpu(card, form):
    """One grok-style MoE layer (8 experts, top-2, a capacity that drops
    copies) on the card against the same call on the CPU, f32: the same
    experts routed, outputs at TOL."""
    from repro_torch.nn import moe

    spec = moe.MoESpec(n_experts=8, top_k=2, d_model=64, d_ff=128, ffn_kind="geglu",
                       capacity_factor=1.0, impl=form, group_size=32)
    params = moe.init_moe(torch.Generator().manual_seed(0), spec)
    x = _rand((2, 64, 64), 1)
    want, aux_want = moe.moe(params, x, spec)
    got, aux = moe.moe(_to(params, card), x.to(card), spec)
    _, idx_want, _ = moe._route(params, x.reshape(-1, 64), spec)
    _, idx, _ = moe._route(_to(params, card), x.reshape(-1, 64).to(card), spec)
    assert torch.equal(idx.cpu(), idx_want)
    _close(got.cpu(), want)
    assert abs(float(aux) - float(aux_want)) <= 1e-5 * abs(float(aux_want))


@pytest.mark.parametrize("arch,change", [("grok-1-314b", {}),
                                         ("llama4-maverick-400b-a17b", {}),
                                         ("qwen2-7b", {"kv_quant": True})])
def test_reduced_moe_and_int8_cache_on_card_match_cpu(card, arch, change):
    """The MoE models and qwen2-7b as shipped (int8 KV cache), f32 at the
    reduced size: a prefill (the flash kernel once per layer, over the
    dequantized int8 prefix for qwen2) and a decode step at per-row
    positions on the card against the same calls on the CPU; the int8
    cache within one step, its scales at 1e-5."""
    import dataclasses

    cfg = dataclasses.replace(reduced(get_config(arch), layers=2, d_model=64, vocab=128),
                              **change)
    params = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 37)))
    out = {}
    for dev in ("cpu", card):
        before = fa.flash_attention.launches
        logits, cache = lm.prefill(_to(params, dev), toks.to(dev), cfg,
                                   lm.init_cache(cfg, 2, 48, device=dev))
        assert fa.flash_attention.launches == before + (cfg.n_layers if dev == card else 0)
        step, cache = lm.decode_step(_to(params, dev), cache, torch.tensor([[1], [2]]).to(dev),
                                     np.asarray([37, 30]), cfg)
        out[str(dev)] = (logits.cpu(), step.cpu(), [c.cpu() for c in cache])
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        _close(got, want)
    for got, want in zip(out["cuda"][2], out["cpu"][2]):
        if got.dtype == torch.int8:
            assert (got.int() - want.int()).abs().max() <= 1
        else:
            torch.testing.assert_close(got, want, rtol=1e-5 if change else TOL,
                                       atol=0 if change else TOL)


def test_blockwise_route_on_card_matches_dense_and_cpu(card):
    """The blockwise route (window 8, q / k blocks of 16 over 96 tokens, key
    blocks under the mask skipped) on the card against the dense route on
    the card and the blockwise route on the CPU, f32."""
    import dataclasses

    from repro_torch.nn import attention

    spec = attention.AttnSpec(n_heads=4, n_kv=2, head_dim=16, q_block=16, k_block=16)
    p = attention.init_attention(torch.Generator().manual_seed(0), 64, 4, 2, 16)
    x = _rand((2, 96, 64), 2)
    out = {}
    for dev in ("cpu", card):
        for impl in ("blockwise", "dense"):
            y, _ = attention.attention(_to(p, dev), x.to(dev), None,
                                       dataclasses.replace(spec, impl=impl),
                                       window=8)
            out[(str(dev), impl)] = y.cpu()
    _close(out[("cuda", "blockwise")], out[("cuda", "dense")])
    _close(out[("cuda", "blockwise")], out[("cpu", "blockwise")])


def _ssd_inputs(b, l, h, p, g, n, seed, model_decay):
    """The JAX kernel test's distributions, or (``model_decay``) the
    model's: a = -(1..H) and dt from its dt_bias range, so that a_cum
    reaches hundreds below zero within a chunk."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)) * 0.5
    if model_decay:
        dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 4.0))
        a = -np.arange(1, h + 1)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
        a = -np.exp(rng.standard_normal(h))
    bb = rng.standard_normal((b, l, g, n)) * 0.3
    cc = rng.standard_normal((b, l, g, n)) * 0.3
    return [torch.from_numpy(np.asarray(t, np.float32)) for t in (x, dt, a, bb, cc)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk,model_decay",
    [
        (1, 2048, 48, 64, 1, 128, 128, True),  # mamba2's longest prompt
        (1, 1024, 64, 64, 1, 64, 128, True),   # zamba2's 1000 tokens, padded
        (1, 512, 8, 64, 2, 128, 128, True),    # two groups
        (1, 256, 8, 64, 1, 128, 16, False),    # chunk 16
        (2, 384, 8, 64, 2, 64, 128, True),     # two rows of the batch
        (1, 256, 6, 160, 1, 32, 64, False),    # P past one 64-column slice
        (1, 256, 48, 64, 1, 128, 128, True),   # mamba2's heads, 2 chunks
        (1, 256, 64, 64, 1, 64, 128, True),    # zamba2's heads
        (2, 64, 8, 16, 2, 16, 16, False),      # two groups, two rows of the batch
        (1, 128, 8, 64, 1, 128, 128, False),   # one chunk only
        (1, 192, 8, 64, 2, 128, 64, True),     # chunk 64: one score tile
        (2, 96, 4, 8, 1, 24, 32, False),       # P below a slice, N not 16k
        (1, 40, 3, 40, 1, 20, 8, False),       # P not a slice multiple, chunk 8
    ],
)
def test_ssd_kernel_matches_plain(card, b, l, h, p, g, n, chunk, model_decay, dtype):
    """The three SSD phases against the plain scan; bf16 x, dt, B and C
    (a stays f32) give a bf16 y and an f32 state."""
    x, dt, a, bb, cc = (t.to(card) for t in _ssd_inputs(b, l, h, p, g, n, l + h,
                                                          model_decay))
    x, dt, bb, cc = (t.to(dtype) for t in (x, dt, bb, cc))
    want_y, want_s = sc.ssd_chunk_plain(x, dt, a, bb, cc, chunk=chunk)
    y, s = _launched(sc.ssd_chunk, lambda: sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk))
    assert y.shape == x.shape and s.shape == (b, h, p, n)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close_rms(y, want_y, rtol=None if dtype == torch.float32 else 2.0 ** -7)
    _close_rms(s, want_s)


def test_ssd_kernel_is_deterministic(card):
    """Two launches at mamba2's 2048-token shape are bit-identical: no
    atomics, the chunk states summed in chunk order."""
    x, dt, a, bb, cc = (t.to(card) for t in _ssd_inputs(1, 2048, 48, 64, 1, 128, 9,
                                                          True))
    first = sc.ssd_chunk(x, dt, a, bb, cc, chunk=128)
    again = sc.ssd_chunk(x, dt, a, bb, cc, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_reduced_ssm_prefill_on_card_matches_cpu(card, arch):
    """A reduced mamba2 / zamba2 prefill (f32) on the card against the
    same prefill on the CPU's plain versions: one SSD launch per layer,
    one flash launch per shared-attention site."""
    cfg = reduced(get_config(arch), layers=4, d_model=64, vocab=128)
    mod = mamba if arch == "mamba2-780m" else hybrid

    def state(device):
        if mod is mamba:
            return mamba.init_state(cfg, 2, device)
        return hybrid.init_state(cfg, 2, 48, device=device)

    params = mod.init(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128, (2, 37)))
    want, want_state = mod.prefill(params, toks, cfg, state("cpu"))
    ssd0, flash0 = sc.ssd_chunk.launches, fa.flash_attention.launches
    got, got_state = mod.prefill(_to(params, card), toks.to(card), cfg, state(card))
    assert sc.ssd_chunk.launches == ssd0 + cfg.n_layers
    sites = hybrid.n_sites(cfg) if mod is hybrid else 0
    assert fa.flash_attention.launches == flash0 + sites
    _close_rms(got.cpu(), want)
    leaves = (lambda st: list(st) if mod is mamba else [*st["ssm"], *st["kv"]])
    for g, w in zip(leaves(got_state), leaves(want_state)):
        _close_rms(g.cpu(), w)


# --------------------------------------------------------------------------
# the stream engine on the card
# --------------------------------------------------------------------------


def _served(family, card, link, *, check=True, sync_mode=None, frames=5):
    """Serve ``frames`` 64x64 frames at micro-batch 2 on the card (the last
    micro-batch padded) with the batch-pinned plan; returns the engine,
    its report and outputs, the params and frames on the card, and the
    plan.  ``sync_mode`` wraps ``run()`` in
    ``torch.cuda.set_sync_debug_mode``."""
    from repro_torch.serving import CNNStreamEngine, ServeConfig

    api, cpu = get_cnn_api(family), get_cnn_api(family, device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    params = _card_params(cpu.init(cfg, torch.Generator().manual_seed(4)), card)
    x = _rand((frames, 64, 64, 3), 9)
    gp = api.partition(cfg, Fraction(3), 3)
    kp = gp.kernel_plan(batch=2)
    eng = CNNStreamEngine(api.graph(cfg), params, gp, ServeConfig(
        microbatch=2, kernel_plan=kp, link_quant=link, check=check))
    eng.submit_all(x)
    torch.cuda.synchronize()
    if sync_mode is not None:
        torch.cuda.set_sync_debug_mode(sync_mode)
    try:
        rep = eng.run()
        out = eng.outputs()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return api, cfg, eng, rep, out, params, x.to(card), gp, kp


@pytest.mark.parametrize("link", [None, "int8"])
@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_stream_engine_on_card_equals_apply_staged(card, family, link):
    """The engine's outputs on the card equal ``apply_staged`` on the same
    zero-padded micro-batches bit for bit (both run every node at the
    pinned batch of 2), fp32 and int8 links; ``outputs()`` is one tensor
    on the card; every arithmetic node launched once per micro-batch."""
    before = _kernel_launches()
    api, cfg, eng, rep, out, params, x, gp, kp = _served(family, card, link)
    arith = [ip for ip in kp.values() if ip.has_kernel]
    per_batch = (sum(ip.kind in ("pointwise", "dense") for ip in arith),
                 sum(ip.kind == "conv" for ip in arith),
                 sum(ip.kind == "dwconv" for ip in arith))
    assert tuple(a - b for a, b in zip(_kernel_launches(), before)) == tuple(
        3 * n for n in per_batch)
    assert rep.completed == 5 and rep.stall_free
    assert out.is_cuda and out.shape == (5, cfg.num_classes)
    pad = torch.zeros_like(x[:1])
    batches = [x[0:2], x[2:4], torch.cat([x[4:5], pad])]
    want = torch.cat([api.apply_staged(params, b, cfg, partition=gp, plan=kp,
                                       link_quant=link) for b in batches])[:5]
    assert torch.equal(out, want)


@pytest.mark.parametrize("check", [False, True])
def test_stream_engine_reads_nothing_back_during_a_run(card, check):
    """Between ``begin`` and ``finish`` nothing waits for the card: under
    ``torch.cuda.set_sync_debug_mode("error")`` any synchronizing call
    (a copy to the host, ``.item()``, a tensor's truth value) raises.
    The node checks of ``check=True`` compare shapes and MAC counts, so
    they do not sync either."""
    for link in (None, "int8"):
        _, _, _, rep, out, _, _, _, _ = _served("mobilenet_v2", card, link,
                                                check=check, sync_mode="error")
        assert rep.completed == 5 and bool(torch.isfinite(out).all())


# --------------------------------------------------------------------------
# the device pipeline on the card: stages on CUDA streams of their own
# --------------------------------------------------------------------------


def _device_pipeline(family, card, n_stages, link=None, microbatch=2, tracer=None):
    """A placed 64x64 pipeline of ``family`` on the card (every stage on
    cuda:0 on a one-card host), the batch-pinned plan, its params and 8
    frames on the card."""
    from repro_torch.distributed.device_pipeline import DevicePipeline

    api, cpu = get_cnn_api(family), get_cnn_api(family, device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    params = _card_params(cpu.init(cfg, torch.Generator().manual_seed(4)), card)
    dse = {"link_dtype": "int8"} if link else {}
    gp = api.partition(cfg, Fraction(3), n_stages, **dse)
    kp = gp.kernel_plan(batch=microbatch)
    dp = DevicePipeline.build(api.graph(cfg), params, partition=gp, plan=kp,
                              link_quant=True if link else None, tracer=tracer)
    return api, cfg, dp, params, gp, kp, _rand((8, 64, 64, 3), 11).to(card)


@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_device_pipeline_launches_on_its_stage_streams(card, family, monkeypatch):
    """Every stage owns a stream of its own on its card, and every kernel
    the GPipe run launches goes on one of them (never the caller's); the
    logits equal ``apply_staged`` per micro-batch bit for bit."""
    api, cfg, dp, params, gp, kp, x = _device_pipeline(family, card, 3)
    pipe = dp.pipeline
    assert dp.placement_ordinals() == (0,) * 3
    handles = {s.cuda_stream for s in pipe.streams}
    assert len(handles) == 3
    assert torch.cuda.current_stream().cuda_stream not in handles
    used = []
    real = _build.raw_stream

    def spy(device):
        used.append(real(device))
        return used[-1]

    monkeypatch.setattr(_build, "raw_stream", spy)
    before = _kernel_launches()
    out = dp.run(x, microbatch=2)
    launched = sum(_kernel_launches()) - sum(before)
    assert launched == len(used) > 0 and set(used) == handles
    want = torch.cat([api.apply_staged(params, x[i:i + 2], cfg, partition=gp, plan=kp)
                      for i in range(0, 8, 2)])
    assert torch.equal(out, want)


def test_device_pipeline_allocator_reuse_stress(card):
    """Many one-frame micro-batches through three streams: boundary tensors
    are dropped after their last consumer while later stages may still
    read them, so without ``record_stream`` the caching allocator could
    hand their memory to the next micro-batch.  Two runs on the same frames
    are bit-identical, and equal ``apply_staged`` frame by frame."""
    api, cfg, dp, params, gp, _, x = _device_pipeline("resnet18", card, 3,
                                                      link="int8", microbatch=1)
    x = torch.cat([x, x.flip(0), 2 * x, -x])  # 32 frames
    kp = gp.kernel_plan(batch=1)
    a = dp.run(x, microbatch=1)
    scratch = [torch.randn((8, 64, 64, 64), device=card) for _ in range(4)]
    b = dp.run(x, microbatch=1)
    del scratch
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    want = torch.cat([api.apply_staged(params, x[i:i + 1], cfg, partition=gp, plan=kp,
                                       link_quant=True) for i in range(len(x))])
    assert torch.equal(a, want)


@pytest.mark.parametrize("link", [None, "int8"])
def test_device_pipeline_reads_nothing_back_during_a_run(card, link):
    """``DevicePipeline.run`` never waits on the card: under
    ``torch.cuda.set_sync_debug_mode("error")`` a synchronizing call
    raises.  The host waits only after, for the comparison."""
    api, cfg, dp, params, gp, kp, x = _device_pipeline("mobilenet_v2", card, 3, link)
    dp.run(x, microbatch=2)  # warm-up: params placed, kernels loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = dp.run(x, microbatch=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out.is_cuda and bool(torch.isfinite(out).all())


def test_placed_int8_transfer_bytes_equal_the_plans_cut_bytes(card):
    """The stream engine's ``execute="devices"`` on the card with int8
    links and tracing: each placed crossing counts its int8 payload and
    its 4-byte scale, the plan's priced cut bytes x micro-batches; the
    served outputs equal ``execute=True``'s bit for bit."""
    from repro_torch.serving import ServeConfig

    api, cpu = get_cnn_api("resnet18"), get_cnn_api("resnet18", device="cpu")
    cfg = api.make_config(input_hw=(64, 64))
    params = _card_params(cpu.init(cfg, torch.Generator().manual_seed(4)), card)
    x = _rand((6, 64, 64, 3), 12)
    gp = api.partition(cfg, Fraction(3), 3, link_dtype="int8")
    config = ServeConfig(microbatch=2, kernel_plan=gp.kernel_plan(batch=2),
                         link_quant=True, trace=True)
    host, _ = api.serve(params, x, cfg, input_rate=Fraction(3), n_stages=3,
                        link_dtype="int8", config=config)
    placed, rep = api.serve(params, x, cfg, input_rate=Fraction(3), n_stages=3,
                            link_dtype="int8", config=config.with_(execute="devices"))
    assert torch.equal(placed, host)
    graph, stage_of = api.graph(cfg), gp.stage_plan.stage_index()
    want = {}
    for v in graph.topo_order():
        for u in graph.preds(v):
            if stage_of[u] != stage_of[v]:
                spec = graph.spec(u)
                feats = 2 * spec.out_hw[0] * spec.out_hw[1] * spec.d_out
                want[f"transfer_bytes{{dtype=int8,edge={u}->s{stage_of[v]}}}"] = \
                    3 * (feats + 4)
    got = {k: v for k, v in rep.metrics.snapshot().items()
           if k.startswith("transfer_bytes")}
    assert got == want and got


# ---------------------------------------------------------------------------
# training: the kernels refuse autograd; a reduced train step on the card
# ---------------------------------------------------------------------------

GUARDED = {
    "fcu_matmul": lambda x: fcu_matmul.fcu_matmul(x, torch.ones(8, 8, device=x.device),
                                                  bm=4, bk=8, bn=8),
    "kpu_conv": lambda x: kpu_conv.kpu_conv(x.reshape(1, 2, 2, 8),
                                            torch.ones(3, 3, 8, 8, device=x.device),
                                            stride=1, bm=4, bci=8, bco=8),
    "dw_conv": lambda x: dw_conv.dw_conv(x.reshape(1, 2, 2, 8),
                                         torch.ones(3, 3, 8, device=x.device),
                                         stride=1, bm=2, bc=8),
    "flash_attention": lambda x: fa.flash_attention(
        x.reshape(1, 2, 1, 16), *[torch.ones(1, 1, 1, 16, device=x.device)] * 2,
        block_q=16, block_k=16),
    "ssd_chunk": lambda x: sc.ssd_chunk(
        x.reshape(1, 16, 1, 2), torch.ones(1, 16, 1, device=x.device),
        -torch.ones(1, device=x.device), *[torch.ones(1, 16, 1, 2, device=x.device)] * 2,
        chunk=16),
}


@pytest.mark.parametrize("name", sorted(GUARDED))
def test_kernels_refuse_autograd_on_card(card, name):
    """A CUDA operand requiring grad with grad enabled raises before the
    launch (the launch counter stays put); under ``torch.no_grad()`` the
    same call launches and matches the plain version on the CPU."""
    mod = {"fcu_matmul": fcu_matmul, "kpu_conv": kpu_conv, "dw_conv": dw_conv,
           "flash_attention": fa, "ssd_chunk": sc}[name]
    wrapper = getattr(mod, name)
    x = _rand((4, 8), 40).to(card).requires_grad_(True)
    before = wrapper.launches
    with pytest.raises(RuntimeError, match=f"{name}: the kernel has no backward"):
        GUARDED[name](x)
    assert wrapper.launches == before
    with torch.no_grad():
        got = GUARDED[name](x)
    assert wrapper.launches == before + 1
    want = GUARDED[name](x.detach().cpu())
    for a, b in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        _close(a.cpu(), b)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m", "zamba2-1.2b"])
def test_reduced_train_step_on_card_matches_cpu(card, arch):
    """``loss_fn`` and its grads at 2 layers, d_model 64, vocab 512, 64
    tokens, f32, TF32 off: the card within 1e-4 of the CPU (loss
    relative, each grad leaf of its scale), and no kernel launched."""
    from repro_torch.launch import train
    from repro_torch.models.registry import get_api
    from repro_torch.tree import leaves, unflatten

    cfg = reduced(get_config(arch), layers=2, d_model=64, vocab=512)
    cpu = get_api(cfg, "cpu").init(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 512, (2, 64)), "labels": rng.integers(0, 512, (2, 64))}
    launches = fa.flash_attention.launches + sc.ssd_chunk.launches
    out = {}
    for dev in ("cpu", card):
        params = train.trainable(unflatten(
            cpu, [p.detach().clone().to(dev) for p in leaves(cpu)]))
        loss, _ = get_api(cfg, dev).loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves(params), materialize_grads=True)
        out[str(dev)] = (loss.detach().cpu(), [g.cpu() for g in grads])
    assert fa.flash_attention.launches + sc.ssd_chunk.launches == launches
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out["cuda"]
    assert abs(float(l_card) - float(l_cpu)) <= TOL * abs(float(l_cpu))
    for a, b in zip(g_card, g_cpu):
        assert (a - b).abs().max().item() <= TOL * max(b.abs().max().item(), 1e-30)


def test_bf16_head_backward_on_card(card):
    """The card's bf16 head under autograd (f32 logits; a backward of two
    bf16 terms of the f32 cotangent): grads within one bf16 rounding
    (2^-8) of the f32 products of the same bf16 values."""
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((64, 128), generator=gen, device=card).bfloat16().requires_grad_(True)
    table = (0.02 * torch.randn((512, 128), generator=gen, device=card)).bfloat16()
    table.requires_grad_(True)
    g = torch.randn((64, 512), generator=gen, device=card)
    logits = unembed(table, x)
    assert logits.dtype == torch.float32 and logits.grad_fn is not None
    got = torch.autograd.grad(logits, [x, table], g)
    want = (g @ table.detach().float(), g.t() @ x.detach().float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert (a.float() - b).abs().max().item() <= 2.0 ** -8 * b.abs().max().item()


@pytest.fixture
def one_rank_world(tmp_path):
    """A gloo world of one rank in this process, destroyed after."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_kernels_refuse_a_dtensor_on_card(card, one_rank_world):
    """A DTensor's ``data_ptr`` is one rank's shard: ``check_operands``
    refuses it, and a mesh route hands the kernel ``to_local()``."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, distribute_tensor
    mesh = init_device_mesh("cuda", (1,))
    x = distribute_tensor(torch.ones((1, 128, 4, 16), device=card), mesh, [Replicate()])
    with pytest.raises(TypeError, match="DTensor"):
        _build.check_operands("probe", x)
    dt, b = (distribute_tensor(t, mesh, [Replicate()]) for t in (
        torch.ones((1, 128, 4), device=card), torch.ones((1, 128, 1, 16), device=card)))
    a = -torch.ones(4, device=card)
    launches = sc.ssd_chunk.launches
    with pytest.raises(TypeError, match="DTensor"):
        sc.ssd_chunk(x, dt, a, b, b, chunk=64)
    assert sc.ssd_chunk.launches == launches


def _seq_parallel_on_card(rank, world):
    """Rank side of the test below: ``ssd_seq_parallel`` on a (1, 2) mesh
    of cuda:0 ranks, and one ``ssd_chunk`` over the whole sequence."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.nn.ssm import ssd_seq_parallel
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, l, h, p, g, n, chunk = 1, 512, 8, 32, 2, 64, 64
    x = torch.randn((b, l, h, p), generator=gen, device="cuda") * 0.5
    dt = torch.nn.functional.softplus(torch.randn((b, l, h), generator=gen, device="cuda") - 3)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    bb = torch.randn((b, l, g, n), generator=gen, device="cuda") * 0.3
    cc = torch.randn((b, l, g, n), generator=gen, device="cuda") * 0.3
    before = sc.ssd_chunk.launches
    y, s = ssd_seq_parallel(x, dt, a, bb, cc, chunk=chunk, mesh=make_local_mesh(world))
    launched = sc.ssd_chunk.launches - before
    want_y, want_s = sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk)
    return launched, y.cpu(), s.cpu(), want_y.cpu(), want_s.cpu()


def test_ssd_seq_parallel_on_card_equals_one_kernel(card, tmp_path):
    """2 ranks on cuda:0 under gloo, each scanning its half on the SSD
    kernel (one launch a rank), against one kernel launch over the whole
    sequence: y and the final state at the SSD's 2e-4 (element and RMS).
    The library is built here before the ranks start."""
    from torch_ranks import result, run_ranks
    _build.library()
    got = result(run_ranks(2, {"ssd": _seq_parallel_on_card}, tmp_path, device="cuda"),
                 "ssd")
    for launched, y, s, want_y, want_s in got:
        assert launched == 1
        _close_rms(y, want_y)
        _close_rms(s, want_s)
