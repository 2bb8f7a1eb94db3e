"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda`` and
skips where no CUDA device is present (decided inside the ``card``
fixture).  On a machine with an H100 and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The first test builds the kernels with nvcc.  fp32 against fp32 in
another summation order is held at 1e-4 of the output's scale.  The flash
kernel is held element by element, |y - plain| <= rtol x |plain| + atol:
bf16 outputs, computed in f32 and rounded once each side, at 2^-7 and
1e-4; f32 at 1e-4 and 1e-5.  The SSD kernel is held element by element
against its plain version at the JAX kernel test's 2e-4, scaled by the
element and by the output's RMS: |y - plain| <= 2e-4 x |plain| + 2e-4 x
rms(plain).
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.dse import select_ours  # noqa: E402
from repro_torch.core.tiles import select_tile_for_impl  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.kernels import dw_conv, fcu_matmul, kpu_conv  # noqa: E402
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


def _close_elementwise(got, want, rtol, atol):
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= rtol * want.float().abs() + atol).all())


def _close_rms(got, want, tol=SSD_TOL):
    torch.cuda.synchronize()
    want = want.float()
    limit = tol * want.abs() + tol * want.square().mean().sqrt()
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
    ],
)
def test_flash_kernel_matches_plain(card, dtype, h, hkv, sq, sk, d, causal):
    q = _rand((2, h, sq, d), sq + d).to(card, dtype)
    k = _rand((2, hkv, sk, d), sk).to(card, dtype)
    v = _rand((2, hkv, sk, d), sk + 1).to(card, dtype)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    for block_q, block_k in {fa.flash_blocks(2 * h, sq), (16, 64), (64, 16)}:
        y = _launched(fa.flash_attention, lambda: fa.flash_attention(
            q, k, v, causal=causal, block_q=block_q, block_k=block_k))
        assert y.dtype == dtype and y.shape == q.shape
        _close_elementwise(y, want, *FLASH_TOL[dtype])


def test_flash_launches_count_only_launches(card):
    q, kv = torch.ones(1, 2, 8, 16), torch.ones(1, 1, 8, 16)
    before = fa.flash_attention.launches
    fa.flash_attention(q, kv, kv, block_q=16, block_k=16)    # CPU: plain version
    with pytest.raises(ValueError):
        fa.flash_attention(q.to(card), kv.to(card), kv.to(card), block_q=8,
                           block_k=16)
    assert fa.flash_attention.launches == before
    fa.flash_attention(q.to(card), kv.to(card), kv.to(card), block_q=16, block_k=16)
    assert fa.flash_attention.launches == before + 1


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


@pytest.mark.parametrize(
    "b,l,h,p,g,n,chunk,model_decay",
    [
        (1, 256, 48, 64, 1, 128, 128, True),   # mamba2's heads, 2 chunks
        (1, 256, 64, 64, 1, 64, 128, True),    # zamba2's heads
        (2, 64, 8, 16, 2, 16, 16, False),      # two groups, two rows of the batch
        (1, 128, 8, 64, 1, 128, 128, False),   # one chunk only
        (1, 192, 8, 64, 2, 128, 64, True),     # chunk 64: one score tile
        (2, 96, 4, 8, 1, 24, 32, False),       # P below a slice, N not 16k
        (1, 40, 3, 40, 1, 20, 8, False),       # P not a slice multiple, chunk 8
    ],
)
def test_ssd_kernel_matches_plain(card, b, l, h, p, g, n, chunk, model_decay):
    x, dt, a, bb, cc = (t.to(card) for t in _ssd_inputs(b, l, h, p, g, n, l + h,
                                                          model_decay))
    want_y, want_s = sc.ssd_chunk_plain(x, dt, a, bb, cc, chunk=chunk)
    y, s = _launched(sc.ssd_chunk, lambda: sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk))
    assert y.shape == x.shape and s.shape == (b, h, p, n)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close_rms(y, want_y)
    _close_rms(s, want_s)


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
