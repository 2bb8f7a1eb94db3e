"""Why the FCU, KPU and SSD kernels run three TF32 products, on the CPU.

The kernels (``csrc/tile_mma.cuh``) feed the tensor cores tf32 operands:
each f32 value ``v`` is split once into ``hi = rna_tf32(v)`` and ``lo =
rna_tf32(v - hi)`` (``cvt.rna.tf32.f32``: round to nearest, ties away
from zero, to 10 mantissa bits), and a product is ``x_lo w_hi + x_hi w_lo
+ x_hi w_hi`` accumulated in f32.  Here that arithmetic is emulated in
PyTorch on the int32 view of f32 tensors, at main-path shapes of the
rate-3 plan at batch 8 (MobileNetV2's b12 / b15 projections, ResNet-18's
l4 3x3 conv through ``kpu_conv_plain``'s windows), on numpy inputs of
seed 15.  The gate is the kernels' own on the card: within 1e-4 of the
output's scale, max(1, max |plain|), of the f32 plain version.  The split
holds it; one TF32 rounding of each operand does not.  The SSD kernels
(``csrc/ssd_chunk.cu``) are emulated the same way at mamba2's chunk
(Q 128, N 128, P 64; two chunks, so the carried state's product counts)
against ``ssd_chunk_plain`` at their gate, |y - plain| <= 2e-4 x |plain|
+ 2e-4 x rms(plain) element by element.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fcu_matmul import fcu_matmul_plain  # noqa: E402
from repro_torch.kernels.kpu_conv import kpu_conv_plain  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk_plain  # noqa: E402

TOL = 1e-4
SEED = 15


def rna_tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 ``v``: add half of the dropped 13 bits'
    unit to the magnitude (the sign bit stands apart), then clear them."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = rna_tf32(v)
    return hi, rna_tf32(v - hi)


def product(x, w, terms):
    """``x @ w`` as the kernels compute it (``terms=3``) or with one TF32
    rounding of each operand (``terms=1``), f32 sums."""
    (x_hi, x_lo), (w_hi, w_lo) = split(x), split(w)
    if terms == 1:
        return torch.matmul(x_hi, w_hi)
    return torch.matmul(x_lo, w_hi) + torch.matmul(x_hi, w_lo) + torch.matmul(x_hi, w_hi)


def conv(x, w, stride, terms):
    """``kpu_conv_plain``'s per-tap windows, each tap's product as above."""
    kh, kw = w.shape[:2]
    acc = 0
    for dy, dx, win in _build.windows(x, kh, kw, stride):
        acc = acc + product(win, w[dy, dx], terms)
    return acc


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def test_rna_tf32_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10                       # tf32's unit at 1.0
    v = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 4, 1.0 + 3 * ulp / 4,
                      -(1.0 + ulp / 2), 3.0e-39], dtype=torch.float32)
    got = rna_tf32(v)
    assert got.tolist()[:5] == [1.0, 1.0 + ulp, 1.0, 1.0 + ulp, -(1.0 + ulp)]
    assert bool((got.view(torch.int32) & 0x1FFF == 0).all())
    hi, lo = split(v)
    assert bool((hi + lo == v)[:5].all())  # two terms carry these exactly


@pytest.mark.parametrize(
    "kind,m,d_in,d_out",
    [
        ("fcu", 1568, 576, 96),   # MobileNetV2 b12_project: [1568, 576] x [576, 96]
        ("fcu", 392, 960, 160),   # MobileNetV2 b15_project: [392, 960] x [960, 160]
        ("kpu", 392, 512, 512),   # ResNet-18 l4b2_conv1: 8x7x7x512 * 3x3x512x512
    ],
)
def test_three_tf32_products_hold_the_f32_gate_and_one_does_not(kind, m, d_in, d_out):
    rng = np.random.default_rng(SEED)
    if kind == "fcu":
        x = _rand(rng, m, d_in)
        w = _rand(rng, d_in, d_out, scale=d_in ** -0.5)
        want = fcu_matmul_plain(x, w)
        got = {t: product(x, w, t) for t in (3, 1)}
    else:
        x = _rand(rng, m // 49, 7, 7, d_in)
        w = _rand(rng, 3, 3, d_in, d_out, scale=(9 * d_in) ** -0.5)
        want = kpu_conv_plain(x, w, 1)
        got = {t: conv(x, w, 1, t) for t in (3, 1)}
    assert got[3].shape == want.shape
    assert _rel_err(got[3], want) <= TOL
    assert _rel_err(got[1], want) > TOL


SSD_TOL = 2e-4


def ssd_chunks(x, dt, a, b, c, chunk, terms):
    """The SSD kernels' decomposition (one group): each chunk's state and
    output from ``product``s of ``terms`` TF32 products, the state passed
    in f32."""
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    s = torch.zeros((bsz, h, p, n))
    ys = []
    for l0 in range(0, l, chunk):
        rows = slice(l0, l0 + chunk)
        dtc = dt[:, rows]                                          # [B, Q, H]
        acum = torch.cumsum(dtc * a, dim=1)
        bc, cc = b[:, rows, 0], c[:, rows, 0]                      # [B, Q, N]
        xd = x[:, rows] * dtc[..., None]                           # [B, Q, H, P]
        scores = product(cc, bc.transpose(1, 2), terms)           # [B, Qi, Qj]
        tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
        y = torch.empty_like(xd)
        for hh in range(h):
            ah = acum[:, :, hh]
            decay = torch.where(tri, torch.exp(ah[:, :, None] - ah[:, None, :]), 0.0)
            y_off = product(cc, s[:, hh].transpose(1, 2), terms) * torch.exp(ah)[..., None]
            y[:, :, hh] = y_off + product(decay * scores, xd[:, :, hh], terms)
            xw = xd[:, :, hh] * torch.exp(ah[:, -1:] - ah)[..., None]   # [B, Q, P]
            ds = product(xw.transpose(1, 2), bc, terms)           # [B, P, N]
            s[:, hh] = torch.exp(ah[:, -1])[:, None, None] * s[:, hh] + ds
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _ssd_worst(got, want):
    """The largest |got - want| as a share of the SSD gate's limit."""
    limit = SSD_TOL * want.abs() + SSD_TOL * want.square().mean().sqrt()
    return ((got - want).abs() / limit).max().item()


def test_three_tf32_products_hold_the_ssd_gate_and_one_does_not():
    """mamba2's chunk, as the model draws its inputs: x, B and C silu of a
    normal, dt a softplus around the dt_bias range, a = -(1 .. H)."""
    rng = np.random.default_rng(SEED)
    l, h, p, n, chunk = 256, 4, 64, 128, 128

    def silu(v):
        return v / (1 + np.exp(-v))

    x = silu(rng.standard_normal((1, l, h, p)))
    b, c = silu(rng.standard_normal((1, l, 1, n))), silu(rng.standard_normal((1, l, 1, n)))
    dt = np.log1p(np.exp(rng.standard_normal((1, l, h)) - 4.0))
    a = -np.arange(1, h + 1)
    x, dt, a, b, c = (torch.from_numpy(np.asarray(t, np.float32)) for t in (x, dt, a, b, c))
    want_y, want_s = ssd_chunk_plain(x, dt, a, b, c, chunk=chunk)
    worst = {}
    for terms in (3, 1):
        y, s = ssd_chunks(x, dt, a, b, c, chunk, terms)
        worst[terms] = max(_ssd_worst(y, want_y), _ssd_worst(s, want_s))
    assert worst[3] <= 1.0, worst
    assert worst[1] > 1.0, worst
