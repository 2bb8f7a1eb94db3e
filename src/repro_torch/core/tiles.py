"""Hopper adaptation of the (j, h) DSE: the tile each CUDA kernel runs.

The Hopper counterpart of the JAX package's ``core/tpu_tiles.py``.  The
paper's constraint set maps onto a CUDA thread-block tiling:

  j  (input features/clock, j | d_in)   -> contraction tile bk (bk | d_in),
                                           the depth one block stages
                                           through shared memory per step
  h  (outputs multiplexed,  h | d_out)  -> output-channel tile bn = d_out/h
  C = h*d_in/j reconfigurations          -> the block's k-loop trip count
  multi-pixel P                          -> pixel tile bm (output positions
                                           per block)
  continuous flow  j/h >= r              -> the tile keeps j/h >= r

Two selection paths share the constraints:

  * ``select_tile``          — the *uniform* path: one rate (or none) for
    the whole network, a BestRate search over the constrained HJ set.
  * ``select_tile_for_impl`` — the *rate-matched* path: one node's DSE
    choice becomes its tile.  ``j`` is the bk floor and ``d_out/h`` the
    bn floor; both grow only upward, so ``j/h >= r`` survives (Eq. 9,
    re-checked here as ``tpu_tiles.py`` does).

Where the TPU rule aligns to 128 lanes and fits VMEM, this one fits the
limits of the CUDA-core FCU / KPU block the kernels first had (since
replaced by the tensor-core block of ``kernels/csrc/tile_mma.cuh``, which
takes every tile this rule gives; a rule sized for that block is still
to come) and of ``dw_conv.cu``, whose block stages its input rows once in
shared memory (``dw_halo_bytes``):

  * alignment: a tile dimension is a multiple of 32 (a warp) where the
    channel count divides by 32, else of 8 where it divides by 8, else
    any divisor — so 960 channels give 32-wide tiles and 1000 outputs
    8-wide ones, never the TPU rule's 1-wide tiles;
  * shared memory: the block stages a ``[bk, bm]`` input slice and a
    ``[bk, bn]`` weight slice (each padded to the thread layout) per
    step, within the 227 KiB a block may use;
  * registers: 256 threads each hold a TM x TN accumulator with
    TM, TN <= 8 (``gemm_layout``), so bm shrinks until bm x bn fits —
    the TPU rule's bm of 512 beside a wide bn cannot live in one block.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

from .dse import LayerImpl
from .hw import H100_SXM
from .rate import divisors

# The limits of the planner's block model: the CUDA-core FCU / KPU block
# the kernels first had (replaced by kernels/csrc/tile_mma.cuh), and
# dw_conv.cu.  Shared memory is sized at 4 bytes an element: the kernels
# take float32 and bfloat16, and a plan that fits f32 fits bf16.
THREADS = 256          # threads of one k-group (the tile's thread grid)
MAX_THREADS = 512      # threads a block, k-groups included
MAX_GROUPS = 64        # k-groups a block (blockDim.z)
MAX_MICRO = 8          # TM, TN <= 8: at most 64 f32 accumulators a thread
MAX_BM = 512           # pixel tile cap, as in the TPU rule
DW_OUTPUTS = 4096      # depthwise outputs per block
WORD = 4               # bytes of an element, the wider of f32 and bf16


@dataclasses.dataclass(frozen=True)
class TileChoice:
    """A concrete thread-block tiling for one layer."""

    bm: int  # output-position (pixel) tile — the multi-pixel P
    bk: int  # contraction tile (the paper's j); channel tile for dwconv
    bn: int  # output-channel tile (d_out / h); 1 for dwconv
    smem_bytes: int  # shared memory one block stages per step
    acc_per_thread: int  # f32 accumulators each thread keeps in registers


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def gemm_layout(bm: int, bn: int, bk: int = 1) -> Tuple[int, int, int, int, int]:
    """Thread layout of the FCU / KPU block for a (bm, bk, bn) tile:
    ``(tx, ty, tm, tn, g)``.  A tx x ty grid of <= 256 threads covers the
    output tile, each thread a tm x tn register tile (powers of two <= 8):
    thread (x, y) owns rows y + ty*i and columns x + tx*j, with ty as
    small as the rows allow.  ``g`` k-groups of that grid share each
    staged bk step (group h takes kk = h, h+g, ...) and sum their partial
    tiles at the end: as many as fit 512 threads, bk, and shared memory.
    Raises when the tile cannot fit, which ``select_tile_for_impl`` never
    plans."""
    tx = min(THREADS, max(1, -(-bn // 4)))
    tm = _pow2_ceil(-(-bm // (THREADS // tx)))
    ty = -(-bm // tm)
    tn = _pow2_ceil(-(-bn // tx))
    if tm > MAX_MICRO or tn > MAX_MICRO:
        raise ValueError(
            f"tile bm={bm} x bn={bn} needs a {tm}x{tn} accumulator a "
            f"thread; the kernels hold at most {MAX_MICRO}x{MAX_MICRO}"
        )
    out_bytes = tm * ty * tn * tx * 4
    g = 1
    while (2 * g <= min(bk, MAX_GROUPS) and tx * ty * 2 * g <= MAX_THREADS
           and (2 * g - 1) * out_bytes <= H100_SXM.smem_per_block):
        g *= 2
    return tx, ty, tm, tn, g


def gemm_smem_bytes(bm: int, bk: int, bn: int, *, conv: bool = False) -> int:
    """Shared memory of one FCU / KPU block: per k step the [bk, bm]
    input slice (rows padded to the layout, plus one float of skew
    against bank conflicts) and the [bk, bn] weight slice, after three
    ints of window origin per row for the KPU (``conv``); the k-groups'
    final reduction reuses the same bytes."""
    tx, ty, tm, tn, g = gemm_layout(bm, bn, bk)
    staged = (tm * ty + 1 + tn * tx) * bk * WORD
    if conv:
        staged += 3 * 4 * tm * ty
    return max(staged, (g - 1) * tm * ty * tn * tx * 4)


def _fits(bm: int, bk: int, bn: int, conv: bool) -> bool:
    try:
        smem = gemm_smem_bytes(bm, bk, bn, conv=conv)
    except ValueError:
        return False
    return smem <= H100_SXM.smem_per_block


def hopper_align(dim: int) -> int:
    """The alignment a tile of a ``dim``-wide axis keeps (see module doc)."""
    for a in (32, 8):
        if dim % a == 0:
            return a
    return 1


def plan_dim_tile(dim: int, floor: int) -> int:
    """Smallest divisor of ``dim`` that is >= ``floor`` and keeps
    ``hopper_align(dim)``.  Growing a tile dimension only adds capacity,
    so the continuous-flow inequality the DSE established survives."""
    align = hopper_align(dim)
    for d in divisors(dim):
        if d >= floor and d % align == 0:
            return d
    return dim


def _fit_bm(m: int, bk: int, bn: int, conv: bool) -> int:
    """Largest power-of-two-halving of min(m, 512) whose block fits."""
    bm = min(m, MAX_BM)
    while bm > 1 and not _fits(bm, bk, bn, conv):
        bm //= 2
    return bm


def pinned_bm(m: int, bk: int, bn: int, *, conv: bool = False) -> int:
    """Largest divisor of ``m`` (capped at 512) whose block fits — the
    batch-pinned pixel tile, so the runtime re-fit is the identity."""
    cands = [d for d in divisors(m) if d <= MAX_BM]
    for bm in reversed(cands):
        if _fits(bm, bk, bn, conv):
            return bm
    return 1


def _gemm_tile(bm: int, bk: int, bn: int, conv: bool) -> TileChoice:
    if not _fits(bm, bk, bn, conv):
        raise ValueError(
            f"no block fits tile (bk={bk}, bn={bn}) even at bm={bm}: "
            f"{H100_SXM.smem_per_block} B of shared memory a block"
        )
    _, _, tm, tn, _ = gemm_layout(bm, bn, bk)
    return TileChoice(
        bm=bm,
        bk=bk,
        bn=bn,
        smem_bytes=gemm_smem_bytes(bm, bk, bn, conv=conv),
        acc_per_thread=tm * tn,
    )


def dw_rows(ho: int, wo: int, bc: int) -> int:
    """Output rows one depthwise block computes: as many as keep the
    block at <= 4096 outputs, at least one."""
    return max(1, min(ho, DW_OUTPUTS // max(1, wo * bc)))


def dw_halo_bytes(rows: int, wo: int, bc: int, kernel: Tuple[int, int],
                  stride: int, word: int = WORD) -> int:
    """Shared memory of one depthwise block: the input rows its ``rows``
    output rows read, ``(rows - 1) * stride + kh`` of them, each
    ``(wo - 1) * stride + kw`` pixels wide with the SAME padding in
    place, ``bc`` channels of ``word`` bytes."""
    kh, kw = kernel
    return ((rows - 1) * stride + kh) * ((wo - 1) * stride + kw) * bc * word


def dw_tile(
    out_hw: Tuple[int, int], bc: int, *, kernel: Tuple[int, int], stride: int = 1
) -> TileChoice:
    """The depthwise block: ``bm`` = whole output rows (a multiple of the
    output width), ``bk`` = the channel tile.  The block stages the input
    rows those outputs read once in shared memory (``smem_bytes``, the
    halo of ``dw_halo_bytes``)."""
    ho, wo = out_hw
    rows = dw_rows(ho, wo, bc)
    return TileChoice(
        bm=rows * wo,
        bk=bc,
        bn=1,
        smem_bytes=dw_halo_bytes(rows, wo, bc, kernel, stride),
        acc_per_thread=1,
    )


def select_tile(
    m: int,
    d_in: int,
    d_out: int,
    *,
    rate: Optional[Fraction] = None,
    conv: bool = False,
) -> TileChoice:
    """Choose (bm, bk, bn) for an [m, d_in] x [d_in, d_out] product
    (``conv``: the KPU block, whose shared memory also holds row origins).

    The candidate set is the paper's HJ set (divisor-constrained); the
    BestRate criterion keeps tiles whose ``bk / h`` covers ``rate``.  The
    tie-break prefers aligned tiles, then deep accumulation (big bk, up
    to 128 so a useful bm still fits), then bn near 128, then big bm.
    With ``rate=None`` the highest-intensity aligned tile is chosen.
    """
    best = None
    for bk in divisors(d_in):
        if bk > 128:
            continue
        for bn in divisors(d_out):
            if bn > 2048:
                continue
            h = d_out // bn
            if rate is not None and Fraction(bk, max(1, h)) < rate:
                continue
            bm = _fit_bm(m, bk, bn, conv)
            if not _fits(bm, bk, bn, conv):
                continue
            aligned = bk % hopper_align(d_in) == 0 and bn % hopper_align(d_out) == 0
            score = (aligned, bk, -abs(bn - 128), bm)
            if best is None or score > best[0]:
                best = (score, bm, bk, bn)
    if best is None:
        raise ValueError(
            f"no tile covers rate {rate} for [{m}, {d_in}] x [{d_in}, {d_out}]"
        )
    _, bm, bk, bn = best
    return _gemm_tile(bm, bk, bn, conv)


def select_tile_for_impl(
    impl: LayerImpl,
    *,
    batch: Optional[int] = None,
) -> TileChoice:
    """Map one node's DSE implementation onto its CUDA block tiling.

      * conv / pointwise / dense — ``bk`` = smallest aligned divisor of
        ``d_in`` >= j; ``bn`` = smallest aligned divisor of ``d_out`` >=
        ``d_out / h``; ``bm`` shrinks from 512 until the block's
        registers and shared memory hold it.
      * dwconv — the channel tile ``bk`` = smallest aligned divisor of
        ``d_in`` >= j (h = 1 per §II-B); ``bn`` is 1 and ``bm`` whole
        output rows (``dw_tile``).

    When the impl's own (j, h) satisfy Eq. 9 — always true for scheme
    'ours' — the tile still satisfies ``bk / (d_out // bn) >= r_phase``;
    this is re-checked here.  ``batch`` pins bm to a divisor of the
    batch-flattened runtime m (``pinned_bm``).
    """
    lay = impl.layer
    if lay.kind not in ("conv", "dwconv", "pointwise", "dense"):
        raise ValueError(
            f"{lay.name}: kind {lay.kind!r} has no kernel tiling "
            f"(non-arithmetic nodes carry no tile in an ImplPlan)"
        )
    m = lay.out_hw[0] * lay.out_hw[1]
    if batch is not None:
        if batch < 1:
            raise ValueError(f"{lay.name}: batch must be >= 1, got {batch}")
        m *= batch
    r_phase = impl.demand / impl.p_raw

    if lay.kind == "dwconv":
        bc = plan_dim_tile(lay.d_in, min(impl.j, lay.d_in))
        return dw_tile(lay.out_hw, bc, kernel=lay.kernel, stride=lay.stride[0])

    conv = lay.kind == "conv"
    bk = plan_dim_tile(lay.d_in, min(impl.j, lay.d_in))
    bn = plan_dim_tile(lay.d_out, max(1, lay.d_out // impl.h))
    if batch is not None:
        bm = pinned_bm(m, bk, bn, conv=conv)
    else:
        bm = _fit_bm(m, bk, bn, conv)
    h_tile = max(1, lay.d_out // bn)
    jh_holds_eq9 = Fraction(impl.j, max(1, impl.h)) >= r_phase
    if jh_holds_eq9 and Fraction(bk, h_tile) < r_phase:
        raise AssertionError(  # unreachable: growth preserves Eq. 9
            f"{lay.name}: tile (bk={bk}, h={h_tile}) lost continuous flow "
            f"for per-phase rate {r_phase}"
        )
    return _gemm_tile(bm, bk, bn, conv)
