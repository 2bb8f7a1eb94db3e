"""The port's planner against the JAX package's, and its Hopper tiles.

For all four CNN families at 224x224 and every rate of the paper's
MobileNetV2 sweep (``benchmarks/table2_mnv2_rates.py::PAPER_ROWS``), the
port's ``plan_graph`` must give exactly the reference's per-node
(j, h, p, demand, q_in) — exact Fractions — and the same join buffers.
Each Hopper tile must keep the paper's rule (bk >= j, bn >= d_out/h,
both dividing their dimension, Eq. 9) within the H100 block budgets.
"""
from fractions import Fraction

import pytest

pytest.importorskip("torch")

from benchmarks.table2_mnv2_rates import PAPER_ROWS  # noqa: E402
from repro.core.graph import plan_graph as ref_plan_graph  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro_torch.core.dse import select_ours  # noqa: E402
from repro_torch.core.graph import plan_graph  # noqa: E402
from repro_torch.core.hw import H100_SXM  # noqa: E402
from repro_torch.core.tiles import (  # noqa: E402
    MAX_MICRO,
    MAX_THREADS,
    THREADS,
    dw_halo_bytes,
    dw_rows,
    gemm_layout,
    plan_dim_tile,
    select_tile,
    select_tile_for_impl,
)
from repro_torch.models.registry import cnn_families, get_cnn_api  # noqa: E402
from repro_torch.models.topology import conv_spec  # noqa: E402

FAMILIES = ("mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34")
RATES = [row[0] for row in PAPER_ROWS]


def _plans(family, rate):
    ra = ref_api(family)
    pa = get_cnn_api(family, device="cpu")
    return (ref_plan_graph(ra.graph(ra.make_config()), rate),
            plan_graph(pa.graph(pa.make_config()), rate))


@pytest.mark.parametrize("rate", RATES, ids=[str(r) for r in RATES])
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_matches_reference(family, rate):
    ref_gp, gp = _plans(family, rate)
    ref_kp = ref_gp.kernel_plan()
    kp = gp.kernel_plan()
    assert list(kp) == list(ref_kp)
    for name, ip in kp.items():
        r = ref_kp[name]
        assert (ip.kind, ip.j, ip.h, ip.p, ip.demand, ip.q_in) == (
            r.kind, r.j, r.h, r.p, r.demand, r.q_in), name
        assert type(ip.demand) is Fraction and type(ip.q_in) is Fraction
        assert (ip.tile is None) == (r.tile is None), name
    assert [(b.join, b.src, b.bound_pixels, b.bits) for b in gp.buffers] == [
        (b.join, b.src, b.bound_pixels, b.bits) for b in ref_gp.buffers]
    assert gp.total_mults == ref_gp.total_mults
    assert gp.continuous_flow

    for name, ip in kp.items():
        t = ip.tile
        if t is None:
            continue
        spec = gp.graph.spec(name)
        impl = gp.impls[name]
        r_phase = impl.demand / impl.p_raw
        assert t.bk >= ip.j and spec.d_in % t.bk == 0, name
        assert t.smem_bytes <= H100_SXM.smem_per_block, name
        if spec.kind == "dwconv":
            assert t.bn == 1 and t.bm % spec.out_hw[1] == 0, name
            continue
        assert t.bn >= spec.d_out // ip.h and spec.d_out % t.bn == 0, name
        assert Fraction(t.bk, spec.d_out // t.bn) >= r_phase, name  # Eq. 9
        tx, ty, tm, tn, g = gemm_layout(t.bm, t.bn, t.bk)
        assert tx * ty <= THREADS and tx * ty * g <= MAX_THREADS, name
        assert tm <= MAX_MICRO and tn <= MAX_MICRO and 1 <= g <= t.bk, name
        assert t.acc_per_thread == tm * tn and tm * ty >= t.bm, name
        assert tn * tx >= t.bn, name
        regs = tx * ty * g * t.acc_per_thread
        assert regs <= H100_SXM.regs_per_sm, name


@pytest.mark.parametrize("rate", [Fraction(1, 8), Fraction(3)], ids=str)
@pytest.mark.parametrize("family", FAMILIES)
def test_ref11_plan_matches_reference(family, rate):
    """The [11] baseline scheme plans the same (j, h, p, configs, mults)."""
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    ref_gp = ref_plan_graph(ra.graph(ra.make_config()), rate, scheme="ref11")
    gp = plan_graph(pa.graph(pa.make_config()), rate, scheme="ref11")
    assert list(gp.impls) == list(ref_gp.impls)
    for name, impl in gp.impls.items():
        r = ref_gp.impls[name]
        assert (impl.j, impl.h, impl.p, impl.configs, impl.mults, impl.capacity,
                impl.pad_waste) == (r.j, r.h, r.p, r.configs, r.mults, r.capacity,
                                    r.pad_waste), name
    assert gp.kernel_plan().keys() == ref_gp.kernel_plan().keys()


def test_degenerate_tpu_tiles_stay_aligned():
    """At rate 3 the TPU rule plans bc=1 for MobileNetV2's 960-channel
    depthwise convs and bn=1 for fc; the Hopper rule keeps 32 and 8."""
    api = get_cnn_api("mobilenet_v2", device="cpu")
    kp = api.plan(api.make_config(), Fraction(3))
    for n in ("b15_dw", "b16_dw", "b17_dw"):
        assert kp[n].j == 1 and kp[n].tile.bk == 32
    assert kp["fc"].tile.bn == 8 and kp["fc"].h == 1000
    assert plan_dim_tile(1000, 1) == 8
    assert plan_dim_tile(960, 1) == 32
    assert plan_dim_tile(3, 1) == 1


@pytest.mark.parametrize("node,halo", [("b1_dw", 3 * 114 * 32 * 4),
                                       ("b4_dw", 19 * 57 * 16 * 4),
                                       ("b15_dw", 9 * 9 * 32 * 4)])
def test_dw_tile_stages_its_input_rows(node, halo):
    """The depthwise block stages the input rows of its output rows once,
    SAME padding in place: ((rows - 1) * stride + 3) rows of ((wo - 1) *
    stride + 3) pixels by bc channels, f32-sized (bf16 takes half); the
    rows stay DW_OUTPUTS' rule (MobileNetV2 at 224, rate 3)."""
    api = get_cnn_api("mobilenet_v2", device="cpu")
    cfg = api.make_config()
    spec, t = api.graph(cfg).spec(node), api.plan(cfg, Fraction(3))[node].tile
    rows = t.bm // spec.out_hw[1]
    assert rows == dw_rows(*spec.out_hw, t.bk)
    assert t.smem_bytes == dw_halo_bytes(rows, spec.out_hw[1], t.bk, spec.kernel,
                                         spec.stride[0]) == halo


def test_bm_shrinks_to_fit_registers():
    """The TPU rule's bm of 512 beside a 128-wide bn cannot live in one
    block's registers: bm shrinks to 64 (a 8x4 tile a thread), and a
    batch-pinned bm to the largest fitting divisor of the runtime m."""
    with pytest.raises(ValueError, match="accumulator"):
        gemm_layout(512, 128)
    spec, _ = conv_spec("p", "pointwise", 256, 512, (56, 56), 1, 1)
    impl = select_ours(spec, Fraction(64))
    assert spec.d_out // impl.h == 128
    t = select_tile_for_impl(impl)
    assert (t.bn, t.bm, t.acc_per_thread) == (128, 64, 32)
    spec, _ = conv_spec("p", "pointwise", 256, 512, (7, 7), 1, 1)
    t = select_tile_for_impl(select_ours(spec, Fraction(64)), batch=8)
    assert (t.bn, t.bm) == (128, 56) and (8 * 49) % t.bm == 0


def test_uniform_select_tile():
    t = select_tile(8 * 49, 960, 160)
    assert 960 % t.bk == 0 and 160 % t.bn == 0 and t.bk % 32 == 0
    assert t.smem_bytes <= H100_SXM.smem_per_block
    t = select_tile(100, 64, 64, rate=Fraction(2))
    assert Fraction(t.bk, 64 // t.bn) >= 2


@pytest.mark.parametrize("kw", [dict(n_stages=2), dict(replicate=2),
                                dict(bram_budget=10**6)])
def test_staged_options_not_ported(kw):
    g = get_cnn_api("resnet18", device="cpu").make_config(input_hw=(32, 32)).graph()
    with pytest.raises(NotImplementedError, match="staged"):
        plan_graph(g, Fraction(3), **kw)


@pytest.mark.parametrize("objective", ["resources", "pareto"])
def test_resource_objectives_not_ported(objective):
    spec, _ = conv_spec("c", "conv", 16, 32, (8, 8), 3, 1)
    with pytest.raises(NotImplementedError, match="resource model"):
        select_ours(spec, Fraction(3), objective=objective)


def test_families():
    assert cnn_families() == tuple(sorted(FAMILIES))
