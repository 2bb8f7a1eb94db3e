"""The multi-stage planners in the port, against the JAX package's.

* The stage partitioner, the multi-chip planner ``plan_graph(n_stages=,
  bram_budget=, replicate=, n_devices=)`` and the replication DSE are
  pure Python over ``Fraction``s: the cut, the stream buffers (bits and
  depths), every node's (j, h, p) and the replications equal the
  reference's field by field, for the four families at 224x224.
* A stage plan never changes a node's Hopper tile (stream buffers
  re-time, never re-rate): the staged and monolithic kernel plans are
  equal at every rate of the paper's MobileNetV2 sweep.

Staged execution is ``tests/test_torch_staged.py``; the bf16 forward's
staged run ``tests/test_torch_staged_bf16.py``.
"""
import dataclasses
import re
from fractions import Fraction as F

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from benchmarks.table2_mnv2_rates import PAPER_ROWS  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import rate as ref_rate  # noqa: E402
from repro.core import replicate as ref_replicate  # noqa: E402
from repro.core import stage_partition as ref_sp  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro_torch.core import graph, rate, replicate, stage_partition  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402

FAMILIES = ("mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34")
RATES = [row[0] for row in PAPER_ROWS]


def plain(obj):
    """Builtins for a field-by-field comparison of port and reference
    objects (dataclasses as (class name, fields), Fractions kept)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(plain(v) for v in obj)
    if isinstance(obj, F):
        return ("Fraction", obj)
    return obj


# --------------------------------------------------------------------------
# the stage partitioner on small graphs (tests/core/test_stage_partition.py)
# --------------------------------------------------------------------------


def _two_diamonds(mod_rate, mod_graph, d=16, hw=(8, 8)):
    """Two residual blocks chained, with a head — 10 nodes, 2 shortcuts."""
    def pw(name, d_in, d_out):
        return mod_rate.LayerSpec(name=name, kind="pointwise", d_in=d_in,
                                  d_out=d_out, in_hw=hw, out_hw=hw)
    g = mod_graph.LayerGraph()
    prev = g.add(pw("stem", d, d))
    for b in range(2):
        block_in = prev
        for i in range(3):
            prev = g.add(pw(f"b{b}t{i}", d, d), [prev])
        prev = g.add(mod_rate.LayerSpec(name=f"b{b}add", kind="add", d_in=d, d_out=d,
                                        in_hw=hw, out_hw=hw), [prev, block_in])
    g.add(pw("head", d, d // 2), [prev])
    return g


def _outcome(fn, *args, **kwargs):
    """The result, or the exception's type and message."""
    try:
        return plain(fn(*args, **kwargs))
    except ValueError as e:  # GraphError too
        return (type(e).__name__, str(e))


def _same_planning(kwargs, g, rg):
    """``plan_graph(**kwargs)`` on both sides: the same plan, or the same
    refusal."""
    try:
        want = ref_graph.plan_graph(rg, F(3), **kwargs)
    except ValueError as e:
        with pytest.raises(type(e), match="^" + re.escape(str(e)) + "$"):
            graph.plan_graph(g, F(3), **kwargs)
        return None
    got = graph.plan_graph(g, F(3), **kwargs)
    _same_plan(got, want)
    return got


@pytest.mark.parametrize("n_stages", [2, 3, 4])
@pytest.mark.parametrize("link", ["int8", "fp32", {"stem": "fp32", "b0add": "bf16"}],
                         ids=["int8", "fp32", "mixed"])
def test_partition_graph_matches_reference(link, n_stages):
    g = _two_diamonds(rate, graph)
    rg = _two_diamonds(ref_rate, ref_graph)
    costs = stage_partition.plan_node_costs(graph.plan_graph(g, F(2)))
    ref_costs = ref_sp.plan_node_costs(ref_graph.plan_graph(rg, F(2)))
    assert costs == ref_costs
    for chain_cuts in (False, True):
        assert _outcome(stage_partition.partition_graph, g, costs, n_stages,
                        chain_cuts=chain_cuts, link_dtype=link) == _outcome(
            ref_sp.partition_graph, rg, ref_costs, n_stages, chain_cuts=chain_cuts,
            link_dtype=link)
    for budget in (10 ** 12, 4096, 1024, [10 ** 9] * (n_stages - 1) + [2048], 1):
        assert _outcome(stage_partition.partition_graph, g, costs, n_stages,
                        link_dtype=link, bram_budget=budget) == _outcome(
            ref_sp.partition_graph, rg, ref_costs, n_stages, link_dtype=link,
            bram_budget=budget), budget
    for positions in (True, False):
        assert stage_partition.legal_cut_positions(g, chain_only=positions) == \
            ref_sp.legal_cut_positions(rg, chain_only=positions)


def test_chain_partition_and_chip_allocation_match_reference():
    costs = [5.0, 1.0, 7.0, 3.0, 3.0, 2.0, 8.0, 1.0, 4.0]
    for n_stages in (1, 2, 3, 4):
        assert _outcome(stage_partition.partition_min_bottleneck, costs, n_stages) == \
            _outcome(ref_sp.partition_min_bottleneck, costs, n_stages)
        for block in (1, 3):
            assert _outcome(stage_partition.partition_blocks, costs, n_stages, block) == \
                _outcome(ref_sp.partition_blocks, costs, n_stages, block)
    for args, kwargs in [(([4.0, 2.0, 2.0], 8), {}),
                         (([1.0, 1.0, 1.0], 10), {"granularity": 3}),
                         (([1.0, 1.0, 1.0], 8), {"granularity": 3}),
                         (([100.0, 50.0, 25.0, 25.0], 16), {"budgets": [2, 16, 16, 16]}),
                         (([100.0, 50.0, 25.0, 25.0], 16), {"budgets": [8, 8]}),
                         (([10.0, 0.1, 0.1, 0.1], 7), {})]:
        chips = _outcome(stage_partition.allocate_chips, *args, **kwargs)
        assert chips == _outcome(ref_sp.allocate_chips, *args, **kwargs)
        if isinstance(chips[0], int):
            assert stage_partition.service_rates(args[0], chips, 1.0) == \
                ref_sp.service_rates(args[0], chips, 1.0)
    for s, d in ((3, 2), (4, 4), (5, 3)):
        assert stage_partition.round_robin_placement(s, d) == \
            ref_sp.round_robin_placement(s, d)
    assert stage_partition.LINK_DTYPE_BITS == ref_sp.LINK_DTYPE_BITS
    for spec in ("int8", "bf16", "fp32", {"a": "bf16"}):
        assert stage_partition.resolve_link_dtype(spec, "a") == \
            ref_sp.resolve_link_dtype(spec, "a")
    with pytest.raises(ValueError):
        stage_partition.resolve_link_dtype("fp8", "a")


# --------------------------------------------------------------------------
# the multi-chip planner on the four families at 224x224
# --------------------------------------------------------------------------


def _graphs(family, **cfg):
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    return ra.graph(ra.make_config(**cfg)), pa.graph(pa.make_config(**cfg))


def _same_plan(gp, want):
    assert gp.graph.topo_order() == want.graph.topo_order()
    assert [plain(gp.graph.spec(n)) for n in gp.graph.topo_order()] == [
        plain(want.graph.spec(n)) for n in want.graph.topo_order()]
    assert plain(gp.stage_plan) == plain(want.stage_plan)
    assert plain(gp.stream_bufs) == plain(want.stream_bufs)
    assert plain(gp.buffers) == plain(want.buffers)
    assert plain(gp.replications) == plain(want.replications)
    assert plain(gp.impls) == plain(want.impls)
    assert gp.stage_mults() == want.stage_mults()
    assert gp.cut_rates() == want.cut_rates()
    assert gp.stage_stream_bits() == want.stage_stream_bits()
    assert gp.total_stream_bits == want.total_stream_bits


OPTIONS = {
    "plain": {},
    "fp32_links": {"link_dtype": "fp32"},
    "chain_cuts": {"chain_cuts": True},
    "n_devices": {"n_devices": 2},
    "replicate": {"replicate": 2},
}


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_graph_stages_match_reference(family, n_stages, option):
    rg, g = _graphs(family)
    gp = _same_planning({"n_stages": n_stages, **OPTIONS[option]}, g, rg)
    if gp is not None and option != "replicate":
        mono = graph.plan_graph(g, F(3)).kernel_plan(batch=8)
        assert gp.kernel_plan(batch=8) == mono


@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_plan_graph_bram_budget_matches_reference(family, n_stages):
    """Budgets that fit, that move the cut, and that no cut fits: the
    same plan, or the same refusal, on both sides."""
    rg, g = _graphs(family)
    free = graph.plan_graph(g, F(3), n_stages=n_stages).stage_stream_bits()
    for budget in (10 ** 12, max(free), max(free) - 1, min(b for b in free if b) // 2,
                   [10 ** 12] * (n_stages - 1) + [max(free) // 3]):
        _same_planning({"n_stages": n_stages, "bram_budget": budget}, g, rg)


@pytest.mark.parametrize("family", FAMILIES)
def test_replication_dse_matches_reference(family):
    rg, g = _graphs(family, input_hw=(16, 16), num_classes=4)
    for n_stages in (2, 3):
        got = replicate.best_replication(g, F(1, 2), n_stages=n_stages)
        want = ref_replicate.best_replication(rg, F(1, 2), n_stages=n_stages)
        _same_plan(got, want)
        for node in replicate.replicable_nodes(g)[:3]:
            assert replicate.lane_multiplicity(got, node) == \
                ref_replicate.lane_multiplicity(want, node)
    base = graph.plan_graph(g, F(1, 2))
    assert replicate.select_bottleneck(base) == ref_replicate.select_bottleneck(
        ref_graph.plan_graph(rg, F(1, 2)))


def test_best_replication_improves_resnet18_at_three_stages():
    """The reference's pin (tests/fleet/test_replicate.py): bottleneck
    18944 -> 18624 mults at equal arithmetic."""
    rg, g = _graphs("resnet18")
    base = graph.plan_graph(g, F(3), n_stages=3)
    rep = replicate.best_replication(g, F(3), n_stages=3)
    assert max(base.stage_mults()) == 18944
    assert [(r.node, r.r) for r in rep.replications] == [("l3b1_conv2", 2)]
    assert max(rep.stage_mults()) == 18624
    assert rep.total_mults == base.total_mults == 54736
    _same_plan(rep, ref_replicate.best_replication(rg, F(3), n_stages=3))


@pytest.mark.parametrize("rate_in", RATES, ids=[str(r) for r in RATES])
@pytest.mark.parametrize("family", FAMILIES)
def test_stage_plan_keeps_the_tiles(family, rate_in):
    """The port's tile rule on a staged plan: every node's Hopper tile is
    the monolithic plan's, pinned to a batch or not."""
    _, g = _graphs(family)
    mono = graph.plan_graph(g, rate_in)
    for n_stages in (2, 3):
        gp = graph.plan_graph(g, rate_in, n_stages=n_stages)
        assert gp.kernel_plan() == mono.kernel_plan()
        assert gp.kernel_plan(batch=8) == mono.kernel_plan(batch=8)
