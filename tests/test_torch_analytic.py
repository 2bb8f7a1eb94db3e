"""The port's analytic core against the JAX package's, exactly.

The FPGA spec, the chain calculus (``propagate_chain``, ``frame_cycles``,
``fps``), the chain planner ``plan_network`` with every scheme and DSE
objective, the §II-E multi-pixel tables, the FPGA resource model and the
discrete-event schedule are pure Python over ``Fraction``s on both
sides, so every field of every result must be equal: values, and the
``Fraction`` type of each exact quantity.  The cases are those of
``tests/core/test_{dse,schedule,multipixel,resource_model}.py``.
"""
import dataclasses
from fractions import Fraction as F

import pytest

pytest.importorskip("torch")

from repro.core import dse as ref_dse  # noqa: E402
from repro.core import hw_specs as ref_hw  # noqa: E402
from repro.core import multipixel as ref_mp  # noqa: E402
from repro.core import rate as ref_rate  # noqa: E402
from repro.core import resource_model as ref_rm  # noqa: E402
from repro.core import schedule as ref_sched  # noqa: E402
from repro.core.graph import plan_graph as ref_plan_graph  # noqa: E402
from repro.models import mobilenet as ref_mobilenet  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro_torch.core import dse, hw, multipixel, rate, resource_model, schedule  # noqa: E402
from repro_torch.core.graph import plan_graph  # noqa: E402
from repro_torch.models import mobilenet  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402

FAMILIES = ("mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34")
# paper Table II's MobileNetV2 rates (tests/core/test_resource_model.py)
TABLE2_RATES = [F(6), F(3), F(3, 2), F(3, 4), F(3, 8), F(3, 16), F(3, 32)]


def plain(obj):
    """A structure of builtins for comparing a port object with a reference
    object field by field: dataclasses become (class name, fields), and a
    Fraction stays a Fraction (so a float where the reference has a
    Fraction does not compare equal)."""
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


def _chains(name):
    if name == "mobilenet_v1":
        return ref_mobilenet.mobilenet_v1_chain(), mobilenet.mobilenet_v1_chain()
    return ref_mobilenet.mobilenet_v2_chain(), mobilenet.mobilenet_v2_chain()


def test_fpga_spec_is_the_reference_device():
    assert plain(hw.XCVU37P)[1] == plain(ref_hw.XCVU37P)[1]
    assert hw.XCVU37P.name == "xcvu37p-fsvh2892-3-e"


@pytest.mark.parametrize("rate_in", TABLE2_RATES, ids=str)
@pytest.mark.parametrize("chain", ["mobilenet_v1", "mobilenet_v2"])
def test_chain_calculus_matches_reference(chain, rate_in):
    ref_chain, chain_ = _chains(chain)
    assert plain(chain_) == plain(ref_chain)
    assert plain(rate.propagate_chain(rate_in, chain_)) == plain(
        ref_rate.propagate_chain(rate_in, ref_chain))
    q = rate_in / chain_[0].d_in
    got = rate.frame_cycles((224, 224), q)
    assert type(got) is F and got == ref_rate.frame_cycles((224, 224), q)
    assert rate.fps((224, 224), q, 403.71e6) == ref_rate.fps((224, 224), q, 403.71e6)
    assert rate.propagate_chain(rate_in, []) == []


PLAN_CASES = [("ours", "max_h"), ("ours", "resources"), ("ours", "pareto"),
              ("ref11", "max_h")]


@pytest.mark.parametrize("rate_in", [F(6), F(3), F(3, 4), F(3, 32)], ids=str)
@pytest.mark.parametrize("scheme,objective", PLAN_CASES)
@pytest.mark.parametrize("chain", ["mobilenet_v1", "mobilenet_v2"])
def test_plan_network_matches_reference(chain, scheme, objective, rate_in):
    ref_chain, chain_ = _chains(chain)
    got = dse.plan_network(chain_, rate_in, scheme=scheme, objective=objective)
    want = ref_dse.plan_network(ref_chain, rate_in, scheme=scheme, objective=objective)
    assert plain(got) == plain(want)
    assert [i.adder_tree_operands for i in got] == [i.adder_tree_operands for i in want]
    # the resource model prices the same (j, h) the same way
    assert plain(resource_model.estimate_network(got)) == plain(
        ref_rm.estimate_network(want))
    assert [plain(resource_model.estimate_layer(i)) for i in got] == [
        plain(ref_rm.estimate_layer(i)) for i in want]


@pytest.mark.parametrize("objective", ["resources", "pareto"])
def test_select_ours_objectives_match_reference(objective):
    """The resource-model objectives compute, and choose the reference's
    (j, h), on awkward widths and rates (tests/core/test_dse.py's space)."""
    layers = []
    for d_in, d_out in [(3, 32), (24, 144), (96, 96), (160, 960), (1280, 1000)]:
        layers.append(ref_rate.LayerSpec(name=f"pw{d_in}", kind="pointwise", d_in=d_in,
                                         d_out=d_out, in_hw=(14, 14), out_hw=(14, 14)))
        layers.append(ref_rate.LayerSpec(name=f"cv{d_in}", kind="conv", d_in=d_in,
                                         d_out=d_out, kernel=(3, 3), stride=(2, 2),
                                         in_hw=(14, 14), out_hw=(7, 7)))
    for lay in layers:
        mine = rate.LayerSpec(**{f.name: getattr(lay, f.name)
                                 for f in dataclasses.fields(lay)})
        for r in (F(1, 7), F(2, 3), F(3), F(17, 4), F(12)):
            got = dse.select_ours(mine, r, objective=objective)
            want = ref_dse.select_ours(lay, r, objective=objective)
            assert plain(got) == plain(want), (lay.name, r)
            assert got.feasible


@pytest.mark.parametrize("p,k,s", [(p, k, s) for p in (1, 2, 3, 4, 6)
                                   for k in (1, 3, 5, 7) for s in (1, 2, 3)])
def test_multipixel_tables_match_reference(p, k, s):
    assert plain(multipixel.plan_phases(p, k, s)) == plain(ref_mp.plan_phases(p, k, s))
    for phase in range(p):
        assert plain(multipixel.phase_tap_routes(p, k, phase)) == plain(
            ref_mp.phase_tap_routes(p, k, phase))
    assert multipixel.window_assignment(p, k, s, 37) == ref_mp.window_assignment(
        p, k, s, 37)
    for n in range(-2, 12):
        assert multipixel.pad_select(n, k, 9, k // 2) == ref_mp.pad_select(n, k, 9, k // 2)


@pytest.mark.parametrize("rate_in", [F(3), F(3, 2), F(1, 5)], ids=str)
def test_simulate_chain_matches_reference(rate_in):
    """MobileNetV2's first blocks (tests/core/test_schedule.py's prefix)
    and one over-provisioned pointwise layer, pass by pass."""
    ref_chain, chain_ = _chains("mobilenet_v2")
    ref_chain = [lay for lay in ref_chain if lay.kind != "gap"][:8]
    chain_ = [lay for lay in chain_ if lay.kind != "gap"][:8]
    got = schedule.simulate_chain(dse.plan_network(chain_, rate_in), 48, rate_in / 3)
    want = ref_sched.simulate_chain(ref_dse.plan_network(ref_chain, rate_in), 48,
                                    rate_in / 3)
    assert plain(got) == plain(want)
    pw = rate.LayerSpec(name="pw", kind="pointwise", d_in=64, d_out=64,
                        in_hw=(8, 8), out_hw=(8, 8))
    ref_pw = ref_rate.LayerSpec(name="pw", kind="pointwise", d_in=64, d_out=64,
                                in_hw=(8, 8), out_hw=(8, 8))
    impl, ref_impl = dse.select_ours(pw, F(16)), ref_dse.select_ours(ref_pw, F(16))
    assert plain(schedule.simulate_chain([impl], 96, F(4, 64))) == plain(
        ref_sched.simulate_chain([ref_impl], 96, F(4, 64)))
    assert schedule.analytical_utilization(impl) == ref_sched.analytical_utilization(
        ref_impl)


@pytest.mark.parametrize("n_stages", [None, 2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_simulate_graph_and_graph_resources_match_reference(family, n_stages):
    """The DAG discrete-event run (every pass, every join FIFO's measured
    occupancy) and the graph / per-stage resource estimates, on each
    family at 16x16 (an integer decimation at every node)."""
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc = ra.make_config(input_hw=(16, 16), num_classes=4)
    pc = pa.make_config(input_hw=(16, 16), num_classes=4)
    want = ref_plan_graph(ra.graph(rc), F(1, 2), n_stages=n_stages)
    got = plan_graph(pa.graph(pc), F(1, 2), n_stages=n_stages)
    sim = schedule.simulate_graph(got, n_pixels=256)
    assert plain(sim) == plain(ref_sched.simulate_graph(want, n_pixels=256))
    assert sim.stall_free and sim.within_bounds
    assert plain(resource_model.estimate_graph(got)) == plain(ref_rm.estimate_graph(want))
    if n_stages:
        assert plain(resource_model.estimate_stages(got)) == plain(
            ref_rm.estimate_stages(want))
        for sb, ref_sb in zip(got.stream_bufs, want.stream_bufs):
            assert plain(resource_model.estimate_stream_buffer(sb)) == plain(
                ref_rm.estimate_stream_buffer(ref_sb))
    for b, ref_b in zip(got.buffers, want.buffers):
        assert plain(resource_model.estimate_join_buffer(b)) == plain(
            ref_rm.estimate_join_buffer(ref_b))
