"""The fleet (``fleet/pool.py``, ``fleet/scheduler.py``) in the port,
against the JAX package's.

Case for case the reference's ``tests/fleet/test_pool.py`` and
``tests/fleet/test_scheduler.py``, plus:

* ``plan_pool`` is pure planning over exact ``Fraction``s: every
  candidate, the chosen plans, the chip assignments, ``utilization()``
  and ``fair_share()`` equal the reference's field by field, on the
  reference tests' 32x32 pool and on a 224x224 pool (MobileNetV2 at rate
  3, ResNet-18 at 3/4, two big-BRAM chips beside four stock ones);
  refusals carry the reference's messages;
* timing-only ``FleetReport``s equal the reference's event for event:
  every tenant's ``ServeReport`` field for field, the makespan and the
  chip occupancy;
* executed fleets at 16x16 on the CPU: outputs within ``TOL`` (1e-4) of
  the reference fleet's on the same numpy weights and frames, bit for bit
  each tenant's standalone engine, and ``execute="devices"`` bit for bit
  ``execute=True``, with a shared tracer that ``obs.audit_fleet`` finds
  clean.
"""
import dataclasses
from fractions import Fraction as F

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.fleet import pool as ref_pool  # noqa: E402
from repro.fleet import scheduler as ref_sched  # noqa: E402
from repro.serving.config import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    Chip,
    FleetError,
    FleetScheduler,
    PoolError,
    Tenant,
    TenantWorkload,
    chip_pool,
    enumerate_candidates,
    plan_pool,
)
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.obs import audit_fleet  # noqa: E402
from repro_torch.serving import ServeConfig  # noqa: E402
from repro_torch.serving.cnn_stream import best_rate_frames  # noqa: E402

TOL = 1e-4
TENANTS = (
    Tenant("alpha", "resnet18", F(1, 2), input_hw=(32, 32), num_classes=10),
    Tenant("beta", "mobilenet_v2", F(1, 2), input_hw=(32, 32), num_classes=10),
)
CHIPS = (Chip("big0", bram36=4096),) + chip_pool(4)
# The 224x224 pool chip_smoke.py serves on the card.
TENANTS_224 = (
    Tenant("mnv2", "mobilenet_v2", F(3), input_hw=(224, 224), num_classes=1000),
    Tenant("r18", "resnet18", F(3, 4), input_hw=(224, 224), num_classes=1000),
)
CHIPS_224 = (Chip("big0", bram36=4096), Chip("big1", bram36=4096)) + chip_pool(4)


def _ref(obj):
    """The reference's twin of a port Tenant / Chip (same fields)."""
    cls = {Tenant: ref_pool.Tenant, Chip: ref_pool.Chip}[type(obj)]
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})


def plain(obj):
    """Builtins for a field-by-field comparison of port and reference
    dataclasses (class name and the fields that take part in ``==``)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj) if f.compare))
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return tuple(plain(v) for v in obj)
    return obj


def _cand(c):
    return (c.label, c.n_stages, c.replicated, c.total_mults, c.bottleneck_mults,
            plain(c.stage_costs), c.plan.stage_plan.boundaries)


def _same_pool(got, want):
    assert plain(got) == plain(want)  # tenants, chips, assignments
    assert sorted(got.chosen) == sorted(want.chosen)
    for name in got.chosen:
        assert _cand(got.chosen[name]) == _cand(want.chosen[name])
    assert got.utilization() == want.utilization()
    assert got.fair_share() == want.fair_share()
    assert (got.total_mults, got.chips_used, got.spare_chips) == \
        (want.total_mults, want.chips_used, want.spare_chips)


_POOLS = {}


def _pools(tenants=TENANTS, chips=CHIPS, **kw):
    key = (tenants, chips, tuple(sorted(kw.items())))
    if key not in _POOLS:
        _POOLS[key] = (plan_pool(tenants, chips, **kw),
                       ref_pool.plan_pool(tuple(map(_ref, tenants)),
                                          tuple(map(_ref, chips)), **kw))
    return _POOLS[key]


@pytest.fixture(scope="module")
def pool():
    got, want = _pools(s_options=(1, 2), try_replicate=True)
    return got


# --------------------------------------------------------------------------
# the pool planner (tests/fleet/test_pool.py)
# --------------------------------------------------------------------------


def test_pool_plan_matches_reference(pool):
    _same_pool(*_pools(s_options=(1, 2), try_replicate=True))
    for t in TENANTS:
        got = enumerate_candidates(t, CHIPS, s_options=(1, 2))
        want = ref_pool.enumerate_candidates(_ref(t), tuple(map(_ref, CHIPS)),
                                             s_options=(1, 2))
        assert [_cand(c) for c in got] == [_cand(c) for c in want]


@pytest.mark.parametrize("s_options", [(2,), (1, 2, 3)])
def test_224_pool_matches_reference(s_options):
    """At 224x224: with s_options=(2,) both tenants run two stages on four
    chips; with (1, 2, 3) both take one stage."""
    got, want = _pools(TENANTS_224, CHIPS_224, s_options=s_options)
    _same_pool(got, want)
    labels = {n: c.label for n, c in got.chosen.items()}
    if s_options == (2,):
        assert labels == {"mnv2": "mnv2:S2", "r18": "r18:S2"}
        assert [(a.tenant, a.stage, a.chip) for a in got.assignments] == [
            ("r18", 0, "chip0"), ("r18", 1, "big0"), ("mnv2", 1, "chip1"),
            ("mnv2", 0, "chip2")]
    else:
        assert labels == {"mnv2": "mnv2:S1", "r18": "r18:S1"}


def test_every_tenant_served_at_target_rate(pool):
    assert set(pool.chosen) == {"alpha", "beta"}
    for t in TENANTS:
        cand = pool.candidate_for(t.name)
        assert cand.plan.input_rate == t.input_rate
        assert not cand.plan.infeasible_nodes


def test_one_stage_per_chip_and_within_budget(pool):
    chips = {c.name: c for c in CHIPS}
    used = [a.chip for a in pool.assignments]
    assert len(used) == len(set(used))
    for a in pool.assignments:
        cand = pool.candidate_for(a.tenant)
        assert chips[a.chip].fits(cand.stage_costs[a.stage])
        assert 0 < a.dsp_frac <= 1 and 0 <= a.bram_frac <= 1
    placed = {(a.tenant, a.stage) for a in pool.assignments}
    want = {(n, s) for n, c in pool.chosen.items() for s in range(c.n_stages)}
    assert placed == want
    assert len(pool.spare_chips) == len(CHIPS) - len(pool.assignments)


def test_objective_minimizes_arithmetic(pool):
    per_tenant_min = 0
    for t in TENANTS:
        cands = enumerate_candidates(t, CHIPS, s_options=(1, 2))
        per_tenant_min += min(c.total_mults for c in cands)
    assert pool.total_mults == per_tenant_min


def test_utilization_and_fair_share_report(pool):
    util = pool.utilization()
    assert set(util) == {c.name for c in CHIPS}
    for name in pool.spare_chips:
        assert util[name]["dsp"] == 0.0
    share = pool.fair_share()
    assert sum(share.values()) == len(CHIPS)
    assert all(v >= 1 for v in share.values())
    assert share["alpha"] > share["beta"]


def _same_refusal(fn, ref_fn, match):
    with pytest.raises(ref_pool.PoolError, match=match) as want:
        ref_fn()
    with pytest.raises(PoolError, match=match) as got:
        fn()
    assert str(got.value) == str(want.value)


def test_heterogeneity_matters():
    """The ResNet tail stage over-fills a stock chip's BRAM — without the
    big-memory chip the pool is infeasible at S<=2."""
    _same_refusal(lambda: plan_pool(TENANTS, chip_pool(5), s_options=(1, 2)),
                  lambda: ref_pool.plan_pool(tuple(map(_ref, TENANTS)),
                                             ref_pool.chip_pool(5), s_options=(1, 2)),
                  "alpha")


def test_pool_validation_errors():
    rt, rc = tuple(map(_ref, TENANTS)), tuple(map(_ref, CHIPS))
    cases = [
        ((TENANTS[0], TENANTS[0]), CHIPS, (rt[0], rt[0]), rc, {"s_options": (1,)},
         "duplicate tenant"),
        (TENANTS, (), rt, (), {"s_options": (1,)}, "no chips"),
        ((), CHIPS, (), rc, {"s_options": (1,)}, "no tenants"),
        (TENANTS, CHIPS[:1], rt, rc[:1], {"s_options": (1,)}, "packs onto"),
        (TENANTS, CHIPS, rt, rc, {"s_options": (1, 2), "max_combos": 1}, "max_combos"),
    ]
    for tenants, chips, rtenants, rchips, kw, match in cases:
        _same_refusal(lambda: plan_pool(tenants, chips, **kw),
                      lambda: ref_pool.plan_pool(rtenants, rchips, **kw), match)


# --------------------------------------------------------------------------
# the scheduler (tests/fleet/test_scheduler.py)
# --------------------------------------------------------------------------


def _workloads(pool, frac=F(1), ref=False):
    """Per-tenant loads at ``frac`` x that tenant's own BestRate."""
    out = []
    for name, frames in (("alpha", 24), ("beta", 16)):
        br = best_rate_frames(pool.candidate_for(name).plan)
        if ref:
            out.append(ref_sched.TenantWorkload(name, frames, arrival_rate=frac * br))
        else:
            out.append(TenantWorkload(name, frames, ServeConfig(
                execute=False, arrival=frac * br)))
    return out


def same_report(got, want):
    assert plain(got) == plain(want)
    assert got._stage_intervals == want._stage_intervals
    assert got.to_rows() == want.to_rows()


@pytest.mark.parametrize("frac", [F(1), F(1, 2), F(3, 2)])
def test_timing_fleet_matches_reference(pool, frac):
    """Event for event: each tenant's report, the makespan, the chip
    occupancy and the fleet's rows."""
    got_pool, ref_pool_plan = _pools(s_options=(1, 2), try_replicate=True)
    got = FleetScheduler(got_pool).serve(_workloads(got_pool, frac))
    want = ref_sched.FleetScheduler(ref_pool_plan, config=RefServeConfig(execute=False)).serve(
        _workloads(ref_pool_plan, frac, ref=True))
    assert sorted(got.reports) == sorted(want.reports)
    for name in got.reports:
        same_report(got.reports[name], want.reports[name])
    assert got.makespan_cycles == want.makespan_cycles
    assert got.chip_occupancy == want.chip_occupancy
    assert got.to_rows() == want.to_rows()
    assert got.summary_rows() == want.summary_rows()


def test_two_families_zero_stalls_at_best_rate(pool):
    rep = FleetScheduler(pool).serve(_workloads(pool, frac=F(1)))
    assert set(rep.reports) == {"alpha", "beta"}
    assert rep.all_stall_free and rep.all_within_bounds
    for r in rep.reports.values():
        assert r.completed == r.frames
        assert r.admitted_rate == r.arrival_rate


def test_fleet_matches_standalone(pool):
    sched = FleetScheduler(pool)
    workloads = _workloads(pool, frac=F(1, 2))
    fleet = sched.serve(workloads)
    for w in workloads:
        solo = sched._engine(w).run()
        got = fleet.reports[w.tenant]
        assert got.makespan_ticks == solo.makespan_ticks
        assert got.latency_ticks == solo.latency_ticks
        assert got.service_latency_ticks == solo.service_latency_ticks
        assert [s.busy_cycles for s in got.stages] == [s.busy_cycles for s in solo.stages]


def test_chip_occupancy_over_fleet_makespan(pool):
    rep = FleetScheduler(pool).serve(_workloads(pool))
    assert set(rep.chip_occupancy) == {c.name for c in CHIPS}
    for name in pool.spare_chips:
        assert rep.chip_occupancy[name] == 0.0
    for a in pool.assignments:
        busy = rep.reports[a.tenant].stages[a.stage].busy_cycles
        want = float(busy / rep.makespan_cycles)
        assert rep.chip_occupancy[a.chip] == pytest.approx(want)
        assert 0 < rep.chip_occupancy[a.chip] <= 1


EXEC_TENANTS = (
    Tenant("a", "resnet18", F(1, 4), input_hw=(16, 16), num_classes=4),
    Tenant("b", "mobilenet_v1", F(1, 4), input_hw=(16, 16), num_classes=4),
)
EXEC_CHIPS = (Chip("big0", bram36=4096),) + chip_pool(3)


def _exec_frames():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((5, 16, 16, 3)).astype(np.float32),
            "b": rng.standard_normal((3, 16, 16, 3)).astype(np.float32)}


def _exec_sched(pool, execute, **cfg):
    sched = FleetScheduler(pool, config=ServeConfig(execute=execute, **cfg),
                           device="cpu")
    sched.init_params("a", torch.Generator().manual_seed(0))
    sched.init_params("b", torch.Generator().manual_seed(1))
    return sched


def test_execute_outputs_match_reference_and_plain_apply():
    """Executed on the CPU: within TOL of the reference fleet on the same
    numpy weights and frames, and of each family's plain forward; bit for
    bit each tenant's standalone engine."""
    pool, rpool = _pools(EXEC_TENANTS, EXEC_CHIPS, s_options=(1, 2))
    _same_pool(pool, rpool)
    sched = _exec_sched(pool, True)
    frames = _exec_frames()
    rep = sched.serve([TenantWorkload(n, f) for n, f in frames.items()])
    assert rep.all_stall_free
    rsched = ref_sched.FleetScheduler(rpool, config=RefServeConfig(execute=True,
                                                                   jit=False))
    for name in frames:
        rsched.params[name] = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()}
                               for n, p in sched.params[name].items()}
    want = rsched.serve([ref_sched.TenantWorkload(n, f) for n, f in frames.items()])
    for name, x in frames.items():
        out = rep.outputs[name]
        assert out.device.type == "cpu" and out.shape == (len(x), 4)
        ref = np.asarray(want.outputs[name], np.float32)
        scale = max(1.0, np.abs(ref).max())
        assert np.abs(out.numpy() - ref).max() <= TOL * scale
        family = {t.name: t.family for t in EXEC_TENANTS}[name]
        plain_out = get_cnn_api(family, device="cpu").apply(
            sched.params[name], x, pool.candidate_for(name).cfg).numpy()
        assert np.abs(out.numpy() - plain_out).max() <= TOL * max(1.0, np.abs(plain_out).max())
        solo = sched._engine(TenantWorkload(name, x))
        solo.run()
        assert torch.equal(solo.outputs(), out)
        same_report(rep.reports[name], want.reports[name])


def test_execute_devices_fleet_with_a_shared_tracer():
    """``execute="devices"`` serves each tenant's stages placed (on the
    CPU's pool here), bit for bit ``execute=True``; every tenant records
    into the shared tracer, which ``audit_fleet`` finds clean and which
    gives each tenant's wall clock."""
    pool, _ = _pools(EXEC_TENANTS, EXEC_CHIPS, s_options=(1, 2))
    frames = _exec_frames()
    workloads = [TenantWorkload(n, f) for n, f in frames.items()]
    host = _exec_sched(pool, True, microbatch=2).serve(workloads)
    sched = _exec_sched(pool, "devices", microbatch=2, trace=True)
    rep = sched.serve(workloads)
    for name in frames:
        assert torch.equal(rep.outputs[name], host.outputs[name])
        same_report(rep.reports[name], host.reports[name])
        assert rep.measured_fps(name) > 0
    audits = audit_fleet(rep.trace)
    assert sorted(audits) == sorted(frames)
    assert all(a.clean for a in audits.values())
    for a in pool.assignments:
        spans = rep.trace.spans("stage", pid=a.tenant, tid=f"stage{a.stage}")
        assert spans and all(s.arg("chip") == a.chip for s in spans)


def test_scheduler_validation_errors(pool):
    sched = FleetScheduler(pool)
    with pytest.raises(FleetError, match="no workloads"):
        sched.serve([])
    with pytest.raises(FleetError, match="unpooled tenant"):
        sched.serve([TenantWorkload("nobody", 4)])
    with pytest.raises(FleetError, match="duplicate workload"):
        sched.serve([TenantWorkload("alpha", 4), TenantWorkload("alpha", 4)])
    with pytest.raises(FleetError, match="no params"):
        FleetScheduler(pool, config=ServeConfig(execute=True), device="cpu").serve(
            [TenantWorkload("alpha", 4)])
