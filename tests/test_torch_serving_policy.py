"""The stream engine's configuration, traffic and policies in the port,
against the JAX package's (all pure Python, compared exactly).

* ``serving/scenarios.py``: the same processes give the same tick lists
  (exact Fractions) for several seeds and jitters, the same mean rates,
  and refuse the same bad arguments with the same messages.
* ``serving/config.py``: ``ServeConfig`` is frozen, ``with_`` copies it,
  and it carries the reference's fields less ``interpret``, ``jit`` and
  ``pipeline_cache``, which the port has no use for.
* ``core/dse.py::plan_ladder`` and ``serving/overload.py``: the ladder's
  plans equal the reference's rung for rung (``try_replicate`` too), the
  priced rungs and their labels are the same, and ``SwitchPolicy.target``
  picks the same rung at every estimate.
* The engine's refusals, ``CNNApi.serve`` (config and flush threaded
  through, the plan memoized in the registry's ``plans``) and the token
  engine's refusal of a CNN config.
"""
import dataclasses
import itertools
from fractions import Fraction as F

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import dse as ref_dse  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro.serving import overload as ref_ov  # noqa: E402
from repro.serving import scenarios as ref_sc  # noqa: E402
from repro.serving.cnn_stream import CNNStreamEngine as RefEngine  # noqa: E402
from repro.serving.cnn_stream import ServingError as RefServingError  # noqa: E402
from repro.serving.config import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.core import dse  # noqa: E402
from repro_torch.core.graph import plan_graph  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CNNStreamEngine,
    Engine,
    LadderRung,
    OverloadError,
    PlanLadder,
    ScenarioError,
    ServeConfig,
    ServingError,
    ShedPolicy,
    SwitchPolicy,
    adversarial,
    bursty,
    constant,
)
from repro_torch.serving import cnn_stream  # noqa: E402
from repro_torch.serving import scenarios  # noqa: E402

HW = (32, 32)


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


def _graphs(family="resnet18", hw=HW):
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    kw = {} if hw is None else {"input_hw": hw, "num_classes": 10}
    return ra.graph(ra.make_config(**kw)), pa.graph(pa.make_config(**kw))


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7, 2026])
def test_scenarios_give_the_reference_tick_lists(seed):
    cases = [
        ("constant", (F(3, 2),), {}),
        ("bursty", (F(2),), dict(burst=8, gap=6, burst_jitter=3, gap_jitter=2,
                                 seed=seed)),
        ("bursty", (F(5, 3),), dict(burst=5, gap=11, burst_jitter=4, seed=seed)),
        ("diurnal", ([(F(1, 2), 8), (0, 5), (F(7, 3), 4)],), {}),
        ("adversarial", (F(3, 4),), {}),
        ("adversarial", (F(3, 4),), {"margin": F(9, 8)}),
    ]
    for fn, args, kw in cases:
        got = getattr(scenarios, fn)(*args, **kw)
        want = getattr(ref_sc, fn)(*args, **kw)
        assert got.name == want.name
        assert got.times(97) == want.times(97), (fn, kw)
        assert all(isinstance(t, F) for t in got.times(97))
        assert got.mean_rate(97) == want.mean_rate(97)
        assert plain(got)[1] == plain(want)[1]
    assert scenarios._lcg(seed).__next__() == ref_sc._lcg(seed).__next__()
    assert (list(itertools.islice(scenarios._lcg(seed), 64))
            == list(itertools.islice(ref_sc._lcg(seed), 64)))


@pytest.mark.parametrize("fn,args,kw", [
    ("constant", (0,), {}),
    ("bursty", (0,), {}),
    ("bursty", (2,), {"burst": 0}),
    ("bursty", (2,), {"gap": 2, "gap_jitter": 3}),
    ("bursty", (2,), {"burst": 3, "burst_jitter": 3}),
    ("diurnal", ([],), {}),
    ("diurnal", ([(1, 0)],), {}),
    ("diurnal", ([(0, 3), (0, 2)],), {}),
    ("adversarial", (0,), {}),
    ("adversarial", (1,), {"margin": 1}),
])
def test_scenarios_refuse_what_the_reference_refuses(fn, args, kw):
    with pytest.raises(ref_sc.ScenarioError) as want:
        getattr(ref_sc, fn)(*args, **kw)
    with pytest.raises(ScenarioError) as got:
        getattr(scenarios, fn)(*args, **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ScenarioError):
        constant(1).mean_rate(0)


# --------------------------------------------------------------------------
# ServeConfig
# --------------------------------------------------------------------------


def test_serve_config_is_frozen_and_with_copies():
    cfg = ServeConfig(microbatch=2)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.microbatch = 4
    cfg2 = cfg.with_(microbatch=4, arrival=F(3))
    assert cfg2.microbatch == 4 and cfg2.arrival == F(3)
    assert cfg.microbatch == 2
    ours = [f.name for f in dataclasses.fields(ServeConfig)]
    theirs = [f.name for f in dataclasses.fields(RefServeConfig)]
    assert ours == [n for n in theirs if n not in ("interpret", "jit", "pipeline_cache")]
    for name in ours:
        if name != "dtype":
            assert getattr(ServeConfig(), name) == getattr(RefServeConfig(), name)


# --------------------------------------------------------------------------
# the ladder and the policies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family,n_stages,factors,rep", [
    ("resnet18", 2, (1, 2), False), ("mobilenet_v2", 2, (1, 2), False),
    ("resnet18", 3, (1, 2), True), ("mobilenet_v2", 3, (1, F(3, 2), 2), True)])
def test_plan_ladder_matches_reference(family, n_stages, factors, rep):
    """At 224x224: the same plans rung for rung, the same priced and pruned
    ladder, the same labels."""
    rg, pg = _graphs(family, hw=None)
    got = dse.plan_ladder(pg, F(3), n_stages=n_stages, rate_factors=factors,
                          try_replicate=rep)
    want = ref_dse.plan_ladder(rg, F(3), n_stages=n_stages, rate_factors=factors,
                               try_replicate=rep)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.input_rate == w.input_rate
        assert plain(g.impls) == plain(w.impls)
        assert plain(g.replications) == plain(w.replications)
        assert plain(g.stream_bufs) == plain(w.stream_bufs)
        assert g.stage_plan.boundaries == w.stage_plan.boundaries
    lg = PlanLadder.build(pg, F(3), n_stages=n_stages, rate_factors=factors,
                          try_replicate=rep)
    lw = ref_ov.PlanLadder.build(rg, F(3), n_stages=n_stages, rate_factors=factors,
                                 try_replicate=rep)
    assert [(r.label, r.rate_cycles) for r in lg.rungs] == [
        (r.label, r.rate_cycles) for r in lw.rungs]
    assert lg.describe() == lw.describe()
    pol, ref_pol = SwitchPolicy(lg, window_ticks=16), ref_ov.SwitchPolicy(lw, window_ticks=16)
    rates = [r.rate_cycles for r in lg.rungs]
    for est in sorted({r * f for r in rates for f in (F(1, 2), F(3, 4), F(9, 10), 1, 2)}):
        for active in range(len(rates)):
            assert pol.target(est, active) == ref_pol.target(est, active)


def test_ladder_and_policy_refusals():
    rg, pg = _graphs()
    with pytest.raises(OverloadError, match="must include 1"):
        PlanLadder.build(pg, F(3), n_stages=2, rate_factors=(2, 4))
    with pytest.raises(ValueError, match="rate_factors must be > 0"):
        dse.plan_ladder(pg, F(3), rate_factors=())
    plan = plan_graph(pg, F(3), n_stages=2)
    rung = LadderRung("a", plan, cnn_stream.sustainable_rate_cycles(plan))
    with pytest.raises(OverloadError, match="strictly increase"):
        PlanLadder(rungs=(rung, rung))
    with pytest.raises(OverloadError, match="at least one rung"):
        PlanLadder(rungs=())
    with pytest.raises(OverloadError, match="deadline_ticks"):
        ShedPolicy(deadline_ticks=F(0))
    ladder = PlanLadder.build(pg, F(3), n_stages=2, rate_factors=(1, 2))
    with pytest.raises(OverloadError, match="window_ticks"):
        SwitchPolicy(ladder, window_ticks=F(0))
    with pytest.raises(OverloadError, match="down_headroom"):
        SwitchPolicy(ladder, down_headroom=F(2))
    assert ShedPolicy(3).deadline_ticks == F(3)


# --------------------------------------------------------------------------
# (iv) the engine's refusals
# --------------------------------------------------------------------------


def _plan(n_stages=2, family="mobilenet_v2"):
    g = get_cnn_api(family, device="cpu").graph(
        get_cnn_api(family, device="cpu").make_config(input_hw=HW, num_classes=10))
    return g, plan_graph(g, F(3), n_stages=n_stages)


def test_engine_refusals(monkeypatch):
    g, plan = _plan()
    timing = ServeConfig(execute=False)
    with pytest.raises(ServingError, match="stage partition"):
        CNNStreamEngine(g, None, plan_graph(g, F(3)), timing)
    with pytest.raises(ServingError, match="pinned to batch"):
        CNNStreamEngine(g, None, plan, timing.with_(
            microbatch=2, kernel_plan=plan.kernel_plan(batch=4)))
    with pytest.raises(ServingError, match="microbatch must be >= 1"):
        CNNStreamEngine(g, None, plan, timing.with_(microbatch=0))
    with pytest.raises(ServingError, match="no frames"):
        CNNStreamEngine(g, None, plan, timing).run()
    eng = CNNStreamEngine(g, None, plan, timing)
    eng.submit(None)
    with pytest.raises(ServingError, match="flush_after_ticks must be >= 0"):
        eng.run(flush_after_ticks=-1)
    with pytest.raises(ServingError, match="arrival_rate must be > 0"):
        eng.run(arrival_rate=0)
    with pytest.raises(ServingError, match="unknown overload policy"):
        CNNStreamEngine(g, None, plan, timing.with_(overload=object()))
    with pytest.raises(ServingError, match="expected True, False"):
        CNNStreamEngine(g, None, plan, timing.with_(execute="bogus"))
    ladder = PlanLadder.build(g, F(3), n_stages=2, rate_factors=(1, 2))
    with pytest.raises(ServingError, match="base rung"):
        CNNStreamEngine(g, None, plan_graph(g, F(3), n_stages=2),
                        timing.with_(overload=SwitchPolicy(ladder)))
    # execute="devices" places every stage on the engine's pool: the CPU
    # here; on the card's pool where CUDA is absent it raises
    placed = CNNStreamEngine(g, {}, plan, ServeConfig(execute="devices"), device="cpu")
    assert placed.pipeline.devices == (torch.device("cpu"),) * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNNStreamEngine(g, {}, plan, ServeConfig(execute="devices"))


def test_engine_refusals_match_the_reference():
    """The tick model's refusals carry the reference's messages."""
    ra = ref_api("mobilenet_v2")
    rc = ra.make_config(input_hw=HW, num_classes=10)
    rg, rplan = ra.graph(rc), ra.partition(rc, F(3), 2)
    pg, pplan = _plan()
    cases = [
        ({"microbatch": 2, "kernel_plan": pplan.kernel_plan(batch=4)},
         {"microbatch": 2, "kernel_plan": rplan.kernel_plan(batch=4)}, None),
        ({"microbatch": 0}, {"microbatch": 0}, None),
        ({}, {}, F(-1)),
    ]
    for pk, rk, flush in cases:
        with pytest.raises(RefServingError) as want:
            eng = RefEngine(rg, None, rplan, RefServeConfig(execute=False, **rk))
            eng.submit(None)
            eng.run(flush_after_ticks=flush)
        with pytest.raises(ServingError) as got:
            eng = CNNStreamEngine(pg, None, pplan, ServeConfig(execute=False, **pk))
            eng.submit(None)
            eng.run(flush_after_ticks=flush)
        assert str(got.value) == str(want.value)


def test_executing_engine_runs_on_the_card_by_default(monkeypatch):
    g, plan = _plan()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CNNStreamEngine(g, {}, plan, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cnn_stream.serve_frames(g, {}, torch.zeros((1, *HW, 3)), input_rate=F(3))
    assert CNNStreamEngine(g, None, plan, ServeConfig(execute=False)).device is None


# --------------------------------------------------------------------------
# (vi) the front doors
# --------------------------------------------------------------------------


def test_api_serve_threads_config_and_flush():
    """The partial micro-batch flushes on the straggler bound (2 ticks,
    inside the 4-tick inter-arrival) instead of waiting to fill 4 frames;
    the plan is memoized in the registry's ``plans`` dict."""
    api = get_cnn_api("resnet18", device="cpu")
    cfg = api.make_config(input_hw=HW, num_classes=10)
    _, rep = api.serve(
        None, 9, cfg, input_rate=F(3), n_stages=2,
        config=ServeConfig(microbatch=4, execute=False, arrival=F(1, 4),
                           flush_after_ticks=F(2)))
    assert rep.completed == 9 and rep.microbatch == 4
    assert all(s.batches_served >= 3 for s in rep.stages)
    assert len(api.caches["plans"]) == 1
    _, rep2 = api.serve(None, 9, cfg, input_rate=F(3), n_stages=2,
                        config=ServeConfig(microbatch=4, execute=False),
                        flush_after_ticks=F(2), arrival_rate=F(1, 4))
    assert len(api.caches["plans"]) == 1
    assert plain(rep2) == plain(rep)


def test_api_serve_runs_on_the_apis_device_in_the_configs_dtype():
    api = get_cnn_api("mobilenet_v1", device="cpu")
    cfg = api.make_config(input_hw=HW, num_classes=10)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    frames = torch.randn((3, *HW, 3), generator=torch.Generator().manual_seed(1))
    out, rep = api.serve(params, frames, cfg, input_rate=F(3), n_stages=2,
                         rate_matched=True, config=ServeConfig(microbatch=3))
    assert rep.completed == 3
    assert out.device.type == "cpu" and out.dtype == cfg.dtype
    gp = api.partition(cfg, F(3), 2)
    assert torch.equal(out, api.apply_staged(params, frames, cfg, partition=gp,
                                             plan=gp.kernel_plan(batch=3)))
    out2, _ = api.serve(params, frames, cfg, input_rate=F(3), n_stages=2,
                        config=ServeConfig(microbatch=3, execute=False))
    assert out2 is None


def test_token_engine_refuses_a_cnn_config_naming_the_stream_engine():
    cfg = get_cnn_api("resnet18", device="cpu").make_config(input_hw=HW, num_classes=10)
    with pytest.raises(ValueError, match="CNNStreamEngine") as e:
        Engine(cfg, None)
    assert "CNNApi.serve" in str(e.value)
    assert registry.get_cnn_api("resnet18", device="cpu").serve is not None


def test_shed_and_switch_accounting():
    """Admitted + shed == submitted; survivors keep rid order; a switch
    drains and serves everything within the queue bounds."""
    g, plan = _plan(family="resnet18")
    br = cnn_stream.best_rate_frames(plan)
    eng = CNNStreamEngine(g, None, plan, ServeConfig(
        microbatch=4, execute=False, arrival=adversarial(br, margin=F(2)),
        overload=ShedPolicy(F(24))))
    for _ in range(64):
        eng.submit(None)
    rep = eng.run()
    assert rep.shed > 0 and rep.completed + rep.shed == 64
    served = [r for r in eng._requests if r.t_shed is None]
    assert [r.t_admit for r in served] == sorted(r.t_admit for r in served)
    assert rep.within_queue_bounds
    ladder = PlanLadder.build(g, F(3), n_stages=2, rate_factors=(1, 2))
    eng = CNNStreamEngine(g, None, ladder.rungs[0].plan, ServeConfig(
        microbatch=4, execute=False, arrival=bursty(2 * br, burst=16, gap=24),
        overload=SwitchPolicy(ladder, window_ticks=8)))
    for _ in range(64):
        eng.submit(None)
    rep = eng.run()
    assert rep.completed == 64 and rep.switches and rep.within_queue_bounds
    assert {s.rung for s in rep.stages} == {0, 1}
