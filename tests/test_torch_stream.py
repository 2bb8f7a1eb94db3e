"""The stream engine (``serving/cnn_stream.py``) in the port, against the
JAX package's.

* The tick model is pure ``Fraction`` arithmetic on a ``GraphPlan``:
  ``slot_cycles``, ``stage_rates``, ``best_rate_frames``,
  ``sustainable_rate_cycles``, ``queue_caps_batches`` and every node's
  ``node_frame_cycles`` equal the reference's exactly, for the four
  families at S = 1, 2, 3 at 224x224 (each package planning its own).
* Timing-only runs (``execute=False``) at 224x224: the port's
  ``ServeReport`` equals the reference's field for field, with no
  tolerance, under constant, bursty, diurnal and adversarial traffic,
  ``flush_after_ticks``, ``ShedPolicy`` and ``SwitchPolicy``; with
  tracing on, every trace event (all are tick-domain in a timing-only
  run) and the plan metadata equal the reference's, and ``obs.audit``
  gives the same verdicts on both traces.
* Served outputs at 32x32, 10 classes, on the CPU (5 frames at
  micro-batch 2, so the last micro-batch is padded): per rid within
  ``TOL`` (1e-4) of the logits' scale of the reference's plain (lax)
  ``apply_graph`` on the same numpy weights and frames; bit for bit
  equal to the port's ``apply_staged`` on the same zero-padded
  micro-batches with fp32 links, int8 links and int8 weights; int8
  links also within ``INT8_LINK_TOL`` (2e-2) of the reference engine's
  own served outputs (its padded batches, its lax stages); a mid-stream
  plan switch bit for bit per rung against that rung served alone; a
  replicated ladder rung within ``TOL`` of the unreplicated forward.
"""
import dataclasses
from fractions import Fraction as F

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro.obs import audit as ref_audit  # noqa: E402
from repro.serving import cnn_stream as ref_cs  # noqa: E402
from repro.serving import overload as ref_ov  # noqa: E402
from repro.serving import scenarios as ref_sc  # noqa: E402
from repro.serving.config import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.core.dse import plan_ladder  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.obs import audit  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CNNStreamEngine,
    LadderRung,
    PlanLadder,
    ServeConfig,
    ServingError,
    ShedPolicy,
    SwitchPolicy,
    adversarial,
    bursty,
    constant,
    diurnal,
)
from repro_torch.serving import cnn_stream  # noqa: E402

FAMILIES = ("mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34")
HW = (32, 32)
TOL = 1e-4
# The two frameworks' activations differ by about 1e-6 of their scale,
# so a value on a rounding edge of an int8 link lands one step (amax/127)
# apart; the sharp check of int8 links is port against port, bit for bit
# (the tolerance tests/test_torch_staged.py states for the same reason).
INT8_LINK_TOL = 2e-2


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


def same_report(got, want):
    """ServeReport equality, port against reference, with no tolerance:
    every field, every StageReport, the busy intervals and the summary."""
    assert plain(got) == plain(want)
    assert got._stage_intervals == want._stage_intervals
    assert plain(got.summary("x")) == plain(want.summary("x"))
    assert got.to_rows() == want.to_rows()


def events(tracer):
    return [(e.name, e.ph, e.t, e.pid, e.tid, e.clock, e.value, e.args)
            for e in tracer.events]


# --------------------------------------------------------------------------
# (i) the tick model, exactly
# --------------------------------------------------------------------------

_PLANS = {}


def _plans(family, n_stages, hw=None, **dse):
    """The family's plan at rate 3, from each package (224x224 unless
    ``hw`` is given), memoized per test module."""
    key = (family, n_stages, hw, repr(sorted(dse.items())))
    if key not in _PLANS:
        ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
        kw = {} if hw is None else {"input_hw": hw, "num_classes": 10}
        rc, pc = ra.make_config(**kw), pa.make_config(**kw)
        _PLANS[key] = (ra.partition(rc, F(3), n_stages, **dse), ra.graph(rc),
                       pa.partition(pc, F(3), n_stages, **dse), pa.graph(pc))
    return _PLANS[key]


@pytest.mark.parametrize("n_stages", [1, 2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_tick_model_matches_reference(family, n_stages):
    rplan, _, pplan, _ = _plans(family, n_stages)
    assert cnn_stream.slot_cycles(pplan) == ref_cs.slot_cycles(rplan)
    assert plain(cnn_stream.stage_rates(pplan)) == plain(ref_cs.stage_rates(rplan))
    assert cnn_stream.best_rate_frames(pplan) == ref_cs.best_rate_frames(rplan)
    assert (cnn_stream.sustainable_rate_cycles(pplan)
            == ref_cs.sustainable_rate_cycles(rplan))
    for mb in (1, 2, 8):
        assert (cnn_stream.queue_caps_batches(pplan, mb)
                == ref_cs.queue_caps_batches(rplan, mb))
    for name in pplan.graph.topo_order():
        assert (cnn_stream.node_frame_cycles(pplan, name)
                == ref_cs.node_frame_cycles(rplan, name))
    for sr in cnn_stream.stage_rates(pplan):
        assert isinstance(sr.utilization, F) and isinstance(sr.svc_cycles, F)


def test_tick_model_on_replicated_and_int8_link_plans():
    """Replication lanes amortize their service by R; int8 wires shrink the
    cut FIFOs and the frames they hold alike: both as in the reference."""
    for kw in ({"replicate": {"l3b1_conv2": 2}}, {"link_dtype": "fp32"}):
        rplan, _, pplan, _ = _plans("resnet18", 3, **kw)
        assert plain(cnn_stream.stage_rates(pplan)) == plain(ref_cs.stage_rates(rplan))
        assert (cnn_stream.queue_caps_batches(pplan, 8)
                == ref_cs.queue_caps_batches(rplan, 8))
        assert (cnn_stream.best_rate_frames(pplan)
                == ref_cs.best_rate_frames(rplan))


# --------------------------------------------------------------------------
# (ii) timing-only runs: the report and the trace, exactly
# --------------------------------------------------------------------------


def _scenario(name, br, pgraph, rgraph):
    """(port config, reference config) kwargs of one named scenario."""
    if name == "constant":
        return {"arrival": constant(br)}, {"arrival": ref_sc.constant(br)}
    if name == "rate_above_best":
        return {"arrival": 2 * br}, {"arrival": 2 * br}
    if name == "bursty":
        kw = dict(burst=12, gap=20, burst_jitter=3, gap_jitter=5, seed=7)
        return ({"arrival": bursty(2 * br, **kw)},
                {"arrival": ref_sc.bursty(2 * br, **kw)})
    if name == "diurnal":
        ph = [(br / 4, 16), (0, 8), (2 * br, 12)]
        return {"arrival": diurnal(ph)}, {"arrival": ref_sc.diurnal(ph)}
    if name == "flush":
        return ({"arrival": F(1, 6) * br, "flush_after_ticks": F(5, 2)},
                {"arrival": F(1, 6) * br, "flush_after_ticks": F(5, 2)})
    if name == "shed":
        return ({"arrival": adversarial(br), "overload": ShedPolicy(F(24))},
                {"arrival": ref_sc.adversarial(br),
                 "overload": ref_ov.ShedPolicy(F(24))})
    if name == "switch":
        pl = PlanLadder.build(pgraph, F(3), n_stages=2, rate_factors=(1, 2))
        rl = ref_ov.PlanLadder.build(rgraph, F(3), n_stages=2, rate_factors=(1, 2))
        return ({"arrival": bursty(2 * br, burst=32, gap=48),
                 "overload": SwitchPolicy(pl, window_ticks=16)},
                {"arrival": ref_sc.bursty(2 * br, burst=32, gap=48),
                 "overload": ref_ov.SwitchPolicy(rl, window_ticks=16)})
    raise KeyError(name)


def _timing_pair(family, name, *, n_frames=68, microbatch=8, trace=True):
    rplan, rgraph, pplan, pgraph = _plans(family, 2)
    br = cnn_stream.best_rate_frames(pplan)
    pkw, rkw = _scenario(name, br, pgraph, rgraph)
    if name == "switch":
        pplan = pkw["overload"].ladder.rungs[0].plan
        rplan = rkw["overload"].ladder.rungs[0].plan
    pe = CNNStreamEngine(pgraph, None, pplan, ServeConfig(
        microbatch=microbatch, execute=False, trace=trace, **pkw))
    re = ref_cs.CNNStreamEngine(rgraph, None, rplan, RefServeConfig(
        microbatch=microbatch, execute=False, trace=trace, **rkw))
    for _ in range(n_frames):
        pe.submit(None)
        re.submit(None)
    return pe.run(), re.run()


SCENARIOS = ("constant", "rate_above_best", "bursty", "diurnal", "flush", "shed",
             "switch")


@pytest.mark.parametrize("name", SCENARIOS)
@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_timing_run_matches_reference(family, name):
    got, want = _timing_pair(family, name)
    same_report(got, want)
    assert events(got.trace) == events(want.trace)
    assert got.trace.meta == want.trace.meta
    assert all(isinstance(e.t, F) for e in got.trace.events)
    assert got.metrics.snapshot() == want.metrics.snapshot()
    ar, rr = audit(got.trace), ref_audit(want.trace)
    assert ar.verdict_line() == rr.verdict_line()
    assert ar.matches(got.summary()) and rr.matches(want.summary())
    assert plain(ar.rows) == plain(rr.rows) and plain(ar.stalls) == plain(rr.stalls)
    if name == "shed":
        assert got.shed > 0
    if name == "switch":
        assert len(got.switches) == 4


def test_tracing_off_is_event_identical_and_stall_free_at_best_rate():
    on, _ = _timing_pair("resnet18", "constant")
    off, want = _timing_pair("resnet18", "constant", trace=False)
    assert off.trace is None and off.metrics is None
    assert plain(on) == plain(off)
    same_report(off, want)
    assert off.stall_free and off.within_queue_bounds
    assert off.admitted_rate == off.best_rate


def test_run_arguments_override_the_config():
    """``run(arrival_rate=, max_ticks=, flush_after_ticks=)`` per run, as
    the reference's ``begin`` takes them."""
    rplan, rgraph, pplan, pgraph = _plans("mobilenet_v2", 3)
    pe = CNNStreamEngine(pgraph, None, pplan, ServeConfig(microbatch=4, execute=False))
    re = ref_cs.CNNStreamEngine(rgraph, None, rplan,
                                RefServeConfig(microbatch=4, execute=False))
    for _ in range(18):
        pe.submit(None)
        re.submit(None)
    same_report(pe.run(arrival_rate=F(1, 3), flush_after_ticks=F(2)),
                re.run(arrival_rate=F(1, 3), flush_after_ticks=F(2)))
    with pytest.raises(ServingError, match="exceeded max_ticks=4"):
        pe.run(max_ticks=4)


# --------------------------------------------------------------------------
# (iii) served outputs at 32x32 on the CPU
# --------------------------------------------------------------------------

_SETUPS = {}


def _setup(family):
    """Both sides at 32x32, 10 classes, on the port's weights (carried to
    the reference as numpy arrays) and 5 numpy frames."""
    if family not in _SETUPS:
        ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
        rc = ra.make_config(input_hw=HW, num_classes=10)
        pc = pa.make_config(input_hw=HW, num_classes=10)
        pp = pa.init(pc, torch.Generator().manual_seed(0))
        rp = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()}
              for n, p in pp.items()}
        x = np.random.default_rng(1).standard_normal((5, *HW, 3)).astype(np.float32)
        _SETUPS[family] = (ra, rc, rp, pa, pc, pp, x)
    return _SETUPS[family]


def _within(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= tol * scale


def _padded_batches(x, microbatch):
    """The engine's micro-batches of frames in rid order, the last
    zero-padded to ``microbatch`` rows."""
    x = torch.as_tensor(x)
    out = []
    for i in range(0, len(x), microbatch):
        b = x[i:i + microbatch]
        if len(b) < microbatch:
            b = torch.cat([b, torch.zeros((microbatch - len(b), *b.shape[1:]))])
        out.append(b)
    return out


def _serve(pa, pc, params, x, gp, **cfg):
    eng = CNNStreamEngine(pa.graph(pc), params, gp, ServeConfig(microbatch=2, **cfg),
                          device="cpu")
    eng.submit_all(x)
    rep = eng.run()
    return eng, rep, eng.outputs()


@pytest.mark.parametrize("family", FAMILIES)
def test_served_outputs_match_reference_apply_graph(family):
    """Above BestRate (queues and backpressure engaged), frames spread over
    three micro-batches, the last padded: per rid within TOL of the
    reference's monolithic forward."""
    ra, rc, rp, pa, pc, pp, x = _setup(family)
    gp = pa.partition(pc, F(3), 2)
    eng, rep, out = _serve(pa, pc, pp, x, gp,
                           arrival=2 * cnn_stream.best_rate_frames(gp),
                           kernel_plan=gp.kernel_plan(batch=2))
    assert rep.completed == 5 and rep.request_queue_peak > 0
    assert out.shape == (5, 10) and out.device.type == "cpu"
    _within(out, ra.apply(rp, jnp.asarray(x), rc), TOL)


@pytest.mark.parametrize("link", [None, "int8", "int8_weights"])
@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_served_equals_apply_staged_per_padded_microbatch(family, link):
    """The same kernels on the same zero-padded micro-batches: bit for bit,
    with fp32 links, int8 links (the pad rows share the payload's scale)
    and int8 weights."""
    _, _, _, pa, pc, pp, x = _setup(family)
    gp = pa.partition(pc, F(3), 3)
    kp = gp.kernel_plan(batch=2)
    params, lq = pp, None
    if link == "int8_weights":
        q, s = pa.quantize(pp)
        params = cnn.dequantize_params(q, s)
    else:
        lq = link
    _, rep, out = _serve(pa, pc, params, x, gp, kernel_plan=kp, link_quant=lq,
                         arrival=F(1))
    assert rep.completed == 5
    want = torch.cat([pa.apply_staged(params, b, pc, partition=gp, plan=kp,
                                      link_quant=lq)
                      for b in _padded_batches(x, 2)])[:5]
    assert torch.equal(out, want)
    if link == "int8_weights":
        assert torch.equal(out, torch.cat([pa.apply_int8(q, s, b, pc, partition=gp)
                                           for b in _padded_batches(x, 2)])[:5])


@pytest.mark.parametrize("family", ["mobilenet_v1", "resnet18"])
def test_int8_links_match_the_reference_engine(family):
    """int8 links, port engine against the reference engine (eager lax
    stages, the same padded micro-batches, each quantizing its padded
    batch with one scale): within INT8_LINK_TOL of the logits' scale."""
    ra, rc, rp, pa, pc, pp, x = _setup(family)
    rgp = ra.partition(rc, F(3), 2, link_dtype="int8")
    ref = ref_cs.CNNStreamEngine(ra.graph(rc), rp, rgp, RefServeConfig(
        microbatch=2, link_quant="int8", jit=False, dtype=jnp.float32))
    ref.submit_all(x)
    ref.run()
    gp = pa.partition(pc, F(3), 2, link_dtype="int8")
    _, _, out = _serve(pa, pc, pp, x, gp, link_quant="int8")
    _within(out, ref.outputs(), INT8_LINK_TOL)


def test_int8_payloads_ride_the_queues_with_their_scales():
    """Between stages a micro-batch's boundary holds each int8 crossing as
    one {"__q__", "__s__"} value: pruning after a stage keeps the scale
    with its payload, and nothing else than what later stages import."""
    _, _, _, pa, pc, pp, x = _setup("resnet18")
    gp = pa.partition(pc, F(3), 3)
    eng = CNNStreamEngine(pa.graph(pc), pp, gp,
                          ServeConfig(microbatch=2, link_quant="int8"), device="cpu")
    eng.submit_all(x)
    rt = eng.begin()
    seen = set()
    while not eng.finished:
        eng.advance(rt.t)
        for s in (1, 2):
            for batch in rt.queues[s]:
                assert set(batch.boundary) <= eng.pipeline.keep_after()[s - 1]
                for v in batch.boundary.values():
                    assert isinstance(v, dict) and set(v) == {"__q__", "__s__"}
                    assert v["__q__"].dtype == torch.int8 and v["__s__"].dim() == 0
                seen.add(s)
        nxt = eng.next_event(rt.t)
        if nxt is not None:
            rt.t = nxt
    assert seen == {1, 2}
    assert eng.finish().completed == 5


def test_switch_mid_stream_bit_exact_per_rung():
    """A batch never straddles a switch, so each frame is served end to
    end by one rung, bit for bit what that rung gives served alone."""
    _, _, _, pa, pc, pp, _ = _setup("mobilenet_v2")
    g = pa.graph(pc)
    ladder = PlanLadder.build(g, F(2), n_stages=2, rate_factors=(1, 2))
    plan = ladder.rungs[0].plan
    br = cnn_stream.best_rate_frames(plan)
    frames = torch.randn((10, *HW, 3), generator=torch.Generator().manual_seed(5))
    eng = CNNStreamEngine(g, pp, plan, ServeConfig(
        microbatch=2, arrival=bursty(2 * br, burst=8, gap=12),
        kernel_plan=plan.kernel_plan(batch=2),
        overload=SwitchPolicy(ladder, window_ticks=F(4))), device="cpu")
    eng.submit_all(frames)
    rep = eng.run()
    assert rep.completed == 10 and len(rep.switches) >= 1
    out = eng.outputs()
    used = sorted({r.rung for r in eng._requests})
    assert len(used) >= 2
    for rung in used:
        rids = [r.rid for r in eng._requests if r.rung == rung]
        rplan = ladder.rungs[rung].plan
        alone = CNNStreamEngine(rplan.graph, pp, rplan, ServeConfig(
            microbatch=2, kernel_plan=rplan.kernel_plan(batch=2)), device="cpu")
        alone.submit_all(frames[rids])
        alone.run()
        assert torch.equal(out[rids], alone.outputs()), rung


def test_replicated_rung_within_tolerance_of_the_unreplicated_forward():
    """A replicated rung from ``plan_ladder(..., try_replicate=True)``
    (at 32x32 ``PlanLadder.build`` prunes it: it sustains less than the
    plain plan at the same rate, so the ladder here goes from the base
    straight to it).  Its lanes see part of each micro-batch, so its
    frames are held at TOL of the unreplicated forward, not bit for bit."""
    _, _, _, pa, pc, pp, _ = _setup("resnet18")
    g = pa.graph(pc)
    plans = plan_ladder(g, F(2), n_stages=2, rate_factors=(1, 2), try_replicate=True)
    base, rep = plans[0], plans[-1]
    assert rep.replications and not base.replications
    ladder = PlanLadder(rungs=tuple(
        LadderRung(label, p, cnn_stream.sustainable_rate_cycles(p))
        for label, p in (("base", base), ("rep", rep))))
    frames = torch.randn((10, *HW, 3), generator=torch.Generator().manual_seed(3))
    eng = CNNStreamEngine(g, pp, base, ServeConfig(
        microbatch=2, arrival=constant(2 * cnn_stream.best_rate_frames(base)),
        overload=SwitchPolicy(ladder, window_ticks=F(4))), device="cpu")
    eng.submit_all(frames)
    rep_ = eng.run()
    assert rep_.completed == 10 and rep_.switches
    assert any(r.rung == 1 for r in eng._requests)
    _within(eng.outputs(), pa.apply(pp, frames, pc).numpy(), TOL)


def test_rid_tracking_under_out_of_order_submission():
    """Outputs map to their requests when rids are submitted out of order:
    a frame's content is tied to its rid, not its arrival position."""
    ra, rc, rp, pa, pc, pp, _ = _setup("mobilenet_v2")
    frames = np.random.default_rng(2).standard_normal((4, *HW, 3)).astype(np.float32)
    gp = pa.partition(pc, F(3), 2)
    eng = CNNStreamEngine(pa.graph(pc), pp, gp, ServeConfig(microbatch=3),
                          device="cpu")
    for rid in (2, 0, 3, 1):
        eng.submit(frames[rid], rid=rid)
    eng.run(arrival_rate=F(1))
    out = eng.outputs()
    _within(out, ra.apply(rp, jnp.asarray(frames), rc), TOL)
    _within(out, pa.apply(pp, torch.from_numpy(frames), pc).numpy(), TOL)


def test_shed_frames_are_skipped_in_the_outputs():
    _, _, _, pa, pc, pp, x = _setup("resnet18")
    gp = pa.partition(pc, F(3), 2)
    br = cnn_stream.best_rate_frames(gp)
    frames = np.concatenate([x] * 4)
    eng, rep, out = _serve(pa, pc, pp, frames, gp, arrival=4 * br,
                           overload=ShedPolicy(F(4)))
    assert rep.shed > 0 and rep.completed + rep.shed == 20
    kept = [r for r in range(20) if r not in rep.shed_rids]
    assert out.shape[0] == len(kept)
    assert torch.equal(out, torch.stack([eng._requests[r].out for r in kept]))


def test_outputs_need_an_executing_engine():
    rplan, rgraph, pplan, pgraph = _plans("resnet18", 2)
    eng = CNNStreamEngine(pgraph, None, pplan, ServeConfig(execute=False))
    assert eng.device is None
    eng.submit(None)
    eng.run()
    with pytest.raises(ServingError, match="execute=False"):
        eng.outputs()
