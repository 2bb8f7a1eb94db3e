"""The port's copy of ``obs/`` (metrics, trace, audit), against the JAX
package's: the same calls give the same snapshots, the same Chrome
trace-event JSON, the same spans and queries, and the same audit
verdicts, rows, windows and stalls, all compared exactly (Fractions
stay Fractions).  The engine traces are the stream engine's timing-only
runs at 32x32, 10 classes, each package planning its own.
"""
import dataclasses
import json
from fractions import Fraction as F

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import obs as ref_obs  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro.serving import cnn_stream as ref_cs  # noqa: E402
from repro.serving import overload as ref_ov  # noqa: E402
from repro.serving import scenarios as ref_sc  # noqa: E402
from repro.serving.config import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    CNNStreamEngine,
    PlanLadder,
    ServeConfig,
    ShedPolicy,
    SwitchPolicy,
    bursty,
)
from repro_torch.serving import cnn_stream  # noqa: E402

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


# --------------------------------------------------------------------------
# metrics
# --------------------------------------------------------------------------


def _drive_metrics(mod):
    m = mod.MetricsRegistry()
    m.counter("frames").inc(3)
    m.counter("busy", stage=1).inc(F(7, 3))
    m.counter("busy", stage=1).inc(F(1, 6))
    m.counter("busy", stage=0, seg=2).inc()
    g = m.gauge("queue_depth", stage=0)
    for v in (1, 3, 2):
        g.set(v)
    h = m.histogram("latency_ticks")
    for v in (F(5, 2), 1, 7, F(1, 3), 4):
        h.observe(v)
    m.histogram("empty")
    return m


def test_metrics_registry_matches_reference():
    got, want = _drive_metrics(obs), _drive_metrics(ref_obs)
    snap = got.snapshot()
    assert repr(snap) == repr(want.snapshot())
    assert snap["busy{stage=1}"] == F(5, 2)
    assert got.to_rows() == want.to_rows()
    assert got.value("busy", stage=1) == want.value("busy", stage=1)
    assert ("frames" in got) and got.get("nope") is None
    assert obs.metric_key("x", {"b": 1, "a": 2}) == ref_obs.metric_key("x", {"b": 1, "a": 2})
    for bad in (lambda m: m.counter("c").inc(-1), lambda m: m.gauge("frames")):
        with pytest.raises(ref_obs.MetricsError) as e_ref:
            bad(_drive_metrics(ref_obs))
        with pytest.raises(obs.MetricsError) as e:
            bad(got)
        assert str(e.value) == str(e_ref.value)


# --------------------------------------------------------------------------
# trace
# --------------------------------------------------------------------------


def _drive_trace(mod):
    tr = mod.Tracer()
    tr.metadata("p", {"slot_cycles": "7/3", "rungs": [{"caps": [2, 2]}]})
    tr.span("stage", F(1, 3), F(7, 3), pid="p", tid="stage0",
            frames=4, rids=(0, 1, 2, 3), ratio=F(5, 2))
    tr.begin("work", F(0), pid="p", tid="t", bid=0)
    tr.begin("work", F(1), pid="p", tid="t", bid=1)
    tr.end("work", F(2), pid="p", tid="t")
    tr.end("work", F(5), pid="p", tid="t")
    tr.instant("done", F(7, 3), pid="p", rid=3)
    tr.counter("queue_depth", 2, F(2), pid="p", tid="stage0")
    tr.counter("queue_depth", 1, F(1), pid="p", tid="stage0")
    tr.span("exec", F(12345, 1000), F(12346, 1000), pid="p", tid="stage0",
            clock="host", bid=0)
    return tr


def test_tracer_matches_reference():
    got, want = _drive_trace(obs), _drive_trace(ref_obs)
    assert got.dumps() == want.dumps()
    assert plain(got.spans()) == plain(want.spans())
    assert plain(got.spans("work")) == plain(want.spans("work"))
    assert got.counter_series("queue_depth") == want.counter_series("queue_depth")
    assert plain(got.frame_spans(2)) == plain(want.frame_spans(2))
    assert plain(got.frame_instants(3)) == plain(want.frame_instants(3))
    assert plain(obs.iter_spans(got.spans(), bid=1)) == plain(
        ref_obs.iter_spans(want.spans(), bid=1))
    assert got.pids() == want.pids() and got.check_balanced() == want.check_balanced()
    back = obs.Tracer.from_chrome(got.dumps())
    assert plain(back.events) == plain(got.events)
    assert back.meta == got.meta
    # the reference reads the port's dump and the port the reference's
    assert plain(obs.Tracer.from_chrome(want.to_chrome()).events) == plain(
        ref_obs.Tracer.from_chrome(json.loads(got.dumps())).events)


def test_tracer_refusals_and_resolve_contract(tmp_path):
    tr = obs.Tracer()
    tr.begin("work", F(0))
    with pytest.raises(obs.TraceError, match="B without E"):
        tr.check_balanced()
    with pytest.raises(obs.TraceError, match="unknown phase"):
        tr.emit("x", "Q", 0)
    tr = obs.Tracer()
    tr.end("work", F(0))
    with pytest.raises(obs.TraceError, match="E without B"):
        tr.spans()
    assert obs.resolve_tracer(None) is None and obs.resolve_tracer(False) is None
    assert isinstance(obs.resolve_tracer(True), obs.Tracer)
    shared = obs.Tracer()
    assert obs.resolve_tracer(shared) is shared
    with pytest.raises(obs.TraceError):
        obs.resolve_tracer("yes")
    path = tmp_path / "trace.json"
    _drive_trace(obs).write(str(path))
    assert len(obs.Tracer.from_chrome(path.read_text()).spans()) == 4


# --------------------------------------------------------------------------
# audit, on the engines' own traces
# --------------------------------------------------------------------------


def _traced_pair(family, n_stages, name, *, n_frames=48, microbatch=4, pid="engine",
                 tracers=(True, True)):
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc = ra.make_config(input_hw=HW, num_classes=10)
    pc = pa.make_config(input_hw=HW, num_classes=10)
    rg, pg = ra.graph(rc), pa.graph(pc)
    rplan, pplan = ra.partition(rc, F(3), n_stages), pa.partition(pc, F(3), n_stages)
    br = cnn_stream.best_rate_frames(pplan)
    pkw, rkw = {"arrival": br}, {"arrival": br}
    if name == "over":
        pkw, rkw = {"arrival": 2 * br}, {"arrival": 2 * br}
    elif name == "shed":
        pkw = {"arrival": 2 * br, "overload": ShedPolicy(F(24))}
        rkw = {"arrival": 2 * br, "overload": ref_ov.ShedPolicy(F(24))}
    elif name == "switch":
        pl = PlanLadder.build(pg, F(3), n_stages=n_stages, rate_factors=(1, 2))
        rl = ref_ov.PlanLadder.build(rg, F(3), n_stages=n_stages, rate_factors=(1, 2))
        pplan, rplan = pl.rungs[0].plan, rl.rungs[0].plan
        pkw = {"arrival": bursty(2 * br, burst=16, gap=24),
               "overload": SwitchPolicy(pl, window_ticks=8)}
        rkw = {"arrival": ref_sc.bursty(2 * br, burst=16, gap=24),
               "overload": ref_ov.SwitchPolicy(rl, window_ticks=8)}
    pe = CNNStreamEngine(pg, None, pplan, ServeConfig(
        microbatch=microbatch, execute=False, trace=tracers[0], trace_pid=pid,
        trace_chips={0: "chip0"}, **pkw))
    re = ref_cs.CNNStreamEngine(rg, None, rplan, RefServeConfig(
        microbatch=microbatch, execute=False, trace=tracers[1], trace_pid=pid,
        trace_chips={0: "chip0"}, **rkw))
    for _ in range(n_frames):
        pe.submit(None)
        re.submit(None)
    return pe.run(), re.run()


def _same_audit(got, want):
    assert got.verdict_line() == want.verdict_line()
    for field in ("rows", "windows", "stalls"):
        assert plain(getattr(got, field)) == plain(getattr(want, field)), field
    for field in ("pid", "window_ticks", "makespan_ticks", "submitted", "completed",
                  "shed", "switches", "best_rate", "arrival_rate", "bottleneck_row",
                  "occupancy_ok", "within_queue_bounds", "stall_free", "overloaded",
                  "clean"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.localization() == want.localization()


@pytest.mark.parametrize("name", ["best", "over", "shed", "switch"])
@pytest.mark.parametrize("family,n_stages", [("mobilenet_v2", 2), ("resnet18", 3)])
def test_audit_matches_reference(family, n_stages, name):
    got, want = _traced_pair(family, n_stages, name)
    assert got.trace.dumps() == want.trace.dumps()
    ag, aw = obs.audit(got.trace), ref_obs.audit(want.trace)
    _same_audit(ag, aw)
    assert ag.matches(got.summary())
    _same_audit(obs.audit(got.trace, window_ticks=5), ref_obs.audit(want.trace, window_ticks=5))
    _same_audit(obs.audit(obs.Tracer.from_chrome(got.trace.dumps())), aw)


def test_audit_flags_a_tampered_service_time():
    got, _ = _traced_pair("resnet18", 3, "best")
    data = got.trace.to_chrome()
    last = [e for e in data["traceEvents"] if e.get("name") == "stage" and e["ph"] == "E"][-1]
    t = F(last["args"]["__t__"]) + F(1, 3)
    last["args"]["__t__"] = f"{t.numerator}/{t.denominator}"
    tampered = obs.audit(obs.Tracer.from_chrome(data))
    assert not tampered.clean
    assert "service" in tampered.first_drift.reason or "overlap" in tampered.first_drift.reason
    assert "drifted at tick" in tampered.localization()


def test_audit_fleet_over_a_shared_tracer():
    """Two engines writing into one tracer under their own pids: each
    timeline audits as it does alone, in both packages."""
    shared, ref_shared = obs.Tracer(), ref_obs.Tracer()
    reports = {}
    for pid, family, n_stages in (("alpha", "resnet18", 2), ("beta", "mobilenet_v2", 3)):
        reports[pid] = _traced_pair(family, n_stages, "best", pid=pid,
                                    tracers=(shared, ref_shared))
    got, want = obs.audit_fleet(shared), ref_obs.audit_fleet(ref_shared)
    assert sorted(got) == sorted(want) == ["alpha", "beta"]
    for pid in got:
        _same_audit(got[pid], want[pid])
        assert got[pid].matches(reports[pid][0].summary())
    with pytest.raises(obs.AuditError, match="pass pid="):
        obs.audit(shared)
    with pytest.raises(obs.AuditError, match="no plan metadata"):
        obs.audit(shared, "gamma")
