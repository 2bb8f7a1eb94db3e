"""The port's host spans (``obs.trace.host_span``) on the CNN main path, on
the CPU at 32x32, 10 classes: under ``torch.profiler`` a ``CNNApi.apply``
and a ``CNNApi.serve`` (executed, 2 stages) emit their spans with the
stated nesting; with neither a profiler nor a tracer no
``record_function`` is entered; with a tracer in ``ServeConfig.trace``
the host spans land in it with their args, and its tick-domain events
are those of a timing-only run.
"""
from fractions import Fraction as F

import pytest

torch = pytest.importorskip("torch")

from torch.autograd import profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.serving import ServeConfig  # noqa: E402

HW = (32, 32)
FRAMES, MICROBATCH, STAGES = 8, 4, 2
STREAM = ("stream.serve", "stream.setup", "stream.plan", "stream.build",
          "stream.submit", "stream.loop", "stream.outputs")
SPANS = ("step.apply", "executor.table", "executor.nodes", "exec") + STREAM


@pytest.fixture(scope="module")
def model():
    api = get_cnn_api("mobilenet_v2", device="cpu")
    cfg = api.make_config(input_hw=HW, num_classes=10)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(FRAMES, *HW, 3, generator=torch.Generator().manual_seed(1))
    return api, cfg, params, x, api.plan(cfg, F(3))


def _apply(model):
    api, cfg, params, x, plan = model
    return api.apply(params, x, cfg, plan=plan)


def _serve(model, **config):
    api, cfg, params, x, _ = model
    return api.serve(params, x, cfg, input_rate=F(3), n_stages=STAGES,
                     rate_matched=True,
                     config=ServeConfig(microbatch=MICROBATCH, **config))


def _profiled(fn):
    """The program's spans among the profiler's events: name -> list of
    (start, end)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for e in prof.events():
        if e.name in SPANS:
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def _inside(child, parent):
    return parent[0] <= child[0] and child[1] <= parent[1]


def test_apply_emits_its_spans_under_the_profiler(model):
    got = _profiled(lambda: _apply(model))
    assert sorted(got) == ["executor.nodes", "executor.table", "step.apply"]
    (step,) = got["step.apply"]
    (table,) = got["executor.table"]
    (nodes,) = got["executor.nodes"]
    assert _inside(table, step) and _inside(nodes, step)
    assert table[1] <= nodes[0]


def test_serve_emits_its_spans_under_the_profiler(model):
    got = _profiled(lambda: _serve(model, execute=True))
    assert set(got) == set(SPANS) - {"step.apply"}
    one = {name: got[name][0] for name in STREAM}
    assert all(len(got[name]) == 1 for name in STREAM)
    for name in ("stream.setup", "stream.loop", "stream.outputs"):
        assert _inside(one[name], one["stream.serve"]), name
    for name in ("stream.plan", "stream.build", "stream.submit"):
        assert _inside(one[name], one["stream.setup"]), name
    assert one["stream.plan"][1] <= one["stream.build"][0]
    assert one["stream.build"][1] <= one["stream.submit"][0]
    assert one["stream.setup"][1] <= one["stream.loop"][0]
    assert one["stream.loop"][1] <= one["stream.outputs"][0]
    # the stages' tables are built once, with the engine
    (table,) = got["executor.table"]
    assert _inside(table, one["stream.build"])
    # a dispatch a stage and micro-batch, each inside the loop, each
    # running its stage's node loop
    execs = got["exec"]
    assert len(execs) == STAGES * (FRAMES // MICROBATCH)
    assert all(_inside(e, one["stream.loop"]) for e in execs)
    assert len(got["executor.nodes"]) == len(execs)
    assert all(any(_inside(n, e) for e in execs) for n in got["executor.nodes"])


def test_no_record_function_without_a_profiler_or_a_tracer(model, monkeypatch):
    entered = []
    real = profiler.record_function

    def counting(name, args=None):
        if name in SPANS:
            entered.append(name)
        return real(name, args)

    monkeypatch.setattr(profiler, "record_function", counting)
    _apply(model)
    _serve(model, execute=True)
    _serve(model, execute=True, trace=obs.Tracer())
    assert entered == []
    # the same calls under a profiler do enter it, through the patch
    _profiled(lambda: (_apply(model), _serve(model, execute=True)))
    assert set(entered) == set(SPANS)


def test_host_span_is_one_shared_null_context_when_off():
    assert obs.host_span("a") is obs.host_span("b", pid="p", frames=3)
    tr = obs.Tracer()
    with obs.host_span("work", tr, pid="p", tid="host", frames=3):
        pass
    (span,) = tr.spans("work", clock="host")
    assert (span.pid, span.tid, span.arg("frames")) == ("p", "host", 3)
    assert span.end >= span.start


@pytest.mark.parametrize("trace", ["true", "shared"])
def test_a_tracer_gets_the_host_spans_and_the_same_tick_events(model, trace):
    shared = obs.Tracer()
    out, got = _serve(model, execute=True,
                      trace=True if trace == "true" else shared)
    tracer = got.trace
    assert tracer is not None and (trace == "true" or tracer is shared)
    host = tracer.spans(clock="host")
    assert sorted({s.name for s in host}) == sorted(STREAM + ("exec",))
    for name in STREAM:
        (span,) = [s for s in host if s.name == name]
        assert (span.pid, span.tid) == ("engine", "host")
    (serve,) = tracer.spans("stream.serve")
    assert serve.arg("frames") == FRAMES
    execs = tracer.spans("exec", clock="host")
    assert sorted((s.tid, s.arg("bid"), s.arg("frames")) for s in execs) == sorted(
        (f"stage{s}", b, MICROBATCH)
        for s in range(STAGES) for b in range(FRAMES // MICROBATCH))
    assert all(serve.start <= s.start and s.end <= serve.end for s in host)
    # the tick model's events: those of a timing-only run; the report and
    # the outputs: those of an untraced run
    _, timing = _serve(model, execute=False, trace=True)
    assert timing.trace.select(clock="host") == []
    assert tracer.select(clock="ticks") == timing.trace.events
    off_out, off = _serve(model, execute=True)
    assert off.trace is None and got == off
    assert torch.equal(out, off_out)
