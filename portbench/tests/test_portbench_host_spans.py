"""The readers of the program's host spans (``obs.trace.host_span``) on
traces made by hand, and the spans on a profiled window on the CPU."""
import time
import types
from fractions import Fraction

import pytest
import torch

from portbench import devtrace, harness
from portbench.tests.smallcell import CELLS, MANIFEST, ROOT, small_cell

NEW = ("executor.table_ms_per_batch", "executor.nodes_ms_per_batch",
       "device.idle_in_program_share", "stream.setup_ms_per_run",
       "stream.loop_self_us_per_frame")
SPANS = ("step.apply", "executor.table", "executor.nodes", "stream.serve",
         "stream.setup", "stream.plan", "stream.build", "stream.submit",
         "stream.loop", "exec", "stream.outputs")

# Two batches through ``apply``, and an ``executor.table`` outside any of
# them (a stage pipeline's build), which the per-batch readers leave out.
OFFLINE = devtrace.Trace(
    ops=[("kpu_kernel<float>", 1.5, 3.5), ("fcu_kernel<float>", 5.0, 6.5)],
    host=[("step.apply", 1.0, 3.0), ("executor.table", 1.0, 1.2),
          ("executor.nodes", 1.2, 2.8), ("aten::add", 1.3, 1.4),
          ("cudaDeviceSynchronize", 3.0, 4.0),
          ("step.apply", 4.0, 6.0), ("executor.table", 4.0, 4.1),
          ("executor.nodes", 4.1, 5.9), ("executor.table", 7.0, 7.5)],
    start=0.5, end=8.0, frames=4, passes=2)

# One stream run; an ``exec`` outside its loop, which the loop's self time
# does not subtract.
STREAM = devtrace.Trace(
    ops=[("fcu_kernel<float>", 3.0, 7.0)],
    host=[("stream.serve", 1.0, 9.0), ("stream.setup", 1.0, 2.0),
          ("stream.plan", 1.0, 1.2), ("stream.build", 1.2, 1.8),
          ("stream.submit", 1.8, 2.0), ("stream.loop", 2.0, 8.0),
          ("exec", 2.5, 3.0), ("exec", 4.0, 5.0), ("stream.outputs", 8.0, 9.0),
          ("exec", 9.5, 9.7)],
    start=0.5, end=10.0, frames=4, passes=1)

BARE = devtrace.Trace(
    ops=[("kpu_kernel<float>", 1.0, 3.0)],
    host=[("aten::add", 4.0, 5.0), ("cudaDeviceSynchronize", 7.0, 8.0)],
    start=0.5, end=8.0, frames=4, passes=2)


def _read(name, trace):
    return harness.reader(ROOT, name)(types.SimpleNamespace(trace=trace))


def test_the_new_metrics_are_in_the_manifest():
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    for name in NEW:
        assert per_layer[name]["source"] == "device_trace"
        assert per_layer[name]["workloads"]


def test_readers_on_an_offline_trace():
    assert _read("executor.table_ms_per_batch", OFFLINE) == pytest.approx(0.3e3 / 2)
    assert _read("executor.nodes_ms_per_batch", OFFLINE) == pytest.approx(3.4e3 / 2)
    # gaps (0.5, 1.5), (3.5, 5.0), (6.5, 8.0) against the spans' union
    # (1.0, 3.0), (4.0, 6.0), (7.0, 7.5): 0.5 + 1.0 + 0.5 of 7.5
    assert _read("device.idle_in_program_share", OFFLINE) == pytest.approx(
        100 * 2.0 / 7.5)
    assert _read("stream.setup_ms_per_run", OFFLINE) is None
    assert _read("stream.loop_self_us_per_frame", OFFLINE) is None


def test_readers_on_a_stream_trace():
    assert _read("stream.setup_ms_per_run", STREAM) == pytest.approx(1.0e3)
    assert _read("stream.loop_self_us_per_frame", STREAM) == pytest.approx(
        (6.0 - 1.5) * 1e6 / 4)
    # gaps (0.5, 3.0), (7.0, 10.0) against (1.0, 9.0) and (9.5, 9.7)
    assert _read("device.idle_in_program_share", STREAM) == pytest.approx(
        100 * (2.0 + 2.0 + 0.2) / 9.5)
    assert _read("executor.table_ms_per_batch", STREAM) is None
    assert _read("executor.nodes_ms_per_batch", STREAM) is None


# Per-layer readers under a cell's own name, that read what their
# original reads (the MobileNetV2 offline cell's, where they move
# frames_per_s): each against its original on one offline context.
SPLIT = {"step.batch_latency_p95_ms": "batch_latency_p95_ms",
         "executor.enqueue_ms_per_batch.host_paced": "executor.enqueue_ms_per_batch",
         "executor.table_ms_per_batch.host_paced": "executor.table_ms_per_batch",
         "executor.nodes_ms_per_batch.host_paced": "executor.nodes_ms_per_batch"}


@pytest.mark.parametrize("name", SPLIT)
def test_a_split_reader_reads_its_original(name):
    records = [(0.0, 0.001 * (1 + j % 5), 0.006 + 0.0001 * j) for j in range(40)]
    ctx = types.SimpleNamespace(trace=OFFLINE, records=records)
    value = harness.reader(ROOT, name)(ctx)
    assert value is not None and value > 0
    assert value == harness.reader(ROOT, SPLIT[name])(ctx)
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert per_layer[name]["moves"] == "frames_per_s"


@pytest.mark.parametrize("trace", [BARE, None], ids=["no_spans", "no_trace"])
def test_readers_find_nothing_without_program_spans(trace):
    for name in NEW:
        assert _read(name, trace) is None, name


@pytest.mark.parametrize("trace", [OFFLINE, STREAM], ids=["offline", "stream"])
def test_idle_in_program_is_within_idle(trace):
    assert (_read("device.idle_in_program_share", trace)
            <= _read("device.idle_share", trace))


def test_program_spans_reach_the_host_timeline_on_the_cpu():
    from repro_torch.models.registry import get_cnn_api
    from repro_torch.serving import ServeConfig

    api = get_cnn_api("mobilenet_v2", "cpu")
    cfg = api.make_config(input_hw=(32, 32), num_classes=10)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(8, 32, 32, 3)
    plan = api.plan(cfg, Fraction(3))
    config = ServeConfig(microbatch=4, execute=True)

    def window():
        api.apply(params, x, cfg, plan=plan)
        api.serve(params, x, cfg, input_rate=Fraction(3), n_stages=2,
                  rate_matched=True, config=config)

    tr = devtrace.record(torch, window, frames=16, passes=3)
    assert set(SPANS) <= {name for name, _, _ in tr.host}
    assert not any(name in SPANS for name, _, _ in tr.ops)


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reports_the_host_span_metrics(name):
    """Every new metric named for the cell but the idle share, which
    needs device operations, has a number from a small traced CPU run."""
    cell = small_cell(name)
    result = harness.run_cell(cell, seed=2 ** 31 + 29, seconds=0.2, trace=True,
                              device="cpu", t_start=time.perf_counter())
    named = [m["name"] for m in cell.per_layer if m["name"] in NEW]
    assert named
    for metric in named:
        if metric == "device.idle_in_program_share":
            assert metric not in result["metrics"]
        else:
            assert result["metrics"][metric]["value"] > 0, metric
