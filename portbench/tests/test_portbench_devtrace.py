"""The reading of a trace (devtrace.Trace) and the per-layer readers on a
trace made by hand, and a profiled window on the CPU."""
import types

import pytest
import torch

from portbench import devtrace, harness, work
from portbench.tests.smallcell import ROOT

TRACE = devtrace.Trace(
    ops=[("kpu_kernel<float>", 1.0, 3.0), ("vectorized_elementwise", 2.5, 4.0),
         ("fcu_kernel<float>", 6.0, 7.0)],
    host=[("aten::add", 4.0, 5.0), ("cudaLaunchKernel", 4.2, 4.4),
          ("cudaDeviceSynchronize", 7.0, 8.0)],
    start=0.5, end=8.0, frames=4, passes=2)


def test_busy_gaps_and_breakdown():
    assert TRACE.busy() == [[1.0, 4.0], [6.0, 7.0]]
    assert TRACE.busy_s() == 4.0
    assert TRACE.gaps() == [(0.5, 1.0), (4.0, 6.0), (7.0, 8.0)]
    assert TRACE.device_s(["kpu_kernel"]) == 2.0
    assert TRACE.device_s(exclude=["kpu_kernel", "fcu_kernel"]) == 1.5
    b = TRACE.breakdown()
    assert b["device_ops"][0] == ["kpu_kernel<float>", 2.0]
    assert b["idle_gaps"] == [["aten::add", 2.0], ["cudaDeviceSynchronize", 1.0],
                              ["host idle", 0.5]]


def test_readers_on_a_trace():
    layers = harness.layers_of(ROOT, harness.resolve_cell(
        ROOT, harness.load_manifest(ROOT), "resnet18.offline.r3.b64").config)
    ctx = types.SimpleNamespace(trace=TRACE, layers=layers, launch_batch=2,
                                itemsize=4, records=[(0.0, 0.001, 0.01)] * 3,
                                frames_per_request=2, window_s=0.03,
                                setup_s=1.5)

    def read(name):
        return harness.reader(ROOT, name)(ctx)

    bound = work.unit_bound_s(layers, "kpu", 2, 4)
    assert read("kpu_conv_roofline") == pytest.approx(100 * bound * 2 / 2.0)
    assert read("dw_conv_roofline") is None
    assert read("executor.other_ms_per_frame") == pytest.approx(1.5e3 / 4)
    assert read("device.idle_share") == pytest.approx(100 * (1 - 4.0 / 7.5))
    assert read("step.mfu") == pytest.approx(
        100 * work.frame_flops(layers) * 4 / 7.5 / work.PEAK_FLOPS)
    assert read("executor.enqueue_ms_per_batch") == pytest.approx(1.0)
    assert read("frames_per_s") == pytest.approx(200.0)
    assert read("setup_s") == 1.5
    ctx.trace = None
    assert read("step.mfu") is None and read("kpu_conv_roofline") is None


def test_a_profiled_window_on_the_cpu():
    x = torch.randn(64, 64)
    tr = devtrace.record(torch, lambda: [x @ x for _ in range(4)], frames=4, passes=4)
    assert tr.window_s > 0 and tr.frames == 4
    assert any("mm" in name for name, _, _ in tr.host)
    assert all(tr.start <= s <= e <= tr.end for _, s, e in tr.host)
