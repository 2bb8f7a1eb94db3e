"""The device pipeline's ``measure`` report and its tracer spans in the
port, against the JAX package's (the reference's
``tests/distributed/test_device_pipeline.py`` cases), on the CPU's
one-device pool at 32x32: ``WallClockReport``'s structural fields, and
the dispatch / transfer spans (names, pids, tids, micro-batches)
exactly.  The rest of the device pipeline is
``tests/test_torch_device_pipeline.py``.
"""
from fractions import Fraction as F

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.distributed import device_pipeline as ref_dp  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro_torch.distributed.device_pipeline import (  # noqa: E402
    DevicePipeline, WallClockReport)
from repro_torch.distributed.pipeline_parallel import microbatch_utilization  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402

HW = (32, 32)


def _setup(family="resnet18"):
    """Both sides at 32x32, 10 classes, on the port's weights (carried to
    the reference as numpy arrays) and 4 numpy frames."""
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc = ra.make_config(input_hw=HW, num_classes=10)
    pc = pa.make_config(input_hw=HW, num_classes=10)
    pp = pa.init(pc, torch.Generator().manual_seed(0))
    rp = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()} for n, p in pp.items()}
    x = np.random.default_rng(1).standard_normal((4, *HW, 3)).astype(np.float32)
    return ra, rc, rp, pa, pc, pp, x


def _ref_pipeline(ra, rc, rp, plan, **kw):
    return ref_dp.DevicePipeline.build(ra.graph(rc), rp, partition=plan,
                                       placement=True, jit=False, **kw)


def test_measure_report_fields():
    """The report's structural fields equal the reference's exactly; its
    times are this host's."""
    ra, rc, rp, pa, pc, pp, x = _setup()
    dp = DevicePipeline.build(pa.graph(pc), pp, partition=pa.partition(pc, F(1), 2))
    rep = dp.measure(x, microbatch=1, warmup=1, repeats=1)
    ref = _ref_pipeline(ra, rc, rp, ra.partition(rc, F(1), 2)).measure(
        x, microbatch=1, warmup=1, repeats=1)
    assert isinstance(rep, WallClockReport)
    for field in ("frames", "microbatch", "n_micro", "n_stages", "n_devices",
                  "placement", "utilization_bound"):
        assert getattr(rep, field) == getattr(ref, field), field
    assert rep.frames == 4 and rep.n_micro == 4 and rep.n_stages == 2
    assert rep.utilization_bound == pytest.approx(4 / 5) == microbatch_utilization(4, 2)
    assert rep.overlap_s > 0 and rep.sequential_s > 0
    assert rep.fps_overlap > 0 and rep.speedup > 0
    assert len(rep.stage_busy_s) == 2 and all(b > 0 for b in rep.stage_busy_s)


def test_tracer_spans_match_reference():
    """With a tracer, the dispatch and transfer spans carry the
    reference's names, pids (one per device ordinal), tids (one per stage)
    and micro-batches, and ``measure`` adds its block_until_ready span."""
    ra, rc, rp, pa, pc, pp, x = _setup()
    rplan, plan = ra.partition(rc, F(1), 3), pa.partition(pc, F(1), 3)
    rdp = _ref_pipeline(ra, rc, rp, rplan, tracer=True)
    dp = DevicePipeline.build(pa.graph(pc), pp, partition=plan, tracer=True)

    def rows(tracer):
        return sorted((s.name, s.pid, s.tid, s.clock, s.args)
                      for s in tracer.spans())

    rdp.run(x, microbatch=1)
    dp.run(x, microbatch=1)
    assert rows(dp.tracer) == rows(rdp.tracer)
    assert len(dp.tracer.spans("dispatch")) == 4 * 3
    dp.measure(x, microbatch=2, warmup=1, repeats=2)
    assert [s.pid for s in dp.tracer.spans("block_until_ready")] == ["host"] * 2
