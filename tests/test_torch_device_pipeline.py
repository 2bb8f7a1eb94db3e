"""The device pipeline (``distributed/device_pipeline.py``, the placed
``StagePipeline``) in the port, against the JAX package's.

Case for case the reference's ``tests/distributed/test_device_pipeline.py``,
on the CPU (the one-device pool: every stage co-resident, as on the
reference's one-CPU host), plus:

* ``resolve_stage_devices`` for every form, and ``device_placement_rows``,
  exactly against the reference — on the CPU's pool and on a pool of four
  cards (``torch.cuda`` told it has four; the reference's ``jax.devices``
  told the same; nothing runs on them);
* ``DevicePipeline.run`` at 32x32 against the reference's ``run`` on the
  same numpy weights and frames, S = 1-3, micro-batch 1, 2 and 4: fp32
  links within ``TOL`` (1e-4) of the logits' scale, int8 links within
  ``INT8_LINK_TOL`` (2e-2); port against port, ``run`` equals
  ``apply_staged`` on each micro-batch bit for bit;
* (``WallClockReport``'s structural fields and the tracer's spans are
  ``tests/test_torch_device_pipeline_measure.py``);
* the stream engine's ``execute="devices"`` against ``execute=True``
  (port against port bit for bit; against the reference's at ``TOL``),
  ``transfer_bytes{edge,dtype}`` equal to the reference's with fp32
  links, and with int8 links — where the reference raises reading
  ``nbytes`` on the wire payload dict — equal to the plan's int8 cut
  bytes.
"""
from fractions import Fraction as F

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.graph import GraphError as RefGraphError  # noqa: E402
from repro.core.graph import plan_graph as ref_plan_graph  # noqa: E402
from repro.core.stage_partition import round_robin_placement as ref_rr  # noqa: E402
from repro.distributed import device_pipeline as ref_dp  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro.serving.cnn_stream import serve_frames as ref_serve_frames  # noqa: E402
from repro.serving.config import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.core.graph import GraphError, plan_graph  # noqa: E402
from repro_torch.core.stage_partition import round_robin_placement  # noqa: E402
from repro_torch.distributed.device_pipeline import (  # noqa: E402
    DevicePipeline,
    DevicePipelineError,
    device_placement_rows,
)
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402
from repro_torch.serving import ServeConfig, ServingError  # noqa: E402

HW = (32, 32)
TOL = 1e-4
# The two frameworks' activations differ by about 1e-6 of their scale,
# so a value on a rounding edge of an int8 link lands one step (amax/127)
# apart; the sharp check of int8 links is port against port, bit for bit
# (tests/test_torch_staged.py states the same tolerance for the reason).
INT8_LINK_TOL = 2e-2
CPU = torch.device("cpu")

_SETUPS = {}


def _setup(family="resnet18"):
    """Both sides at 32x32, 10 classes, on the port's weights (carried to
    the reference as numpy arrays) and 4 numpy frames."""
    if family not in _SETUPS:
        ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
        rc = ra.make_config(input_hw=HW, num_classes=10)
        pc = pa.make_config(input_hw=HW, num_classes=10)
        pp = pa.init(pc, torch.Generator().manual_seed(0))
        rp = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()}
              for n, p in pp.items()}
        x = np.random.default_rng(1).standard_normal((4, *HW, 3)).astype(np.float32)
        _SETUPS[family] = (ra, rc, rp, pa, pc, pp, x)
    return _SETUPS[family]


def _within(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= tol * scale


# ---------------------------------------------------------------------------
# placement resolution
# ---------------------------------------------------------------------------


def test_round_robin_placement_math():
    for s, n in ((4, 2), (2, 4), (1, 1), (3, 3), (5, 2)):
        assert round_robin_placement(s, n) == ref_rr(s, n)
    assert round_robin_placement(4, 2) == (0, 1, 0, 1)
    assert round_robin_placement(2, 4) == (0, 1)
    for bad in ((0, 2), (2, 0)):
        with pytest.raises(ValueError):
            round_robin_placement(*bad)
        with pytest.raises(ValueError):
            ref_rr(*bad)


def test_plan_graph_records_placement():
    ra, rc, _, pa, pc, _, _ = _setup()
    plan = plan_graph(pa.graph(pc), F(1), n_stages=3, n_devices=2)
    ref = ref_plan_graph(ra.graph(rc), F(1), n_stages=3, n_devices=2)
    assert plan.stage_plan.placement == ref.stage_plan.placement == (0, 1, 0)
    with pytest.raises(GraphError):
        plan_graph(pa.graph(pc), F(1), n_devices=2)
    with pytest.raises(RefGraphError):
        ref_plan_graph(ra.graph(rc), F(1), n_devices=2)


def _outcome(fn):
    try:
        return fn()
    except (ValueError, RuntimeError) as e:  # GraphExecutionError
        return (type(e).__name__, str(e))


FORMS = [None, False, True, 1, 2, 3, 5, (0, 1, 2), (2,), [1, 0], (7, 3), 0, ()]


@pytest.mark.parametrize("n_cards", [None, 4], ids=["cpu-pool", "four-card-pool"])
def test_resolve_stage_devices_forms(monkeypatch, n_cards):
    """Every form on both sides, as device ordinals: on the CPU's pool of
    one, and on a pool of four cards (``torch.cuda`` and ``jax.devices``
    told so; resolving touches no card)."""
    _, _, _, pa, pc, _, _ = _setup()
    recorded = plan_graph(pa.graph(pc), F(1), n_stages=3, n_devices=2).stage_plan
    if n_cards is None:
        home = "cpu"
    else:
        home = None
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
        fakes = [object() for _ in range(n_cards)]
        monkeypatch.setattr(jax, "devices", lambda *a: list(fakes))
    ref_devs = jax.devices()

    def port(form, n_stages, part):
        devs = cnn.resolve_stage_devices(form, n_stages, part, device=home)
        return None if devs is None else tuple(
            0 if d.index is None else d.index for d in devs)

    def ref(form, n_stages, part):
        devs = ref_cnn.resolve_stage_devices(form, n_stages, part)
        return None if devs is None else tuple(ref_devs.index(d) for d in devs)

    for form in FORMS:
        for n_stages in (1, 3, 4):
            for part in (None, recorded):
                if part is recorded and n_stages != 3:
                    continue
                assert _outcome(lambda: port(form, n_stages, part)) == \
                    _outcome(lambda: ref(form, n_stages, part)), (form, n_stages)
    # explicit devices, round robin
    devs = ("cpu",) if n_cards is None else ("cuda:3", "cuda:1")
    got = cnn.resolve_stage_devices(devs, 3, device=home)
    assert got == tuple(torch.device(devs[s % len(devs)]) for s in range(3))


def test_resolve_stage_devices_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for home in (None, "cuda", "cuda:0"):
        with pytest.raises(cnn.GraphExecutionError, match="needs CUDA"):
            cnn.resolve_stage_devices(True, 2, device=home)
    assert cnn.resolve_stage_devices(True, 2, device="cpu") == (CPU, CPU)


def test_device_pipeline_requires_placement():
    _, _, _, pa, pc, pp, _ = _setup()
    plan = pa.partition(pc, F(1), 2)
    pipe = cnn.stage_functions(pa.graph(pc), partition=plan)
    with pytest.raises(DevicePipelineError):
        DevicePipeline(pipe, pp, placement=None)
    # an unplaced pipeline is placed in place, on the params' device
    dp = DevicePipeline(pipe, pp)
    assert pipe.devices == (CPU, CPU) and pipe.streams is None
    assert dp.placement_ordinals() == (0, 0) and dp.n_devices() == 1


@pytest.mark.parametrize("n_stages,n_devices", [(3, 2), (4, 2), (2, 4), (1, 1), (5, 3)])
def test_device_placement_rows_structural(n_stages, n_devices):
    assert device_placement_rows(n_stages, n_devices) == \
        ref_dp.device_placement_rows(n_stages, n_devices)
    assert device_placement_rows(3, 2) == [("stage0_dev", 0), ("stage1_dev", 1),
                                           ("stage2_dev", 0)]


# ---------------------------------------------------------------------------
# schedule correctness (the one-device pool: stages co-resident)
# ---------------------------------------------------------------------------


def _ref_pipeline(ra, rc, rp, plan, **kw):
    return ref_dp.DevicePipeline.build(ra.graph(rc), rp, partition=plan,
                                       placement=True, jit=False, **kw)


@pytest.mark.parametrize("n_stages", [1, 2, 3])
def test_gpipe_matches_reference_and_staged_forward(n_stages):
    """GPipe at M = 4, 2, 1 (micro-batch 1, 2, 4): within TOL of the
    reference's DevicePipeline on the same weights and frames, and bit for
    bit the port's ``apply_staged`` on each micro-batch."""
    ra, rc, rp, pa, pc, pp, x = _setup()
    rplan, plan = ra.partition(rc, F(1), n_stages), pa.partition(pc, F(1), n_stages)
    rdp = _ref_pipeline(ra, rc, rp, rplan)
    dp = DevicePipeline.build(pa.graph(pc), pp, partition=plan, placement=True)
    assert dp.n_stages == n_stages and dp.placement_ordinals() == (0,) * n_stages
    xt = torch.from_numpy(x)
    for mb in (1, 2, 4):
        out = dp.run(x, microbatch=mb)
        _within(out, rdp.run(x, microbatch=mb), TOL)
        want = torch.cat([pa.apply_staged(pp, xt[i:i + mb], pc, partition=plan)
                          for i in range(0, len(x), mb)])
        assert torch.equal(out, want)


@pytest.mark.parametrize("family", ["resnet18", "mobilenet_v2"])
def test_gpipe_int8_links_match_reference(family):
    ra, rc, rp, pa, pc, pp, x = _setup(family)
    rplan = ra.partition(rc, F(1), 3, link_dtype="int8")
    plan = pa.partition(pc, F(1), 3, link_dtype="int8")
    rdp = _ref_pipeline(ra, rc, rp, rplan, link_quant=True)
    dp = DevicePipeline.build(pa.graph(pc), pp, partition=plan, link_quant=True)
    xt = torch.from_numpy(x)
    for mb in (1, 2, 4):
        out = dp.run(x, microbatch=mb)
        _within(out, rdp.run(x, microbatch=mb), INT8_LINK_TOL)
        want = torch.cat([pa.apply_staged(pp, xt[i:i + mb], pc, partition=plan,
                                          link_quant=True)
                          for i in range(0, len(x), mb)])
        assert torch.equal(out, want)


def test_single_stage_degenerate():
    ra, rc, rp, pa, pc, pp, x = _setup()
    plan = pa.partition(pc, F(1), 1)
    dp = DevicePipeline.build(pa.graph(pc), pp, partition=plan, placement=True)
    out = dp.run(x, microbatch=2)
    _within(out, ra.apply(rp, jnp.asarray(x), rc), TOL)
    xt = torch.from_numpy(x)
    assert torch.equal(out, torch.cat([pa.apply(pp, xt[:2], pc),
                                       pa.apply(pp, xt[2:], pc)]))


def test_repeated_runs_and_donation_safety():
    """Boundary entries dropped after their last consumer never leave a
    stage reading a freed tensor: the same pipeline re-runs on identical
    inputs bit for bit and on fresh ones."""
    _, _, _, pa, pc, pp, x = _setup()
    plan = pa.partition(pc, F(1), 2)
    dp = DevicePipeline.build(pa.graph(pc), pp, partition=plan, placement=True)
    a = dp.run(x, microbatch=2)
    b = dp.run(x, microbatch=2)
    assert torch.equal(a, b)
    c = dp.run(np.ascontiguousarray(x[::-1]), microbatch=2)
    np.testing.assert_allclose(c.numpy(), a.numpy()[::-1], atol=1e-5, rtol=1e-5)
    assert dp.pipeline._ready == {}


# ---------------------------------------------------------------------------
# the stream engine: execute="devices"
# ---------------------------------------------------------------------------


def _transfers(metrics):
    return {k: v for k, v in metrics.snapshot().items() if k.startswith("transfer_bytes")}


def test_serve_execute_devices_matches_host():
    """Port against port bit for bit, against the reference's served
    outputs within TOL; with tracing on, transfer_bytes{edge,dtype} equals
    the reference's (fp32 links)."""
    ra, rc, rp, pa, pc, pp, x = _setup()
    host, _ = pa.serve(pp, x, pc, input_rate=F(1), n_stages=2,
                       config=ServeConfig(execute=True, microbatch=2))
    placed, rep = pa.serve(pp, x, pc, input_rate=F(1), n_stages=2,
                           config=ServeConfig(execute="devices", microbatch=2,
                                              trace=True))
    assert torch.equal(placed, host) and rep.completed == 4
    ref, ref_rep = ref_serve_frames(
        ra.graph(rc), rp, x, input_rate=F(1), n_stages=2,
        config=RefServeConfig(execute="devices", microbatch=2, jit=False, trace=True))
    _within(placed, ref, TOL)
    got, want = _transfers(rep.metrics), _transfers(ref_rep.metrics)
    assert got == want and got


def _edge_bytes(graph, plan, batch, link):
    """Bytes a micro-batch moves on each placed cut edge u->s{stage}: one
    payload per (producer, consuming stage); an int8 payload is one int8 a
    feature plus its 4-byte scale."""
    stage_of = plan.stage_plan.stage_index()
    out = {}
    for v in graph.topo_order():
        for u in graph.preds(v):
            if stage_of[u] != stage_of[v]:
                spec = graph.spec(u)
                feats = batch * spec.out_hw[0] * spec.out_hw[1] * spec.d_out
                out[(u, stage_of[v])] = feats + 4 if link == "int8" else 4 * feats
    return out


@pytest.mark.parametrize("link", [None, "int8"])
@pytest.mark.parametrize("family", ["resnet18", "mobilenet_v2"])
def test_transfer_bytes_equal_the_plans_cut_bytes(family, link):
    """Each placed crossing's count equals the plan's cut bytes x
    micro-batches.  With int8 links the reference's prefetch reads
    ``nbytes`` on the wire payload dict and raises (ROADMAP Queue 3); the
    port counts the payload's int8 tensor and its scale."""
    _, _, _, pa, pc, pp, x = _setup(family)
    dse = {"link_dtype": "int8"} if link else {}
    gp = pa.partition(pc, F(1), 3, **dse)
    _, rep = pa.serve(pp, x, pc, input_rate=F(1), n_stages=3,
                      config=ServeConfig(execute="devices", microbatch=2,
                                         link_quant=True if link else None,
                                         trace=True), **dse)
    want = {f"transfer_bytes{{dtype={'int8' if link else 'float32'},edge={u}->s{s}}}":
            2 * b for (u, s), b in _edge_bytes(pa.graph(pc), gp, 2, link).items()}
    assert _transfers(rep.metrics) == want


def test_serve_rejects_unknown_execute():
    _, _, _, pa, pc, pp, x = _setup()
    with pytest.raises(ServingError, match="expected True, False"):
        pa.serve(pp, x, pc, input_rate=F(1), n_stages=2,
                 config=ServeConfig(execute="device"))
