"""Staged (multi-stage) execution in the port, against the JAX package's.

(The planners are ``tests/test_torch_staged_plan.py``, the bf16 forward's
staged run ``tests/test_torch_staged_bf16.py``.)

* ``apply_staged`` against the reference's plain (lax) staged path at
  32x32, 10 classes, on the same numpy weights and frames: fp32 links at
  1e-4 of the logits' scale; int8 links at 2e-2 of it (see
  ``INT8_LINK_TOL``).
* Port against port, bit for bit (the reference's own claims): staged
  equals monolithic with fp32 links, and with int8 and bf16 links against
  the monolithic fake-quant; fp32 links are a no-op.
"""
import dataclasses
from fractions import Fraction as F

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import graph as ref_graph  # noqa: E402
from repro.core import replicate as ref_replicate  # noqa: E402
from repro.models import cnn as ref_cnn  # noqa: E402
from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro_torch.core import graph, replicate  # noqa: E402
from repro_torch.models import cnn, mobilenet, resnet  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402

FAMILIES = ("mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34")
HW = (32, 32)
TOL = 1e-4
# The two frameworks' activations differ by about 1e-6 of their scale
# (other summation orders), so a value on a rounding edge of the int8
# link lands one step apart: one step is amax/127, about 0.8 % of the
# cut's scale, and a few such flips move the logits by a like share.
# The sharp check of int8 links is port against port, bit for bit.
INT8_LINK_TOL = 2e-2


def plain(obj):
    """Builtins for a field-by-field comparison of port and reference
    objects (dataclasses as (class name, fields), Fractions kept)."""
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


# --------------------------------------------------------------------------
# staged execution against the reference's plain staged path
# --------------------------------------------------------------------------


def _setup(family, seed=0, batch=2):
    """Both sides at 32x32, 10 classes, on the port's weights (carried to
    the reference as numpy arrays) and the same numpy frames."""
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc = ra.make_config(input_hw=HW, num_classes=10)
    pc = pa.make_config(input_hw=HW, num_classes=10)
    pp = pa.init(pc, torch.Generator().manual_seed(seed))
    rp = {n: {k: jnp.asarray(v.numpy()) for k, v in p.items()} for n, p in pp.items()}
    x = np.random.default_rng(seed).standard_normal((batch, *HW, 3)).astype(np.float32)
    return ra, rc, rp, pa, pc, pp, x


def _within(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.numpy() - want).max() <= tol * scale


@pytest.mark.parametrize("family,n_stages,link", [
    ("mobilenet_v1", 2, "int8"), ("mobilenet_v2", 3, None),
    ("resnet18", 3, "int8"), ("resnet34", 2, None)])
def test_apply_staged_matches_reference(family, n_stages, link):
    ra, rc, rp, pa, pc, pp, x = _setup(family, seed=1)
    want = ra.apply_staged(rp, jnp.asarray(x), rc,
                           partition=ra.partition(rc, F(3), n_stages), link_quant=link)
    gp = pa.partition(pc, F(3), n_stages)
    executed = {}
    got = pa.apply_staged(pp, torch.from_numpy(x), pc, partition=gp,
                          plan=gp.kernel_plan(batch=2), link_quant=link,
                          executed=executed)
    assert sorted(executed) == sorted(n for n, ip in gp.kernel_plan().items()
                                      if ip.has_kernel)
    _within(got, want, INT8_LINK_TOL if link else TOL)
    if link is None:  # the same network, stage by stage
        _within(got, ra.apply(rp, jnp.asarray(x), rc), TOL)


def test_replicated_plan_matches_unreplicated_and_reference():
    """ResNet-18 at S=3 with the replication the DSE picks: lanes see part
    of the batch, so the port holds its logits at 1e-4 of the
    unreplicated forward's scale (not bit for bit), and against the
    reference's replicated staged run."""
    ra, rc, rp, pa, pc, pp, x = _setup("resnet18", seed=2, batch=3)
    g = pa.graph(pc)
    gp = graph.plan_graph(g, F(3), n_stages=3, replicate={"l3b1_conv2": 2})
    assert plain(gp.replications) == plain(
        ref_graph.plan_graph(ra.graph(rc), F(3), n_stages=3,
                             replicate={"l3b1_conv2": 2}).replications)
    rparams = replicate.replicate_params(pp, gp.replications)
    xt = torch.from_numpy(x)
    got = pa.apply_staged(rparams, xt, pc, graph=gp.graph, partition=gp,
                          plan=gp.kernel_plan(batch=3))
    _within(got, pa.apply(pp, xt, pc).numpy(), TOL)
    rgp = ref_graph.plan_graph(ra.graph(rc), F(3), n_stages=3, replicate={"l3b1_conv2": 2})
    want = ref_cnn.apply_staged(ref_replicate.replicate_params(rp, rgp.replications),
                                jnp.asarray(x), rgp.graph, partition=rgp)
    _within(got, want, TOL)


# --------------------------------------------------------------------------
# port against port: the reference's bit-exact claims
# --------------------------------------------------------------------------

_PORT = {}


def _port(family, dtype=torch.float32):
    key = (family, dtype)
    if key not in _PORT:
        pa = get_cnn_api(family, device="cpu")
        pc = pa.make_config(input_hw=HW, num_classes=10, dtype=dtype)
        params = pa.init(pc, torch.Generator().manual_seed(3))
        x = torch.randn((3, *HW, 3), generator=torch.Generator().manual_seed(4))
        _PORT[key] = (pa, pc, params, x)
    return _PORT[key]


@pytest.mark.parametrize("link", [None, "int8", "bf16"])
@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("family", FAMILIES)
def test_staged_equals_monolithic_bit_for_bit(family, n_stages, link):
    pa, pc, params, x = _port(family)
    g = pa.graph(pc)
    gp = pa.partition(pc, F(3), n_stages)
    kp = gp.kernel_plan(batch=3)
    staged = pa.apply_staged(params, x, pc, partition=gp, plan=kp, link_quant=link,
                             check_monolithic=True)
    emap = cnn.cut_edge_dtypes(g, gp, link) if link else None
    assert bool(emap) == bool(link)
    mono = cnn.apply_graph(params, x, g, plan=kp, link_quant=emap)
    assert torch.equal(staged, mono)
    if link is not None:  # the wire narrowing is real
        assert not torch.equal(staged, pa.apply(params, x, pc, plan=kp))


@pytest.mark.parametrize("family", FAMILIES)
def test_fp32_links_are_a_no_op(family):
    pa, pc, params, x = _port(family)
    for n_stages in (2, 3):
        gp = pa.partition(pc, F(3), n_stages)
        assert cnn.cut_edge_dtypes(pa.graph(pc), gp, "fp32") == {}
        a = pa.apply_staged(params, x, pc, partition=gp, link_quant="fp32")
        b = pa.apply_staged(params, x, pc, partition=gp)
        assert torch.equal(a, b) and torch.equal(a, pa.apply(params, x, pc))


def test_link_quant_true_reads_the_plans_dtype():
    pa, pc, params, x = _port("resnet18")
    for link in ("int8", "bf16"):
        gp = pa.partition(pc, F(3), 3, link_dtype=link)
        a = pa.apply_staged(params, x, pc, partition=gp, link_quant=True)
        b = pa.apply_staged(params, x, pc, partition=gp, link_quant=link)
        assert torch.equal(a, b)


def test_stage_pipeline_wiring():
    """Imports, exports, the payloads on the wire, ``keep_after`` and
    ``decode_boundary`` of a three-stage ResNet-18 pipeline."""
    pa, pc, params, x = _port("resnet18")
    g = pa.graph(pc)
    gp = pa.partition(pc, F(3), 3)
    pipe = cnn.stage_functions(g, partition=gp, link_quant="int8")
    assert pipe.n_stages == 3
    assert pipe.imports[0] == set()
    assert pipe.out_name in pipe.exports[2]
    boundary = {}
    for s in range(3):
        pipe.run_stage(s, params, boundary, x if s == 0 else None)
        assert set(pipe.stage_params(s, params)) == {
            n for n in gp.stage_plan.stage_nodes(s) if n in params}
    wire = {u for u, _ in pipe.link_quant_edges}
    assert wire and all(set(boundary[u]) == {"__q__", "__s__"} for u in wire)
    assert all(boundary[u]["__q__"].dtype == torch.int8 for u in wire)
    keep = pipe.keep_after()
    assert keep[2] == {pipe.out_name}
    assert keep[1] == {pipe.out_name} | pipe.imports[2]
    assert keep[0] == keep[1] | pipe.imports[1]
    decoded = pipe.decode_boundary(boundary)
    assert all(decoded[u].dtype == torch.float32 for u in wire)
    forward = cnn.staged_forward(g, partition=gp, link_quant="int8")
    out = forward(params, x)
    assert torch.equal(out[pipe.out_name], decoded[pipe.out_name])


def test_stage_functions_build_a_fresh_pipeline_each_call():
    """Nothing memoizes a pipeline: each build is its own, and one built
    with an ``executed`` out-param fills it when it runs."""
    pa, pc, params, x = _port("mobilenet_v1")
    g = pa.graph(pc)
    gp = pa.partition(pc, F(3), 2)
    kp = gp.kernel_plan(batch=x.shape[0])
    a = cnn.stage_functions(g, partition=gp, plan=kp)
    executed = {}
    b = cnn.stage_functions(g, partition=gp, plan=kp, executed=executed)
    assert a is not b and a.stage_fns is not b.stage_fns
    outs = []
    for pipe in (a, b):
        boundary = {}
        for s in range(pipe.n_stages):
            pipe.run_stage(s, params, boundary, x if s == 0 else None)
        outs.append(boundary[pipe.out_name])
    assert torch.equal(outs[0], outs[1])
    assert sorted(executed) == sorted(n for n, ip in kp.items() if ip.has_kernel)


def test_registry_memoizes_graphs_and_plans():
    pa, pc, params, x = _port("mobilenet_v1")
    assert pa.partition(pc, F(3), 2) is pa.partition(pc, F(3), 2)
    assert pa.partition(pc, F(3), 2) is not pa.partition(pc, F(3), 3)
    assert pa.graph(pc) is pa.graph(pc)
    assert sorted(pa.caches) == ["graphs", "plans"]
    gp = pa.partition(pc, F(3), 2)
    y = pa.apply_staged(params, x, pc, partition=gp)
    assert torch.equal(y, pa.apply_staged(params, x, pc, partition=gp))


def test_staged_rejects_bad_partitions_and_later_slices(monkeypatch):
    pa, pc, params, x = _port("resnet18")
    g = pa.graph(pc)
    with pytest.raises(cnn.GraphExecutionError, match="no stage partition"):
        cnn.apply_staged(params, x, g, partition=pa.partition(pc, F(3), None))
    other = get_cnn_api("resnet34", device="cpu")
    oc = other.make_config(input_hw=HW, num_classes=10)
    with pytest.raises(cnn.GraphExecutionError, match="does not cover"):
        cnn.apply_staged(params, x, g, partition=other.partition(oc, F(3), 2))
    gp = pa.partition(pc, F(3), 3)
    producer = next(u for u, _ in cnn.cut_edge_dtypes(g, gp, "int8"))
    edges = [(u, v) for (u, v) in cnn.cut_edge_dtypes(g, gp, "int8") if u == producer]
    if len(edges) > 1:
        with pytest.raises(cnn.GraphExecutionError, match="conflicting link dtypes"):
            cnn.stage_functions(g, partition=gp, link_quant={edges[0]: "int8",
                                                              edges[1]: "bf16"})
    # stages on devices of their own: on the CPU every form places all
    # stages on its one-device pool, and the result is the unplaced one
    unplaced = pa.apply_staged(params, x, pc, partition=gp)
    for placement in (True, 2, [0, 1], ["cpu"]):
        assert torch.equal(
            pa.apply_staged(params, x, pc, partition=gp, placement=placement),
            unplaced)
    pipe = cnn.stage_functions(g, partition=gp, placement=False)
    pipe.prefetch(1, {})  # unplaced: nothing to move
    # the transfer hook is stored; an unplaced pipeline never calls it
    calls = []
    pipe.observe(lambda **kw: calls.append(kw))
    pipe.run_stage(0, params, {}, x)
    assert calls == []
    pipe.observe(None)
    assert pipe._observer is None
    assert cnn.resolve_stage_devices(None, 3) is None
    # a placement on the card, where there is none, raises: nothing falls
    # back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(cnn.GraphExecutionError, match="needs CUDA"):
        cnn.stage_functions(g, partition=gp, placement=True)


def test_family_wrappers_run_staged_and_int8():
    for mod, family in ((resnet, "resnet18"), (mobilenet, "mobilenet_v2")):
        pa, pc, params, x = _port(family)
        gp = pa.partition(pc, F(3), 2)
        y = mod.apply_staged(params, x, pc, partition=gp, check_monolithic=True)
        assert torch.equal(y, mod.apply(params, x, pc))
        q, s = mod.quantize_params(params)
        assert torch.equal(mod.apply_int8(q, s, x, pc, partition=gp),
                           mod.apply_int8(q, s, x, pc))
