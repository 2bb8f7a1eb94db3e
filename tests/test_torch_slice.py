"""The port's rate-matched forward pass against the JAX package's.

The reference's parameters cross over as numpy arrays
(``params_from_reference``); the same numpy frames go through both
sides at 32x32, batch 2, on the CPU.  The reference's planned path runs
its Pallas kernels in interpret mode; the port's runs its kernels' plain
versions (the CPU dispatch of each wrapper), with the executor's
executed-tile == plan assertion live on every arithmetic node.  fp32 is
held at 1e-4 of the logits' scale: sums run in different orders.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.models.registry import get_cnn_api as ref_api  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402

TOL = 1e-4
HW = (32, 32)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(want).max()))


def _pair(family, seed=0):
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc, pc = ra.make_config(input_hw=HW), pa.make_config(input_hw=HW)
    rp = ra.init(rc, jax.random.key(seed))
    pp = cnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    x = np.random.default_rng(seed).standard_normal((2, *HW, 3)).astype(np.float32)
    return ra, rc, rp, pa, pc, pp, x


@pytest.mark.parametrize("family", ["resnet18", "mobilenet_v2"])
def test_rate_matched_matches_reference_kernels(family):
    ra, rc, rp, pa, pc, pp, x = _pair(family)
    want = ra.apply(rp, jax.numpy.asarray(x), rc, plan=ra.plan(rc, Fraction(3)))
    kp = pa.plan(pc, Fraction(3))
    executed = {}
    got = pa.apply(pp, torch.from_numpy(x), pc, plan=kp, executed=executed)
    _close(got.numpy(), want)
    arith = [n for n, ip in kp.items() if ip.has_kernel]
    assert sorted(executed) == sorted(arith)
    for n in arith:
        t, e = kp[n].tile, executed[n]
        assert (e["bk"], e["bn"]) == (t.bk, t.bn), n
        if kp[n].kind in ("conv", "dwconv"):
            assert e["bm"] == t.bm, n


BF16_TOL = 3e-2


@pytest.mark.parametrize("family,seed", [("mobilenet_v2", 1), ("resnet18", 2)])
def test_bf16_forward_matches_reference_kernels(family, seed):
    """The rate-matched forward pass in bf16 against the reference's, on the
    same bf16 parameters, at 3e-2 of the logits' scale (the JAX KPU and
    depthwise kernel tests' bf16 tolerance): every node's output is
    rounded to bf16 on both sides from sums taken in another order.  The
    reference's ``init`` at ``dtype=bfloat16`` keeps its weights in f32
    (a numpy scalar promotes them), so its arrays are rounded to bf16 first
    and both sides run those."""
    bf16 = jax.numpy.bfloat16
    ra, pa = ref_api(family), get_cnn_api(family, device="cpu")
    rc = ra.make_config(input_hw=HW, dtype=bf16)
    pc = pa.make_config(input_hw=HW, dtype=torch.bfloat16)
    rp = jax.tree_util.tree_map(lambda v: v.astype(bf16), ra.init(rc, jax.random.key(seed)))
    pp = cnn.params_from_reference(jax.tree_util.tree_map(np.asarray, rp), "cpu",
                                   dtype=torch.bfloat16)
    x = np.random.default_rng(seed).standard_normal((2, *HW, 3)).astype(np.float32)
    want = ra.apply(rp, jax.numpy.asarray(x), rc, plan=ra.plan(rc, Fraction(3)))
    executed = {}
    got = pa.apply(pp, torch.from_numpy(x), pc, plan=pa.plan(pc, Fraction(3)),
                   executed=executed)
    assert want.dtype == bf16 and got.dtype == torch.bfloat16
    assert sorted(executed) == sorted(n for n, ip in pa.plan(pc, Fraction(3)).items()
                                      if ip.has_kernel)
    want = np.asarray(want, np.float32)
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got.float().numpy() - want).max() <= BF16_TOL * scale


@pytest.mark.parametrize(
    "family", ["mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34"])
def test_plain_path_matches_reference_lax(family):
    ra, rc, rp, pa, pc, pp, x = _pair(family, seed=1)
    want = ra.apply(rp, jax.numpy.asarray(x), rc)
    got = pa.apply(pp, torch.from_numpy(x), pc)
    assert tuple(got.shape) == (2, 1000)
    _close(got.numpy(), want)


def test_tampered_plan_raises():
    pa = get_cnn_api("resnet18", device="cpu")
    cfg = pa.make_config(input_hw=HW)
    graph = pa.graph(cfg)
    params = pa.init(cfg, torch.Generator().manual_seed(0))
    kp = pa.plan(cfg, Fraction(3))
    tampered = dict(kp)
    t = kp["l1b1_conv1"].tile
    tampered["l1b1_conv1"] = dataclasses.replace(
        kp["l1b1_conv1"], tile=dataclasses.replace(t, bk=t.bk // 2))
    executed = {}
    real = cnn.kernel_impls(plan=kp, executed=executed)
    x = torch.zeros((1, *HW, 3))
    with pytest.raises(cnn.GraphExecutionError, match="l1b1_conv1"):
        cnn.apply_graph(params, x, graph, impls=real, plan=tampered,
                        executed=executed)
    missing = dict(kp)
    del missing["fc"]
    with pytest.raises(cnn.GraphExecutionError, match="missing from the kernel plan"):
        cnn.apply_graph(params, x, graph, plan=missing)
    with pytest.raises(cnn.GraphExecutionError, match="unknown nodes"):
        cnn.apply_graph(params, x, graph, overrides={"nope": cnn.kpu_conv_plain})


@pytest.mark.parametrize("hw,k,s", [(8, 3, 2), (112, 3, 2), (9, 3, 2), (8, 2, 1)])
def test_same_max_pool_matches_reduce_window(hw, k, s):
    """SAME max-pool pads asymmetrically with -inf: (0, 1) at an even
    size with a 3x3/s2 window, where a symmetric torch pool would not."""
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((2, hw, hw, 4)).astype(np.float32) - 3.0
    want = jax.lax.reduce_window(
        jax.numpy.asarray(x), -jax.numpy.inf, jax.lax.max,
        window_dimensions=(1, k, k, 1), window_strides=(1, s, s, 1),
        padding="SAME")
    got = cnn._max_pool_same(torch.from_numpy(x), (k, k), (s, s))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_graph_params_from_generator():
    pa = get_cnn_api("mobilenet_v2", device="cpu")
    cfg = pa.make_config(input_hw=HW)
    a = pa.init(cfg, torch.Generator().manual_seed(3))
    b = pa.init(cfg, torch.Generator().manual_seed(3))
    assert sorted(a) == sorted(n for n in pa.graph(cfg).topo_order()
                               if pa.graph(cfg).spec(n).kind in cnn.ARITH_KINDS)
    assert all(torch.equal(a[n]["w"], b[n]["w"]) for n in a)
    assert tuple(a["b2_dw"]["w"].shape) == (3, 3, 1, 96)
    std = a["b2_expand"]["w"].std().item()
    assert abs(std - np.sqrt(2.0 / 16)) < 0.1


def test_unported_entry_points_raise():
    """What later slices port raises with its ROADMAP name: stages on
    devices of their own (``placement=``, and the stream engine's
    ``execute="devices"``).  The stream engine (``serve``) and the
    cut-transfer hook (``StagePipeline.observe``, which an unplaced
    pipeline never calls) are ported."""
    from repro_torch.serving import ServeConfig

    pa = get_cnn_api("resnet18", device="cpu")
    cfg = pa.make_config(input_hw=HW)
    params = pa.init(cfg, torch.Generator().manual_seed(0))
    gp = pa.partition(cfg, Fraction(3), 2)
    x = torch.zeros((1, *HW, 3))
    with pytest.raises(NotImplementedError, match=r"ROADMAP: Device pipeline"):
        pa.apply_staged(params, x, cfg, partition=gp, placement=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP: Device pipeline"):
        pa.serve(params, x, cfg, input_rate=Fraction(3), n_stages=2,
                 config=ServeConfig(execute="devices"))
    pipe = cnn.stage_functions(pa.graph(cfg), partition=gp)
    pipe.observe(print)
    assert pipe._observer is print
