"""The port's dry run (``launch/dryrun.py``, ``core/hlo_analysis.py``, the
abstract specs) on the CPU, in this process.

* The four abstract spec functions of ``models/registry.py`` against the
  JAX package's ``ShapeDtypeStruct``s (its serve states through
  ``jax.eval_shape``): the same shapes and dtypes, nothing allocated.
* ``roofline_terms`` on ``HopperSpec``: the reference's formula test
  (``tests/core/test_tpu_mapping.py::test_roofline_terms_math``) restated
  on the H100's numbers, and the collective term by the axis's link.
* ``StepCounter`` on a hand-computed sharded product over a fake (2, 2)
  world: FLOPs of each rank's own product, the gathers' bytes by axis, the
  peak of live bytes.
* The flash and SSD wrappers on fake CUDA tensors reach their custom ops:
  output shapes, the kernels' own FLOP formulas, no launch.
* ``run_cell`` on fake worlds: a reduced qwen2 and mamba2 on (4, 2), train
  and serve; reduced grok-1 and internvl2-2b prefill and decode from int8
  weights on (4, 2); qwen2 at ``grad_accum`` 1 and 2 (the same FLOPs a
  rank); reduced grok-1 at ``grad_accum`` 4 on 2 x 16 x 16 (16 rows a
  microbatch for 32 data ranks); the five dense / SSM archs', the two MoE archs' and the vlm's
  train steps at (16, 16).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard, distribute_tensor  # noqa: E402

from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.shapes import SHAPES as REF_SHAPES  # noqa: E402
from repro.models import registry as ref_models  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSuite, cell_enabled  # noqa: E402
from repro_torch.core.hlo_analysis import (CollectiveStats, StepCounter,  # noqa: E402
                                           roofline_terms)
from repro_torch.core.hw import H100_SXM  # noqa: E402
from repro_torch.distributed.sharding import rows_matmul  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

SPEC_FNS = ("train_batch_specs", "prefill_batch_specs", "decode_batch_specs")


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _entries(tree) -> list:
    return sorted((tuple(x.shape), _dtype(x.dtype)) for x in tree)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_specs_are_the_references(arch):
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    for name, shape in SHAPES.items():
        for fn in SPEC_FNS:
            got = getattr(models, fn)(cfg, shape)
            want = getattr(ref_models, fn)(ref_cfg, REF_SHAPES[name])
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert _dtype(got[k].dtype) == str(want[k].dtype)
                assert got[k].device.type == "meta"
        if not cell_enabled(cfg, shape) or shape.kind == "train":
            continue
        state = leaves(models.serve_state_specs(cfg, shape))
        ref_state = jax.tree_util.tree_leaves(
            ref_models.serve_state_specs(ref_cfg, REF_SHAPES[name]))
        assert _entries(state) == _entries(ref_state)
        assert {t.device.type for t in state} == {"meta"}


def test_roofline_terms_on_the_h100():
    """The reference's formula test on the H100's peaks: per-rank FLOPs and
    bytes that take one second each, MODEL_FLOPS half the work."""
    spec = H100_SXM
    t = roofline_terms(spec.peak_bf16_flops, spec.hbm_bw, None, chips=256,
                       model_flops=spec.peak_bf16_flops * 128)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.dominant in ("compute", "memory")
    assert t.roofline_fraction == pytest.approx(0.5, rel=0.01)
    assert t.useful_flops_ratio == pytest.approx(0.5, rel=0.01)
    # one axis inside a node at NVLink's 450 GB/s, one across nodes at the NIC's 50
    coll = CollectiveStats({"all-gather": 0}, {"all-gather": 2},
                           {"model": 225e9, "data": 25e9}, {"model": 1, "data": 1},
                           {"model": False, "data": True})
    t = roofline_terms(0.0, 0.0, coll, chips=256)
    assert t.collective_s == pytest.approx(1.0) and t.dominant == "collective"
    assert t.bound_s == pytest.approx(1.0)


def test_step_counter_on_a_sharded_product():
    """``rows_matmul`` of x [8, 16] (rows over 'data') by w [16, 12] (FSDP
    rows over 'data', columns over 'model') on a fake (2, 2) world: w is
    gathered over 'model' then 'data', and each rank multiplies its 4 rows."""
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(8, 16), mesh, [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(16, 12), mesh, [Shard(0), Shard(1)])
            counter = StepCounter(mesh)
            held = counter.hold(x, w)
            with counter:
                y = rows_matmul(x, w)
            assert tuple(y.to_local().shape) == (4, 12)
    assert held == 512 + 512                       # 4x16 and 8x6 f32, rounded to 512
    assert counter.flops == 2 * 4 * 16 * 12
    coll = counter.collectives
    assert coll.count_by_kind["all-gather"] == 2 and coll.total_count == 2
    # 'model' gathers w's 8 x 12 half-rows, 'data' the whole 16 x 12
    assert coll.bytes_by_axis == {"model": 8 * 12 * 4, "data": 16 * 12 * 4}
    assert coll.spans_nodes == {"model": False, "data": False}
    # x, w, the gathered halves and whole w, the product (each rounded)
    assert counter.peak_bytes >= held + 512 + 1024 + 512


def test_kernel_wrappers_trace_through_their_ops():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    launches = (flash_attention.launches, ssd_chunk.launches)
    with FakeTensorMode():
        q = torch.empty(2, 4, 64, 32, device="cuda", dtype=torch.bfloat16)
        k = torch.empty(2, 2, 96, 32, device="cuda", dtype=torch.bfloat16)
        x = torch.empty(2, 128, 4, 16, device="cuda")
        dt = torch.empty(2, 128, 4, device="cuda")
        a = torch.empty(4, device="cuda")
        b = torch.empty(2, 128, 1, 8, device="cuda")
        counter = StepCounter()
        with counter:
            o = flash_attention(q, k, k, causal=False, block_q=64, block_k=64)
            oc = flash_attention(q, q, q, block_q=64, block_k=64)
            y, state = ssd_chunk(x, dt, a, b, b, chunk=64)
    assert o.shape == oc.shape == q.shape and o.device.type == "cuda"
    assert y.shape == x.shape and tuple(state.shape) == (2, 4, 16, 8)
    assert state.dtype == torch.float32
    assert (flash_attention.launches, ssd_chunk.launches) == launches
    tokens = 2 * 128
    assert counter.flops_by_op == {
        "repro_torch.flash_attention": 4 * 2 * 4 * 64 * 96 * 32 + 4 * 2 * 4 * 64 * 64 * 32 // 2,
        "repro_torch.ssd_chunk": 2 * tokens * 64 * 4 * (8 + 16) + 4 * tokens * 4 * 16 * 8}
    # the SSD's workspace is live while the op runs
    work = 2 * 2 * 4 * (16 * 8 + 1) * 4
    assert counter.peak_bytes >= work + 2 * 128 * 4 * 16 * 4


def _small(arch, **kw):
    return reduced(get_config(arch), layers=2, d_model=64, vocab=256, **kw)


def _check_record(rec):
    assert rec["status"] == "ok" and rec["mesh"] == "4x2" and rec["chips"] == 8
    assert rec["flops"]["counted_per_rank"] > 0 and rec["flops"]["analytic_per_rank"] > 0
    assert rec["collectives"]["total_count"] > 0 and rec["collectives"]["total_bytes"] > 0
    assert set(rec["collectives"]["count_by_axis"]) <= {"data", "model"}
    assert rec["memory"]["peak_bytes"] > rec["memory"]["input_bytes"] > 0
    assert rec["memory"]["fits_hbm"]
    r = rec["roofline"]
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"], r["collective_s"]) > 0


@pytest.mark.parametrize("arch,kind", [("qwen2-7b", "prefill"), ("mamba2-780m", "train"),
                                       ("mamba2-780m", "decode")])
def test_run_cell_on_a_fake_4x2_mesh(arch, kind):
    shape = ShapeSuite(f"small_{kind}", 64, 8, kind)
    _check_record(dryrun.run_cell(arch, shape, cfg=_small(arch), mesh_shape=(4, 2),
                                  device="cpu"))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "internvl2-2b"])
def test_int8_serve_cells_trace_on_a_fake_4x2_mesh(arch, kind):
    """The ``serve_weight_quant`` configs' serve cells: int8 leaves
    sharded like their parents, dequantized shard by shard
    (``nn.quant.dequantize_tree``)."""
    cfg = _small(arch)
    assert cfg.serve_weight_quant
    shape = ShapeSuite(f"small_{kind}", 64, 8, kind)
    _check_record(dryrun.run_cell(arch, shape, cfg=cfg, mesh_shape=(4, 2), device="cpu"))


def test_microbatches_stay_on_the_batch_sharding():
    """``grad_accum`` 2 splits each rank's rows, so a rank counts the FLOPs
    of one whole-batch step; a microbatch replicated whole on every rank
    (DTensor's slice of a sharded dim) would count 4 times as many on 4
    data ranks."""
    shape = ShapeSuite("small_train", 64, 8, "train")
    recs = [dryrun.run_cell("qwen2-7b", shape, mesh_shape=(4, 2), device="cpu",
                            cfg=dataclasses.replace(_small("qwen2-7b"), grad_accum=n))
            for n in (1, 2)]
    for rec in recs:
        _check_record(rec)
    assert recs[0]["flops"]["counted_per_rank"] == recs[1]["flops"]["counted_per_rank"]


def test_microbatches_narrower_than_the_data_ranks_trace():
    """grad_accum 4 on 64 rows leaves 16 rows a microbatch for the 32 data
    ranks of the 2 x 16 x 16 mesh, as grok-1's train_4k does at
    grad_accum 16: each microbatch splits over 'data' and is whole on each
    'pod' (``optim.optimizers._rows_split``), where a split over all 32
    raised in the CE."""
    shape = ShapeSuite("small_train", 16, 64, "train")
    cfg = dataclasses.replace(reduced(get_config("grok-1-314b"), layers=1, d_model=64,
                                      vocab=256), grad_accum=4)
    rec = dryrun.run_cell("grok-1-314b", shape, cfg=cfg, multi_pod=True, device="cpu")
    assert rec["status"] == "ok" and rec["chips"] == 512, rec.get("error")


@pytest.mark.parametrize("arch", ["qwen2-7b", "deepseek-coder-33b", "starcoder2-15b",
                                  "gemma3-1b", "mamba2-780m", "grok-1-314b",
                                  "llama4-maverick-400b-a17b", "internvl2-2b"])
def test_train_steps_trace_on_a_fake_16x16_world(arch):
    """Reduced configs at 256 ranks: every head count is uneven on a
    'model' axis of 16, as the shipped configs' are; the MoE steps route
    each rank's rows on its local tensors (``nn.moe._moe_on_mesh``); the
    vlm's CE masks its patch positions (``models.vlm.loss_fn``)."""
    shape = ShapeSuite("small_train", 32, 16, "train")
    rec = dryrun.run_cell(arch, shape, cfg=_small(arch), mesh_shape=(16, 16), device="cpu")
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["flops"]["counted_per_rank"] > 0
    assert math.isfinite(rec["roofline"]["bound_s"])
