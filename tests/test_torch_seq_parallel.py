"""The sequence-parallel SSD scan and the ring pipeline on 2 and 4 gloo
ranks of the CPU, against the JAX package.

Each world size is one spawn (``torch_ranks.run_ranks``); the reference's
side runs here, in the test process, and the inputs reach the ranks
through a file in the directory they share.

* ``ssd_seq_parallel`` on the 'model' axis of a (1, 2) and a (1, 4) mesh
  (plain tensors: each rank scans its slice and all-gathers y), and on a
  (2, 2) mesh with DTensor operands (y stays sequence-sharded), against
  the JAX package's ``ssd_chunked_streaming`` over the whole sequence at
  1e-4 in f32 — its own claim for its ``ssd_seq_parallel``.  The
  reference's ``ssd_seq_parallel`` needs a mesh of several devices, which
  its tests do not have here.
* Under autograd the gradients of every operand are finite and equal the
  one-process ``ssd_chunked`` gradients at 1e-4 of their scale.
* Reduced mamba2-780m and zamba2-1.2b prefills inside a (1, 2) and a
  (2, 2) mesh take the sequence-parallel route in every layer; their
  logits and final SSM states equal the JAX package's one-device prefill
  at 1e-4 of scale.
* ``pipeline_forward`` at S = 2 and 4 stages (one a rank, an uneven
  plan padded with zero layers at S = 4) against the reference's
  ``pipeline_forward`` on its 1-stage mesh and its vmapped ``block_fn``,
  at rtol / atol 1e-5; ``stack_stage_params`` and
  ``plan_stages_for_layers`` against the reference's, exactly.  The ring
  shift's route (``shift_route``): sends of the tensors themselves on CPU
  tensors, host buffers only where gloo meets a CUDA tensor, and the
  host-staged route's output bit for bit the other's (the CUDA route
  itself is held on the card by ``chip_smoke.py``'s ``mesh_pipeline``).
"""
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import result, run_ranks  # noqa: E402

TOL = 1e-4
CHUNK = 8
SSD_SHAPE = dict(b=2, l=64, h=4, p=8, g=2, n=8)
ARCHS = ("mamba2-780m", "zamba2-1.2b")
SMALL = dict(layers=4, d_model=64, vocab=128)
TOKENS = (2, 32)                 # reduced SSM chunk 16: 32 tokens split 2 ways
PIPE = dict(layers=6, d=4, m=5, mb=2)


def _ssd_inputs():
    b, l, h, p, g, n = (SSD_SHAPE[k] for k in "blhpgn")
    rng = np.random.default_rng(0)
    return (rng.standard_normal((b, l, h, p)).astype(np.float32) * 0.5,
            np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32),
            -np.exp(rng.standard_normal(h)).astype(np.float32),
            rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.3,
            rng.standard_normal((b, l, g, n)).astype(np.float32) * 0.3)


def _pipe_inputs():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((PIPE["layers"], PIPE["d"], PIPE["d"])).astype(np.float32) * 0.3
    x = rng.standard_normal((PIPE["m"], PIPE["mb"], PIPE["d"])).astype(np.float32)
    return w, x


def _inputs():
    with open(os.path.join(os.environ["TORCH_RANKS_DIR"], "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _mesh(shape):
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(shape[1], device_type="cpu")


# --------------------------------------------------------------------------
# checks, run in every rank
# --------------------------------------------------------------------------

def check_ssd_plain(rank, world):
    from repro_torch.nn.ssm import ssd_seq_parallel
    x, dt, a, b, c = (torch.from_numpy(t) for t in _ssd_inputs())
    y, s = ssd_seq_parallel(x, dt, a, b, c, chunk=CHUNK, mesh=_mesh((1, world)))
    return y.numpy(), s.numpy()


def check_ssd_dtensor(rank, world):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.nn.ssm import ssd_seq_parallel
    mesh = _mesh((2, 2))
    ts = [distribute_tensor(torch.from_numpy(t), mesh, [Replicate(), Replicate()])
          for t in _ssd_inputs()]
    y, s = ssd_seq_parallel(*ts, chunk=CHUNK, mesh=mesh)
    assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(s.placements) == (Shard(0), Replicate())
    return y.full_tensor().numpy(), s.full_tensor().numpy()


def check_ssd_grad(rank, world):
    from repro_torch.nn.ssm import ssd_chunked, ssd_seq_parallel
    rng = np.random.default_rng(5)
    wy = torch.from_numpy(rng.standard_normal((2, 64, 4, 8)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))

    def grads(fn):
        ts = [torch.from_numpy(t).requires_grad_(True) for t in _ssd_inputs()]
        y, s = fn(*ts)
        loss = (y * wy).sum() + (s * ws).sum()
        return [g.numpy() for g in torch.autograd.grad(loss, ts)]

    want = grads(lambda *t: ssd_chunked(*t, chunk=CHUNK))
    got = grads(lambda *t: ssd_seq_parallel(*t, chunk=CHUNK, mesh=_mesh((1, world))))
    return got, want


def check_prefill(rank, world):
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.models import hybrid, mamba
    from repro_torch.nn import ssm
    inputs = _inputs()
    calls = []
    seq_parallel = ssm.ssd_seq_parallel

    def counted(*args, **kw):
        calls.append(1)
        return seq_parallel(*args, **kw)

    ssm.ssd_seq_parallel = counted
    out = {}
    for arch in ARCHS:
        mod = mamba if arch == "mamba2-780m" else hybrid
        cfg = reduced(get_config(arch), **SMALL)
        params = mod.params_from_reference(inputs["params"][arch], cfg, "cpu")
        state = (mod.init_state(cfg, TOKENS[0], "cpu") if mod is mamba else
                 mod.init_state(cfg, TOKENS[0], TOKENS[1], device="cpu"))
        mesh = _mesh((world // 2, 2))
        with mesh:
            logits, state = mod.prefill(params, torch.from_numpy(inputs["tokens"]).long(),
                                        cfg, state)
        ssm_state = state[0] if mod is mamba else state["ssm"][0]
        out[arch] = (logits.numpy(), ssm_state.numpy(), len(calls))
        calls.clear()
    ssm.ssd_seq_parallel = seq_parallel
    return out


def _block_fn(p, x):
    """A residual block stack: a zero layer is the identity."""
    for i in range(p["w"].shape[0]):
        x = x + torch.tanh(x @ p["w"][i])
    return x


def check_pipeline(rank, world):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.pipeline_parallel import (
        pipeline_forward, plan_stages_for_layers, stack_stage_params)
    w, x = _pipe_inputs()
    plan = plan_stages_for_layers([1.0] * PIPE["layers"], world)
    stacked = stack_stage_params({"w": torch.from_numpy(w)}, plan)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    out = pipeline_forward(_block_fn, stacked, torch.from_numpy(x), mesh)
    return out.numpy(), plan.boundaries, stacked["w"].numpy()


def check_pipeline_routes(rank, world):
    """The ring shift's routes on CPU tensors: the route each tick took
    (``shift_route`` gives ``"p2p"`` for gloo on the CPU), and the output
    again with every shift staged through host buffers (the route gloo
    ranks take on the card), which must equal the sends of the tensors
    themselves bit for bit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import pipeline_parallel as pp
    w, x = _pipe_inputs()
    stacked = pp.stack_stage_params({"w": torch.from_numpy(w)},
                                    pp.plan_stages_for_layers([1.0] * PIPE["layers"], world))
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
    ring_shift, route_of, taken = pp._ring_shift, pp.shift_route, []

    def spied(y, nxt, prv, group, route, host):
        taken.append(route)
        return ring_shift(y, nxt, prv, group, route, host)

    pp._ring_shift = spied
    try:
        p2p = pp.pipeline_forward(_block_fn, stacked, torch.from_numpy(x), mesh)
        routes = list(taken)
        taken.clear()
        pp.shift_route = lambda backend, device: "host"
        host = pp.pipeline_forward(_block_fn, stacked, torch.from_numpy(x), mesh)
    finally:
        pp._ring_shift, pp.shift_route = ring_shift, route_of
    return {"routes": routes, "host_routes": taken, "equal": torch.equal(p2p, host),
            "backend": dist.get_backend(mesh.get_group("stage"))}


CHECKS_2 = {"ssd_plain": check_ssd_plain, "ssd_grad": check_ssd_grad,
            "prefill": check_prefill, "pipeline": check_pipeline,
            "pipeline_routes": check_pipeline_routes}
CHECKS_4 = {"ssd_plain": check_ssd_plain, "ssd_dtensor": check_ssd_dtensor,
            "prefill": check_prefill, "pipeline": check_pipeline,
            "pipeline_routes": check_pipeline_routes}


# --------------------------------------------------------------------------
# the reference's side
# --------------------------------------------------------------------------

def _ref_params(arch):
    """The reference's param tree (its structure from ``jax.eval_shape``
    of its ``init``), every leaf drawn with numpy: matrices at 1/sqrt(fan
    in), norm scales, skips and biases around their init values, the
    decay rates ``a_log`` as the reference's log(1..H) plus noise."""
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_config, reduced
    from repro.models import hybrid, mamba
    mod = mamba if arch == "mamba2-780m" else hybrid
    cfg = reduced(get_config(arch), **SMALL)
    rng = np.random.default_rng(0)
    around = {"ln": 1, "ln1": 1, "ln2": 1, "norm_scale": 1, "final_norm": 1, "d_skip": 1,
              "conv_b": 0, "dt_bias": -3}

    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "a_log":
            base = np.log(np.arange(1, leaf.shape[-1] + 1))
            return (base + rng.normal(0, 0.1, leaf.shape)).astype(np.float32)
        if name in around:
            return rng.normal(around[name], 0.2, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])).astype(np.float32)

    shapes = jax.eval_shape(lambda: mod.init(cfg, jax.random.key(0)))
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def reference():
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs.registry import get_config, reduced
    from repro.models import hybrid, mamba
    from repro.nn.ssm import ssd_chunked_streaming
    y, s = jax.jit(lambda *t: ssd_chunked_streaming(*t, chunk=CHUNK))(
        *map(jnp.asarray, _ssd_inputs()))
    tokens = np.random.default_rng(6).integers(0, SMALL["vocab"], TOKENS).astype(np.int32)
    params, prefill = {}, {}
    for arch in ARCHS:
        mod = mamba if arch == "mamba2-780m" else hybrid
        cfg = reduced(get_config(arch), **SMALL)
        params[arch] = _ref_params(arch)
        state = (mod.init_state(cfg, TOKENS[0]) if mod is mamba else
                 mod.init_state(cfg, TOKENS[0], TOKENS[1]))
        logits, state = jax.jit(lambda p, t, st: mod.prefill(p, t, cfg, st))(
            jax.tree.map(jnp.asarray, params[arch]), jnp.asarray(tokens), state)
        ssm_state = state[0] if mod is mamba else state["ssm"][0]
        prefill[arch] = (np.asarray(logits), np.asarray(ssm_state))
    return {"ssd": (np.asarray(y), np.asarray(s)), "tokens": tokens, "params": params,
            "prefill": prefill}


def _run(world, checks, reference, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"seq{world}")
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump({"tokens": reference["tokens"], "params": reference["params"]}, f)
    return run_ranks(world, checks, d)


@pytest.fixture(scope="module")
def ranks2(reference, tmp_path_factory):
    return _run(2, CHECKS_2, reference, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(reference, tmp_path_factory):
    return _run(4, CHECKS_4, reference, tmp_path_factory)


@pytest.fixture(params=[2, 4])
def ranks(request):
    return request.getfixturevalue(f"ranks{request.param}")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def test_ssd_seq_parallel_matches_the_streaming_scan(ranks, reference):
    want_y, want_s = reference["ssd"]
    for y, s in result(ranks, "ssd_plain"):
        _close(y, want_y)
        _close(s, want_s)


def test_ssd_seq_parallel_on_dtensors_matches_the_streaming_scan(ranks4, reference):
    want_y, want_s = reference["ssd"]
    for y, s in result(ranks4, "ssd_dtensor"):
        _close(y, want_y)
        _close(s, want_s)


def test_ssd_seq_parallel_gradient_is_the_one_process_gradient(ranks2):
    for got, want in result(ranks2, "ssd_grad"):
        assert len(got) == 5
        for g, w in zip(got, want):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL * float(np.abs(w).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_prefill_matches_jax(ranks, reference, arch):
    want_logits, want_state = reference["prefill"][arch]
    for got in result(ranks, "prefill"):
        logits, state, calls = got[arch]
        assert calls == SMALL["layers"]          # every layer's scan on the mesh route
        _close(logits, want_logits)
        _close(state, want_state)


@pytest.fixture(scope="module")
def pipe_reference():
    """The reference's ``pipeline_forward`` on its 1-stage mesh and its
    vmapped ``block_fn`` over the whole stack."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from jax.sharding import Mesh
    from repro.distributed.pipeline_parallel import pipeline_forward as ref_forward
    from repro.distributed.pipeline_parallel import plan_stages_for_layers as ref_plan
    from repro.distributed.pipeline_parallel import stack_stage_params as ref_stack

    w, x = _pipe_inputs()

    def block_fn(p, xx):
        for i in range(p["w"].shape[0]):
            xx = xx + jnp.tanh(xx @ p["w"][i])
        return xx

    one = ref_stack({"w": jnp.asarray(w)}, ref_plan([1.0] * PIPE["layers"], 1))
    ref_out = ref_forward(block_fn, one, jnp.asarray(x),
                          Mesh(np.array(jax.devices()[:1]), ("stage",)))
    vmapped = jax.vmap(lambda xx: block_fn({"w": jnp.asarray(w)}, xx))(jnp.asarray(x))
    return np.asarray(ref_out), np.asarray(vmapped)


def test_pipeline_forward_matches_the_references(ranks, pipe_reference):
    jax = pytest.importorskip("jax")
    from repro.distributed.pipeline_parallel import plan_stages_for_layers as ref_plan
    from repro.distributed.pipeline_parallel import stack_stage_params as ref_stack

    w, _ = _pipe_inputs()
    ref_out, vmapped = pipe_reference
    per_rank = result(ranks, "pipeline")
    world = len(per_rank)
    plan = ref_plan([1.0] * PIPE["layers"], world)
    for out, bounds, stacked in per_rank:
        np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, vmapped, rtol=1e-5, atol=1e-5)
        assert bounds == plan.boundaries
        np.testing.assert_array_equal(stacked, np.asarray(ref_stack({"w": jax.numpy.asarray(w)},
                                                                    plan)["w"]))


def test_ring_shift_routes(ranks):
    """gloo ranks on CPU tensors send the tensors themselves every tick;
    the host-staged route (CUDA tensors under gloo) gives the same output
    bit for bit."""
    per_rank = result(ranks, "pipeline_routes")
    ticks = PIPE["m"] + len(per_rank) - 1
    for out in per_rank:
        assert out["backend"] == "gloo"
        assert out["routes"] == ["p2p"] * ticks
        assert out["host_routes"] == ["host"] * ticks and out["equal"]


@pytest.mark.parametrize("backend,device,want", [
    ("gloo", "cpu", "p2p"), ("gloo", "cuda", "host"), ("gloo", "cuda:1", "host"),
    ("nccl", "cuda", "p2p"), ("nccl", "cuda:0", "p2p")])
def test_shift_route_follows_backend_and_device(backend, device, want):
    """Host staging only where gloo meets a CUDA tensor."""
    from repro_torch.distributed.pipeline_parallel import shift_route
    assert shift_route(backend, torch.device(device)) == want


def test_stack_stage_params_pads_with_zero_layers():
    """The reference's ``test_stage_param_stacking_pads_identity`` case,
    and an uneven plan, exactly."""
    jax = pytest.importorskip("jax")
    from repro.core.stage_partition import partition_min_bottleneck as ref_partition
    from repro.distributed.pipeline_parallel import stack_stage_params as ref_stack
    from repro_torch.core.stage_partition import partition_min_bottleneck
    from repro_torch.distributed.pipeline_parallel import stack_stage_params
    for costs, s in (([1.0, 1.0, 1.0, 1.0, 4.0], 2), ([1.0] * 7, 3)):
        w = np.arange(len(costs) * 3.0, dtype=np.float32).reshape(len(costs), 3)
        plan = partition_min_bottleneck(costs, s)
        assert plan.boundaries == ref_partition(costs, s).boundaries
        got = stack_stage_params({"w": torch.from_numpy(w)}, plan)["w"].numpy()
        want = np.asarray(ref_stack({"w": jax.numpy.asarray(w)}, ref_partition(costs, s))["w"])
        np.testing.assert_array_equal(got, want)
        sizes = np.diff(plan.boundaries)
        for i, size in enumerate(sizes):
            assert (got[i, size:] == 0).all()


def test_plan_stages_for_layers_is_the_references():
    from repro.distributed.pipeline_parallel import plan_stages_for_layers as ref_plan
    from repro_torch.distributed.pipeline_parallel import plan_stages_for_layers
    for costs, s, block in (([1.0] * 8, 4, 2), ([1.0, 2.0, 3.0, 4.0, 5.0, 6.0], 3, 1),
                            ([2.0] * 12, 3, 4), ([5.0, 1.0, 1.0, 1.0], 2, 1)):
        got, want = plan_stages_for_layers(costs, s, block), ref_plan(costs, s, block)
        assert got.boundaries == want.boundaries
        assert list(got.stage_cost) == list(want.stage_cost)
