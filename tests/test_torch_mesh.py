"""The port's mesh runtime on four gloo ranks of the CPU.

One spawn of 4 ranks (``torch_ranks.run_ranks``, a ``FileStore`` under
``tmp_path``) runs every check; each test asserts one check's results.

* ``make_local_mesh``; ``make_production_mesh`` at 256 and 512 ranks of a
  fake process group in this process (``FakeStore``, destroyed after).
* ``compressed_psum`` / ``compressed_tree_psum`` against the JAX
  package's under ``jax.vmap(axis_name=)`` — 4 rows, the 4 workers —
  bit for bit over 30 steps of error feedback, and within the
  reference test's bounds of the true mean.
* ``viable_mesh_shape`` and ``ElasticMesh`` on the reference test's
  cases: re-mesh 3 survivors of 4, re-shard onto them.
* ``Checkpointer.restore(shardings=)``: a tree sharded on a (2, 2) mesh
  saved, restored onto (4, 1), bit for bit.
* ``constrain`` inside a mesh: values unchanged, placements as the
  logical table and its divisibility guard give them.
* The sharded ``build_train_step`` on a (2, 2) ``("data", "model")``
  mesh (DTensor params, AdamW state and batch; FSDP / TP placements;
  the residual stream sequence-sharded through ``constrain``; mamba2's
  scan on ``ssd_seq_parallel``) against the port's unsharded step on the
  same weights and batch (which ``tests/test_torch_train.py`` holds
  against the JAX package; the JAX package's own sharded step does not
  compile on this jax): loss at 1e-5 relative, every grad leaf at 1e-4
  of its scale, params after one AdamW step (eps 1e-3) at 1e-4 of their
  scale.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from torch_ranks import result, run_ranks  # noqa: E402

WORLD = 4
STEPS = 30
TRAIN_ARCHS = ("qwen2-7b", "mamba2-780m")
PROMPT = 24
ROW_POSITIONS = (24, 21, 18, 23)     # each row's length before the first decode step


def _grads_rows():
    return np.random.default_rng(0).standard_normal((WORLD, 64)).astype(np.float32)


def _tree_rows():
    rng = np.random.default_rng(1)
    return {"a": rng.standard_normal((WORLD, 3, 5)).astype(np.float32) * 4,
            "b": {"c": rng.standard_normal((WORLD, 7)).astype(np.float32) * 1e-3}}


def _err(a, b) -> float:
    """max|a - b| over max|a|, ``b`` a DTensor."""
    return float((a - b.full_tensor()).abs().max()) / max(float(a.abs().max()), 1e-30)


# --------------------------------------------------------------------------
# checks, run in every rank
# --------------------------------------------------------------------------

def check_local_mesh(rank, world):
    mesh = make_local_mesh(2, device_type="cpu")
    flat = make_local_mesh(device_type="cpu")
    try:
        make_local_mesh(3, device_type="cpu")
        raised = False
    except ValueError:
        raised = True
    return (tuple(mesh.shape), tuple(mesh.mesh_dim_names), tuple(flat.shape),
            mesh.get_coordinate(), raised)


def check_compressed_psum(rank, world):
    from repro_torch.distributed.collectives import compressed_psum
    g = torch.from_numpy(_grads_rows()[rank])
    res = torch.zeros_like(g)
    out = []
    for _ in range(STEPS):
        mean, res = compressed_psum(g, res)
        out.append((mean.numpy().copy(), res.numpy().copy()))
    return out


def check_compressed_tree_psum(rank, world):
    from repro_torch.distributed.collectives import compressed_tree_psum
    rows = _tree_rows()
    grads = {"a": torch.from_numpy(rows["a"][rank]),
             "b": {"c": torch.from_numpy(rows["b"]["c"][rank])}}
    res = {"a": torch.zeros(3, 5), "b": {"c": torch.zeros(7)}}
    for _ in range(3):
        mean, res = compressed_tree_psum(grads, res)
    return ({"a": mean["a"].numpy(), "c": mean["b"]["c"].numpy()},
            {"a": res["a"].numpy(), "c": res["b"]["c"].numpy()})


def check_elastic(rank, world):
    from repro_torch.distributed.fault_tolerance import ElasticMesh
    from repro_torch.distributed.sharding import NamedSharding, P
    em = ElasticMesh(model_degree=1)
    mesh = em.remesh([0, 1, 2], device_type="cpu")        # rank 3 is lost
    out = {"shape": tuple(mesh.shape), "member": mesh.get_coordinate() is not None}
    if rank < 3:
        tree = {"w": np.arange(8.0, dtype=np.float32)}
        got = em.reshard(tree, {"w": NamedSharding(mesh, P())})
        out["w"] = got["w"].full_tensor().numpy()
        out["w_placements"] = tuple(got["w"].placements)
    em2 = ElasticMesh(model_degree=2)
    mesh2 = em2.remesh(list(range(world)), device_type="cpu")
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    got = em2.reshard({"x": x}, {"x": NamedSharding(mesh2, P("data", "model"))})
    out["x"] = got["x"].full_tensor().numpy()
    out["x_local"] = tuple(got["x"].to_local().shape)
    return out


def check_checkpoint_reshard(rank, world):
    from repro_torch.checkpoint import checkpointer
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed import sharding as shd
    from repro_torch.tree import leaves
    rng = np.random.default_rng(2)
    tree = {"blocks": [{"attn": {"wq": rng.standard_normal((8, 12)).astype(np.float32)},
                        "ln1": rng.standard_normal(8).astype(np.float32)}],
            "embed": rng.standard_normal((16, 8)).astype(np.float32),
            "half": torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32)
                                     ).to(torch.bfloat16)}
    mesh = make_local_mesh(2, device_type="cpu")
    sharded = shd.shard_tree(tree, shd.params_shardings(tree, mesh))
    ck = Checkpointer(os.path.join(os.environ["TORCH_RANKS_DIR"], "ckpt"))
    to_host, host_copies = checkpointer._to_host, []

    def counted(t):
        host_copies.append(1)
        return to_host(t)

    checkpointer._to_host = counted
    try:
        ck.save(3, sharded, extra={"step": 3}, blocking=True)
    finally:
        checkpointer._to_host = to_host
    dist.barrier()
    flat = make_local_mesh(1, device_type="cpu")              # (4, 1)
    new = shd.params_shardings(tree, flat)
    restored, extra = ck.restore(None, sharded, shardings=new)
    want = leaves(shd.shard_tree(tree, new))
    got = leaves(restored)
    return {"extra": extra,
            "placements": [tuple(t.placements) for t in got],
            "want_placements": [tuple(t.placements) for t in want],
            "equal": [torch.equal(a.full_tensor(), b.full_tensor()) for a, b in zip(got, want)],
            "dtypes": [a.dtype for a in got], "host_copies": len(host_copies)}


def check_constrain_inside_mesh(rank, world):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.sharding import constrain
    mesh = make_local_mesh(2, device_type="cpu")
    x = torch.arange(4 * 8 * 16, dtype=torch.float32).reshape(4, 8, 16)
    out = {}
    dx = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with mesh:
        y = constrain(dx, ("batch", "seq", None)) * 2
        odd = constrain(distribute_tensor(x[:3], mesh, [Replicate(), Replicate()]),
                        ("batch", "seq", None))
        plain = constrain(x, ("batch", "seq", None))
    out["placements"] = tuple(y.placements)
    out["values"] = torch.equal(y.full_tensor(), x * 2)
    out["odd"] = tuple(odd.placements)
    out["plain_is_x"] = plain is x
    out["outside"] = constrain(dx, ("batch", "seq", None)) is dx
    return out


def check_sharded_train_step(rank, world):
    """Per arch: the sharded and the unsharded step on the same weights
    and batch; returns the relative loss error, the worst grad and param
    errors as fractions of their leaves' scales, and the leaf types."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models.registry import get_api
    from repro_torch.nn import ssm
    from repro_torch.optim import optimizers as opt
    from repro_torch.tree import leaves

    seq_parallel = ssm.ssd_seq_parallel
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return seq_parallel(*args, **kw)

    ssm.ssd_seq_parallel = counted
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = reduced(get_config(arch), layers=2, d_model=64, vocab=256)
        adam = train.adam_config_for(cfg, lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-3)
        api = get_api(cfg, "cpu")
        rng = np.random.default_rng(3)
        batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64),
                 "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)}
        batch["labels"][0, :3] = -1

        plain = train.trainable(api.init(cfg, torch.Generator().manual_seed(0)))
        mesh = make_local_mesh(2, device_type="cpu")
        pshard = shd.params_shardings(plain, mesh)
        params = train.trainable(shd.shard_tree(plain, pshard))
        dbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh))

        loss_fn = lambda p, b: api.loss_fn(p, b, cfg)  # noqa: E731
        l0, _, g0 = opt.accumulate_grads(loss_fn, plain, batch, 1)
        from torch.distributed.tensor.experimental import implicit_replication
        with mesh, implicit_replication():
            l1, _, g1 = opt.accumulate_grads(loss_fn, params, dbatch, 1,
                                             grad_shardings=pshard)
        grad_err = max(float((a - b.full_tensor()).abs().max()) / float(a.abs().max())
                       for a, b in zip(leaves(g0), leaves(g1)))
        grad_placed = all(tuple(g.placements) == s.placements
                          for g, s in zip(leaves(g1), leaves(pshard)))

        state0 = opt.init(adam, plain)
        state1 = shd.shard_tree(opt.init(adam, plain),
                                shd.opt_state_shardings(state0, plain, mesh))
        p0, s0, m0 = train.build_train_step(cfg, adam, "cpu")(plain, state0, batch)
        with mesh:
            p1, s1, m1 = train.build_train_step(cfg, adam, "cpu", grad_shardings=pshard)(
                params, state1, dbatch)
        param_err = max(float((a - b.full_tensor()).abs().max()) / float(a.abs().max())
                        for a, b in zip(leaves(p0), leaves(p1)))
        out[arch] = {
            "loss": (float(l0), float(l1.full_tensor())),
            "step_loss": (float(m0["loss"]), float(m1["loss"].full_tensor())),
            "grad_err": grad_err, "grad_placed": grad_placed, "param_err": param_err,
            "all_dtensor": all(isinstance(t, DTensor) for t in leaves(p1) + leaves(s1)),
            "params_placed": all(tuple(p.placements) == s.placements
                                 for p, s in zip(leaves(p1), leaves(pshard))),
            "seq_parallel_calls": len(calls), "remat": cfg.remat,
        }
        calls.clear()
    return out


def check_uneven_heads_train_step(rank, world):
    """qwen2 with 6 query and 2 KV heads on a (1, 4) mesh: neither divides
    the 'model' degree, as qwen2-7b's 28 / 4 do not divide 16.  The sharded
    and the unsharded step on the same weights and batch, as
    ``check_sharded_train_step`` compares them."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt
    from repro_torch.tree import leaves

    # a vocab of 255 does not split over 4 either: the head multiplies each
    # rank's rows by the whole table, the CE reduces them where they lie
    cfg = dataclasses.replace(reduced(get_config("qwen2-7b"), vocab=255), n_heads=6, n_kv=2)
    api = get_api(cfg, "cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64),
             "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)}
    batch["labels"][1, :5] = -1
    plain = train.trainable(api.init(cfg, torch.Generator().manual_seed(1)))
    mesh = make_local_mesh(4, device_type="cpu")
    pshard = shd.params_shardings(plain, mesh)
    params = train.trainable(shd.shard_tree(plain, pshard))
    dbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh))
    loss_fn = lambda p, b: api.loss_fn(p, b, cfg)  # noqa: E731
    l0, _, g0 = opt.accumulate_grads(loss_fn, plain, batch, 1)
    with mesh, implicit_replication():
        l1, _, g1 = opt.accumulate_grads(loss_fn, params, dbatch, 1, grad_shardings=pshard)
    return {"heads": (cfg.n_heads, cfg.n_kv, tuple(mesh.shape)),
            "loss": (float(l0), float(l1.full_tensor())),
            "grad_err": max(float((a - b.full_tensor()).abs().max()) / float(a.abs().max())
                            for a, b in zip(leaves(g0), leaves(g1))),
            "wq_sharded": any(p.is_shard() for p in params["blocks"][0]["attn"]["wq"].placements),
            "embed_vocab_whole": not any(p.is_shard(0) for p in params["embed"].placements)}


def check_sharded_ssm_decode(rank, world):
    """mamba2's decode step on DTensor params and serve state on a (2, 2)
    mesh (rows over 'data', heads over 'model') against the unsharded
    decode from the same prefilled state; returns the worst errors as
    fractions of the scales, and the new state's placements."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.registry import get_api
    from repro_torch.tree import leaves

    cfg = reduced(get_config("mamba2-780m"), layers=2, d_model=64, vocab=256)
    api = get_api(cfg, "cpu")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int64)
    tok = {"tokens": rng.integers(0, cfg.vocab, (4, 1)).astype(np.int64)}
    params = api.init(cfg, torch.Generator().manual_seed(2))
    _, state = api.prefill(params, {"tokens": prompt}, api.make_serve_state(cfg, 4, 32), cfg)
    mesh = make_local_mesh(2, device_type="cpu")
    dparams = shd.shard_tree(params, shd.params_shardings(params, mesh))
    dstate = shd.shard_tree(state, shd.serve_state_specs(state, mesh))   # copies: a step
    logits0, state0 = api.decode(params, state, tok, 16, cfg)            # updates in place
    dtok = shd.shard_tree(tok, shd.batch_specs(tok, mesh))
    with mesh, implicit_replication():
        logits1, state1 = api.decode(dparams, dstate, dtok, 16, cfg)

    def err(a, b):
        return float((a - b.full_tensor()).abs().max()) / float(a.abs().max())

    return {"logits_err": err(logits0, logits1),
            "state_err": max(err(a, b) for a, b in zip(leaves(state0), leaves(state1))),
            "ssm_placements": tuple(state1[0].placements),
            "all_dtensor": all(isinstance(t, DTensor) for t in leaves(state1))}


def check_remat_backward_in_another_thread(rank, world):
    """mamba2's sharded loss on a (2, 2) mesh, its backward run in a thread
    of its own, as autograd runs a CUDA backward: the remat recomputation
    must take the forward's routes (the sequence-parallel scan, the
    ``constrain`` placements), though the mesh stack is thread-local.
    Returns the worst grad difference from the backward in this thread."""
    import threading
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.models.registry import get_api
    from repro_torch.tree import leaves

    cfg = reduced(get_config("mamba2-780m"), layers=2, d_model=64, vocab=256)
    assert cfg.remat
    api = get_api(cfg, "cpu")
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64),
             "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)}
    plain = api.init(cfg, torch.Generator().manual_seed(3))
    mesh = make_local_mesh(2, device_type="cpu")
    params = train.trainable(shd.shard_tree(plain, shd.params_shardings(plain, mesh)))
    dbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh))
    ps = leaves(params)
    grads = []
    for threaded in (False, True):
        with mesh, implicit_replication():
            loss, _ = api.loss_fn(params, dbatch, cfg)
            if not threaded:
                grads.append(torch.autograd.grad(loss, ps))
                continue
        out = {}

        def backward():
            try:
                with implicit_replication():
                    out["g"] = torch.autograd.grad(loss, ps)
            except Exception as e:          # noqa: BLE001 - reported to the test
                out["error"] = repr(e)

        t = threading.Thread(target=backward)
        t.start()
        t.join()
        if "error" in out:
            return {"error": out["error"]}
        grads.append(out["g"])
    return {"err": max(float((a - b).full_tensor().abs().max()) for a, b in zip(*grads))}


def check_per_row_decode(rank, world):
    """Two greedy decode steps with every row at its own position (the
    engine's slots), on DTensor params, caches and tokens on a (4, 1) and
    a (2, 2) mesh, against the unsharded ``decode_step`` from the same
    prefilled caches: qwen2's bf16-layout (f32 here) and int8 caches and
    gemma3's rings.  The second step reads what the first wrote.  Returns
    the worst logits and cache errors as fractions of their scales."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.registry import get_api
    from repro_torch.tree import leaves, unflatten

    qwen = reduced(get_config("qwen2-7b"), layers=2, d_model=64, vocab=256)
    out = {}
    for kind, cfg, max_len in (("plain", qwen, 64),
                               ("int8", dataclasses.replace(qwen, kv_quant=True), 64),
                               ("ring", reduced(get_config("gemma3-1b"), layers=2,
                                                d_model=64, vocab=256), 40)):
        api = get_api(cfg, "cpu")
        params = api.init(cfg, torch.Generator().manual_seed(21))
        prompt = {"tokens": np.random.default_rng(22).integers(
            0, cfg.vocab, (4, PROMPT)).astype(np.int64)}
        with torch.no_grad():
            _, state = api.prefill(params, prompt, api.make_serve_state(cfg, 4, max_len), cfg)
        for degree in (1, 2):
            mesh = make_local_mesh(degree, device_type="cpu")
            dparams = shd.shard_tree(params, shd.params_shardings(params, mesh))
            dstate = shd.shard_tree(state, shd.serve_state_specs(state, mesh))   # copies
            s0 = unflatten(state, [t.clone() for t in leaves(state)])
            pos = np.asarray(ROW_POSITIONS)
            tok = {"tokens": np.random.default_rng(23).integers(
                0, cfg.vocab, (4, 1)).astype(np.int64)}
            errs = []
            with torch.no_grad():
                for _ in range(2):
                    l0, s0 = api.decode(params, s0, tok, pos, cfg)
                    with mesh, implicit_replication():
                        l1, dstate = api.decode(dparams, dstate, shd.shard_tree(
                            tok, shd.batch_specs(tok, mesh)), pos, cfg)
                    errs.append(_err(l0, l1))
                    tok = {"tokens": l0[:, -1].argmax(-1)[:, None].numpy()}
                    pos = pos + 1
            out[(kind, tuple(mesh.shape))] = {
                "errs": errs,
                "cache_err": max(_err(a, b) for a, b in zip(leaves(s0), leaves(dstate))),
                "cache_dtensor": all(isinstance(t, DTensor) for t in leaves(dstate)),
                "rings": isinstance(state, list), "int8": leaves(state)[0].dtype == torch.int8}
    return out


CHECKS = {
    "local_mesh": check_local_mesh,
    "compressed_psum": check_compressed_psum,
    "compressed_tree_psum": check_compressed_tree_psum,
    "elastic": check_elastic,
    "checkpoint": check_checkpoint_reshard,
    "constrain": check_constrain_inside_mesh,
    "train": check_sharded_train_step,
    "uneven_heads": check_uneven_heads_train_step,
    "ssm_decode": check_sharded_ssm_decode,
    "remat_thread": check_remat_backward_in_another_thread,
    "per_row_decode": check_per_row_decode,
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(WORLD, CHECKS, tmp_path_factory.mktemp("mesh"))


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

def test_make_local_mesh(ranks):
    got = result(ranks, "local_mesh")
    for r, (shape, names, flat, coord, raised) in enumerate(got):
        assert shape == (2, 2) and names == ("data", "model") and flat == (4, 1)
        assert list(coord) == [r // 2, r % 2] and raised


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("multi_pod,world,shape", [(False, 256, (16, 16)),
                                                   (True, 512, (2, 16, 16))])
def test_make_production_mesh(fake_world, multi_pod, world, shape):
    fake_world(world)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.shape) == shape
    assert mesh.mesh_dim_names == (("pod", "data", "model") if multi_pod else ("data", "model"))


def _ref_compressed(fn):
    """The JAX package's collective over 4 workers: the rows of a
    ``jax.vmap`` with ``axis_name="w"``, run eagerly as its own test runs
    it (under ``jax.jit`` XLA rewrites the quotients, and the bits move)."""
    jax = pytest.importorskip("jax")
    return jax.vmap(fn, axis_name="w")


def test_compressed_psum_is_the_references_bit_for_bit(ranks):
    jax = pytest.importorskip("jax")
    from repro.distributed.collectives import compressed_psum as ref
    got = result(ranks, "compressed_psum")
    grads = jax.numpy.asarray(_grads_rows())
    res = jax.numpy.zeros_like(grads)
    true_mean = _grads_rows().mean(0)
    acc = np.zeros(64, np.float32)
    run = _ref_compressed(lambda g, r: ref(g, r, "w"))
    for step in range(STEPS):
        mean, res = run(grads, res)
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r][step][0], np.asarray(mean[r]))
            np.testing.assert_array_equal(got[r][step][1], np.asarray(res[r]))
        acc += got[0][step][0] / STEPS
    assert np.abs(got[0][-1][0] - true_mean).max() < 0.05
    assert np.abs(acc - true_mean).max() < 0.02


def test_compressed_tree_psum_is_the_references_bit_for_bit(ranks):
    jax = pytest.importorskip("jax")
    from repro.distributed.collectives import compressed_tree_psum as ref
    got = result(ranks, "compressed_tree_psum")
    rows = jax.tree.map(jax.numpy.asarray, _tree_rows())
    res = jax.tree.map(jax.numpy.zeros_like, rows)
    run = _ref_compressed(lambda g, r: ref(g, r, "w"))
    for _ in range(3):
        mean, res = run(rows, res)
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r][0]["a"], np.asarray(mean["a"][r]))
        np.testing.assert_array_equal(got[r][0]["c"], np.asarray(mean["b"]["c"][r]))
        np.testing.assert_array_equal(got[r][1]["a"], np.asarray(res["a"][r]))
        np.testing.assert_array_equal(got[r][1]["c"], np.asarray(res["b"]["c"][r]))


def test_viable_mesh_shape_is_the_references():
    from repro.distributed.fault_tolerance import viable_mesh_shape as ref
    from repro_torch.distributed.fault_tolerance import viable_mesh_shape
    for n, m in [(256, 16), (240, 16), (8, 16), (4, 1), (3, 1), (4, 2), (7, 2), (512, 16)]:
        assert viable_mesh_shape(n, m) == ref(n, m)
    assert viable_mesh_shape(240, 16) == (15, 16) and viable_mesh_shape(8, 16) is None


def test_elastic_remesh_and_reshard(ranks):
    got = result(ranks, "elastic")
    for r, out in enumerate(got):
        assert out["shape"] == (3, 1) and out["member"] == (r < 3)
        if r < 3:
            np.testing.assert_array_equal(out["w"], np.arange(8.0))
            assert out["w_placements"] == (Replicate(), Replicate())
        np.testing.assert_array_equal(out["x"], np.arange(32.0).reshape(8, 4))
        assert out["x_local"] == (4, 2)


def test_elastic_remesh_refuses_too_few_survivors():
    from repro_torch.distributed.fault_tolerance import ElasticMesh
    with pytest.raises(RuntimeError, match="cannot host model degree 16"):
        ElasticMesh(model_degree=16).remesh(list(range(8)), device_type="cpu")


def test_checkpoint_restores_onto_another_mesh_bit_for_bit(ranks):
    for out in result(ranks, "checkpoint"):
        assert out["extra"] == {"step": 3}
        assert all(out["equal"]) and len(out["equal"]) == 4
        assert out["placements"] == out["want_placements"]
        assert torch.bfloat16 in out["dtypes"]
        # (4, 1): FSDP over 'data' on wq's rows, TP over 'model' (size 1) on its columns
        assert (Shard(0), Shard(1)) in out["placements"]


def test_checkpoint_save_copies_to_the_host_on_rank_0_only(ranks):
    """Every rank joins each DTensor leaf's gather, but only the writing
    rank keeps a host copy of the tree."""
    assert [out["host_copies"] for out in result(ranks, "checkpoint")] == [4, 0, 0, 0]


def test_constrain_inside_a_mesh(ranks):
    for out in result(ranks, "constrain"):
        assert out["values"]
        assert out["placements"] == (Shard(0), Shard(1))
        assert out["odd"] == (Replicate(), Shard(1))        # 3 rows: batch unsharded
        assert out["plain_is_x"] and out["outside"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_the_unsharded_step(ranks, arch):
    for out in result(ranks, "train"):
        got = out[arch]
        for a, b in (got["loss"], got["step_loss"]):
            np.testing.assert_allclose(b, a, rtol=1e-5)
        assert got["grad_err"] <= 1e-4
        assert got["param_err"] <= 1e-4
        assert got["grad_placed"] and got["params_placed"] and got["all_dtensor"]
        # mamba2's 2 layers scan on ssd_seq_parallel in both sharded passes
        # (and again in each backward's recomputation under remat)
        want = 2 * 2 * (2 if got["remat"] else 1) if arch == "mamba2-780m" else 0
        assert got["seq_parallel_calls"] == want


def test_sharded_step_with_heads_uneven_on_the_model_axis(ranks):
    """The q / k / v widths are gathered over 'model' where the heads do
    not divide it (``nn.attention._whole_heads``); the step equals the
    unsharded one at ``test_sharded_train_step_matches_the_unsharded_step``'s
    tolerances."""
    for out in result(ranks, "uneven_heads"):
        assert out["heads"] == (6, 2, (1, 4)) and out["wq_sharded"] and out["embed_vocab_whole"]
        np.testing.assert_allclose(out["loss"][1], out["loss"][0], rtol=1e-5)
        assert out["grad_err"] <= 1e-4


def test_ssm_decode_on_dtensors_matches_the_unsharded_decode(ranks):
    """The decode recurrence runs on each rank's rows and heads
    (``nn.ssm._decode_local``), where DTensor's einsums merged a
    data-sharded batch with model-sharded heads and raised."""
    for out in result(ranks, "ssm_decode"):
        assert out["logits_err"] <= 1e-5 and out["state_err"] <= 1e-5
        assert out["ssm_placements"] == (Shard(1), Shard(2)) and out["all_dtensor"]


def test_remat_recomputes_inside_the_forwards_mesh(ranks):
    """A backward run where the mesh stack is empty (autograd's CUDA thread)
    gives the grads of one run where it is not (``models.lm.remat``)."""
    for out in result(ranks, "remat_thread"):
        assert "error" not in out, out
        assert out["err"] == 0.0


@pytest.mark.parametrize("kind", ["plain", "int8", "ring"])
def test_per_row_decode_on_dtensors_matches_the_unsharded_decode(ranks, kind):
    """Rows at different positions (``ROW_POSITIONS``) decode two steps on
    (4, 1) and (2, 2): each rank attends its rows against their own key
    lengths and slot positions, and writes its rows at their own positions
    into the shards of a DTensor cache (``nn.attention._put_rows``), where
    DTensor's own indexed write refused the cache's placements."""
    for out in result(ranks, "per_row_decode"):
        for shape in ((4, 1), (2, 2)):
            got = out[(kind, shape)]
            assert got["cache_dtensor"] and got["rings"] == (kind == "ring")
            assert got["int8"] == (kind == "int8")
            assert len(got["errs"]) == 2 and max(got["errs"]) <= 1e-4, got["errs"]
            assert got["cache_err"] <= 1e-4
