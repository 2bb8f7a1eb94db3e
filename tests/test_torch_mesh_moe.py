"""The MoE train step, int8 serve weights and head-split queries on
DTensors, on four gloo ranks of the CPU.

One spawn of 4 ranks (``torch_ranks.run_ranks``) runs every check; each
test asserts one check's results.  Reduced configs (2 layers, d 64, vocab
256), f32.

* The sharded ``build_train_step`` of grok-1 and llama4-maverick on a
  (2, 2) ``("data", "model")`` mesh (``nn.moe._moe_on_mesh``: each rank
  routes and dispatches its own rows, the expert stacks FSDP over 'data'
  and split over 'model' on their hidden width) against the port's
  unsharded step on the same weights and batch: loss and aux loss at 1e-5
  relative, every grad leaf and every param after one AdamW step at 1e-4
  of its scale.  The weights are the JAX package's (``params_from_
  reference``), and the unsharded loss is held to the JAX package's
  ``loss_fn`` on them here, at ``tests/test_torch_train.py``'s 1e-5.
* The auxiliary loss's trap: its two means span every rank's rows; the
  per-rank aux losses differ from the whole batch's, so summing or
  averaging them would not give it.  One MoE layer on DTensors equals
  the whole input's under each dispatch form (einsum, scatter, ragged).
* ``dequantize_tree`` of sharded int8 leaves (an embedding table whose
  scales are split otherwise than its values, expert stacks of 4 and of
  20 experts) equals the whole leaves' bit for bit, on ``__q__``'s
  placements; the int8 prefill and 4 greedy decode steps of reduced
  grok-1 and of ``tests/test_torch_moe.py``'s 16-expert maverick on
  DTensor params, caches and tokens equal the unsharded int8 serve at
  1e-5 of the logits' scale, as gemma3-1b's on its ring caches does.
* internvl2-2b's structure with 4 q heads and 2 KV heads on a (1, 4)
  mesh: ``wq`` stays split, q reaches ``nn.attention._attend_local``
  head-split (one head a rank, against the KV head it maps to), and the
  loss and grads equal the unsharded step's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.distributed.tensor import DTensor, Replicate, Shard  # noqa: E402

from torch_ranks import result, run_ranks  # noqa: E402

WORLD = 4
ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b")
SMALL = dict(layers=2, d_model=64, vocab=256)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SERVE_TOL = 1e-5
DECODE_STEPS = 4


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64),
             "labels": rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)}
    batch["labels"][0, :3] = -1
    return batch


def _config(arch):
    from repro_torch.configs.registry import get_config, reduced
    return reduced(get_config(arch), **SMALL)


def _err(a, b) -> float:
    """max|a - b| over max|a|, ``b`` a DTensor or a tensor."""
    b = b.full_tensor() if isinstance(b, DTensor) else b
    return float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)


def _value(t) -> float:
    return float(t.full_tensor() if isinstance(t, DTensor) else t)


# --------------------------------------------------------------------------
# checks, run in every rank
# --------------------------------------------------------------------------

def check_moe_train_step(rank, world):
    """Per arch: the sharded and the unsharded step on the JAX package's
    weights (``weights_<arch>.pt``, written by the test process)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt
    from repro_torch.tree import leaves

    out = {}
    for arch in ARCHS:
        cfg = _config(arch)
        adam = train.adam_config_for(cfg, lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-3)
        api = get_api(cfg, "cpu")
        batch = _batch(cfg, 7)
        plain = train.trainable(torch.load(
            os.path.join(os.environ["TORCH_RANKS_DIR"], f"weights_{arch}.pt")))
        mesh = make_local_mesh(2, device_type="cpu")
        pshard = shd.params_shardings(plain, mesh)
        params = train.trainable(shd.shard_tree(plain, pshard))
        dbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh))

        loss_fn = lambda p, b: api.loss_fn(p, b, cfg)  # noqa: E731
        l0, m0, g0 = opt.accumulate_grads(loss_fn, plain, batch, 1)
        with mesh, implicit_replication():
            l1, m1, g1 = opt.accumulate_grads(loss_fn, params, dbatch, 1,
                                              grad_shardings=pshard)
        state0 = opt.init(adam, plain)
        state1 = shd.shard_tree(opt.init(adam, plain),
                                shd.opt_state_shardings(state0, plain, mesh))
        p0, _, s0 = train.build_train_step(cfg, adam, "cpu")(plain, state0, batch)
        with mesh:
            p1, st1, s1 = train.build_train_step(cfg, adam, "cpu", grad_shardings=pshard)(
                params, state1, dbatch)
        out[arch] = {
            "loss": (float(l0), _value(l1)), "aux": (float(m0["aux"]), _value(m1["aux"])),
            "step_loss": (float(s0["loss"]), _value(s1["loss"])),
            "grad_err": max(_err(a, b) for a, b in zip(leaves(g0), leaves(g1))),
            "param_err": max(_err(a, b) for a, b in zip(leaves(p0), leaves(p1))),
            "grad_placed": all(tuple(g.placements) == s.placements
                               for g, s in zip(leaves(g1), leaves(pshard))),
            "all_dtensor": all(isinstance(t, DTensor) for t in leaves(p1) + leaves(st1)),
            "expert_placements": tuple(p1["blocks"][-1]["moe"]["w_up"].placements),
        }
    return out


def check_aux_loss_trap(rank, world):
    """One MoE layer of reduced grok-1 on a sequence-sharded DTensor input
    ([4, 32, 64], rows over 'data') against the whole input, under each
    dispatch form; and each data rank's rows' own aux loss, as a rank
    would compute it alone."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.nn import moe

    cfg = _config(ARCHS[0])
    spec = lm._moe_spec(cfg)
    params = moe.init_moe(torch.Generator().manual_seed(5), spec)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((4, 32, 64)).astype(np.float32))
    x[2:] = x[2:] * 3 + 1                 # the second data rank's rows lean elsewhere
    mesh = make_local_mesh(2, device_type="cpu")
    dparams = shd.shard_tree({"moe": params}, shd.params_shardings({"moe": params}, mesh))
    dx = shd.shard_tree(x, shd.NamedSharding(mesh, shd.P("data", "model", None)))
    out = {}
    for form in ("einsum", "scatter", "ragged"):
        sp = dataclasses.replace(spec, impl=form)
        y0, aux0 = moe.moe(params, x, sp)
        with mesh, implicit_replication():
            y1, aux1 = moe.moe(dparams["moe"], dx, sp)
        out[form] = {"aux": (float(aux0), _value(aux1)), "y_err": _err(y0, y1),
                     "y_placements": tuple(y1.placements)}
    out["per_rank"] = [float(moe.moe(params, x[i:i + 2], spec)[1]) for i in (0, 2)]
    return out


def check_dequantize_shards(rank, world):
    """Sharded int8 leaves against the whole leaves' ``dequantize_tree`` on
    a (2, 2) and a (1, 4) mesh: whether every leaf is equal bit for bit,
    on ``__q__``'s placements, and the table's values' and scales'
    placements."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.nn.quant import dequantize_tree, quantize_tree
    from repro_torch.tree import leaves

    gen = torch.Generator().manual_seed(9)
    tree = {"embed": torch.randn(1024, 1024, generator=gen),
            "blocks": [{"moe": {"w_up": torch.randn(4, 64, 128, generator=gen),
                                "w_down": torch.randn(20, 32, 64, generator=gen)},
                        "attn": {"wq": torch.randn(64, 64, generator=gen)}}
                       for _ in range(2)]}
    q = quantize_tree(tree)
    want = dequantize_tree(q, torch.float32)
    out = {}
    for model in (2, 4):
        mesh = make_local_mesh(model, device_type="cpu")
        dq = shd.shard_tree(q, shd.params_shardings(q, mesh))
        got = dequantize_tree(dq, torch.float32)
        q_leaves = [t for t in leaves(dq) if t.dtype == torch.int8]
        out[tuple(mesh.shape)] = {
            "equal": [torch.equal(a, b.full_tensor()) for a, b in zip(leaves(want), leaves(got))],
            "placed": [tuple(g.placements) == tuple(t.placements)
                       for g, t in zip(leaves(got), q_leaves)],
            "embed_split": (tuple(dq["embed"]["__q__"].placements),
                            tuple(dq["embed"]["__s__"].placements))}
    return out


def check_serve(rank, world):
    """Per model: the prefill of 4 prompts of 24 tokens, then DECODE_STEPS
    greedy steps, on DTensor params, caches and tokens on a (2, 2) mesh
    against the unsharded serve: grok-1 and the 16-expert maverick from
    int8 weights (caches of 256 positions, split over 'model'), gemma3-1b
    on its rings of 8 slots and global caches of 40: the worst logits
    error as a fraction of their scale, whether the greedy tokens agree."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.nn.quant import quantize_tree

    maverick16 = dataclasses.replace(_config(ARCHS[1]), moe_experts=16)
    out = {}
    for name, cfg, int8, max_len in (("grok-1-314b", _config(ARCHS[0]), True, 256),
                                     ("maverick16", maverick16, True, 256),
                                     ("gemma3-1b", _config("gemma3-1b"), False, 40)):
        api = get_api(cfg, "cpu")
        params = api.init(cfg, torch.Generator().manual_seed(11))
        params = quantize_tree(params) if int8 else params
        rng = np.random.default_rng(12)
        prompt = {"tokens": rng.integers(0, cfg.vocab, (4, 24)).astype(np.int64)}
        mesh = make_local_mesh(2, device_type="cpu")
        dparams = shd.shard_tree(params, shd.params_shardings(params, mesh))
        state = api.make_serve_state(cfg, 4, max_len)
        dstate = shd.shard_tree(state, shd.serve_state_specs(state, mesh))
        errs, same = [], True
        with torch.no_grad():
            l0, state = api.prefill(params, prompt, state, cfg)
            with mesh, implicit_replication():
                l1, dstate = api.prefill(dparams, shd.shard_tree(
                    prompt, shd.batch_specs(prompt, mesh)), dstate, cfg)
            for step in range(DECODE_STEPS + 1):
                errs.append(_err(l0, l1))
                tok0 = l0[:, -1].argmax(-1)
                tok1 = l1.full_tensor()[:, -1].argmax(-1)
                same = same and torch.equal(tok0, tok1)
                if step == DECODE_STEPS:
                    break
                tok = {"tokens": tok0[:, None]}
                l0, state = api.decode(params, state, tok, 24 + step, cfg)
                with mesh, implicit_replication():
                    l1, dstate = api.decode(dparams, dstate, shd.shard_tree(
                        tok, shd.batch_specs(tok, mesh)), 24 + step, cfg)
        leaf = dparams["blocks"][-1]["moe"]["w_up"]["__q__"] if int8 else dparams["embed"]
        out[name] = {"errs": errs, "tokens_equal": same, "dtensor": isinstance(leaf, DTensor),
                     "rings": isinstance(state, list)}
    return out


def check_uneven_kv_train_step(rank, world):
    """internvl2-2b reduced (4 q heads, 2 KV heads; 8 patches ahead of 32
    tokens) on a (1, 4) mesh: the q heads split over 'model', the KV heads
    do not, as internvl2-2b's 16 / 8 on 16.  The sharded and the
    unsharded loss and grads; the placements of q as it reaches
    ``_attend_local`` and the local head counts it attends."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.nn import attention
    from repro_torch.optim import optimizers as opt
    from repro_torch.tree import leaves

    cfg = _config("internvl2-2b")
    seen = []
    attend_local = attention._attend_local

    def spied(attend, qh, kh, vh, q_pos):
        def local(ql, kl, vl, pos):
            seen.append((tuple(qh.placements), ql.shape[1], kl.shape[1]))
            return attend(ql, kl, vl, pos)
        return attend_local(local, qh, kh, vh, q_pos)

    attention._attend_local = spied
    api = get_api(cfg, "cpu")
    batch = _batch(cfg, 13)
    batch["patches"] = np.random.default_rng(15).standard_normal(
        (4, cfg.n_patches, cfg.d_model)).astype(np.float32)
    plain = train.trainable(api.init(cfg, torch.Generator().manual_seed(14)))
    mesh = make_local_mesh(4, device_type="cpu")
    pshard = shd.params_shardings(plain, mesh)
    params = train.trainable(shd.shard_tree(plain, pshard))
    dbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh))
    loss_fn = lambda p, b: api.loss_fn(p, b, cfg)  # noqa: E731
    l0, _, g0 = opt.accumulate_grads(loss_fn, plain, batch, 1)
    with mesh, implicit_replication():
        l1, _, g1 = opt.accumulate_grads(loss_fn, params, dbatch, 1, grad_shardings=pshard)
    attention._attend_local = attend_local
    return {"heads": (cfg.n_heads, cfg.n_kv, tuple(mesh.shape)),
            "loss": (float(l0), _value(l1)),
            "grad_err": max(_err(a, b) for a, b in zip(leaves(g0), leaves(g1))),
            "wq_placements": tuple(params["blocks"][0]["attn"]["wq"].placements),
            "seen": seen}


CHECKS = {
    "moe_train": check_moe_train_step,
    "aux_trap": check_aux_loss_trap,
    "dequantize": check_dequantize_shards,
    "serve": check_serve,
    "uneven_kv": check_uneven_kv_train_step,
}


def _norms_from_numpy(tree, rng):
    """Norm scales (every leaf named ln* or *norm) drawn around 1, as
    ``tests/test_torch_train.py`` draws them."""
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _norms_from_numpy(leaf, rng)
        elif name.startswith("ln") or name.endswith("norm"):
            tree[name] = rng.normal(1, 0.2, leaf.shape).astype(np.float32)


def _reference(arch):
    """The JAX package's reduced config and weights."""
    jax = pytest.importorskip("jax")
    from repro.configs.registry import get_config as ref_get_config
    from repro.configs.registry import reduced as ref_reduced
    from repro.models.registry import get_api as ref_get_api

    ref_cfg = ref_reduced(ref_get_config(arch), **SMALL)
    params = jax.tree.map(np.array, ref_get_api(ref_cfg).init(ref_cfg, jax.random.key(0)))
    _norms_from_numpy(params, np.random.default_rng(0))
    return ref_cfg, params


@pytest.fixture(scope="module")
def weights():
    from repro_torch.models import lm
    out = {}
    for arch in ARCHS:
        ref_cfg, ref_params = _reference(arch)
        out[arch] = (ref_cfg, ref_params, lm.params_from_reference(
            ref_params, _config(arch), "cpu"))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    out_dir = tmp_path_factory.mktemp("mesh_moe")
    for arch, (_, _, params) in weights.items():
        torch.save(params, os.path.join(out_dir, f"weights_{arch}.pt"))
    return run_ranks(WORLD, CHECKS, out_dir)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_moe_loss_matches_jax(weights, arch):
    """The unsharded step's loss and aux loss on the JAX package's weights
    against its ``loss_fn``: the mesh tests below hold the sharded step
    to this one."""
    import jax
    from repro.models.registry import get_api as ref_get_api
    from repro_torch.models.registry import get_api

    ref_cfg, ref_params, params = weights[arch]
    cfg = _config(arch)
    batch = _batch(cfg, 7)
    want, want_m = ref_get_api(ref_cfg).loss_fn(
        jax.tree.map(jax.numpy.asarray, ref_params),
        {k: jax.numpy.asarray(v.astype(np.int32)) for k, v in batch.items()}, ref_cfg)
    with torch.no_grad():
        got, got_m = get_api(cfg, "cpu").loss_fn(params, batch, cfg)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(got_m["aux"]), float(want_m["aux"]), rtol=LOSS_TOL)
    assert float(got_m["aux"]) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_step_matches_the_unsharded_step(ranks, arch):
    for out in result(ranks, "moe_train"):
        got = out[arch]
        for a, b in (got["loss"], got["aux"], got["step_loss"]):
            np.testing.assert_allclose(b, a, rtol=LOSS_TOL)
        assert got["grad_err"] <= GRAD_TOL and got["param_err"] <= GRAD_TOL
        assert got["grad_placed"] and got["all_dtensor"]
        # [E, d, f]: d over 'data' (FSDP), f over 'model'
        assert got["expert_placements"] == (Shard(1), Shard(2))


def test_aux_loss_spans_every_ranks_rows(ranks):
    """The sharded aux loss is the whole batch's under each dispatch form;
    each data rank's rows alone give another, so neither their sum nor
    their mean is it."""
    for out in result(ranks, "aux_trap"):
        whole = out["einsum"]["aux"][0]
        for form in ("einsum", "scatter", "ragged"):
            got = out[form]
            np.testing.assert_allclose(got["aux"][1], got["aux"][0], rtol=LOSS_TOL)
            assert got["y_err"] <= 1e-5 and got["y_placements"] == (Shard(0), Shard(1))
        a, b = out["per_rank"]
        assert abs(a - b) > 1e-3 * whole
        for wrong in (a + b, (a + b) / 2):
            assert abs(wrong - whole) > 100 * LOSS_TOL * whole


def test_dequantize_tree_on_dtensors_is_bit_for_bit(ranks):
    for out in result(ranks, "dequantize"):
        for got in out.values():
            assert len(got["equal"]) == 1 + 2 * 3 and all(got["equal"])
            assert all(got["placed"])
        # the table's vocab rows over 'model' for its values; on (1, 4) its
        # scales' row of 1 splits its columns there instead
        assert out[(2, 2)]["embed_split"] == ((Replicate(), Shard(0)), (Replicate(), Replicate()))
        assert out[(1, 4)]["embed_split"] == ((Replicate(), Shard(0)), (Replicate(), Shard(1)))


@pytest.mark.parametrize("name", ["grok-1-314b", "maverick16", "gemma3-1b"])
def test_serve_on_dtensors_matches_the_unsharded_serve(ranks, name):
    """Each rank writes the cache positions it holds (``nn.attention._put``):
    DTensor's own indexed write into a cache split over its positions
    lands in a copy, and the cache stays empty."""
    for out in result(ranks, "serve"):
        got = out[name]
        assert got["dtensor"] and len(got["errs"]) == DECODE_STEPS + 1
        assert got["rings"] == (name == "gemma3-1b")
        assert max(got["errs"]) <= SERVE_TOL, got["errs"]
        assert got["tokens_equal"]


def test_q_heads_stay_split_where_only_the_kv_heads_are_uneven(ranks):
    for out in result(ranks, "uneven_kv"):
        assert out["heads"] == (4, 2, (1, 4))
        np.testing.assert_allclose(out["loss"][1], out["loss"][0], rtol=LOSS_TOL)
        assert out["grad_err"] <= GRAD_TOL
        assert out["wq_placements"] == (Shard(0), Shard(1))
        # every attention call: q head-split over 'model', one q head and
        # the one KV head it reads on each rank
        assert out["seen"] and all(s == ((Shard(0), Shard(1)), 1, 1) for s in out["seen"])
