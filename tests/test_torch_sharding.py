"""The port's sharding rules against the JAX package's, in one process.

The rules read only a mesh's axis names and sizes, so both packages run
on a stand-in mesh (``axis_names`` and ``devices.shape``, no devices) at
the production sizes (16, 16) and (2, 16, 16) and at (2, 2) and (1, 4).
The reference's trees come from ``jax.eval_shape``, the port's are built
under ``FakeTensorMode`` (no memory), every shipped config at full size,
float and (grok-1 and internvl2-2b, two of the ``serve_weight_quant``
configs) ``quantize_tree``'s int8 leaves.  The reference stacks layers ``[L, ...]`` where the port
keeps per-layer lists: a stacked reference leaf is compared with its
per-layer shape and its spec without the leading (stack) entry.  Specs
are equal exactly, leaf for leaf.  The reference's ``NamedSharding`` is
replaced by its spec, since a stand-in mesh is no ``jax`` mesh.
"""
import collections
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.launch.train import adam_config_for as ref_adam_config_for  # noqa: E402
from repro.models.registry import get_api as ref_get_api  # noqa: E402
from repro.nn.quant import quantize_tree as ref_quantize_tree  # noqa: E402
from repro.optim import optimizers as ref_opt  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.train import adam_config_for  # noqa: E402
from repro_torch.models.registry import get_api  # noqa: E402
from repro_torch.nn.quant import quantize_tree  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 4): ("data", "model")}
STACKS = ("blocks_dense", "blocks_moe", "blocks", "enc", "dec")
TREES = [(a, False) for a in sorted(ARCHS)] + [(a, True) for a in ("grok-1-314b",
                                                                  "internvl2-2b")]


def standin(shape):
    return types.SimpleNamespace(axis_names=MESHES[shape], devices=np.zeros(shape))


@pytest.fixture(autouse=True)
def ref_specs_only(monkeypatch):
    """The reference's tree functions give specs: a stand-in mesh is no
    ``jax.sharding.Mesh``."""
    monkeypatch.setattr(ref_shd, "NamedSharding", lambda mesh, spec: spec)


def _ref_tree(arch, quant):
    cfg = REF_ARCHS[arch]
    api = ref_get_api(cfg)
    init = (lambda: ref_quantize_tree(api.init(cfg, jax.random.key(0)))) if quant else \
        (lambda: api.init(cfg, jax.random.key(0)))
    return jax.eval_shape(init)


def _port_tree(arch, quant):
    cfg = ARCHS[arch]
    with FakeTensorMode():
        params = get_api(cfg, "cpu").init(cfg, torch.Generator().manual_seed(0))
        return quantize_tree(params) if quant else params


_CACHE = {}


def _cached(key, build):
    """Trees are built once a test module run, each mesh reusing them."""
    if key not in _CACHE:
        _CACHE[key] = build()
    return _CACHE[key]


def _trees(arch, quant):
    return _cached((arch, quant), lambda: (_ref_tree(arch, quant), _port_tree(arch, quant)))


def _opt_states(arch):
    def build():
        ref_tree, port_tree = _trees(arch, False)
        ref_st = jax.eval_shape(
            lambda p: ref_opt.init(ref_adam_config_for(REF_ARCHS[arch]), p), ref_tree)
        with FakeTensorMode():
            port_st = opt.init(adam_config_for(ARCHS[arch]), port_tree)
        return ref_st, port_st
    return _cached(("opt", arch), build)


def _serve_states(arch, b, max_len):
    def build():
        cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
        ref_state = jax.eval_shape(lambda: ref_get_api(ref_cfg).make_serve_state(
            ref_cfg, b, max_len))
        with FakeTensorMode():
            state = get_api(cfg, "cpu").make_serve_state(cfg, b, max_len)
        return ref_state, state
    return _cached(("serve", arch, b, max_len), build)


def _ref_entries(tree, specs, stack_len):
    """{path with the stack's name and index dropped: Counter of (shape,
    spec)}, a stacked leaf at its per-layer shape and spec."""
    out = collections.defaultdict(collections.Counter)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for (path, leaf), spec in zip(leaves, spec_leaves):
        parts = ref_shd._named(path).split("/")
        head = 1 if parts[0] in ("mu", "nu") else 0
        shape, spec = tuple(leaf.shape), tuple(spec)
        if parts[head] in STACKS:
            if shape and shape[0] == stack_len[parts[head]]:
                shape, spec = shape[1:], spec[1:]
            parts[head] = "blocks" if parts[head].startswith("blocks") else parts[head]
        out["/".join(parts)][(shape, spec)] += 1
    return out


def _port_entries(tree, shardings):
    out = collections.defaultdict(collections.Counter)
    for (path, leaf, in_list), (_, s, _) in zip(shd._walk(tree), shd._walk(shardings)):
        parts = path.split("/")
        if in_list:          # drop the layer index under its list
            i = next(i for i, p in enumerate(parts) if p.isdigit())
            parts = parts[:i] + parts[i + 1:]
        out["/".join(parts)][(tuple(leaf.shape), tuple(s.spec))] += 1
    return {k: collections.Counter(set(v)) for k, v in out.items()}


def _stack_lens(ref_tree):
    return {k: jax.tree_util.tree_leaves(v)[0].shape[0]
            for k, v in ref_tree.items() if k in STACKS}


def _assert_same(port, ref):
    ref = {k: collections.Counter(set(v)) for k, v in ref.items()}
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k] == ref[k], (k, port[k], ref[k])


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch,quant", TREES, ids=[f"{a}{'-int8' if q else ''}"
                                                   for a, q in TREES])
def test_param_specs_are_the_references_for_every_leaf(arch, quant, shape):
    ref_tree, port_tree = _trees(arch, quant)
    mesh = standin(shape)
    ref = _ref_entries(ref_tree, ref_shd.params_shardings(ref_tree, mesh),
                       _stack_lens(ref_tree))
    port = _port_entries(port_tree, shd.params_shardings(port_tree, mesh))
    _assert_same(port, ref)
    if quant:
        assert any("__s__" in k for k in port)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", ["qwen2-7b", "grok-1-314b", "mamba2-780m"])
def test_opt_state_specs_are_the_references(arch, shape):
    """The configs' AdamW states (qwen2: f32 moments; grok-1: factored, no
    momentum; mamba2: per-layer vectors) at full size."""
    ref_tree, port_tree = _trees(arch, False)
    ref_st, port_st = _opt_states(arch)
    mesh = standin(shape)
    ref = _ref_entries(ref_st, ref_shd.opt_state_shardings(ref_st, ref_tree, mesh),
                       _stack_lens(ref_tree))
    port = _port_entries(port_st, shd.opt_state_shardings(port_st, port_tree, mesh))
    _assert_same(port, ref)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serve_state_specs_are_the_references(arch, shape):
    """Every config's serve state at 8 slots of 4096 and at one slot of
    32768 (the batch-1 long-context rule): the (shape, spec) pairs are
    the reference's."""
    mesh = standin(shape)
    for b, max_len in ((8, 4096), (1, 32768)):
        ref_state, state = _serve_states(arch, b, max_len)
        ref_specs = jax.tree_util.tree_leaves(
            ref_shd.serve_state_specs(ref_state, mesh),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        want = sorted((tuple(x.shape), tuple(s)) for x, s in
                      zip(jax.tree_util.tree_leaves(ref_state), ref_specs))
        got = sorted((tuple(x.shape), tuple(s.spec)) for (_, x, _), (_, s, _) in
                     zip(shd._walk(state), shd._walk(shd.serve_state_specs(state, mesh))))
        assert got == want


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(map(str, s)))
def test_batch_specs_are_the_references(shape):
    mesh = standin(shape)
    for b in (1, 4, 8, 32, 256, 512):
        batch = {"tokens": np.zeros((b, 16), np.int32), "labels": np.zeros((b, 16), np.int32),
                 "frames": np.zeros((b, 13, 8), np.float32)}
        want = ref_shd.batch_specs(batch, mesh)
        got = shd.batch_specs({k: torch.as_tensor(v) for k, v in batch.items()}, mesh)
        assert {k: tuple(s.spec) for k, s in got.items()} == \
            {k: tuple(s) for k, s in want.items()}


def test_param_rules():
    """The reference's own rule table (``tests/distributed/test_sharding.py``)
    on a (1, 1) mesh, and the divisibility guard at production size."""
    mesh = standin((1, 4))
    one = types.SimpleNamespace(axis_names=("data", "model"), devices=np.zeros((1, 1)))
    P = shd.P
    cases = {
        "embed": ((1024, 64), P("model", None)),
        "blocks_dense/attn/wq": ((4, 64, 64), P(None, ("data",), "model")),
        "blocks_dense/attn/wo": ((4, 64, 64), P(None, "model", ("data",))),
        "blocks_dense/ffn/w_up": ((4, 64, 128), P(None, ("data",), "model")),
        "blocks_dense/ffn/w_down": ((4, 128, 64), P(None, "model", ("data",))),
        "blocks_moe/moe/w_up": ((4, 8, 64, 128), P(None, None, ("data",), "model")),
        "blocks_dense/ln1": ((64,), P()),
        "step": ((), P()),
    }
    for path, (shape, want) in cases.items():
        assert shd.param_spec(path, shape, one) == want, path
    assert P(None, ("data",), "model") == (None, "data", "model")
    fm = standin((16, 16))
    assert not shd._fits(92553, fm, "model")
    assert shd._fits(92544, fm, "model")
    assert not shd._fits(8, fm, "model")
    assert shd._fits(512, fm, ("data", "model"))
    assert shd.param_spec("blocks/attn/wq", (2048, 2048), mesh) == P("data", "model")


def test_placements_from_specs():
    big = standin((2, 16, 16))
    P = shd.P
    cases = {
        P(None, ("pod", "data"), "model"): (Shard(1), Shard(1), Shard(2)),
        P("model", None): (Replicate(), Replicate(), Shard(0)),
        P(): (Replicate(),) * 3,
        P(None, None, ("data", "model")): (Replicate(), Shard(2), Shard(2)),
        P(("pod", "data")): (Shard(0), Shard(0), Replicate()),
    }
    for spec, want in cases.items():
        assert shd.NamedSharding(big, spec).placements == want, spec
    with pytest.raises(ValueError, match="major-to-minor"):
        shd.NamedSharding(big, P(("model", "data"))).placements


def test_logical_spec_and_constrain_outside_a_mesh():
    """``constrain`` is the identity outside a mesh (the reference's
    ``test_constrain_noop_outside_mesh``); the logical table with its
    guard, on a stand-in mesh."""
    x = torch.ones((4, 8, 16))
    assert shd.constrain(x, ("batch", "seq", None)) is x
    P = shd.P
    assert shd.logical_spec((4, 8, 16), ("batch", "seq", None), standin((2, 2))) == \
        P("data", "model", None)
    assert shd.logical_spec((4, 8, 16), ("batch", "seq", None), standin((2, 16, 16))) == \
        P(None, None, None)
    assert shd.logical_spec((64, 32, 16), ("batch", None, "tp"), standin((2, 16, 16))) == \
        P(("pod", "data"), None, "model")
    assert shd.logical_spec((1, 8, 16), ("batch", "seq", None), standin((1, 4))) == \
        P(None, "model", None)
