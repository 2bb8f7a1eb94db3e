"""The port's pure dry-run functions against the JAX package's, exactly.

``configs/shapes.py`` (``SHAPES``, ``cell_enabled``, ``skip_reason``),
``core/flops.py`` (``step_flops``, ``scan_trips``, ``step_hbm_bytes`` at
three meshes, ``graph_macs``, ``graph_weight_count``, ``chain_macs``) and
``launch/dryrun.py::model_flops``, for every shipped config and every
shape suite, and the four CNN families' graphs.
"""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs import shapes as ref_shapes  # noqa: E402
from repro.core import flops as ref_flops  # noqa: E402
from repro.models.registry import get_cnn_api as ref_cnn_api  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.configs.registry import ARCHS  # noqa: E402
from repro_torch.core import flops  # noqa: E402
from repro_torch.launch.dryrun import model_flops  # noqa: E402
from repro_torch.models.registry import make_cnn_config  # noqa: E402

MESHES = ((16, 1), (16, 16), (32, 16))      # (n_data, n_model)
CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(shapes.SHAPES)]


def _ref_model_flops():
    """The reference's ``model_flops``.  Its module forces 512 host devices
    through ``XLA_FLAGS`` when imported; the variable is put back at once
    so that nothing else in this process sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops as ref
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref


def test_shape_suites_are_the_references():
    assert sorted(shapes.SHAPES) == sorted(ref_shapes.SHAPES)
    for name, suite in shapes.SHAPES.items():
        assert dataclasses.asdict(suite) == dataclasses.asdict(ref_shapes.SHAPES[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_functions_are_the_references(arch, shape):
    cfg, ref_cfg = ARCHS[arch], REF_ARCHS[arch]
    suite, ref_suite = shapes.SHAPES[shape], ref_shapes.SHAPES[shape]
    assert shapes.cell_enabled(cfg, suite) == ref_shapes.cell_enabled(ref_cfg, ref_suite)
    assert shapes.skip_reason(cfg, suite) == ref_shapes.skip_reason(ref_cfg, ref_suite)
    assert flops.step_flops(cfg, suite) == ref_flops.step_flops(ref_cfg, ref_suite)
    assert flops.scan_trips(cfg, suite) == ref_flops.scan_trips(ref_cfg, ref_suite)
    assert model_flops(cfg, suite) == _ref_model_flops()(ref_cfg, ref_suite)
    for n_data, n_model in MESHES:
        assert (flops.step_hbm_bytes(cfg, suite, n_model, n_data)
                == ref_flops.step_hbm_bytes(ref_cfg, ref_suite, n_model, n_data))


@pytest.mark.parametrize("family", ["mobilenet_v1", "mobilenet_v2", "resnet18", "resnet34"])
def test_graph_counts_are_the_references(family):
    graph = make_cnn_config(family).graph()
    api = ref_cnn_api(family)
    ref_graph = api.graph(api.make_config())
    assert flops.graph_macs(graph) == ref_flops.graph_macs(ref_graph)
    assert flops.graph_weight_count(graph) == ref_flops.graph_weight_count(ref_graph)
    chain = [graph.spec(n) for n in graph.topo_order()]
    ref_chain = [ref_graph.spec(n) for n in ref_graph.topo_order()]
    assert flops.chain_macs(chain) == ref_flops.chain_macs(ref_chain) > 0
