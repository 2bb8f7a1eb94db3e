"""The plain reference and the yardstick's work counts, on the CPU.

The reference is held against the port's CPU path (the kernels' plain
versions) at a small input, and its layer lists against the port's graphs
and the papers' published counts.
"""
import json
from fractions import Fraction
from pathlib import Path

import pytest
import torch

from portbench import harness, work
from portbench.reference import net

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = ("resnet18", "mobilenet_v2")
# Published: ResNet-18 1.8 GMAC a frame (He et al., Table 1) and 11.7 M
# parameters (torchvision's count, batch norm folded here); MobileNetV2
# 300 M MACs and 3.4 M parameters (Sandler et al., Table 4).
PUBLISHED = {"resnet18": (1.8e9, 11.7e6), "mobilenet_v2": (300e6, 3.4e6)}


def config(name, **changes):
    c = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    c.update(changes)
    return c


@pytest.mark.parametrize("name", CONFIGS)
def test_layers_match_the_ports_graph(name):
    from repro_torch.models.registry import make_cnn_config

    c = config(name)
    graph = make_cnn_config(c["family"]).graph()
    port = []
    for node in graph.topo_order():
        s = graph.spec(node)
        k = None if s.kind == "gap" else s.kernel[0]  # the port's gap spans the map
        port.append((node, s.kind, list(graph.preds(node)), s.d_in, s.d_out,
                     k, s.stride[0], s.activation, s.in_hw))
    ours = [(lay["name"], lay["kind"], lay["inputs"], lay["d_in"], lay["d_out"],
             None if lay["kind"] == "gap" else lay["k"], lay["stride"], lay["act"],
             lay["in_hw"])
            for lay in harness.layers_of(ROOT, c)]
    assert ours == port


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_match_the_published(name):
    layers = harness.layers_of(ROOT, config(name))
    macs = sum(work.macs(lay) for lay in layers)
    params = sum(work.weights(lay) + lay["d_out"] for lay in layers
                 if lay["kind"] in net.WEIGHTED)
    want_macs, want_params = PUBLISHED[name]
    assert abs(macs / want_macs - 1) < 0.03
    assert abs(params / want_params - 1) < 0.03
    assert work.frame_flops(layers) == 2 * macs


def test_bound_and_units():
    lay = net.layer("c", "conv", [], 64, 64, (56, 56), 3, 1)
    flops = 2 * 9 * 64 * 64 * 56 * 56 * 8
    nbytes = 4 * (2 * 8 * 56 * 56 * 64 + 9 * 64 * 64)
    assert work.launch_bytes(lay, 8, 4) == nbytes
    assert work.launch_bound_s(lay, 8, 4) == max(flops / work.PEAK_FLOPS,
                                                 nbytes / work.PEAK_BYTES)
    layers = harness.layers_of(ROOT, config("mobilenet_v2"))
    kinds = {work.UNIT.get(lay["kind"]) for lay in layers}
    assert kinds == {"kpu", "fcu", "dw", None}
    kpu = [lay["name"] for lay in layers if work.UNIT.get(lay["kind"]) == "kpu"]
    assert kpu == ["conv1"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_ports_cpu_path(name):
    from repro_torch.models.registry import get_cnn_api

    c = config(name, input_hw=[32, 32])
    layers = harness.layers_of(ROOT, c)
    gen = torch.Generator().manual_seed(2 ** 33 + 5)
    params = harness.make_weights(torch, layers, gen, "cpu", torch.float32)
    x = torch.randn((4, 32, 32, 3), generator=gen)
    api = get_cnn_api(c["family"], "cpu")
    cfg = api.make_config(input_hw=(32, 32))
    got = api.apply(params, x, cfg, plan=api.plan(cfg, Fraction(3)))
    want = net.forward(layers, params, x)
    assert harness.logit_err(got, want) < 1e-5
    # each bias counts: leaving one out moves the logits past the limit
    params["fc"]["b"] = torch.zeros_like(params["fc"]["b"])
    assert harness.logit_err(net.forward(layers, params, x), want) > c["limits"]["logit_err"]


def test_logit_err():
    want = torch.tensor([[1.0, -2.0], [4.0, 0.5]])
    assert harness.logit_err(want.clone(), want) == 0.0
    got = want.clone()
    got[1, 1] += 0.04
    assert harness.logit_err(got, want) == pytest.approx(0.01)
    got[0, 0] = float("nan")
    assert harness.logit_err(got, want) == float("inf")
    assert harness.logit_err(want[:1], want) == float("inf")
