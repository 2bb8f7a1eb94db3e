"""Squeeze-and-excitation in the plain reference, on the CPU.

The ``scale`` join and the ``sigmoid`` and ``silu`` activations against
hand-written formulas; a slice of EfficientNetV2 (Tan & Le,
arXiv:2104.00298, Table 4) at 32x32 held against a forward written here
on the same weights; its work counts; malformed joins; and the slice's
configuration and layer list dropped into a copy of ``portbench/`` as new
files, found by name with no other edit.
"""
import json
import math
import shutil

import pytest
import torch
import torch.nn.functional as F

from portbench import harness, work
from portbench.reference import net
from portbench.tests.smallcell import MANIFEST, ROOT

# A configuration's layer list as a later configuration brings it:
# reference/<reference>.py with ``layers(config)``.
SLICE_REFERENCE = '''\
"""A slice of EfficientNetV2 (arXiv:2104.00298, Table 4): the stem, one
Fused-MBConv and one MBConv with squeeze-and-excitation (its width a
share of the block's input channels), each of stride 1 with its
residual, and the 1x1 head; SiLU throughout."""
from portbench.reference.net import layer


def layers(config):
    hw, c = tuple(config["input_hw"]), config["channels"]
    e, head = c * config["expansion"], config["head_channels"]
    se = max(1, int(c * config["se_ratio"]))
    out = [layer("stem", "conv", [], config["in_channels"], c, hw, 3, 2, "silu")]
    hw = out[0]["out_hw"]
    return out + [
        layer("f1_expand", "conv", ["stem"], c, e, hw, 3, 1, "silu"),
        layer("f1_project", "pointwise", ["f1_expand"], e, c, hw),
        layer("f1_add", "add", ["f1_project", "stem"], c, c, hw),
        layer("m1_expand", "pointwise", ["f1_add"], c, e, hw, act="silu"),
        layer("m1_dw", "dwconv", ["m1_expand"], e, e, hw, 3, 1, "silu"),
        layer("m1_se_gap", "gap", ["m1_dw"], e, e, hw),
        layer("m1_se_reduce", "dense", ["m1_se_gap"], e, se, (1, 1), act="silu"),
        layer("m1_se_expand", "dense", ["m1_se_reduce"], se, e, (1, 1),
              act="sigmoid"),
        layer("m1_se_scale", "scale", ["m1_dw", "m1_se_expand"], e, e, hw),
        layer("m1_project", "pointwise", ["m1_se_scale"], e, c, hw),
        layer("m1_add", "add", ["m1_project", "f1_add"], c, c, hw),
        layer("head", "pointwise", ["m1_add"], c, head, hw, act="silu"),
        layer("gap", "gap", ["head"], head, head, hw),
        layer("fc", "dense", ["gap"], head, config["num_classes"], (1, 1)),
    ]
'''
SLICE_CONFIG = {
    "family": "efficientnet_v2", "reference": "efficientnet_v2_slice",
    "source": "https://arxiv.org/abs/2104.00298", "input_hw": [32, 32],
    "in_channels": 3, "num_classes": 10, "channels": 24, "expansion": 4,
    "se_ratio": 0.25, "head_channels": 128, "dtype": "float32", "tf32": False,
    "limits": {"logit_err": 5e-4}}
CELL = "efficientnet_v2_slice.offline.r3.b64"
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def slice_root(tmp_path_factory):
    """A copy of the benchmark with the slice's configuration, layer list and
    a cell naming them added as new files."""
    root = tmp_path_factory.mktemp("gated")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = root / "portbench"
    (pb / "configs" / "efficientnet_v2_slice.json").write_text(json.dumps(SLICE_CONFIG))
    (pb / "reference" / "efficientnet_v2_slice.py").write_text(SLICE_REFERENCE)
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "efficientnet_v2_slice",
                         "source": SLICE_CONFIG["source"],
                         "file": "portbench/configs/efficientnet_v2_slice.json",
                         "reduced": [], "why": "squeeze-and-excitation"})
    m["workloads"].append({"name": CELL, "config": "efficientnet_v2_slice",
                           "traffic": "offline.r3.b64", "chips": 1, "why": "SE"})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.fixture(scope="module")
def slice_layers(slice_root):
    cell = harness.resolve_cell(slice_root, harness.load_manifest(slice_root), CELL)
    return harness.layers_of(slice_root, cell.config)


def weights_and_frames(layers):
    gen = torch.Generator().manual_seed(SEED)
    params = harness.make_weights(torch, layers, gen, "cpu", torch.float32)
    return params, torch.randn((4, 32, 32, 3), generator=gen)


def _same(x, k, s):
    """TensorFlow's SAME padding: the odd pixel after the image."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        total = max(0, (math.ceil(size / s) - 1) * s + k - size)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def by_hand(p, x):
    """The slice's forward written out, on ``net``'s weight layouts."""
    def conv(v, name, s=1, groups=1):
        w = p[name]["w"]
        return F.conv2d(_same(v, w.shape[0], s), w.permute(3, 2, 0, 1), p[name]["b"],
                        stride=s, groups=groups)

    def pointwise(v, name):
        return torch.einsum("nchw,cd->ndhw", v, p[name]["w"]) + p[name]["b"][:, None, None]

    def dense(v, name):
        return F.linear(v, p[name]["w"].t(), p[name]["b"])

    stem = F.silu(conv(x.permute(0, 3, 1, 2), "stem", 2))
    f1 = pointwise(F.silu(conv(stem, "f1_expand")), "f1_project") + stem
    dw = F.silu(conv(F.silu(pointwise(f1, "m1_expand")), "m1_dw", groups=96))
    squeeze = F.silu(dense(dw.mean(dim=(2, 3)), "m1_se_reduce"))
    gate = torch.sigmoid(dense(squeeze, "m1_se_expand"))
    m1 = pointwise(dw * gate[:, :, None, None], "m1_project") + f1
    return dense(F.silu(pointwise(m1, "head")).mean(dim=(2, 3)), "fc")


SCALE = net.layer("m1_se_scale", "scale", ["m1_dw", "m1_se_expand"], 5, 5, (3, 3))


def test_scale_is_the_map_times_its_channels_gate():
    gen = torch.Generator().manual_seed(SEED)
    fmap, gate = torch.randn((2, 5, 3, 3), generator=gen), torch.randn((2, 5), generator=gen)
    want = torch.empty_like(fmap)
    for n in range(2):
        for c in range(5):
            want[n, c] = fmap[n, c] * gate[n, c]
    assert torch.equal(net._layer_forward(SCALE, [fmap, gate], None), want)
    assert SCALE["in_hw"] == SCALE["out_hw"] == (3, 3)
    assert "scale" not in net.WEIGHTED


@pytest.mark.parametrize("act, formula", [
    ("sigmoid", lambda x: 1 / (1 + torch.exp(-x))),
    ("silu", lambda x: x / (1 + torch.exp(-x))),
])
def test_sigmoid_and_silu(act, formula):
    x = torch.randn(100_003, generator=torch.Generator().manual_seed(SEED)) * 6
    got = net._ACT[act](x)
    # the formula, computed in float64: the CPU's vectorized kernels round
    # within 2 ulp of it (1.3e-7 and 1.5e-7 relative on these inputs)
    torch.testing.assert_close(got.double(), formula(x.double()), rtol=2 ** -21, atol=0)


def test_slice_matches_a_forward_written_by_hand(slice_layers):
    params, x = weights_and_frames(slice_layers)
    got = net.forward(slice_layers, params, x)
    want = by_hand(params, x)
    assert got.shape == (4, 10)
    # Both sides are float32 with TF32 off (there is none on the CPU, and
    # net.forward turns it off on a card); only the order of the sums
    # differs, which moves a logit by a few ulp of the largest.
    assert harness.logit_err(got, want) < 1e-6
    # the gate counts: the map passed to the projection ungated moves the
    # logits past 5e-4, the widest limit a configuration has
    no_se = [dict(lay, inputs=["m1_dw"]) if lay["name"] == "m1_project" else lay
             for lay in slice_layers if not lay["name"].startswith("m1_se_")]
    assert harness.logit_err(net.forward(no_se, params, x), got) > 5e-4


def test_slice_work_counts(slice_layers):
    by_name = {lay["name"]: lay for lay in slice_layers}
    assert work.macs(by_name["m1_se_scale"]) == work.weights(by_name["m1_se_scale"]) == 0
    assert work.UNIT.get("scale") is None
    fcu = {lay["name"]: work.macs(lay) for lay in slice_layers
           if work.UNIT.get(lay["kind"]) == "fcu"}
    hw = 16 * 16
    assert fcu == {"f1_project": 96 * 24 * hw, "m1_expand": 24 * 96 * hw,
                   "m1_se_reduce": 96 * 6, "m1_se_expand": 6 * 96,
                   "m1_project": 96 * 24 * hw, "head": 24 * 128 * hw, "fc": 128 * 10}
    kpu = 9 * 3 * 24 * hw + 9 * 24 * 96 * hw
    total = sum(work.macs(lay) for lay in slice_layers)
    assert total == kpu + sum(fcu.values()) + 9 * 96 * hw
    assert work.frame_flops(slice_layers) == 2 * total


def _zeros(*shape):
    return torch.zeros(shape)


@pytest.mark.parametrize("xs", [
    [_zeros(2, 5, 9), _zeros(2, 5)],                   # the map is not 4-D
    [_zeros(2, 5, 3, 3), _zeros(2, 5, 1)],             # the gate is not 2-D
    [_zeros(2, 5, 3, 3), _zeros(2, 4)],                # the channels disagree
    [_zeros(2, 5, 3, 3)],                              # one operand
    [_zeros(2, 5, 3, 3), _zeros(2, 5), _zeros(2, 5)],  # three
], ids=["map-3d", "gate-3d", "channels", "one-operand", "three-operands"])
def test_a_malformed_scale_raises_naming_the_layer(xs):
    with pytest.raises(ValueError, match="m1_se_scale"):
        net._layer_forward(SCALE, xs, None)


def test_unknown_kinds_and_activations_still_raise(slice_layers):
    params, x = weights_and_frames(slice_layers)
    for bad, error in ((dict(kind="gate"), ValueError), (dict(act="gelu"), KeyError)):
        layers = [dict(lay, **bad) if lay["name"] == "m1_se_scale" else lay
                  for lay in slice_layers]
        with pytest.raises(error, match="m1_se_scale" if error is ValueError else "gelu"):
            net.forward(layers, params, x)
    one = [dict(lay, inputs=["m1_dw"]) if lay["name"] == "m1_se_scale" else lay
           for lay in slice_layers]
    with pytest.raises(ValueError, match="m1_se_scale"):
        net.forward(one, params, x)


def test_slice_found_as_new_files(slice_root, slice_layers):
    """The slice's configuration, layer list and cell are new files and a
    manifest entry; the harness finds them by name and the reference runs
    them, its SE blocks included, with no other edit."""
    assert not (ROOT / "portbench" / "reference" / "efficientnet_v2_slice.py").exists()
    cell = harness.resolve_cell(slice_root, harness.load_manifest(slice_root), CELL)
    assert cell.config == SLICE_CONFIG
    assert [lay["kind"] for lay in slice_layers].count("scale") == 1
    params, x = weights_and_frames(slice_layers)
    assert set(params) == {lay["name"] for lay in slice_layers
                           if lay["kind"] in net.WEIGHTED}
    assert params["m1_se_reduce"]["w"].shape == (96, 6)
    logits = net.forward(slice_layers, params, x)
    assert logits.shape == (4, 10) and torch.isfinite(logits).all()
    # the control's path: weights and frames from a seed, the reference
    # run two ways over the frames a run sends (here float64 against f32)
    cell.traffic.update(batch=8, pool_batches=2)
    reading = harness.control_reading(cell, SEED, "cpu", dtype=torch.float64)
    assert 0 < reading < 1e-6
