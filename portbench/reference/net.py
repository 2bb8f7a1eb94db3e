"""The plain reference: a CNN's layer list run in plain PyTorch.

A layer is a dict: ``name``, ``kind`` (``conv``, ``dwconv``,
``pointwise``, ``dense``, ``pool``, ``gap``, ``add``, ``scale``),
``inputs`` (the names it reads; none for the first), ``d_in``, ``d_out``,
``k``, ``stride``, ``act`` (``none``, ``relu``, ``relu6``, ``sigmoid``,
``silu``), ``in_hw`` and ``out_hw``.  ``scale`` is squeeze-and-excitation's
join: ``inputs = [map, gate]``, a ``[N, C, H, W]`` map times a ``[N, C]``
gate (what ``gap`` and ``dense`` give) broadcast over the pixels, with no
weights; its ``d_in``, ``d_out``, ``in_hw`` and ``out_hw`` are the map's.
Frames are NHWC.  Weights are ``{name: {"w", "b"}}`` in the
layouts ``weight_shape`` gives (HWIO convs, ``[k, k, 1, C]`` depthwise,
``[d_in, d_out]`` pointwise and dense); the benchmark makes them and hands
the same tensors to the program.

Convs and the max pool pad by TensorFlow's SAME rule, which puts the odd
pixel of padding after the image (ResNet's 7x7/2 stem at 224 pads 2 before
and 3 after; torchvision pads 3 and 3): the port follows the same rule.
The max pool pads with -inf.  The forward runs on the weights' device in
float32 with TF32 off unless the caller asks otherwise; it imports
nothing of the program.
"""
import contextlib

import torch
import torch.nn.functional as F


def layer(name, kind, inputs, d_in, d_out, hw, k=1, stride=1, act="none"):
    out_hw = (1, 1) if kind == "gap" else tuple(-(-d // stride) for d in hw)
    return {"name": name, "kind": kind, "inputs": list(inputs), "d_in": d_in,
            "d_out": d_out, "k": k, "stride": stride, "act": act,
            "in_hw": tuple(hw), "out_hw": out_hw}


WEIGHTED = ("conv", "dwconv", "pointwise", "dense")


def weight_shape(lay):
    k = lay["k"]
    if lay["kind"] == "conv":
        return (k, k, lay["d_in"], lay["d_out"])
    if lay["kind"] == "dwconv":
        return (k, k, 1, lay["d_out"])
    return (lay["d_in"], lay["d_out"])


def fan_in(lay):
    k2 = lay["k"] * lay["k"]
    return {"conv": k2 * lay["d_in"], "dwconv": k2}.get(lay["kind"], lay["d_in"])


def _same(size, k, s):
    total = max(0, (-(-size // s) - 1) * s + k - size)
    return total // 2, total - total // 2


def _pad(x, k, s, fill=0.0):
    top, bottom = _same(x.shape[2], k, s)
    left, right = _same(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom), value=fill)


_ACT = {"none": lambda x: x, "relu": torch.relu,
        "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
        "sigmoid": torch.sigmoid, "silu": F.silu}


def _scale(lay, xs):
    if len(xs) != 2:
        raise ValueError(f"{lay['name']}: scale takes [map, gate], got {len(xs)} "
                         "operands")
    fmap, gate = xs
    if fmap.dim() != 4 or gate.dim() != 2:
        raise ValueError(f"{lay['name']}: scale takes a 4-D map and a 2-D gate, got "
                         f"{tuple(fmap.shape)} and {tuple(gate.shape)}")
    if tuple(gate.shape) != tuple(fmap.shape[:2]):
        raise ValueError(f"{lay['name']}: the gate {tuple(gate.shape)} is not the "
                         f"map's [N, C] {tuple(fmap.shape[:2])}")
    return fmap * gate[:, :, None, None]


def _layer_forward(lay, xs, p):
    kind, k, s = lay["kind"], lay["k"], lay["stride"]
    x = xs[0]
    if p is not None:
        p = {key: v.to(x.dtype) for key, v in p.items()}
    if kind == "conv":
        y = F.conv2d(_pad(x, k, s), p["w"].permute(3, 2, 0, 1), stride=s)
    elif kind == "dwconv":
        y = F.conv2d(_pad(x, k, s), p["w"].permute(3, 2, 0, 1), stride=s,
                     groups=lay["d_in"])
    elif kind == "pointwise":
        y = F.conv2d(x, p["w"].t()[:, :, None, None])
    elif kind == "dense":
        y = x @ p["w"]
    elif kind == "pool":
        y = F.max_pool2d(_pad(x, k, s, -float("inf")), k, s)
    elif kind == "gap":
        y = x.mean(dim=(2, 3))
    elif kind == "add":
        y = xs[0] + xs[1]
    elif kind == "scale":
        y = _scale(lay, xs)
    else:
        raise ValueError(f"{lay['name']}: no reference for kind {kind!r}")
    if kind in WEIGHTED:
        y = y + (p["b"] if y.dim() == 2 else p["b"][None, :, None, None])
    return _ACT[lay["act"]](y)


@contextlib.contextmanager
def tf32(on):
    """TF32 in cuBLAS and cuDNN on or off inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@torch.no_grad()
def forward(layers, params, x, *, tf32_on=False, dtype=torch.float32):
    """Logits [N, classes] of NHWC frames ``x`` in ``dtype`` (TF32 off
    unless ``tf32_on``), every tensor dropped once its last reader has
    run."""
    last_use = {}
    for i, lay in enumerate(layers):
        for name in lay["inputs"]:
            last_use[name] = i
    values = {}
    with tf32(tf32_on):
        for i, lay in enumerate(layers):
            xs = ([values[n] for n in lay["inputs"]] if lay["inputs"]
                  else [x.to(dtype).permute(0, 3, 1, 2)])
            values[lay["name"]] = _layer_forward(lay, xs, params.get(lay["name"]))
            for n in lay["inputs"]:
                if last_use[n] == i:
                    del values[n]
    return values[layers[-1]["name"]]
