"""ResNet's layer list, from He et al., arXiv:1512.03385, Table 1.

``layers(config)`` reads the stem, the stages ``[[channels, blocks], ...]``
and the head from a configuration file and lists every layer as a dict
(see ``net.py``).  A stage's first block strides by 2 (but the first
stage's, which follows the max pool); a block whose shape changes takes a
strided 1x1 projection as its shortcut (the paper's option B).  Batch
norm is folded into each conv's bias.  Layer names are the port's node
names, so one weight dict serves both sides.

Plain Python: the reference takes nothing of the program.
"""
from portbench.reference.net import layer as _layer


def layers(config):
    stem = config["stem"]
    hw = tuple(config["input_hw"])
    d = config["in_channels"]
    out = [_layer("conv1", "conv", [], d, stem["channels"], hw, stem["kernel"],
                  stem["stride"], "relu")]
    hw, d = out[-1]["out_hw"], stem["channels"]
    out.append(_layer("maxpool", "pool", ["conv1"], d, d, hw, stem["pool_kernel"],
                      stem["pool_stride"]))
    hw, prev = out[-1]["out_hw"], "maxpool"
    for si, (ch, blocks) in enumerate(config["stages"], start=1):
        for bi in range(1, blocks + 1):
            stride = 2 if si > 1 and bi == 1 else 1
            name = f"l{si}b{bi}"
            out.append(_layer(f"{name}_conv1", "conv", [prev], d, ch, hw, 3, stride,
                              "relu"))
            mid = out[-1]["out_hw"]
            out.append(_layer(f"{name}_conv2", "conv", [f"{name}_conv1"], ch, ch,
                              mid, 3, 1))
            shortcut = prev
            if stride != 1 or d != ch:
                out.append(_layer(f"{name}_down", "conv", [prev], d, ch, hw, 1,
                                  stride))
                shortcut = f"{name}_down"
            out.append(_layer(f"{name}_add", "add", [f"{name}_conv2", shortcut],
                              ch, ch, mid, act="relu"))
            hw, d, prev = mid, ch, f"{name}_add"
    out.append(_layer("gap", "gap", [prev], d, d, hw))
    out.append(_layer("fc", "dense", ["gap"], d, config["num_classes"], (1, 1)))
    return out
