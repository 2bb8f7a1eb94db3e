"""MobileNetV2's layer list, from Sandler et al., arXiv:1801.04381, Table 2.

``layers(config)`` reads the stem, the bottleneck rows ``[[t, c, n, s],
...]`` (expansion, output channels, repeats, first stride), the last 1x1
conv and the head from a configuration file.  A bottleneck is a 1x1
expansion with ReLU6 (left out where t = 1), a 3x3 depthwise conv with
ReLU6 and a linear 1x1 projection; a block of stride 1 whose input and
output widths agree adds its input (the paper's Fig. 4).  Channels scale
by the width multiplier and round to a multiple of 8 (the paper's code);
the last conv keeps 1280 at multipliers up to 1.  Batch norm is folded
into each conv's bias.  Layer names are the port's node names.
"""
from portbench.reference.net import layer as _layer


def _channels(ch, alpha):
    ch = int(ch * alpha)
    return max(8, (ch + 4) // 8 * 8)


def layers(config):
    alpha = config["width_multiplier"]
    hw = tuple(config["input_hw"])
    d = _channels(config["stem_channels"], alpha)
    out = [_layer("conv1", "conv", [], config["in_channels"], d, hw, 3, 2, "relu6")]
    hw, prev, blk = out[-1]["out_hw"], "conv1", 0
    for t, c, n, s in config["bottlenecks"]:
        for i in range(n):
            blk += 1
            stride = s if i == 0 else 1
            block_in, exp, ch = prev, d * t, _channels(c, alpha)
            if t != 1:
                out.append(_layer(f"b{blk}_expand", "pointwise", [prev], d, exp, hw,
                                  act="relu6"))
                prev = f"b{blk}_expand"
            out.append(_layer(f"b{blk}_dw", "dwconv", [prev], exp, exp, hw, 3, stride,
                              "relu6"))
            hw = out[-1]["out_hw"]
            out.append(_layer(f"b{blk}_project", "pointwise", [f"b{blk}_dw"], exp, ch,
                              hw))
            prev = f"b{blk}_project"
            if stride == 1 and d == ch:
                out.append(_layer(f"b{blk}_add", "add", [prev, block_in], ch, ch, hw))
                prev = f"b{blk}_add"
            d = ch
    last = config["last_channels"]
    last = _channels(last, alpha) if alpha > 1.0 else last
    out.append(_layer("conv_last", "pointwise", [prev], d, last, hw, act="relu6"))
    out.append(_layer("gap", "gap", ["conv_last"], last, last, hw))
    out.append(_layer("fc", "dense", ["gap"], last, config["num_classes"], (1, 1)))
    return out
