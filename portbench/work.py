"""The yardstick's work counts and peaks.

Counted from the benchmark's own layer lists (``reference/``), never from
the program's plan or from what a kernel implements: the algorithm's work,
so that a later route of the same layer reads against the same bound.

- FLOPs: 2 x MACs.  The elementwise kinds (``pool``, ``gap``, ``add``,
  and squeeze-and-excitation's ``scale``) count no MACs, no weights and no
  model FLOPs, and have no unit; an SE block's two ``dense`` layers count
  as FCU work.
- Bytes: the input, the weights and the output of a launch, each once.
- Units, by the layer's kind, as the paper assigns them: the KPU takes
  every dense KxK conv (1x1 downsamples and MobileNet's stem included),
  the FCU the pointwise convs and the dense heads, DW the depthwise convs.
- Bound of a launch: max(FLOPs / PEAK_FLOPS, bytes / PEAK_BYTES).
"""
# NVIDIA H100 SXM, dense, published: 495 TFLOP/s is the TF32 tensor-core
# rate, the fastest at which any route can carry f32 operands, so no share
# of f32 work can read over 100 % whatever later implements a layer.
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12

UNIT = {"conv": "kpu", "pointwise": "fcu", "dense": "fcu", "dwconv": "dw"}
# The port's device functions of each unit, by a part of their names.
KERNEL_NAMES = {"kpu": ("kpu_kernel",), "fcu": ("fcu_kernel",), "dw": ("dw_kernel",)}


def macs(lay):
    """MACs of one frame through ``lay``."""
    ho, wo = lay["out_hw"]
    k2 = lay["k"] * lay["k"]
    kind = lay["kind"]
    if kind == "conv":
        return k2 * lay["d_in"] * lay["d_out"] * ho * wo
    if kind == "dwconv":
        return k2 * lay["d_out"] * ho * wo
    if kind in ("pointwise", "dense"):
        return lay["d_in"] * lay["d_out"] * ho * wo
    return 0


def weights(lay):
    """Weights of ``lay`` (the bias is added outside the kernels)."""
    k2 = lay["k"] * lay["k"]
    kind = lay["kind"]
    if kind == "conv":
        return k2 * lay["d_in"] * lay["d_out"]
    if kind == "dwconv":
        return k2 * lay["d_out"]
    if kind in ("pointwise", "dense"):
        return lay["d_in"] * lay["d_out"]
    return 0


def launch_bytes(lay, batch, itemsize):
    hi, wi = lay["in_hw"]
    ho, wo = lay["out_hw"]
    return itemsize * (batch * hi * wi * lay["d_in"] + weights(lay)
                       + batch * ho * wo * lay["d_out"])


def launch_bound_s(lay, batch, itemsize):
    """The least time one launch of ``lay`` over ``batch`` frames takes."""
    return max(2 * macs(lay) * batch / PEAK_FLOPS,
               launch_bytes(lay, batch, itemsize) / PEAK_BYTES)


def unit_bound_s(layers, unit, batch, itemsize):
    """Bound of one pass of ``batch`` frames through ``unit``'s layers."""
    return sum(launch_bound_s(lay, batch, itemsize) for lay in layers
               if UNIT.get(lay["kind"]) == unit)


def frame_flops(layers):
    return sum(2 * macs(lay) for lay in layers)


def roofline_share(ctx, unit):
    """Percent: the bound of the traced passes through ``unit`` over the
    device time of its kernels; None where the trace holds none."""
    trace = ctx.trace
    if trace is None:
        return None
    device_s = trace.device_s(KERNEL_NAMES[unit])
    bound = unit_bound_s(ctx.layers, unit, ctx.launch_batch, ctx.itemsize)
    if device_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound * trace.passes / device_s
