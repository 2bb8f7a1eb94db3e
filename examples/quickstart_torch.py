"""Quickstart on the PyTorch / CUDA port: the paper's pipeline end to end.

1. Build MobileNetV2, propagate the input data rate through all 54
   layers (watch it drop at every stride — the paper's core observation).
2. Run the (j,h) design-space exploration at the paper's 3/1 operating
   point and print the per-layer implementations + FPGA resource bill
   (Table II row).
3. Run actual inference in PyTorch, once through the kernels' plain
   PyTorch versions and once through the KPU / FCU / depthwise CUDA
   kernels, and check they agree.

Usage:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
(on the CPU the kernel wrappers run their plain versions)
"""
import argparse
from fractions import Fraction as F

import torch

from repro_torch.core import (estimate_network, fps, plan_network,
                              propagate_chain)
from repro_torch.models import cnn
from repro_torch.models import mobilenet as mn
from repro_torch.models.registry import resolve_device

RATE = F(3, 1)   # 3 features/clock = 1 pixel/clock at the RGB input


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = mn.MobileNetConfig(version=2, input_hw=(224, 224))
    chain = cfg.chain()

    print("=== 1. data-rate propagation (features/clock) ===")
    pts = propagate_chain(RATE, chain)
    for spec, pt in list(zip(chain, pts[1:]))[:12]:
        q = pt.pixels_per_clock
        print(f"  {spec.name:>12}  ->  r={str(pt.features_per_clock):>9} "
              f"(pixels/clk {str(q):>8})")
    print("  ... rate falls 16x by the last stride stage\n")

    print("=== 2. (j,h) DSE + resource bill @ r=3/1 ===")
    impls = plan_network(chain, RATE)
    for impl in impls[:8]:
        print(f"  {impl.layer.name:>12}: j={impl.j:<4} h={impl.h:<4} "
              f"C={impl.configs:<6} units={impl.units:<5} "
              f"util={float(impl.utilization):.2f}")
    est = estimate_network(impls).rounded()
    print(f"  TOTAL: {est}  |  paper Table II row: DSP 3168, LUT 124k")
    print(f"  FPS @ 404.53 MHz: {fps((224, 224), RATE / 3, 404.53e6):.1f} "
          f"(paper: 8026.4)\n")

    print(f"=== 3. PyTorch inference on {dev}: plain vs KPU/FCU/DW kernels ===")
    small = mn.MobileNetConfig(version=2, input_hw=(32, 32), num_classes=10)
    params = mn.init_params(small, torch.Generator(dev).manual_seed(0), dev)
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator(dev).manual_seed(1),
                    device=dev)
    with torch.no_grad():
        base = mn.apply(params, x, small)
        kern = mn.apply(params, x, small, conv_impls=cnn.kernel_impls())
    err = float((base - kern).abs().max())
    print(f"  max |plain - kernels| = {err:.2e}  (tolerance 2e-3)")
    assert err < 2e-3
    print("  OK — kernels are numerically neutral; the DSE only changes "
          "the schedule.")


if __name__ == "__main__":
    main()
