"""Rate sweep on the PyTorch / CUDA port: the paper's Table II +
pick-your-own rate.

Sweeps MobileNetV2 implementations across data rates (the paper's 7 rows
plus any ``--rate N/D`` you pass), printing the resource/FPS trade-off
curve — the design space the paper's DSE exposes.  Analytic: it runs on
no device.

Usage:
  PYTHONPATH=src python examples/rate_sweep_torch.py
  PYTHONPATH=src python examples/rate_sweep_torch.py --rate 1/4 --model v1
"""
import argparse
from fractions import Fraction as F

from repro_torch.core import estimate_network, fps, plan_network
from repro_torch.models.mobilenet import mobilenet_v1_chain, mobilenet_v2_chain

DEFAULT_RATES = [F(6, 1), F(3, 1), F(3, 2), F(3, 4), F(3, 8), F(3, 16),
                 F(3, 32)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("v1", "v2"), default="v2")
    ap.add_argument("--rate", type=str, default=None,
                    help="extra rate to evaluate, e.g. 1/4")
    ap.add_argument("--fmax", type=float, default=400e6)
    ap.add_argument("--device", default=None,
                    help="accepted like the other examples' and unused: "
                         "the sweep is analytic")
    args = ap.parse_args(argv)

    chain = (mobilenet_v1_chain() if args.model == "v1"
             else mobilenet_v2_chain())
    rates = list(DEFAULT_RATES)
    if args.rate:
        num, _, den = args.rate.partition("/")
        rates.append(F(int(num), int(den or 1)))

    print(f"{'rate':>7} {'FPS':>9} {'DSP':>6} {'LUT':>8} {'BRAM':>7} "
          f"{'util%':>6} {'mults':>7}")
    for r in sorted(set(rates), reverse=True):
        impls = plan_network(chain, r)
        est = estimate_network(impls).rounded()
        util = sum(float(i.utilization) * i.mults for i in impls) / max(
            1, sum(i.mults for i in impls))
        f = fps((224, 224), r / 3, args.fmax)
        print(f"{str(r):>7} {f:>9.1f} {est['DSP']:>6} {est['LUT']:>8,} "
              f"{est['BRAM36']:>7} {100 * util:>5.1f}% "
              f"{sum(i.mults for i in impls):>7,}")
    print("\nEvery row is a valid continuous-flow implementation; "
          "pick the rate your sensor actually delivers (the paper's point).")


if __name__ == "__main__":
    main()
