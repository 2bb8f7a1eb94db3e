"""The readings that a cell's correctness limit is set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds <n> --first-seed <s>
        --seconds <s> [--control-seeds <m>]

For each of ``n`` seeds, one run of the cell in this process (the window
``--seconds`` long, at the cell's own load and sizes) gives the program's
reading; for ``m`` of them, the control (the reference in TF32, one
precision below the configuration's) gives its own, and the float32
reference's own gap to a float64 one.  One JSON line each.
The benchmark's runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch
    from portbench import harness

    cell = harness.resolve_cell(ROOT, harness.load_manifest(ROOT), args.workload)
    for k in range(args.seeds):
        seed = args.first_seed + k
        r = harness.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                             device="cuda", t_start=time.perf_counter())
        line = {"workload": args.workload, "seed": seed,
                "program": r["checks"]["logit_err"]["value"],
                "correct": r["correct"], "attempted": r["attempted"]}
        if k < args.control_seeds:
            line["control"] = harness.control_reading(cell, seed, "cuda")
            # a witness: how far the float32 reference itself lies from a
            # float64 one on the same frames
            line["reference_vs_float64"] = harness.control_reading(
                cell, seed, "cuda", dtype=torch.float64)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
