"""A cell of the manifest cut to a size a CPU test can hold: 32x32 frames,
batches and micro-batches of 8, runs of 32 frames.  The port then runs its
kernels' plain versions."""
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = harness.load_manifest(ROOT)
CELLS = [w["name"] for w in MANIFEST["workloads"]]
SIZES = {"batch": 8, "microbatch": 8, "pool_batches": 2, "frames_per_run": 32,
         "trace_requests": 1}


def small_cell(name):
    cell = harness.resolve_cell(ROOT, MANIFEST, name)
    cell.config["input_hw"] = [32, 32]
    for key, value in SIZES.items():
        if key in cell.traffic:
            cell.traffic[key] = value
    return cell
