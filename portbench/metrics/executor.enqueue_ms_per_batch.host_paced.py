"""``executor.enqueue_ms_per_batch`` in a cell where the host can set the
pace, where it moves ``frames_per_s``."""
from pathlib import Path

from portbench import harness


def read(ctx):
    return harness.reader(Path(__file__).resolve().parents[2],
                          "executor.enqueue_ms_per_batch")(ctx)
