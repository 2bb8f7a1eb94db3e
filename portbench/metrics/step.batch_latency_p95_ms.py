"""``batch_latency_p95_ms`` as a per-layer number, in a cell where the
host can set the pace: there the tail follows the host's speed from one
machine to the next, so it moves ``frames_per_s`` and carries no bound."""
from pathlib import Path

from portbench import harness


def read(ctx):
    return harness.reader(Path(__file__).resolve().parents[2],
                          "batch_latency_p95_ms")(ctx)
