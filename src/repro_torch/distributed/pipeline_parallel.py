"""The GPipe schedule's bound: with M micro-batches through S pipeline
stages, each stage is busy M / (M + S - 1) of the schedule (the fill and
drain bubble amortizes as M grows) — the pipeline-level twin of the
paper's j/h >= r utilization bound.  ``distributed.device_pipeline``
measures a placed stage pipeline against it."""
from __future__ import annotations


def microbatch_utilization(n_micro: int, n_stages: int) -> float:
    """GPipe bubble math: busy fraction of each stage."""
    return n_micro / (n_micro + n_stages - 1)
