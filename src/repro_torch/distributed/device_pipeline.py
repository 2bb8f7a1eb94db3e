"""DevicePipeline: wall-clock staged CNN execution, stages overlapping.

The port's counterpart of the JAX package's ``distributed/device_pipeline.py``.
A ``DevicePipeline`` takes the per-stage functions of a stage partition
(``models.cnn.stage_functions`` with ``placement=``), places stage ``s``
on device ``s % n`` of its pool (round robin when stages outnumber
devices: on a one-card host every stage lands on ``cuda:0``, each on a
CUDA stream of its own), and drives them with the GPipe schedule:

    for t in 0 .. M+S-2:           # M micro-batches, S stages
        for s in min(S-1, t) .. 0:  # deepest stage first
            m = t - s
            stage s computes micro-batch m

Nothing waits on the host: each stage's kernels are queued on its own
stream behind the events its producers recorded for that micro-batch, so
while stage 1 works on micro-batch m, stage 0's kernels for micro-batch
m+1 may already run beside them, on other SMs of the same card or on
another card.  The cut crossing toward stage s+1 is queued right after
stage s (``StagePipeline.prefetch``), and every boundary tensor read by
another stream than the one that made it is ``record_stream``-ed for its
reader, so dropping a boundary entry after its last consumer is safe.
With quantized links (``link_quant``) the crossings carry the int8 wire
payloads.

The steady-state bound is ``pipeline_parallel.microbatch_utilization``:
M / (M + S - 1).  ``DevicePipeline.measure`` reports where a card lands
against it: host wall clock around work that ends in
``torch.cuda.synchronize()`` for the overlapped schedule and for a
per-micro-batch blocking pass over the same stages, per-stage busy
seconds and the overlap speedup.
"""
from __future__ import annotations

import dataclasses
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.pipeline_parallel import microbatch_utilization
from repro_torch.models import cnn
from repro_torch.obs.trace import resolve_tracer


@dataclasses.dataclass(frozen=True)
class WallClockReport:
    """Measured wall-clock behaviour of one ``DevicePipeline.measure``.

    ``overlap_s`` / ``sequential_s`` are best-of-``repeats`` wall times
    for the whole batch; ``speedup = sequential_s / overlap_s``.
    ``stage_busy_s[s]`` is stage ``s``'s serialized time (measured
    blocking, one stage at a time), ``stage_busy_frac[s]`` that time
    over the overlapped wall clock.  ``utilization_bound`` is the
    schedule's M/(M+S-1) ceiling — structural, while every measured field
    is a host-clock time of this run.
    """

    frames: int                      # batch rows pushed per timed run
    microbatch: int                  # rows per micro-batch
    n_micro: int                     # M
    n_stages: int                    # S
    n_devices: int                   # distinct devices the stages landed on
    placement: Tuple[int, ...]       # device ordinal per stage
    utilization_bound: float         # M / (M + S - 1)
    overlap_s: float
    sequential_s: float
    fps_overlap: float
    fps_sequential: float
    speedup: float
    stage_busy_s: Tuple[float, ...]
    stage_busy_frac: Tuple[float, ...]


class DevicePipelineError(RuntimeError):
    pass


def _home(params) -> Optional[torch.device]:
    """The device the params live on: the pool a placement is taken from
    (None, the card, for a model without params)."""
    for p in params.values():
        for t in p.values():
            return t.device
    return None


class DevicePipeline:
    """Drive a placed ``StagePipeline`` with the GPipe schedule.

    ``pipeline`` should come from ``models.cnn.stage_functions(...,
    placement=...)`` (or ``DevicePipeline.build``).  An unplaced pipeline
    is placed in place via ``placement`` (default ``True``: the
    partition's recorded ordinals, else round robin over the pool of the
    params' device) — pass a pipeline you own.

    ``run(x, microbatch=m)`` splits ``x`` into M = ceil(N/m) micro-batches,
    pumps them through the schedule and returns the re-assembled logits,
    readable on the caller's stream; the host does not wait for them.
    The same arithmetic as ``staged_forward`` on each micro-batch.
    """

    def __init__(self, pipeline, params, *, placement=True, tracer=None):
        if pipeline.devices is None:
            devices = cnn.resolve_stage_devices(
                placement, pipeline.n_stages, pipeline.partition, device=_home(params)
            )
            if devices is not None:
                pipeline.place(devices)
        if pipeline.devices is None:
            raise DevicePipelineError(
                "DevicePipeline needs a placed StagePipeline — build with "
                "stage_functions(..., placement=True) or pass placement="
            )
        self.pipeline = pipeline
        self.params = params
        self._keep = pipeline.keep_after()
        # opt-in obs.Tracer: host wall-clock spans around every dispatch /
        # cut transfer / wait, one pid per device ordinal, one tid per
        # stage.  None/False = off, True = fresh.
        self.tracer = resolve_tracer(tracer)

    @classmethod
    def build(
        cls,
        graph,
        params,
        *,
        partition,
        placement=True,
        tracer=None,
        **stage_kwargs,
    ):
        """One-call constructor: build the per-stage functions with
        ``placement`` (its pool taken from the params' device) and wrap
        them.  ``stage_kwargs`` flow through to
        ``models.cnn.stage_functions`` (impls/plan/overrides/link_quant/
        dtype/check/...)."""
        pipeline = cnn.stage_functions(
            graph,
            partition=partition,
            placement=placement,
            device=_home(params),
            **stage_kwargs,
        )
        return cls(pipeline, params, tracer=tracer)

    # -- placement introspection ------------------------------------------

    @property
    def n_stages(self) -> int:
        return self.pipeline.n_stages

    def placement_ordinals(self) -> Tuple[int, ...]:
        """Device ordinal per stage (the card's index; 0 on the CPU)."""
        return tuple(0 if d.index is None else d.index for d in self.pipeline.devices)

    def n_devices(self) -> int:
        """Distinct devices the stages actually landed on."""
        return len(set(self.pipeline.devices))

    # -- execution ---------------------------------------------------------

    def _split(self, x, microbatch: Optional[int]):
        x = torch.as_tensor(x)
        n = x.shape[0]
        mb = n if microbatch is None else int(microbatch)
        if mb < 1:
            raise DevicePipelineError(f"microbatch must be >= 1, got {mb}")
        return [x[i : i + mb] for i in range(0, n, mb)], mb

    def _sync(self) -> None:
        """The host waits for every card the stages run on (nothing to
        wait for on the CPU)."""
        for d in set(self.pipeline.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _schedule(self, splits) -> List[torch.Tensor]:
        """The GPipe loop: queue every (stage, micro-batch) cell without
        waiting, deepest stage first within each step so each stage's
        stream receives its next work before new work enters stage 0.
        Returns the per-micro-batch logits, still being computed."""
        pipe, S, M = self.pipeline, self.pipeline.n_stages, len(splits)
        tr = self.tracer
        ords = self.placement_ordinals() if tr is not None else ()
        bnds: List[Dict[str, object]] = [{} for _ in range(M)]
        outs: List[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):
            for s in range(min(S - 1, t), -1, -1):
                m = t - s
                if not 0 <= m < M:
                    continue
                if tr is not None:
                    t0 = time.perf_counter()
                pipe.run_stage(s, self.params, bnds[m], splits[m] if s == 0 else None)
                if tr is not None:
                    tr.span(
                        "dispatch",
                        Fraction(t0),
                        Fraction(time.perf_counter()),
                        pid=f"dev{ords[s]}",
                        tid=f"stage{s}",
                        clock="host",
                        micro=m,
                    )
                keep = self._keep[s]
                for k in list(bnds[m]):
                    if k not in keep:
                        del bnds[m][k]
                if s == S - 1:
                    outs[m] = bnds[m][pipe.out_name]
                else:
                    # double-buffer: queue the cut crossing toward stage
                    # s+1 now, behind stage s's work on s+1's stream
                    if tr is not None:
                        t0 = time.perf_counter()
                    pipe.prefetch(s + 1, bnds[m])
                    if tr is not None:
                        tr.span(
                            "transfer",
                            Fraction(t0),
                            Fraction(time.perf_counter()),
                            pid=f"dev{ords[s]}",
                            tid=f"stage{s}",
                            clock="host",
                            micro=m,
                        )
        return outs

    def _to_caller(self, outs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The caller's stream waits for the stages, and each output's
        memory outlives the caller's reads of it."""
        self.pipeline.join()
        return [self.pipeline.keep_for_caller(o) for o in outs]

    def run(self, x, *, microbatch: Optional[int] = None) -> torch.Tensor:
        splits, _ = self._split(x, microbatch)
        outs = self._to_caller(self._schedule(splits))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _run_sequential(self, splits) -> List[torch.Tensor]:
        """The no-overlap baseline: the same stages on the same
        micro-batches, but each micro-batch is walked through all S stages
        and waited for before the next is admitted — what
        ``staged_forward`` does per call.  Any wall-clock gap to
        ``_schedule`` is pipeline overlap."""
        pipe, S = self.pipeline, self.pipeline.n_stages
        outs = []
        for xm in splits:
            bnd: Dict[str, object] = {}
            for s in range(S):
                pipe.run_stage(s, self.params, bnd, xm if s == 0 else None)
            self._sync()
            outs.append(bnd[pipe.out_name])
        return outs

    def _stage_busy(self, splits) -> Tuple[float, ...]:
        """Serialized per-stage seconds: run one (stage, micro-batch) cell
        at a time, waiting around it — the busy time each stage would
        take if nothing overlapped."""
        pipe, S = self.pipeline, self.pipeline.n_stages
        busy = [0.0] * S
        for xm in splits:
            bnd: Dict[str, object] = {}
            for s in range(S):
                t0 = time.perf_counter()
                pipe.run_stage(s, self.params, bnd, xm if s == 0 else None)
                self._sync()
                busy[s] += time.perf_counter() - t0
        return tuple(busy)

    def measure(
        self,
        x,
        *,
        microbatch: Optional[int] = None,
        warmup: int = 1,
        repeats: int = 3,
    ) -> WallClockReport:
        """Warm up, then time the overlapped schedule against the blocking
        sequential pass; best-of-``repeats`` each, host clock around work
        that ends with the host waiting for the cards."""
        splits, mb = self._split(x, microbatch)
        frames = int(sum(s.shape[0] for s in splits))
        for _ in range(max(1, warmup)):
            self._to_caller(self._schedule(splits))
            self._sync()
            self._run_sequential(splits)

        def _overlap_once():
            outs = self._to_caller(self._schedule(splits))
            if self.tracer is None:
                self._sync()
                return outs
            t0 = time.perf_counter()
            self._sync()
            self.tracer.span(
                "block_until_ready",
                Fraction(t0),
                Fraction(time.perf_counter()),
                pid="host",
                tid="measure",
                clock="host",
                frames=frames,
            )
            return outs

        overlap_s = min(self._timed(_overlap_once) for _ in range(max(1, repeats)))
        sequential_s = min(
            self._timed(lambda: self._run_sequential(splits))
            for _ in range(max(1, repeats))
        )
        busy = self._stage_busy(splits)

        return WallClockReport(
            frames=frames,
            microbatch=mb,
            n_micro=len(splits),
            n_stages=self.n_stages,
            n_devices=self.n_devices(),
            placement=self.placement_ordinals(),
            utilization_bound=microbatch_utilization(len(splits), self.n_stages),
            overlap_s=overlap_s,
            sequential_s=sequential_s,
            fps_overlap=frames / overlap_s if overlap_s > 0 else float("inf"),
            fps_sequential=(
                frames / sequential_s if sequential_s > 0 else float("inf")
            ),
            speedup=sequential_s / overlap_s if overlap_s > 0 else float("inf"),
            stage_busy_s=busy,
            stage_busy_frac=tuple(
                b / overlap_s if overlap_s > 0 else 0.0 for b in busy
            ),
        )

    @staticmethod
    def _timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0


def device_placement_rows(n_stages: int, n_devices: int) -> List[Tuple[str, int]]:
    """Structural rows for a wall-clock benchmark: the round-robin ordinal
    of every stage on an ``n_devices`` host — pure arithmetic, identical
    on every machine."""
    from repro_torch.core.stage_partition import round_robin_placement

    return [
        (f"stage{s}_dev", d)
        for s, d in enumerate(round_robin_placement(n_stages, n_devices))
    ]
