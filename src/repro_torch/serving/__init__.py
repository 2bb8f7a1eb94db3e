"""Serving engines (the port's copy of the JAX package's ``serving``).

Two front doors, one admission calculus (Eq. 9: admit only into free
capacity):

* ``Engine`` — continuous batching of token streams (LM/SSM/hybrid
  families) over a slotted KV cache or SSM state;
* ``CNNStreamEngine`` — data-rate-aware streaming of CNN frame
  pipelines (the four CNN registry families) with BestRate admission,
  micro-batching to the planned kernel tiles, and bounded inter-stage
  queues (``serve_frames`` / ``registry.CNNApi.serve`` are the
  one-call forms).

The CNN engine is configured by one frozen ``ServeConfig``.  Traffic
shapes come from ``serving.scenarios`` (constant / bursty / diurnal /
adversarial — seeded, deterministic, exact-rational); overload behavior
from ``serving.overload`` (``ShedPolicy`` SLA shedding, ``SwitchPolicy``
online plan switching over a ``PlanLadder``); rendered telemetry from
``serving.telemetry.ServeSummary``.
"""

from repro_torch.serving.cnn_stream import (
    CNNStreamEngine,
    FrameRequest,
    ServeReport,
    ServingError,
    StageReport,
    serve_frames,
)
from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.overload import (
    LadderRung,
    OverloadError,
    PlanLadder,
    ShedPolicy,
    SwitchPolicy,
)
from repro_torch.serving.scenarios import (
    ArrivalProcess,
    Bursty,
    Constant,
    Diurnal,
    ScenarioError,
    adversarial,
    bursty,
    constant,
    diurnal,
)
from repro_torch.serving.telemetry import ServeSummary

__all__ = [
    "ArrivalProcess",
    "Bursty",
    "CNNStreamEngine",
    "Constant",
    "Diurnal",
    "Engine",
    "FrameRequest",
    "LadderRung",
    "OverloadError",
    "PlanLadder",
    "Request",
    "ScenarioError",
    "ServeConfig",
    "ServeReport",
    "ServeSummary",
    "ServingError",
    "ShedPolicy",
    "StageReport",
    "SwitchPolicy",
    "adversarial",
    "bursty",
    "constant",
    "diurnal",
    "serve_frames",
]
