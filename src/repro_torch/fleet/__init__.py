"""Fleet subsystem: multi-tenant CNN serving on a pool of chips (the
port's own copy of the JAX package's ``fleet``).

Two layers, both built on the core rate calculus:

* ``pool`` — the chip-pool planner.  N tenants (a CNN registry family
  plus a target input rate each) are planned independently — stage-count
  and Multi-CLP replication sweeps priced by the analytic resource
  model — and packed onto a heterogeneous chip budget, one pipeline
  stage per chip.  The objective is lexicographic: serve every tenant's
  target rate (Eq. 9/10 hold per stage by construction of the DSE),
  then minimize total arithmetic, then total chips.
* ``scheduler`` — the multi-tenant serving loop.  One
  ``serving.CNNStreamEngine`` per tenant, pumped on a *shared*
  deterministic rational clock via the engine's steppable API
  (``begin`` / ``advance`` / ``next_event`` / ``finish``), with
  per-tenant BestRate admission.  Tenants share the clock but not
  chips, so each tenant's report is identical to a standalone run —
  a property ``tests/test_torch_fleet.py`` asserts.
"""

from repro_torch.fleet.pool import (
    Chip,
    ChipAssignment,
    PoolError,
    PoolPlan,
    Tenant,
    TenantCandidate,
    chip_pool,
    enumerate_candidates,
    plan_pool,
)
from repro_torch.fleet.scheduler import (
    FleetError,
    FleetReport,
    FleetScheduler,
    TenantWorkload,
)

__all__ = [
    "Chip",
    "ChipAssignment",
    "FleetError",
    "FleetReport",
    "FleetScheduler",
    "PoolError",
    "PoolPlan",
    "Tenant",
    "TenantCandidate",
    "TenantWorkload",
    "chip_pool",
    "enumerate_candidates",
    "plan_pool",
]
