"""The paper's rate calculus, the (j, h) DSE, the DAG planner and the
Hopper tile rule: the port's own copy of the JAX package's ``core``.

  rate            — data-rate algebra (exact fractions), LayerSpec, propagation
  graph           — DAG rate graph, join skew buffers, the DAG-aware DSE
                    (plan_graph) and the per-node ImplPlan contract the
                    executor consumes
  dse             — (j, h) design-space exploration, Eqs. (1)-(11)
  multipixel      — §II-E phase analysis: tap routing, stride pruning
  schedule        — discrete-event continuous-flow validation (chain + DAG)
  resource_model  — analytical FPGA model reproducing Tables I & II
  tiles           — the Hopper lowering: (j, h) -> kernel tiles
  stage_partition — rate-aware pipeline-stage partitioning with inter-chip
                    stream buffers
  replicate       — Multi-CLP bottleneck replication
  hw              — hardware constants (H100 SXM + xcvu37p)
"""

from .rate import (  # noqa: F401
    LayerSpec,
    RatePoint,
    divisors,
    fps,
    frame_cycles,
    propagate,
    propagate_chain,
)
from .dse import (  # noqa: F401
    NON_ARITH_KINDS,
    LayerImpl,
    best_rate,
    hj_set,
    pixel_phases,
    plan_network,
    select_impl,
    select_ours,
    select_ref11,
    surviving_phases,
)
from .stage_partition import (  # noqa: F401
    GraphStagePlan,
    StagePlan,
    StreamBuffer,
    allocate_chips,
    partition_graph,
    partition_min_bottleneck,
    plan_node_costs,
    stream_buffers,
)
from .graph import (  # noqa: F401
    GraphError,
    GraphPlan,
    ImplPlan,
    JoinBuffer,
    LayerGraph,
    NodeTiming,
    compute_timing,
    deal_buffers,
    join_buffers,
    plan_graph,
    propagate_graph,
)
from .replicate import (  # noqa: F401
    ReplicatedGraph,
    ReplicatedPlan,
    Replication,
    lane_multiplicity,
    plan_replicated,
    replicable_nodes,
    replicate_node,
    replicate_params,
    select_bottleneck,
)
from .tiles import TileChoice, select_tile, select_tile_for_impl  # noqa: F401
from .hw import H100_SXM, XCVU37P, FPGASpec, HopperSpec  # noqa: F401
from .resource_model import (  # noqa: F401
    ResourceEstimate,
    estimate_graph,
    estimate_join_buffer,
    estimate_layer,
    estimate_network,
    estimate_stages,
    estimate_stream_buffer,
)
