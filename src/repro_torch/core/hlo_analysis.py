"""The roofline terms of a traced step; the port's counterpart of the JAX
package's ``core/hlo_analysis.py``.

There is no HLO: the port's step runs eagerly, op by op.  The JAX package
reads FLOPs and bytes from ``compiled.cost_analysis()`` and parses the
collectives out of the compiled per-device HLO text; the port watches one
call of the step through a dispatch mode, ``StepCounter``, which sees every
op the call runs (autograd's backward included) and counts, per rank:

* **FLOPs**, from the formulas ``torch.utils.flop_counter.FlopCounterMode``
  reads (``flop_registry``: matmuls, convolutions, attention; the port's
  kernels register theirs, ``kernels/flash_attention.py`` and
  ``kernels/ssd_chunk.py``).  An op on DTensors is not counted: its local
  op on the rank's shards is, so the count is the rank's own work.
  (``FlopCounterMode`` itself counts both, the global op and its local
  op.)
* **Peak live bytes**: every storage an op makes, from its creation until
  its last reference goes, rounded up to the CUDA caching allocator's 512
  bytes, on top of the storages the step's inputs hold (``hold``).  That is
  ``torch.cuda.max_memory_allocated()``'s measure, taken from the trace:
  under ``FakeTensorMode`` nothing is allocated.
* **Collectives** by kind and by mesh axis: every ``c10d`` op (the
  functional collectives DTensor issues and ``torch.distributed``'s own),
  its result bytes (the reference's measure: an all-gather's gathered
  buffer, a reduce-scatter's shard, an all-reduce's tensor) and the
  process group it runs on, named by the mesh dim whose group it is.

``roofline_terms`` turns the counts into the three times on ``HopperSpec``:
compute at the bf16 tensor-core peak, memory at HBM bandwidth, and each
axis's collective bytes at NVLink's rate where the axis's ranks share one
node of ``cards_per_node`` cards, at the NIC's rate where they span nodes.
The reference's ``normalize_cost_analysis`` and its HLO text parser have
no counterpart.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hw import H100_SXM, HopperSpec
from repro_torch.tree import leaves

ALLOC_ROUND = 512        # the CUDA caching allocator's block rounding

# op name (after the namespace) -> the reference's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
        "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


def storage_bytes(t: torch.Tensor) -> int:
    """A tensor's storage, rounded up as the caching allocator rounds it."""
    n = t.untyped_storage().nbytes()
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND if n else 0


def _propagating() -> bool:
    """True inside DTensor's sharding propagation, which runs an op on
    fake tensors of the global shapes to learn its output's shape: that
    op is no work of the step (and its tensors no memory)."""
    f = sys._getframe(2)
    for _ in range(_PROPAGATION_DEPTH):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


_PROPAGATION_DEPTH = 12


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    bytes_by_axis: Dict[str, int]
    count_by_axis: Dict[str, int]
    spans_nodes: Dict[str, bool]       # axis -> its ranks span several nodes

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def seconds(self, spec: HopperSpec = H100_SXM) -> float:
        """Each axis's bytes at its link's rate, the axes one after another."""
        return sum(b / (spec.nic_bw if self.spans_nodes[a] else spec.nvlink_bw)
                   for a, b in self.bytes_by_axis.items())

    def summary(self) -> dict:
        return {"bytes_by_kind": self.bytes_by_kind, "count_by_kind": self.count_by_kind,
                "bytes_by_axis": self.bytes_by_axis, "count_by_axis": self.count_by_axis,
                "axis_spans_nodes": self.spans_nodes, "total_bytes": self.total_bytes,
                "total_count": self.total_count}


class StepCounter(TorchDispatchMode):
    """Counts FLOPs, peak live bytes and collectives of what runs inside
    it, per rank (module note).  ``mesh`` names the process groups of its
    dims; any other group is named by its size."""

    def __init__(self, mesh=None):
        super().__init__()
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._axes: Dict[str, str] = {}
        if mesh is not None:
            for name in mesh.mesh_dim_names:
                self._axes[mesh.get_group(name).group_name] = name
        self.collectives = CollectiveStats({k: 0 for k in KINDS}, {k: 0 for k in KINDS},
                                           {}, {}, {})

    # -- live bytes ---------------------------------------------------------

    def hold(self, *trees) -> int:
        """Count the storages of ``trees``' tensors (a DTensor's local
        shard) as live from here on; returns their bytes."""
        before = self.live_bytes
        for t in leaves(list(trees)):
            if isinstance(t, torch.Tensor):
                self._track(t.to_local() if isinstance(t, DTensor) else t)
        return self.live_bytes - before

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = storage_bytes(t)
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- collectives --------------------------------------------------------

    def _group(self, func, args, kwargs) -> tuple:
        """(axis name, its ranks span nodes) of a collective's group: the
        functional ops' ``group_name``, ``torch.distributed``'s
        ``process_group``."""
        from torch.distributed.distributed_c10d import _resolve_process_group
        for i, arg in enumerate(func._schema.arguments):
            a = args[i] if i < len(args) else kwargs.get(arg.name)
            if arg.name == "group_name":
                pg = _resolve_process_group(a)
            elif arg.name == "process_group":
                pg = dist.ProcessGroup.unbox(a)
        ranks = dist.get_process_group_ranks(pg)
        name = self._axes.get(pg.group_name, f"group{len(ranks)}")
        return name, len({r // H100_SXM.cards_per_node for r in ranks}) > 1

    def _collective(self, kind: str, func, args, kwargs, out) -> None:
        nbytes = sum(t.numel() * t.element_size() for t in tree_flatten(out)[0]
                     if isinstance(t, torch.Tensor))
        axis, spans = self._group(func, args, kwargs)
        s = self.collectives
        s.bytes_by_kind[kind] += nbytes
        s.count_by_kind[kind] += 1
        s.bytes_by_axis[axis] = s.bytes_by_axis.get(axis, 0) + nbytes
        s.count_by_axis[axis] = s.count_by_axis.get(axis, 0) + 1
        s.spans_nodes[axis] = spans

    # -- dispatch -----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(a, DTensor) for a in tree_flatten((args, kwargs))[0]):
            # DTensor's own handler runs next, and its local ops come back
            # here: they are the rank's work
            return NotImplemented
        out = func(*args, **kwargs)
        if _propagating():
            return out                   # DTensor deriving an output's shape
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            name = f"{func.namespace}.{packet.__name__}"
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if func.namespace in ("_c10d_functional", "c10d"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                self._collective(kind, func, args, kwargs, out)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                self._track(t)
        return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time — how close the step is to the
        pure-compute roofline if MODEL_FLOPS were all that ran."""
        if self.bound_s <= 0 or self.model_flops <= 0:
            return 0.0
        ideal = self.model_flops / (self.chips * H100_SXM.peak_bf16_flops)
        return ideal / self.bound_s

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total FLOPs (the flops field is per rank)."""
        total = self.flops * max(self.chips, 1)
        return self.model_flops / total if total else 0.0

    def summary(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes, "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "bound_s": self.bound_s, "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(flops: float, hbm_bytes: float,
                   collectives: Optional[CollectiveStats], chips: int, *,
                   model_flops: float = 0.0,
                   spec: HopperSpec = H100_SXM) -> RooflineTerms:
    """The three roofline terms of a step from its per-rank FLOPs and HBM
    bytes and its collectives (``StepCounter``); ``model_flops`` is the
    whole step's (all ranks)."""
    coll = collectives.total_bytes if collectives is not None else 0
    return RooflineTerms(
        flops=float(flops), hbm_bytes=float(hbm_bytes), coll_bytes=float(coll),
        chips=chips,
        compute_s=flops / spec.peak_bf16_flops,
        memory_s=hbm_bytes / spec.hbm_bw,
        collective_s=collectives.seconds(spec) if collectives is not None else 0.0,
        model_flops=model_flops)
