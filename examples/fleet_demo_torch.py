"""Fleet demo on the PyTorch / CUDA port: two CNN families served
concurrently on one chip pool.

1. Replicate the Multi-CLP headline inline: ResNet-18 at 224x224,
   rate 3, S = 3 — the contiguous-partition bottleneck falls from
   18944 to 18624 mults at equal arithmetic once the hot node of the
   bottleneck stage is cloned behind a round-robin splitter.
2. Plan a chip pool: ResNet-18 and MobileNetV1 tenants, each with its
   own target rate, packed onto a heterogeneous five-chip budget (one
   big-BRAM chip + four stock xcvu37p) by ``fleet.plan_pool``.
3. Serve both tenants *concurrently* on the device — one streaming
   engine per tenant on a shared deterministic clock
   (``fleet.FleetScheduler``), real frames, per-tenant BestRate
   admission — and print per-tenant latency next to per-chip occupancy.

Usage:  PYTHONPATH=src python examples/fleet_demo_torch.py [--device cpu]
"""
import argparse
from fractions import Fraction as F

import numpy as np
import torch

from repro_torch.core.graph import plan_graph
from repro_torch.core.replicate import best_replication
from repro_torch.fleet import (
    Chip,
    FleetScheduler,
    Tenant,
    TenantWorkload,
    chip_pool,
    plan_pool,
)
from repro_torch.models.registry import get_cnn_api, resolve_device
from repro_torch.serving import ServeConfig


def replication_headline() -> None:
    print("=== 1. Multi-CLP replication (ResNet-18, r=3, S=3) ===")
    api = get_cnn_api("resnet18", device="cpu")      # planning only
    graph = api.graph(api.make_config())
    base = plan_graph(graph, F(3), n_stages=3)
    rep = best_replication(graph, F(3), n_stages=3)
    what = rep.replications[0]
    print(f"  base       stage mults {base.stage_mults()}  "
          f"bottleneck {max(base.stage_mults())}")
    print(f"  replicated {rep.stage_mults()}  "
          f"bottleneck {max(rep.stage_mults())}  "
          f"({what.node} x{what.r}, total {rep.total_mults} == "
          f"{base.total_mults})")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    replication_headline()

    print("\n=== 2. chip-pool plan (2 tenants, 5 heterogeneous chips) ===")
    tenants = (
        Tenant("vision-a", "resnet18", F(1, 4), input_hw=(16, 16),
               num_classes=4),
        Tenant("vision-b", "mobilenet_v1", F(1, 4), input_hw=(16, 16),
               num_classes=4),
    )
    chips = (Chip("big0", bram36=4096),) + chip_pool(4)
    pool = plan_pool(tenants, chips, s_options=(1, 2))
    for t in tenants:
        c = pool.candidate_for(t.name)
        print(f"  {t.name}: {t.family} @ r={t.input_rate} -> plan "
              f"{c.label}, {c.total_mults} mults")
    for a in pool.assignments:
        print(f"  {a.chip} <- {a.tenant} stage {a.stage} "
              f"(dsp {a.dsp_frac:.2f}, bram {a.bram_frac:.2f})")
    print(f"  spare chips: {pool.spare_chips}; advisory fair share "
          f"{pool.fair_share()}")

    print(f"\n=== 3. concurrent serving on one shared clock, on {dev} ===")
    sched = FleetScheduler(pool, config=ServeConfig(execute=True), device=dev)
    sched.init_params("vision-a", torch.Generator(dev).manual_seed(0))
    sched.init_params("vision-b", torch.Generator(dev).manual_seed(1))
    rng = np.random.default_rng(0)
    fa = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    fb = rng.standard_normal((6, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        rep = sched.serve([
            TenantWorkload("vision-a", fa, ServeConfig(execute=True, arrival=F(1))),
            TenantWorkload("vision-b", fb, ServeConfig(execute=True, arrival=F(1, 2))),
        ])
    for name, value in rep.summary_rows():
        print(f"  {name}: {value}")
    print(f"  all stall-free: {rep.all_stall_free}, "
          f"queues bounded: {rep.all_within_bounds}")
    for name in ("vision-a", "vision-b"):
        vals = ", ".join(f"{v:.2e}" for v in rep.outputs[name][0, :4].tolist())
        print(f"  {name} logits[0, :4] = [{vals}]")


if __name__ == "__main__":
    main()
