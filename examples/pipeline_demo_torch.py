"""Pipeline parallelism with rate-aware stage balance on the PyTorch /
CUDA port — live demo.

Runs a toy residual-block stack through the ring pipeline
(``repro_torch/distributed/pipeline_parallel.py``) on 4 gloo ranks that
share the device, and shows the paper's continuous-flow math at stage
level:

  1. Uneven per-layer costs (a 'pooling-like' cost drop mid-network) get
     partitioned by the min-bottleneck DP (``core.stage_partition``) —
     compare against the naive equal-layer-count split.
  2. The GPipe bubble follows util = M/(M+S-1); numerics: pipeline output
     == sequential stack output.  The ranks are spawned processes, one a
     stage, on the device (NCCL takes one rank a card, so ranks that
     share a card run gloo, and each tick's activations cross the ring
     through host buffers: ``pipeline_parallel.shift_route``).
  3. Chips-per-stage for heterogeneous stages.
  4. Wall-clock: a real staged CNN through
     ``distributed/device_pipeline.py`` on one device — on the card every
     stage runs on a CUDA stream of its own, micro-batches overlap under
     the GPipe schedule, and the report shows measured frames/sec against
     the sequential baseline.

Run: PYTHONPATH=src python examples/pipeline_demo_torch.py [--device cpu]
"""
import argparse
import os
import tempfile
from fractions import Fraction as F

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.stage_partition import (allocate_chips,
                                              partition_min_bottleneck,
                                              service_rates)
from repro_torch.distributed.pipeline_parallel import (microbatch_utilization,
                                                       pipeline_forward,
                                                       shift_route)
from repro_torch.models.registry import resolve_device

STAGES = 4
L, MB, D, M = 8, 4, 32, 12


def block(ps, x):
    for i in range(ps.shape[0]):
        x = x + torch.tanh(x @ ps[i])
    return x


def _ring_rank(rank, world, store_path, out_path, device, w, x):
    """One stage of the ring: rank ``rank`` of a gloo world over a
    FileStore; rank 0 saves the pipeline's output and the shift's route."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh(dev.type, (world,), mesh_dim_names=("stage",))
        got = pipeline_forward(block, w.to(dev).reshape(world, -1, D, D), x.to(dev), mesh)
        if rank == 0:
            route = shift_route(dist.get_backend(mesh.get_group("stage")), dev)
            torch.save({"out": got.cpu(), "route": route}, out_path)
    finally:
        dist.destroy_process_group()


def run_ring(dev, w, x, world=STAGES) -> dict:
    """``pipeline_forward`` on ``world`` spawned gloo ranks on ``dev``."""
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.pt")
        mp.start_processes(_ring_rank, args=(world, os.path.join(tmp, "store"), out_path,
                                             str(dev), w, x),
                           nprocs=world, start_method="spawn")
        return torch.load(out_path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("=== 1. rate-aware stage partition ===")
    # 16 layers; the back half is 4x cheaper (post-'pooling' rate drop)
    costs = [4.0] * 8 + [1.0] * 8
    plan = partition_min_bottleneck(costs, 4)
    naive = max(sum(costs[i * 4:(i + 1) * 4]) for i in range(4))
    print(f"  per-layer costs: {costs}")
    print(f"  DP stage bounds: {plan.boundaries}  "
          f"(stage costs {plan.stage_cost})")
    print(f"  bottleneck {plan.bottleneck} vs naive equal-count {naive} "
          f"-> {naive / plan.bottleneck:.2f}x more throughput")

    print(f"\n=== 2. pipeline ring on {STAGES} gloo ranks on {dev} ===")
    w = torch.randn((L, D, D), generator=torch.Generator().manual_seed(0)) * 0.1
    x = torch.randn((M, MB, D), generator=torch.Generator().manual_seed(1))
    ring = run_ring(dev, w, x)
    want = x.to(dev)
    for i in range(L):
        want = want + torch.tanh(want @ w[i].to(dev))
    err = float((ring["out"] - want.cpu()).abs().max())
    print(f"  {M} microbatches x {STAGES} stages: max |pipeline - sequential| "
          f"= {err:.2e} (ring shift: {ring['route']})")
    assert err < 1e-4
    print(f"  utilization (GPipe bubble): {microbatch_utilization(M, STAGES):.3f} "
          f"(= M/(M+S-1) = {M}/{M + STAGES - 1})")

    print("\n=== 3. chips-per-stage for heterogeneous stages ===")
    chips = allocate_chips(list(plan.stage_cost), 16)
    rates = service_rates(list(plan.stage_cost), chips, 1.0)
    print(f"  16 chips over stages {plan.stage_cost} -> {chips} "
          f"(min service rate {min(rates):.3f}/s vs even-split "
          f"{min(service_rates(list(plan.stage_cost), [4] * 4, 1.0)):.3f}/s)")

    print(f"\n=== 4. wall-clock staged CNN on {dev} ===")
    from repro_torch.distributed.device_pipeline import DevicePipeline
    from repro_torch.models.registry import get_cnn_api

    api = get_cnn_api("resnet18", device=dev)
    cfg = api.make_config(input_hw=(32, 32), num_classes=10)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0))
    cut = api.partition(cfg, F(3), 4)
    frames = torch.randn((8, 32, 32, 3), generator=torch.Generator(dev).manual_seed(2),
                         device=dev)
    dp = DevicePipeline.build(api.graph(cfg), params, partition=cut, placement=True)
    print(f"  resnet18 cut into {dp.n_stages} stages on devices "
          f"{dp.placement_ordinals()}"
          + (" (one card, a CUDA stream a stage)" if dev.type == "cuda" else ""))
    with torch.no_grad():
        rep = dp.measure(frames, microbatch=1, warmup=1, repeats=2)
    print(f"  overlap {rep.fps_overlap:8.1f} frames/s   "
          f"sequential {rep.fps_sequential:8.1f} frames/s   "
          f"speedup {rep.speedup:.2f}x (bound {rep.utilization_bound:.2f})")
    print("  stage busy fractions: "
          + ", ".join(f"s{i}={f:.2f}" for i, f in
                      enumerate(rep.stage_busy_frac)))

    print("\nContinuous flow at rack scale: every stage's service rate "
          "covers the stream — the paper's j/h >= r, in chips.")


if __name__ == "__main__":
    main()
