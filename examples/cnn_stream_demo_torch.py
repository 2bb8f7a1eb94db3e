"""Streaming CNN serving demo on the PyTorch / CUDA port: the rate
calculus at the request level.

1. Plan ResNet-18 at r = 5/2 with a 3-stage partition (the multi-chip
   cut) and read off the request-level numbers: per-stage service rates,
   the BestRate admission ceiling, and the stream-buffer-derived
   inter-stage queue caps.
2. Serve a burst of frames through the software pipeline on the device —
   admission at BestRate, micro-batches pinned to the rate-matched kernel
   tiles, bounded queues with backpressure — and print the per-tick
   telemetry next to the analytical bounds.
3. Push the arrival rate past BestRate and watch the engine throttle to
   exactly BestRate with the excess parked outside the pipeline.
4. Serve adversarial traffic (just above BestRate, forever) under an
   SLA shedding policy and under online plan switching over the DSE
   ladder — the two overload policies behind ``ServeConfig.overload``.

Usage:  PYTHONPATH=src python examples/cnn_stream_demo_torch.py [--device cpu]
"""
import argparse
from fractions import Fraction as F

import torch

from repro_torch.core.graph import plan_graph
from repro_torch.models.registry import get_cnn_api, resolve_device
from repro_torch.serving import (
    CNNStreamEngine,
    PlanLadder,
    ServeConfig,
    ShedPolicy,
    SwitchPolicy,
    adversarial,
)
from repro_torch.serving.cnn_stream import best_rate_frames, stage_rates

RATE = F(5, 2)     # features/clock at the RGB input
N_STAGES = 3
MICROBATCH = 2
TOL = 1e-4         # served vs api.apply: max|err| over max(1, max|logits|)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    api = get_cnn_api("resnet18", device=dev)
    cfg = api.make_config(input_hw=(32, 32), num_classes=10)
    graph = cfg.graph()
    params = api.init(cfg, torch.Generator(dev).manual_seed(0))

    print(f"=== 1. request-level plan (r={RATE}, S={N_STAGES}) ===")
    plan = plan_graph(graph, RATE, n_stages=N_STAGES)
    br = best_rate_frames(plan)
    for sr in stage_rates(plan):
        print(f"  stage {sr.stage}: {len(sr.nodes):>2} nodes, "
              f"util {float(sr.utilization):.3f} "
              f"(bottleneck {sr.bottleneck_node})")
    print(f"  BestRate = {br} frames/tick "
          f"(1 tick = 1 frame interval at the plan rate)\n")

    print(f"=== 2. serve at the plan rate (admitted <= BestRate) on {dev} ===")
    frames = torch.randn((8, 32, 32, 3), generator=torch.Generator(dev).manual_seed(1),
                         device=dev)
    kp = plan.kernel_plan(batch=MICROBATCH)   # pixel tiles pinned to B
    serve_cfg = ServeConfig(microbatch=MICROBATCH, kernel_plan=kp,
                            dtype=cfg.dtype, arrival=F(1))
    eng = CNNStreamEngine(graph, params, plan, serve_cfg, device=dev)
    with torch.no_grad():
        eng.submit_all(frames)
        rep = eng.run()
        ref = api.apply(params, frames, cfg)
    print(f"  {rep.completed} frames, throughput "
          f"{float(rep.throughput):.3f} f/tick, "
          f"p50/p99 latency {rep.p50_latency():.1f}/"
          f"{rep.p99_latency():.1f} ticks")
    for s in rep.stages:
        print(f"  stage {s.stage}: occupancy {s.measured_occupancy:.3f} "
              f"(analytic {float(s.analytic_occupancy):.3f}), "
              f"stalls {float(s.stall_cycles):.0f}, "
              f"queue {s.max_queue_batches}/{s.queue_cap_batches}")
    served = eng.outputs()
    err = float((served - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    ok = torch.allclose(served, ref, rtol=1e-5, atol=1e-5)
    print(f"  served outputs match apply_graph: {ok} "
          f"(max |err| {err:.2e}, gate {TOL:g} x {scale:.2f})\n")
    assert err <= TOL * scale

    print("=== 3. overload: arrivals at 2 x BestRate ===")
    eng2 = CNNStreamEngine(
        graph, None, plan,
        ServeConfig(microbatch=MICROBATCH, execute=False, arrival=2 * br))
    for _ in range(32):
        eng2.submit(None)
    rep2 = eng2.run()
    bott = rep2.stages[rep2.bottleneck_stage]
    print(f"  admitted rate {rep2.admitted_rate} (= BestRate), "
          f"throughput {float(rep2.throughput):.3f} f/tick")
    print(f"  bottleneck stage {bott.stage} occupancy "
          f"{bott.measured_occupancy:.3f}, queues bounded: "
          f"{rep2.within_queue_bounds}, request-queue peak "
          f"{rep2.request_queue_peak} frames\n")

    print("=== 4. overload policies: shed vs switch ===")
    adv = adversarial(br, margin=F(5, 4))   # 5/4 x BestRate, forever
    shed_eng = CNNStreamEngine(
        graph, None, plan,
        ServeConfig(microbatch=MICROBATCH, execute=False, arrival=adv,
                    overload=ShedPolicy(deadline_ticks=F(24))))
    for _ in range(200):
        shed_eng.submit(None)
    shed = shed_eng.run()
    print(f"  shed:   {shed.summary('shed').to_rows()[0][1]} "
          f"(p99 total {shed.p99_total_latency():.1f} ticks, "
          f"pinned near the 24-tick deadline)")

    ladder = PlanLadder.build(graph, RATE, n_stages=N_STAGES,
                              rate_factors=(1, 2), try_replicate=True)
    print(f"  ladder: {ladder.describe()}")
    sw_eng = CNNStreamEngine(
        graph, None, ladder.rungs[0].plan,
        ServeConfig(microbatch=MICROBATCH, execute=False,
                    arrival=adversarial(best_rate_frames(ladder.rungs[0].plan)),
                    overload=SwitchPolicy(ladder)))
    for _ in range(200):
        sw_eng.submit(None)
    sw = sw_eng.run()
    print(f"  switch: {sw.summary('switch').to_rows()[0][1]} "
          f"(p99 total {sw.p99_total_latency():.1f} ticks, bounded)")


if __name__ == "__main__":
    main()
