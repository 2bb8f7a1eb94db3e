#!/usr/bin/env python3
"""Whether stages on CUDA streams of their own overlap, on one CUDA card.

    python3 tools/device_pipeline_times.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  For MobileNetV2 and ResNet-18 at 224x224 (1000 classes,
fp32, random weights from a seed) on the batch-pinned rate-3 plan, with
``chip_smoke.py``'s ``devices`` runs (S = 2 and 3 with fp32 links, S = 3
with int8 links), 64 frames at micro-batch 8:

* ``measure``: ``DevicePipeline.measure(warmup=1, repeats=1)`` ``ROUNDS``
  times, each a pair of the overlapped GPipe schedule and the blocking
  sequential pass (host clock around work that ends in a synchronize);
* ``profiled``: ``PROFILED`` runs under ``torch.profiler``, each giving
  the device's busy share and the kernel pairs of different streams that
  overlap in time (``chip_smoke.kernel_overlaps``).

Then, in turns (True, "devices", "devices", True, ...) over ``TURNS``
rounds: the stream engine at S = 2 (fp32 and int8 links, 68 frames,
untraced; host clock around ``run()`` and ``outputs()`` up to the
outputs synchronized) and ``chip_smoke.py``'s two-tenant fleet at
224x224 (64 frames a tenant, untraced).  It prints one JSON line per
case with every time, its median and its spread, and the card's name
and power limit as ``nvidia-smi`` gives them.
The engine and fleet cases also count the caching allocator's
``cudaMalloc`` calls during each timed run (``num_device_alloc``): a
stream the allocator has cached no memory for allocates afresh.  The
engine cases end with one profiled run of each mode
(``chip_smoke.kernel_overlaps``: device ms, busy share, overlapping
kernel pairs).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from fractions import Fraction

ROUNDS = 9
PROFILED = 3
TURNS = 3


def spread(xs) -> dict:
    return {"all": xs, "median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("device_pipeline_times: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from repro_torch.distributed.device_pipeline import DevicePipeline
    from repro_torch.fleet import Chip, FleetScheduler, Tenant, TenantWorkload, chip_pool
    from repro_torch.fleet import plan_pool
    from repro_torch.models.registry import get_cnn_api
    from repro_torch.serving import CNNStreamEngine, ServeConfig, constant
    from repro_torch.serving.cnn_stream import best_rate_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(2031)
    mb = cs.DEVICES_MICROBATCH

    def emit(obj):
        print(json.dumps({**obj, "card": smi}), flush=True)

    def device_allocs() -> int:
        """cudaMalloc calls the caching allocator has made so far."""
        return torch.cuda.memory_stats().get("num_device_alloc", 0)

    for family in ("mobilenet_v2", "resnet18"):
        api = get_cnn_api(family)
        cfg = api.make_config()
        graph = api.graph(cfg)
        params = api.init(cfg, torch.Generator().manual_seed(0))
        frames = torch.randn((cs.DEVICES_FRAMES, *cfg.input_hw, 3), generator=gen).cuda()
        for n_stages, link in cs.DEVICES_RUNS:
            dse = {"link_dtype": link} if link else {}
            gp = api.partition(cfg, cs.RATE, n_stages, **dse)
            dp = DevicePipeline.build(graph, params, partition=gp,
                                      plan=gp.kernel_plan(batch=mb),
                                      link_quant=True if link else None)
            overlap, sequential, speedup, busy = [], [], [], []
            for _ in range(ROUNDS):
                rep = dp.measure(frames, microbatch=mb, warmup=1, repeats=1)
                overlap.append(rep.overlap_s * 1e3)
                sequential.append(rep.sequential_s * 1e3)
                speedup.append(rep.speedup)
                busy.append([b * 1e3 for b in rep.stage_busy_s])
            prof = [cs.kernel_overlaps(torch, lambda: dp.run(frames, microbatch=mb))
                    for _ in range(PROFILED)]
            emit({
                "case": "devices", "family": family, "stages": n_stages,
                "links": link or "fp32", "frames": cs.DEVICES_FRAMES, "microbatch": mb,
                "overlap_ms": spread(overlap), "sequential_ms": spread(sequential),
                "speedup": spread(speedup),
                "stage_busy_ms_median": [statistics.median(b[s] for b in busy)
                                         for s in range(n_stages)],
                "device_busy_share": spread([p["device_busy_share"] for p in prof]),
                "device_ms": spread([p["device_ms"] for p in prof]),
                "cross_stream_overlapping_kernel_pairs": [
                    p["cross_stream_overlapping_kernel_pairs"] for p in prof],
                "kernels": prof[0]["kernels"],
            })

        frames = torch.randn((cs.STREAM_FRAMES, *cfg.input_hw, 3), generator=gen)
        for link in (None, "int8"):
            dse = {"link_dtype": link} if link else {}
            gp = api.partition(cfg, cs.RATE, 2, **dse)
            config = ServeConfig(microbatch=mb, kernel_plan=gp.kernel_plan(batch=mb),
                                 link_quant=True if link else None,
                                 arrival=constant(best_rate_frames(gp)))
            times = {True: [], "devices": []}
            mallocs = {True: [], "devices": []}
            for i in range(2 * TURNS + 1):
                for mode in ((True, "devices") if i % 2 else ("devices", True)):
                    eng = CNNStreamEngine(graph, params, gp, config.with_(execute=mode))
                    eng.submit_all(frames)
                    torch.cuda.synchronize()
                    n0 = device_allocs()
                    t0 = time.perf_counter()
                    eng.run()
                    eng.outputs()
                    torch.cuda.synchronize()
                    if i:  # round 0 warms both up
                        times[mode].append((time.perf_counter() - t0) * 1e3)
                        mallocs[mode].append(device_allocs() - n0)
            profiled = {}
            for mode in (True, "devices"):
                eng = CNNStreamEngine(graph, params, gp, config.with_(execute=mode))
                eng.submit_all(frames)
                torch.cuda.synchronize()
                profiled[str(mode)] = cs.kernel_overlaps(
                    torch, lambda: (eng.run(), eng.outputs()))
            emit({"case": "stream", "family": family, "stages": 2,
                  "links": link or "fp32", "frames": cs.STREAM_FRAMES,
                  "wall_ms": {str(k): spread(v) for k, v in times.items()},
                  "cuda_mallocs_in_run": {str(k): v for k, v in mallocs.items()},
                  "profiled": profiled})

    tenants = (Tenant("mnv2", "mobilenet_v2", cs.RATE, input_hw=(224, 224),
                      num_classes=1000),
               Tenant("r18", "resnet18", Fraction(3, 4), input_hw=(224, 224),
                      num_classes=1000))
    pool = plan_pool(tenants, (Chip("big0", bram36=4096), Chip("big1", bram36=4096))
                     + chip_pool(4), s_options=(2,))
    params, frames, configs = {}, {}, {}
    for i, t in enumerate(tenants):
        cand = pool.candidate_for(t.name)
        params[t.name] = get_cnn_api(t.family).init(cand.cfg,
                                                    torch.Generator().manual_seed(i))
        frames[t.name] = torch.randn((cs.FLEET_FRAMES, *t.input_hw, 3), generator=gen).cuda()
        configs[t.name] = ServeConfig(
            microbatch=mb, kernel_plan=cand.plan.kernel_plan(batch=mb),
            arrival=constant(best_rate_frames(cand.plan)))
    times = {True: [], "devices": []}
    mallocs = {True: [], "devices": []}
    for i in range(2 * TURNS + 1):
        for mode in ((True, "devices") if i % 2 else ("devices", True)):
            sched = FleetScheduler(pool, params=params, config=ServeConfig(execute=mode))
            work = [TenantWorkload(n, frames[n], configs[n].with_(execute=mode))
                    for n in frames]
            n0 = device_allocs()
            t0 = time.perf_counter()
            sched.serve(work)
            torch.cuda.synchronize()
            if i:
                times[mode].append((time.perf_counter() - t0) * 1e3)
                mallocs[mode].append(device_allocs() - n0)
    emit({"case": "fleet", "frames_per_tenant": cs.FLEET_FRAMES,
          "wall_ms": {str(k): spread(v) for k, v in times.items()},
          "cuda_mallocs_in_serve": {str(k): v for k, v in mallocs.items()}})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
