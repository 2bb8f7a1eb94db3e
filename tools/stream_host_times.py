#!/usr/bin/env python3
"""Where the stream engine's host time goes, on one CUDA card.

    python3 tools/stream_host_times.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  For MobileNetV2 and ResNet-18 at 224x224 (1000 classes,
fp32, random weights from a seed), planned at rate 3 with S = 1, 2 and 3
stages and the batch-pinned kernel plan, it serves 68 frames at
micro-batch 8 (``chip_smoke.py``'s run a) and times, in turns, over
``ROUNDS`` rounds (engine, staged, staged, engine, ...):

* ``engine``: ``CNNStreamEngine.run()`` + ``outputs()``, host clock up to
  the outputs synchronized;
* ``engine_gc_off``: the same with Python's cyclic garbage collector off
  for the run;
* ``staged``: ``apply_staged`` over the same 9 zero-padded micro-batches;
* ``loop``: the engine's ``execute=False`` twin (the event loop alone).

It prints one JSON line per (family, S) with every time, their medians
and spreads, then ``cProfile``'s top functions (by own time) of one
engine run of each family at S = 3, and the card's name and power limit
as ``nvidia-smi`` gives them.  Under ``cProfile`` every Python call
costs more, so its shares are for ranking, not for times.
"""
from __future__ import annotations

import cProfile
import gc
import json
import os
import pstats
import statistics
import subprocess
import sys
import time
from fractions import Fraction

FRAMES = 68
MICROBATCH = 8
RATE = Fraction(3)
ROUNDS = 5


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("stream_host_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.models.registry import get_cnn_api
    from repro_torch.serving import CNNStreamEngine, ServeConfig, constant
    from repro_torch.serving.cnn_stream import best_rate_frames

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(2029)
    profiles = {}
    for family in ("mobilenet_v2", "resnet18"):
        api = get_cnn_api(family)
        cfg = api.make_config()
        params = api.init(cfg, torch.Generator().manual_seed(0))
        frames = torch.randn((FRAMES, *cfg.input_hw, 3), generator=gen)
        on_card = frames.cuda()
        for n_stages in (1, 2, 3):
            gp = api.partition(cfg, RATE, n_stages)
            kp = gp.kernel_plan(batch=MICROBATCH)
            config = ServeConfig(microbatch=MICROBATCH, kernel_plan=kp,
                                 arrival=constant(best_rate_frames(gp)))
            batches = []
            for i in range(0, FRAMES, MICROBATCH):
                b = on_card[i:i + MICROBATCH]
                if len(b) < MICROBATCH:
                    b = torch.cat([b, b.new_zeros((MICROBATCH - len(b), *b.shape[1:]))])
                batches.append(b)

            def engine(execute=True):
                eng = CNNStreamEngine(api.graph(cfg), params, gp,
                                      config.with_(execute=execute))
                if execute:
                    eng.submit_all(frames)
                    torch.cuda.synchronize()
                else:
                    for _ in range(FRAMES):
                        eng.submit(None)
                return eng

            def serve(gc_off=False):
                eng = engine()
                if gc_off:
                    gc.disable()
                try:
                    t0 = time.perf_counter()
                    eng.run()
                    eng.outputs()
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) * 1e3
                finally:
                    gc.enable()

            def staged():
                t0 = time.perf_counter()
                for b in batches:
                    api.apply_staged(params, b, cfg, partition=gp, plan=kp)
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            def loop():
                eng = engine(execute=False)
                t0 = time.perf_counter()
                eng.run()
                return (time.perf_counter() - t0) * 1e3

            serve(), staged(), loop()  # warm-up
            times = {"engine": [], "engine_gc_off": [], "staged": [], "loop": []}
            for r in range(ROUNDS):
                order = ("engine", "engine_gc_off", "staged", "loop")
                for name in (order if r % 2 == 0 else order[::-1]):
                    fn = {"engine": serve, "engine_gc_off": lambda: serve(True),
                          "staged": staged, "loop": loop}[name]
                    times[name].append(fn())
            med = {k: statistics.median(v) for k, v in times.items()}
            print(json.dumps({
                "family": family, "stages": n_stages, "frames": FRAMES,
                "microbatch": MICROBATCH, "rounds": ROUNDS, "ms": times,
                "median_ms": med,
                "spread_ms": {k: max(v) - min(v) for k, v in times.items()},
                "frames_per_s": {k: FRAMES / (m / 1e3) for k, m in med.items()
                                 if k != "loop"},
                "engine_minus_staged_ms": med["engine"] - med["staged"],
                "nvidia_smi": smi,
            }), flush=True)
            if n_stages == 3:
                eng = engine()
                prof = cProfile.Profile()
                prof.enable()
                eng.run()
                eng.outputs()
                torch.cuda.synchronize()
                prof.disable()
                stats = pstats.Stats(prof)
                total = sum(v[2] for v in stats.stats.values())
                top = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:15]
                profiles[family] = {
                    "profiled_total_ms": total * 1e3,
                    "top_by_own_time": [
                        {"fn": f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                         "calls": v[1], "own_ms": v[2] * 1e3,
                         "cum_ms": v[3] * 1e3} for k, v in top],
                }
    for family, prof in profiles.items():
        print(json.dumps({"family": family, "stages": 3, "cprofile": prof}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
