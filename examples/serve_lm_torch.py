"""Batched serving demo on the PyTorch / CUDA port: continuous batching
through the slotted engine.

Loads a reduced gemma3-style model, submits a burst of prompts with
different lengths and generation budgets, and drives the engine until
drained — reporting time-to-first-token and throughput.  Slot admission
is the paper's continuous-flow constraint (capacity >= arrival); watch
the engine keep all slots busy while requests churn.

Usage:  PYTHONPATH=src python examples/serve_lm_torch.py --requests 12 --slots 4 [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.models.registry import get_api, resolve_device
from repro_torch.serving.engine import Engine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_config(args.arch), layers=4, d_model=128, vocab=512)
    api = get_api(cfg, dev)
    params = api.init(cfg, torch.Generator(dev).manual_seed(0))
    eng = Engine(cfg, params, slots=args.slots, max_len=128, device=dev)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(4, 24))
        r = Request(rid=i, prompt=prompt.astype(np.int32),
                    max_new=args.max_new)
        reqs.append(r)
        eng.submit(r)

    ticks = tokens = 0
    with torch.no_grad():
        while eng.queue or eng.active:
            tokens += eng.step()
            ticks += 1
    dt = time.perf_counter() - t0

    ttfts = [r.t_first - r.t_submit for r in reqs if r.t_first]
    print(f"[serve_lm] {args.requests} requests, {args.slots} slots, "
          f"{tokens} tokens in {dt:.1f}s ({tokens / dt:.1f} tok/s) on {dev}")
    print(f"[serve_lm] TTFT p50={np.median(ttfts)*1e3:.0f}ms "
          f"p max={max(ttfts)*1e3:.0f}ms | engine ticks {ticks} "
          f"(slot util {tokens / (ticks * args.slots):.2f})")
    assert all(r.done for r in reqs)
    print("[serve_lm] all requests completed")


if __name__ == "__main__":
    main()
