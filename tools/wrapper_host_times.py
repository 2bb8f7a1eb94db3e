#!/usr/bin/env python3
"""Time the host side of the flash and SSD kernel wrappers on one CUDA card.

    python3 tools/wrapper_host_times.py [--src DIR] [--calls N]

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  ``--src`` names the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's), so that two trees can be compared in
one run on one card: run it over each, in turns.  At shapes so small that
the host sets the pace (flash: q, k, v [1, 2, 64, 64] bf16, causal; SSD:
x [1, 64, 2, 16] f32, one group of state 16, chunk 64), it times N calls
back to back of each wrapper and, where the tree has them, of the kernels'
custom ops (``torch.ops.repro_torch.flash_attention`` / ``ssd_chunk``, the
dry run's traced route), and prints one JSON line: host µs a call, the
tree, and the card's name and power limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def host_us(torch, fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                  "..", "src"))
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("wrapper_host_times: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import _build, flash_attention, ssd_chunk

    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 2, 64, 64), device="cuda", generator=gen).to(torch.bfloat16)
    x = torch.randn((1, 64, 2, 16), device="cuda", generator=gen)
    dt = torch.rand((1, 64, 2), device="cuda", generator=gen)
    a = -torch.rand((2,), device="cuda", generator=gen)
    b = torch.randn((1, 64, 1, 16), device="cuda", generator=gen)
    fns = {"flash_attention": lambda: flash_attention.flash_attention(
               q, q, q, block_q=64, block_k=64),
           "ssd_chunk": lambda: ssd_chunk.ssd_chunk(x, dt, a, b, b, chunk=64)}
    if hasattr(torch.ops.repro_torch, "flash_attention"):
        fns["flash_attention_op"] = lambda: torch.ops.repro_torch.flash_attention(
            q, q, q, True, 64, 64)
        fns["ssd_chunk_op"] = lambda: torch.ops.repro_torch.ssd_chunk(x, dt, a, b, b, 64)
    out = {name: host_us(torch, fn, args.calls) for name, fn in fns.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"tree": os.path.abspath(args.src), "calls": args.calls,
                      "host_us": out, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
