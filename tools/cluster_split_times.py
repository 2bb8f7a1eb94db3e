#!/usr/bin/env python3
"""Time the FCU / KPU kernels' cluster split on and off on one CUDA card.

    python3 tools/cluster_split_times.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  For every FCU and KPU node of MobileNetV2 and ResNet-18 at
224x224, batch 8 and the rate-3 plan (the shapes ``chip_smoke.py``
drives) whose tile the kernel's rule splits over a thread-block
cluster, it launches the kernel with the rule's split and with none
(split 1), holds both against the plain version at 1e-4 of the output's
scale with TF32 off, and prints one JSON line a node with both device
times, then the sums a kernel and the card's name and power limit as
``nvidia-smi`` gives them.  Device ms are CUDA-event medians over 5
repeats of 10 back-to-back launches, split on and off alternating.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
from fractions import Fraction

BATCH = 8
RATE = Fraction(3)
TOL = 1e-4


def cuda_ms(torch, fn, launches=10, repeats=5):
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def node_case(torch, s, t, gen):
    """(kernel, the rule's split, launch(split), plain output) of one node."""
    from repro_torch.kernels import fcu_matmul, kpu_conv

    x = torch.randn((BATCH, *s.in_hw, s.d_in), generator=gen).cuda()
    if s.kind == "conv":
        kh, kw = s.kernel
        stride = s.stride[0]
        w = torch.randn((kh, kw, s.d_in, s.d_out), generator=gen).cuda()
        w = w / (kh * kw * s.d_in) ** 0.5
        split = kpu_conv.cluster_split(x.shape, w.shape, stride=stride,
                                       bm=t.bm, bci=t.bk, bco=t.bn)
        return ("kpu_conv", split,
                lambda sp: kpu_conv._launch(x, w, stride, t.bm, t.bk, t.bn, sp),
                kpu_conv.kpu_conv_plain(x, w, stride))
    x = x.reshape(-1, s.d_in)
    w = torch.randn((s.d_in, s.d_out), generator=gen).cuda() / s.d_in ** 0.5
    bm = fcu_matmul._pick_bm(x.shape[0], t.bm)
    split = fcu_matmul.cluster_split(x.shape[0], s.d_in, s.d_out, bm=bm, bk=t.bk,
                                     bn=t.bn)
    return ("fcu_matmul", split,
            lambda sp: fcu_matmul._launch(x, w, bm, t.bk, t.bn, sp),
            fcu_matmul.fcu_matmul_plain(x, w))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cluster_split_times: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.models.registry import get_cnn_api

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2026)
    sums = {}
    for family in ("mobilenet_v2", "resnet18"):
        api = get_cnn_api(family)
        cfg = api.make_config()
        graph = api.graph(cfg)
        for name, ip in api.plan(cfg, RATE).items():
            s, t = graph.spec(name), ip.tile
            if not ip.has_kernel or s.kind not in ("pointwise", "dense", "conv"):
                continue
            kernel, split, launch, plain = node_case(torch, s, t, gen)
            if split <= 1:
                continue
            scale = max(1.0, plain.abs().max().item())
            err = {}
            for label, sp in (("on", 0), ("off", 1)):
                err[label] = (launch(sp) - plain).abs().max().item()
                if err[label] > TOL * scale:
                    raise SystemExit(f"{family}/{name} split {label}: max|err| "
                                     f"{err[label]} > {TOL} x {scale}")
            ms = {"on": [], "off": []}
            for label, sp in (("on", 0), ("off", 1), ("off", 1), ("on", 0)):
                ms[label].append(cuda_ms(torch, lambda: launch(sp)))
            row = {"node": f"{family}/{name}", "kernel": kernel, "split": split,
                   "ms_split_on": statistics.mean(ms["on"]),
                   "ms_split_off": statistics.mean(ms["off"]),
                   "rel_err_on": err["on"] / scale, "rel_err_off": err["off"] / scale}
            print(json.dumps(row), flush=True)
            total = sums.setdefault(kernel, {"nodes": 0, "ms_split_on": 0.0,
                                             "ms_split_off": 0.0})
            total["nodes"] += 1
            total["ms_split_on"] += row["ms_split_on"]
            total["ms_split_off"] += row["ms_split_off"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"sums": sums, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
