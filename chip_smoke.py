#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main paths once on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit (nvcc).  It imports nothing of JAX and nothing of the JAX
package (``src/repro``); it uses ``src/repro_torch`` only.  Phases, each
printing JSON lines:

1. device — torch / CUDA versions; TF32 is turned off for matmuls and
   cuDNN convolutions (the yardsticks below), and the card's name and
   power limit are printed as ``nvidia-smi`` gives them;
2. build — the kernels' nvcc build (``repro_torch.kernels._build``), and
   ptxas's registers and spills for each instance of the bf16 flash
   kernel (``flash_kernel_wgmma``), of the FCU and KPU tensor-core kernels
   (``fcu_kernel``, ``kpu_kernel``, f32 and bf16), of the depthwise
   kernel (``dw_kernel``, f32 and bf16) and of the SSD
   phases (``ssd_states``, ``ssd_pass``, ``ssd_output``) from the build's
   ``nvcc.log``; no FCU, KPU or depthwise instance may spill;
3. kernels — every kernel against its plain PyTorch version on the card
   at every shape its main path gives it (MobileNetV2 and ResNet-18 at
   224x224, batch 8, the rate-3 plan's tiles, in f32 and again in bf16;
   qwen2-7b's prefill attention and mamba2's and zamba2's SSD scans at
   the served prompt lengths) plus odd-size extras (the SSD's also with
   bf16 inputs); each with its time, the plain version's, the library
   call's (``torch.matmul`` / ``F.conv2d`` with TF32 off, in the row's
   dtype, and ``F.scaled_dot_product_attention``; none for the SSD) and
   the roofline bound (``BOUND``); FCU and KPU rows name the cluster split
   the kernel's plan takes; and the FCU wrapper's host µs a call beside
   ``torch.matmul``'s;
4. slice — MobileNetV2, then ResNet-18, at 224x224: 4 requests of 8
   frames through ``api.apply(params, x, cfg, plan=kp)``, launch counts
   set to 0 just before and read just after, executed tile == plan on
   every arithmetic node, logits held against the plain path on the card;
   one more forward pass under ``torch.profiler`` gives the device time
   by kernel and the device's busy share of the batch latency, and shows
   every depthwise launch on the 16-byte vector instances; then each
   family's forward in bf16 (``slice_bf16``: bf16 weights and frames),
   held against the plain path in bf16, with its frames/s;
5. partition, staged, int8, replicated — the multi-stage path, for
   MobileNetV2 and ResNet-18 at 224x224 with BATCH frames a request:
   ``api.partition`` at S in STAGES (the stages' nodes and mults, every
   cut edge with its activation shape, the stream buffers' bits at int8
   and at fp32, the planning time); ``api.apply_staged`` with the
   batch-pinned kernel plan, fp32 and then int8 links, REQUESTS requests
   with the launch counts set to 0 just before and read just after (each
   kernel: its arithmetic nodes x requests), executed tile == plan in
   every stage, ``check_monolithic=True`` bit for bit on every request,
   the batch latency beside the monolithic forward's, the host time of
   the pipeline build each staged call makes (median of BUILDS builds),
   the device busy share and the cut-crossing bytes a batch; ``api.quantize`` +
   ``api.apply_int8`` monolithic and at S=3 (bit-identical, both within
   TOL of the plain path's int8 logits); and ResNet-18 at S=3 with the
   replication ``best_replication`` picks, held within TOL of the
   unreplicated monolithic forward;
6. stream — the stream engine (``serving/cnn_stream.py``), for
   MobileNetV2 and ResNet-18 at 224x224, STREAM_FRAMES frames a run at
   micro-batch STREAM_MICROBATCH on the batch-pinned rate-3 plan: (a) S
   = 1, 2, 3 with fp32 links and (b) S = 3 with int8 links, constant
   traffic at BestRate; (c) S = 2, adversarial traffic with a
   STREAM_DEADLINE-tick ``ShedPolicy``; (d) S = 2, bursty traffic with a
   ``SwitchPolicy`` over the rate-3 / rate-6 ladder; (e) S = 2 traced,
   audited by ``obs.audit``.  Each run: launch counts set to 0 just
   before ``run()`` and read after the outputs (each kernel: its
   arithmetic nodes x micro-batches executed, summed over rungs); served
   outputs bit for bit ``apply_staged`` on the same zero-padded
   micro-batches (d: each rung's frames against that rung served alone);
   the report equal to the ``execute=False`` twin's field for field;
   stall-free at BestRate; finite logits; host syncs inside ``run()``
   counted under ``torch.cuda.set_sync_debug_mode("warn")``; wall ms and
   frames/s beside ``apply_staged``'s over the same micro-batches, the
   twin's loop ms, and the busy share of one profiled run;
7. lm, ssm, hybrid — qwen2-7b (bf16 KV cache: the config's int8 cache is
   not ported), then mamba2-780m, then zamba2-1.2b, each at full width
   and depth with random weights from a seeded CUDA generator: the token
   engine serves 4 prompts of 512-2048 tokens on 2 slots, 16 new tokens
   each, launch counts set to 0 just before and read just after (the
   flash kernel once per attention layer or site, the SSD kernel once
   per Mamba2 layer, per prefill); then each prompt's prefill logits on
   the kernels against the same prefill on their plain versions, and
   one prefill and one decode step under ``torch.profiler``;
8. the ``kernels`` line, the card line, and the final ``ok`` line.

Any failure raises: the script then exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from fractions import Fraction

BATCH = 8
REQUESTS = 4
RATE = Fraction(3)
# fp32 against fp32 with another summation order: max |kernel - plain|
# must stay within TOL x max(1, max |plain|); bf16 outputs, each rounded
# once, within BF16_TOL x the same scale (the LM logits, the library
# yardstick).  The flash and SSD kernels are held element by element
# instead, |kernel - plain| <= rtol x |plain| + atol + rms x rms(plain).
# Flash: both sides compute in f32, so a bf16 output differs by at most
# one rounding each side (2^-7 relative), while a late row's typical |o|
# (about 0.05 over 1000 keys) lies far below any fraction of the largest
# |o|.  SSD: the JAX kernel test's 2e-4 (tests/kernels/test_ssd_chunk.py),
# scaled by the element and by the output's RMS.
FLASH_TOL = {"bfloat16": (2.0 ** -7, 1e-4, 0.0), "float32": (1e-4, 1e-5, 0.0)}
SSD_TOL = (2e-4, 0.0, 2e-4)
TOL = 1e-4
BF16_TOL = 3e-2
# The bf16 routes of the CNN kernels, held at the JAX kernel tests' bf16
# tolerances of the output's scale (tests/kernels/test_fcu_matmul.py,
# test_kpu_conv.py, test_dw_conv.py); the SSD's bf16 y, rounded once from
# f32 on each side, at 2^-7 |plain| + 2e-4 rms(plain).
KERNEL_BF16_TOL = {"fcu_matmul": 2e-2, "kpu_conv": 3e-2, "dw_conv": 3e-2}
SSD_BF16_TOL = (2.0 ** -7, 0.0, 2e-4)
# Why the SSM phases hold their prefill logits on an f32 copy of the
# weights: in a deep bf16 stack a difference of a few parts in 10^6 in
# one layer's f32 SSD output flips bf16 roundings, and the flips compound
# through the residual stream, so bf16 logits cannot tell the kernel from
# another summation order of the same sums.  The f32 copy is held at TOL.
# The served bf16 logits are held too, to catch a gross fault on the
# served dtype: within SSM_BF16_FACTOR x the gap measured on an H100
# between the plain path's two SSD forms (the streaming scan against
# ``nn.ssm.ssd_chunked``), as a share of the logits' scale, the largest
# over the four prompts (PERF.md records the run).
SSM_BF16_WITNESS = {"mamba2-780m": 0.0456, "zamba2-1.2b": 0.0351}
SSM_BF16_FACTOR = 3
SSM_CHECK = (f"f32 copy of the weights at TOL; bf16 within {SSM_BF16_FACTOR} x "
             "the plain path's measured other-order gap")
# The multi-stage phases: the stage counts and the wire formats of the cuts.
STAGES = (2, 3)
LINKS = (None, "int8")
BUILDS = 20
# The stream phase: frames a run (8 full micro-batches and one of 4,
# padded), the micro-batch, and run c's SLA deadline in ticks (it sheds
# frames under adversarial traffic at S=2; 64 ticks would shed none).
STREAM_FRAMES = 68
STREAM_MICROBATCH = 8
STREAM_DEADLINE = Fraction(24)
# The serving phases: prompts (tokens), new tokens each, engine shape.
PROMPT_LENS = (512, 1000, 1536, 2048)
MAX_NEW = 16
SLOTS = 2
MAX_LEN = 2304
KERNELS = {
    "fcu_matmul": ("src/repro_torch/kernels/csrc/fcu_matmul.cu",
                   "src/repro/kernels/fcu_matmul/fcu_matmul.py:45"),
    "kpu_conv": ("src/repro_torch/kernels/csrc/kpu_conv.cu",
                 "src/repro/kernels/kpu_conv/kpu_conv.py:79"),
    "dw_conv": ("src/repro_torch/kernels/csrc/dw_conv.cu",
                "src/repro/kernels/dw_conv/dw_conv.py:41"),
    # the bf16 kernel, the served one (f32, off the timed path, runs
    # csrc/flash_attention.cu)
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                        "src/repro/kernels/attention/flash_attention.py:89"),
    "ssd_chunk": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd_chunk/ssd_chunk.py:82"),
}
NO_LIBRARY = {"ssd_chunk": "no single PyTorch call computes the SSD chunked scan"}
KIND_KERNEL = {"conv": "kpu_conv", "dwconv": "dw_conv",
               "pointwise": "fcu_matmul", "dense": "fcu_matmul"}
# The CUDA function each kernel launches (csrc/*.cu), as the profiler names it.
DEVICE_FN = {"fcu_matmul": ("fcu_kernel",), "kpu_conv": ("kpu_kernel",),
             "dw_conv": ("dw_kernel",)}
# The serving paths' device time: the flash and SSD kernels, cuBLAS's
# products, the rest.  Both flash kernels' names contain "flash_kernel"
# (flash_kernel, flash_kernel_wgmma), and the flash class is matched first.
SERVE_DEVICE_FN = {"flash_attention": ("flash_kernel",),
                   "ssd_chunk": ("ssd_states", "ssd_pass", "ssd_output"),
                   "matmul": ("gemm", "gemv", "xmma", "cutlass", "splitK", "nvjet")}
# The FCU and KPU (f32) and the SSD run 3xTF32 on the tensor cores: each
# product three times in TF32 at 495 TFLOP/s, i.e. 165 TFLOP/s of work at
# the gate's fp32 accuracy.  Their f32 rows keep the 67 TFLOP/s CUDA-core
# bound beside it (``bound_ms_fp32``): the FCU's and KPU's for one more PR,
# the SSD's (restated here) for one PR.
TF32_TERMS = 3
TF32_KERNELS = ("fcu_matmul", "kpu_conv", "ssd_chunk")
BOUND = ("max(flops / peak of the route on the H100 SXM (67 TFLOP/s fp32 CUDA "
         "cores: depthwise, f32 flash; 989 TFLOP/s bf16 tensor cores: bf16 flash, "
         "FCU and KPU; f32 FCU, KPU and SSD: 3xTF32, 3 x flops at 495 TFLOP/s "
         "TF32 = 165 TFLOP/s of fp32-accurate work, the 67 TFLOP/s CUDA-core "
         "bound beside it as bound_ms_fp32); bytes / 3.35 TB/s HBM at the "
         "row's element size), each input read once, each output written once; "
         "the SSD's f32 chunk-state workspace is not the function's and stays out "
         "(workspace_bytes and bound_ms_with_workspace beside it)")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, launches: int = 10, repeats: int = 5) -> float:
    """Device ms per call of ``fn``: after a warm-up call, the median
    over ``repeats`` of one CUDA-event pair around ``launches``
    back-to-back calls, divided by ``launches`` (one pair per call
    would also time the host's launch gap after the start event)."""
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


class KernelBench:
    """Holds each kernel against its plain version and times all three."""

    def __init__(self, torch, hw):
        self.torch = torch
        self.hw = hw
        self.rows = []

    def case(self, kernel, label, fn, plain, library, flops, nbytes, timed=True,
             tol=TOL, peak=None, elementwise=None, info=None):
        """``fn`` and ``plain`` return a tensor or a tuple of tensors, each
        held against its counterpart.  ``elementwise=(rtol, atol, rms)``
        holds the kernel to |y - plain| <= rtol x |plain| + atol + rms x
        rms(plain) everywhere instead of ``tol`` x the scale.  ``library``
        is None where no PyTorch call computes the function; else it is
        held at ``tol`` x the scale.  ``info`` is copied into the row."""
        torch = self.torch
        ys, refs = fn(), plain()
        lib = library() if library is not None else None
        torch.cuda.synchronize()
        ys = ys if isinstance(ys, tuple) else (ys,)
        refs = refs if isinstance(refs, tuple) else (refs,)
        err, scale, worst = 0.0, 1.0, 0.0
        for y, ref in zip(ys, refs):
            require(bool(torch.isfinite(y).all()), f"{label}: non-finite output")
            ref = ref.float()
            diff = (y.float() - ref).abs()
            err = max(err, diff.max().item())
            scale = max(scale, ref.abs().max().item())
            if elementwise is not None:
                rtol, atol, rms = elementwise
                limit = rtol * ref.abs() + atol + rms * ref.square().mean().sqrt()
                worst = max(worst, (diff / limit).max().item())
        row = {"node": label, "kernel": kernel, **(info or {}), "max_abs_err": err,
               "rel_err": err / scale, "tolerance": tol}
        if elementwise is None:
            require(err <= tol * scale,
                    f"{label}: kernel vs plain max|err| {err} > {tol} x {scale}")
        else:
            require(worst <= 1.0,
                    f"{label}: kernel vs plain |err| up to {worst} x the limit "
                    f"{elementwise[0]} x |plain| + {elementwise[1]} + "
                    f"{elementwise[2]} x rms(plain)")
            row.update(tolerance={"rtol": elementwise[0], "atol": elementwise[1],
                                  "rms": elementwise[2]}, worst_of_limit=worst)
        if lib is not None:
            lib_err = (lib.float() - refs[0].float()).abs().max().item()
            require(lib_err <= tol * scale,
                    f"{label}: library call vs plain max|err| {lib_err} > {tol} x {scale}")
        if timed:
            t_ops = flops / (peak or self.hw.peak_fp32_flops) * 1e3
            t_bytes = nbytes / self.hw.hbm_bw * 1e3
            row.update(
                ms=cuda_ms(torch, fn), plain_ms=cuda_ms(torch, plain),
                library_ms=cuda_ms(torch, library) if library is not None else None,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                ops_ms=t_ops, bytes_ms=t_bytes,
            )
            if kernel in TF32_KERNELS and "route" not in row:
                row["bound_ms_fp32"] = max(flops / self.hw.peak_fp32_flops * 1e3, t_bytes)
        self.rows.append(row)
        emit(row)


def bench_nodes(torch, bench, family, plan, graph, gen, dtype=None, only=None,
                suffix="", timed=True):
    """Every arithmetic node of ``family``'s main path, at its shapes; on
    bf16 operands with ``dtype=torch.bfloat16`` (rows marked ``route``
    "bf16", labelled ``.../bf16``, at the JAX tests' bf16 tolerances, the
    bound at 2-byte elements and the FCU's and KPU's products at 989
    TFLOP/s).  ``only`` limits the rows to those nodes, labelled with
    ``suffix``; ``timed=False`` checks them without timing."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, dw_conv, fcu_matmul, kpu_conv

    bf16 = dtype == torch.bfloat16
    dtype = dtype or torch.float32
    elem = dtype.itemsize
    mma_peak = bench.hw.peak_bf16_flops if bf16 else bench.hw.peak_tf32_flops / TF32_TERMS
    for name, ip in plan.items():
        if not ip.has_kernel or (only is not None and name not in only):
            continue
        s, t = graph.spec(name), ip.tile
        kernel = KIND_KERNEL[s.kind]
        label = f"{family}/{name}" + ("/bf16" if bf16 else "") + suffix
        tol = KERNEL_BF16_TOL[kernel] if bf16 else TOL
        info = {"route": "bf16"} if bf16 else {}
        x = torch.randn((BATCH, *s.in_hw, s.d_in), generator=gen).to("cuda", dtype)
        macs = s.total_macs * BATCH
        out_elems = BATCH * s.out_hw[0] * s.out_hw[1] * s.d_out
        if s.kind in ("pointwise", "dense"):
            x2 = x.reshape(-1, s.d_in)
            w = (torch.randn((s.d_in, s.d_out), generator=gen) / s.d_in ** 0.5).to(
                "cuda", dtype)
            bm = fcu_matmul._pick_bm(x2.shape[0], t.bm)
            split = fcu_matmul.cluster_split(x2.shape[0], s.d_in, s.d_out, bm=bm,
                                             bk=t.bk, bn=t.bn, dtype=dtype)
            bench.case(
                kernel, label,
                lambda: fcu_matmul.fcu_matmul(x2, w, bm=bm, bk=t.bk, bn=t.bn),
                lambda: fcu_matmul.fcu_matmul_plain(x2, w),
                lambda: torch.matmul(x2, w),
                2 * macs, elem * (x2.numel() + w.numel() + out_elems),
                tol=tol, peak=mma_peak, info={**info, "split": split}, timed=timed,
            )
            continue
        kh, kw = s.kernel
        stride = s.stride[0]
        _, (pt, pb) = _build.same_pads(s.in_hw[0], kh, stride)
        _, (pl, pr) = _build.same_pads(s.in_hw[1], kw, stride)
        xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
        if s.kind == "conv":
            w = torch.randn((kh, kw, s.d_in, s.d_out), generator=gen)
            w = (w / (kh * kw * s.d_in) ** 0.5).to("cuda", dtype)
            w_oihw = w.permute(3, 2, 0, 1)
            split = kpu_conv.cluster_split(x.shape, w.shape, stride=stride, bm=t.bm,
                                           bci=t.bk, bco=t.bn, dtype=dtype)
            bench.case(
                kernel, label,
                lambda: kpu_conv.kpu_conv(x, w, stride=stride, bm=t.bm,
                                          bci=t.bk, bco=t.bn),
                lambda: kpu_conv.kpu_conv_plain(x, w, stride),
                lambda: F.conv2d(xp, w_oihw, stride=stride).permute(0, 2, 3, 1),
                2 * macs, elem * (x.numel() + w.numel() + out_elems),
                tol=tol, peak=mma_peak, info={**info, "split": split}, timed=timed,
            )
        else:
            w = (torch.randn((kh, kw, s.d_in), generator=gen) / (kh * kw) ** 0.5).to(
                "cuda", dtype)
            w_oihw = w.permute(2, 0, 1).unsqueeze(1)
            bench.case(
                kernel, label,
                lambda: dw_conv.dw_conv(x, w, stride=stride, bm=t.bm, bc=t.bk),
                lambda: dw_conv.dw_conv_plain(x, w, stride),
                lambda: F.conv2d(xp, w_oihw, stride=stride,
                                 groups=s.d_in).permute(0, 2, 3, 1),
                2 * macs, elem * (x.numel() + w.numel() + out_elems),
                tol=tol, info=info, timed=timed,
            )


def bench_extras(torch, bench, gen):
    """Odd spatial sizes and ragged channels off the 224 path (checked,
    not timed, not counted in the kernels line)."""
    import torch.nn.functional as F

    from repro_torch.core.tiles import dw_rows, plan_dim_tile, select_tile
    from repro_torch.kernels import _build, dw_conv, fcu_matmul, kpu_conv

    for hw, cin, cout, k, s in [(15, 24, 32, 3, 2), (17, 3, 64, 7, 2),
                                (13, 144, 24, 1, 2), (9, 960, 40, 3, 1)]:
        x = torch.randn((2, hw, hw, cin), generator=gen).cuda()
        w = torch.randn((k, k, cin, cout), generator=gen).cuda() / (k * k * cin) ** 0.5
        ho, (pt, pb) = _build.same_pads(hw, k, s)
        t = select_tile(ho * ho, cin, cout)
        xp = F.pad(x, (0, 0, pt, pb, pt, pb)).permute(0, 3, 1, 2)
        bench.case(
            "kpu_conv", f"extra/conv{hw}x{hw}x{cin}-{cout}k{k}s{s}",
            lambda: kpu_conv.kpu_conv(x, w, stride=s, bm=t.bm, bci=t.bk, bco=t.bn),
            lambda: kpu_conv.kpu_conv_plain(x, w, s),
            lambda: F.conv2d(xp, w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1),
            0, 0, timed=False,
        )
    for hw, c, s in [(15, 144, 2), (7, 960, 1), (11, 24, 2)]:
        x = torch.randn((2, hw, hw, c), generator=gen).cuda()
        w = torch.randn((3, 3, c), generator=gen).cuda() / 3.0
        ho, (pt, pb) = _build.same_pads(hw, 3, s)
        bc = plan_dim_tile(c, 1)
        xp = F.pad(x, (0, 0, pt, pb, pt, pb)).permute(0, 3, 1, 2)
        bench.case(
            "dw_conv", f"extra/dw{hw}x{hw}x{c}s{s}",
            lambda: dw_conv.dw_conv(x, w, stride=s, bm=dw_rows(ho, ho, bc) * ho, bc=bc),
            lambda: dw_conv.dw_conv_plain(x, w, s),
            lambda: F.conv2d(xp, w.permute(2, 0, 1).unsqueeze(1), stride=s,
                             groups=c).permute(0, 2, 3, 1),
            0, 0, timed=False,
        )
    for m, cin, cout in [(450, 24, 144), (3, 1280, 1000), (1001, 960, 160)]:
        x = torch.randn((m, cin), generator=gen).cuda()
        w = torch.randn((cin, cout), generator=gen).cuda() / cin ** 0.5
        t = select_tile(m, cin, cout)
        bm = fcu_matmul._pick_bm(m, t.bm)
        bench.case(
            "fcu_matmul", f"extra/fcu{m}x{cin}-{cout}",
            lambda: fcu_matmul.fcu_matmul(x, w, bm=bm, bk=t.bk, bn=t.bn),
            lambda: fcu_matmul.fcu_matmul_plain(x, w),
            lambda: torch.matmul(x, w),
            0, 0, timed=False,
        )
    # one-row tiles: one live row of a 64-row wgmma atom; bn = 4 padded to
    # the wgmma width 8
    x = torch.randn((1, 2, 2, 3), generator=gen).cuda()
    w = torch.randn((3, 3, 3, 32), generator=gen).cuda() / 27 ** 0.5
    bench.case(
        "kpu_conv", "extra/conv2x2x3-32k3s2-bm1",
        lambda: kpu_conv.kpu_conv(x, w, stride=2, bm=1, bci=3, bco=32),
        lambda: kpu_conv.kpu_conv_plain(x, w, 2),
        lambda: F.conv2d(F.pad(x, (0, 0, 0, 1, 0, 1)).permute(0, 3, 1, 2),
                         w.permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1),
        0, 0, timed=False,
    )
    xf = torch.randn((1, 24), generator=gen).cuda()
    wf = torch.randn((24, 4), generator=gen).cuda() / 24 ** 0.5
    bench.case(
        "fcu_matmul", "extra/fcu1x24-4-bm1",
        lambda: fcu_matmul.fcu_matmul(xf, wf, bm=1, bk=24, bn=4),
        lambda: fcu_matmul.fcu_matmul_plain(xf, wf),
        lambda: torch.matmul(xf, wf),
        0, 0, timed=False,
    )


def wrapper_host_us(torch, calls=2000):
    """Host µs a call of the FCU wrapper (checks, output allocation,
    ctypes launch with the kernel's host-side plan) and of ``torch.matmul``, on an [8, 64] x
    [64, 8] product so small that the host, not the card, sets the pace:
    the floor under a kernel row's time where launches run back to
    back.  The launches here are outside every counted window."""
    from repro_torch.kernels import fcu_matmul

    x = torch.randn((8, 64), device="cuda")
    w = torch.randn((64, 8), device="cuda")
    out = {}
    for name, fn in (("fcu_matmul", lambda: fcu_matmul.fcu_matmul(x, w, bm=8, bk=64, bn=8)),
                     ("torch.matmul", lambda: torch.matmul(x, w))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    emit({"phase": "wrapper_host_us", "shape": [8, 64, 8], "calls": calls, **out})


def ptxas_report(lib_path, kernel):
    """Registers, stack and spills ptxas reported for each instance of
    ``kernel`` (its element type and integer template arguments from the
    mangled name), read from the build's ``nvcc.log``."""
    import re

    log = os.path.join(os.path.dirname(lib_path), "nvcc.log")
    rows, cur = [], None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = None
                # the kernel's name as the mangling spells it, then its
                # template arguments: element type, integers
                at = m.group(1).find(f"{len(kernel)}{kernel}")
                if at >= 0:
                    rest = m.group(1)[at + len(f"{len(kernel)}{kernel}"):]
                    args = re.match(r"I(f|13__nv_bfloat16)?((?:Li\d+E)*)E", rest)
                    cur = {"dtype": {"f": "float32", "13__nv_bfloat16": "bfloat16"}.get(
                               args.group(1)) if args else None,
                           "template": [int(a) for a in re.findall(r"\d+", args.group(2))]
                           if args else []}
                    rows.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m:
                cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m[1])
            if "C7512" in line or "setmaxnreg ignored" in line:
                cur["warning"] = line.strip()[:160]
    require(rows, f"no {kernel} in {log}")
    return rows


def device_ms_by_kernel(torch, fn, classes=DEVICE_FN):
    """One call of ``fn`` under ``torch.profiler``: device ms summed per
    class of device function (``classes``: name -> substrings of the
    function's name), the rest (bias, activation, joins, pooling, norms,
    copies) under "other" (empty if the profiler saw no device activity);
    the call's host-clock ms, ending in a synchronize; and every device
    function as (ms, calls, name), the longest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out, by_fn = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        name = next((k for k, subs in classes.items()
                     if any(f in e.key for f in subs)), "other")
        out[name] = out.get(name, 0.0) + e.device_time_total / 1e3
        by_fn.append((e.device_time_total / 1e3, e.count, e.key))
    return out, wall, sorted(by_fn, reverse=True)


def reset_counts(kernels_mod) -> None:
    for name in KERNELS:
        getattr(kernels_mod[name], name).launches = 0


def read_counts(kernels_mod) -> dict:
    return {name: getattr(kernels_mod[name], name).launches for name in KERNELS}


def run_slice(torch, family, kernels_mod, gen, bench, dtype=None):
    """One family's main path: REQUESTS batches of BATCH frames through
    the rate-matched forward pass on the card; with ``dtype=torch.bfloat16``
    the same forward in bf16 (weights, frames and logits; phase
    ``slice_bf16``, logits at BF16_TOL of their scale, off the main path:
    its launches stay out of the kernels line)."""
    from repro_torch.kernels.fcu_matmul import _pick_bm
    from repro_torch.models.registry import get_cnn_api

    bf16 = dtype == torch.bfloat16
    tol = BF16_TOL if bf16 else TOL
    api = get_cnn_api(family)
    cfg = api.make_config(dtype=dtype or torch.float32)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    kp = api.plan(cfg, RATE)
    graph = api.graph(cfg)
    xs = [torch.randn((BATCH, *cfg.input_hw, 3), generator=gen)
          for _ in range(REQUESTS)]
    api.apply(params, xs[0], cfg, plan=kp)  # warm-up
    torch.cuda.synchronize()

    reset_counts(kernels_mod)
    logits, latency_ms, executed = [], [], []
    for x in xs:
        ex = {}
        t0 = time.perf_counter()
        y = api.apply(params, x, cfg, plan=kp, executed=ex)
        torch.cuda.synchronize()
        latency_ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(y)
        executed.append(ex)
    counts = read_counts(kernels_mod)

    arith = [n for n, ip in kp.items() if ip.has_kernel]
    want = {k: 0 for k in KERNELS}
    for n in arith:
        want[KIND_KERNEL[kp[n].kind]] += REQUESTS
    require(counts == want, f"{family}: launches {counts} != nodes x requests {want}")
    for ex in executed:
        require(sorted(ex) == sorted(arith), f"{family}: executed tiles miss nodes")
        for n in arith:
            t, got, spec = kp[n].tile, ex[n], graph.spec(n)
            bm = t.bm
            if spec.kind in ("pointwise", "dense"):
                bm = _pick_bm(BATCH * spec.out_hw[0] * spec.out_hw[1], t.bm)
            require((got["bk"], got["bn"], got["bm"]) == (t.bk, t.bn, bm),
                    f"{family}/{n}: executed {got} != plan {t}")

    plain_ms, errs = [], []
    for x, y in zip(xs, logits):
        require(tuple(y.shape) == (BATCH, cfg.num_classes) and y.dtype == cfg.dtype,
                f"{family}: logits {tuple(y.shape)} {y.dtype}")
        require(bool(torch.isfinite(y).all()), f"{family}: non-finite logits")
        t0 = time.perf_counter()
        ref = api.apply(params, x, cfg)  # the plain versions, on the card
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        scale = max(1.0, ref.abs().max().item())
        err = (y.float() - ref.float()).abs().max().item()
        require(err <= tol * scale,
                f"{family}: logits vs plain path max|err| {err} > {tol} x {scale}")
        errs.append(err / scale)
    device_ms, _, fns = device_ms_by_kernel(
        torch, lambda: api.apply(params, xs[0], cfg, plan=kp))
    # The planned depthwise tiles are whole 16-byte channel vectors, so
    # every depthwise launch of the main path runs the vector instances
    # (dw_kernel<element, 16 bytes of channels, stride>), none the
    # element-at-a-time ones.
    dw_fns = sorted({key for _, _, key in fns if "dw_kernel" in key})
    vec = 16 // cfg.dtype.itemsize
    require(all(re.search(rf"dw_kernel<[^,<>]+, {vec}, [12]>", k) for k in dw_fns),
            f"{family}: depthwise time outside the {vec}-channel vector kernel: {dw_fns}")
    busy_ms = sum(device_ms.values())
    latency = statistics.median(latency_ms)
    isolated = {k: sum(r["ms"] for r in bench.rows if r["kernel"] == k and "ms" in r
                       and (r.get("route") == "bf16") == bf16
                       and r["node"].startswith(family + "/")) for k in KERNELS}
    row = {
        "phase": "slice_bf16" if bf16 else "slice", "family": family,
        "input_hw": list(cfg.input_hw), "batch": BATCH, "requests": REQUESTS,
        "rate": str(RATE), "arith_nodes": len(arith), "launches": counts,
        "executed_tile_eq_plan": True,
        "frames_per_s": BATCH * REQUESTS / (sum(latency_ms) / 1e3),
        "latency_ms": latency_ms, "latency_ms_median": latency,
        "plain_path_latency_ms_median": statistics.median(plain_ms),
        "profiled_device_ms": device_ms,
        "dw_instances": [re.search(r"dw_kernel<[^<>]*>", k)[0] for k in dw_fns],
        "device_busy_share": busy_ms / latency if device_ms else None,
        "kernel_ms_isolated": isolated,
        "logits_max_rel_err": max(errs), "tolerance": tol,
    }
    emit(row)
    return counts


def repinned_nodes(plan, pinned, graph) -> set:
    """The nodes whose batch-pinned tile runs another (bk, bn, bm) than the
    main path's plan executes at BATCH frames."""
    from repro_torch.kernels.fcu_matmul import _pick_bm

    out = set()
    for n, ip in plan.items():
        if not ip.has_kernel:
            continue
        spec, t, tp = graph.spec(n), ip.tile, pinned[n].tile
        bm = t.bm
        if spec.kind in ("pointwise", "dense"):
            bm = _pick_bm(BATCH * spec.out_hw[0] * spec.out_hw[1], t.bm)
        if (t.bk, t.bn, bm) != (tp.bk, tp.bn, tp.bm):
            out.add(n)
    return out


def want_launches(plan, requests: int) -> dict:
    """Each kernel's launches for ``requests`` forwards of ``plan``: its
    arithmetic nodes x requests."""
    want = {k: 0 for k in KERNELS}
    for ip in plan.values():
        if ip.has_kernel:
            want[KIND_KERNEL[ip.kind]] += requests
    return want


def timed_calls(torch, fn, xs):
    """``fn(x)`` for each x, host-clock ms each, ending in a synchronize."""
    outs, ms = [], []
    for x in xs:
        t0 = time.perf_counter()
        outs.append(fn(x))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def rel_err(torch, got, want) -> float:
    scale = max(1.0, want.abs().max().item())
    return (got.float() - want.float()).abs().max().item() / scale


def cut_bytes(graph, stage_plan, batch: int) -> dict:
    """Bytes that cross the cuts a batch, one stream per exported
    producer, at fp32 and as int8 payloads (one int8 a feature plus the
    4-byte scale)."""
    stage_of = stage_plan.stage_index()
    producers = {u for v in graph.topo_order() for u in graph.preds(v)
                 if stage_of[u] != stage_of[v]}
    feats = [batch * graph.spec(u).out_hw[0] * graph.spec(u).out_hw[1]
             * graph.spec(u).d_out for u in producers]
    return {"producers": len(producers), "fp32": 4 * sum(feats),
            "int8": sum(feats) + 4 * len(feats)}


def run_partition(api, cfg, family):
    """``api.partition`` at each S: stages, cuts, stream buffers, time."""
    from repro_torch.core.stage_partition import stream_buffers

    graph = api.graph(cfg)
    plans = {}
    for n_stages in STAGES:
        t0 = time.perf_counter()
        gp = api.partition(cfg, RATE, n_stages)
        plan_s = time.perf_counter() - t0
        sp = gp.stage_plan
        fp32 = stream_buffers(gp, sp, link_dtype="fp32")
        require(gp.continuous_flow and not any(gp.stage_infeasible_nodes()),
                f"{family}/S={n_stages}: a stage cannot absorb its rate")
        emit({
            "phase": "partition", "family": family, "stages": n_stages,
            "rate": str(RATE), "plan_s": plan_s,
            "stage_nodes": [len(sp.stage_nodes(s)) for s in range(n_stages)],
            "stage_mults": gp.stage_mults(),
            "cut_edges": [{"src": u, "dst": v, "shape": [*graph.spec(u).out_hw,
                                                         graph.spec(u).d_out]}
                          for cut in sp.cut_edges for u, v in cut],
            "stream_buffers": [{"src": b.src, "dst": b.dst, "int8_bits": b.bits,
                                "fp32_bits": f.bits, "depth_words": b.depth_words}
                               for b, f in zip(gp.stream_bufs, fp32)],
            "stream_bits": {"int8": gp.total_stream_bits,
                            "fp32": sum(b.bits for b in fp32)},
            "cut_bytes_per_batch": cut_bytes(graph, sp, BATCH),
        })
        plans[n_stages] = gp
    return plans


def run_staged(torch, family, kernels_mod, gen):
    """The multi-stage path of one family on the card (phases
    ``partition``, ``staged``, ``int8``, and ``replicated`` for ResNet-18);
    returns the launches of its counted runs, per kernel."""
    from repro_torch.core.graph import plan_graph
    from repro_torch.core.replicate import best_replication, replicate_params
    from repro_torch.models.cnn import apply_graph, cut_edge_dtypes, stage_functions
    from repro_torch.models.registry import get_cnn_api

    api = get_cnn_api(family)
    cfg = api.make_config()
    graph = api.graph(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    xs = [torch.randn((BATCH, *cfg.input_hw, 3), generator=gen).cuda()
          for _ in range(REQUESTS)]
    plans = run_partition(api, cfg, family)
    kp = plans[STAGES[0]].kernel_plan(batch=BATCH)
    arith = [n for n, ip in kp.items() if ip.has_kernel]
    total = {k: 0 for k in KERNELS}

    def counted(label, fn, plan, per_request=1):
        """REQUESTS calls of ``fn`` between a reset and a read of the
        launch counts; every kernel must launch its nodes x requests."""
        fn(xs[0])  # warm-up
        torch.cuda.synchronize()
        reset_counts(kernels_mod)
        outs, ms = timed_calls(torch, fn, xs)
        counts = read_counts(kernels_mod)
        want = want_launches(plan, REQUESTS * per_request)
        require(counts == want, f"{label}: launches {counts} != nodes x requests {want}")
        for k, v in counts.items():
            total[k] += v
        for y in outs:
            require(tuple(y.shape) == (BATCH, cfg.num_classes) and y.dtype == cfg.dtype
                    and bool(torch.isfinite(y).all()), f"{label}: logits {tuple(y.shape)}")
        return outs, ms, counts

    mono, mono_ms, _ = counted(f"{family}/monolithic",
                               lambda x: api.apply(params, x, cfg, plan=kp), kp)
    mono_device, _, _ = device_ms_by_kernel(
        torch, lambda: api.apply(params, xs[0], cfg, plan=kp))
    for n_stages in STAGES:
        gp = plans[n_stages]
        kps = gp.kernel_plan(batch=BATCH)
        require(kps == kp, f"{family}/S={n_stages}: the stage plan changed a tile")
        for link in LINKS:
            label = f"{family}/S={n_stages}/{link or 'fp32'}"

            def staged(x, link=link):
                # builds the stages afresh each call; the executor asserts
                # executed tile == plan on every node
                return api.apply_staged(params, x, cfg, partition=gp, plan=kps,
                                        link_quant=link)

            outs, ms, counts = counted(label, staged, kps)
            ex = {}
            api.apply_staged(params, xs[0], cfg, partition=gp, plan=kps, link_quant=link,
                             executed=ex)
            require(sorted(ex) == sorted(arith), f"{label}: executed tiles miss nodes")
            for n in arith:
                t = kps[n].tile
                require((ex[n]["bk"], ex[n]["bn"], ex[n]["bm"]) == (t.bk, t.bn, t.bm),
                        f"{label}/{n}: executed {ex[n]} != plan {t}")
            for x, y in zip(xs, outs):
                # raises unless every cut tensor and the logits are bit-identical
                # to the monolithic forward (with the same fake-quant at the cuts)
                y2 = api.apply_staged(params, x, cfg, partition=gp, plan=kps,
                                      link_quant=link, check_monolithic=True)
                require(torch.equal(y, y2), f"{label}: two staged runs differ")
            if link is None:
                require(all(torch.equal(y, m) for y, m in zip(outs, mono)),
                        f"{label}: fp32 links differ from the monolithic forward")
                yard, yard_name = mono, "monolithic forward (bit-identical)"
            else:
                qmap = cut_edge_dtypes(graph, gp, link)
                yard = [apply_graph(params, x, graph, plan=kps, link_quant=qmap)
                        for x in xs]
                require(all(torch.equal(y, m) for y, m in zip(outs, yard)),
                        f"{label}: int8 links differ from the monolithic fake-quant")
                yard_name = "monolithic forward with the same fake-quant (bit-identical)"
            device_ms, _, _ = device_ms_by_kernel(torch, lambda: staged(xs[0]))
            latency = statistics.median(ms)
            builds = []  # host ms of the pipeline build each staged call makes
            for _ in range(BUILDS):
                t0 = time.perf_counter()
                stage_functions(graph, partition=gp, plan=kps, link_quant=link)
                builds.append((time.perf_counter() - t0) * 1e3)
            emit({
                "phase": "staged", "family": family, "stages": n_stages,
                "link": link or "fp32", "batch": BATCH, "requests": REQUESTS,
                "launches": counts, "arith_nodes": len(arith),
                "executed_tile_eq_plan": True, "check_monolithic": "bit-identical",
                "latency_ms": ms, "latency_ms_median": latency,
                "frames_per_s": BATCH * REQUESTS / (sum(ms) / 1e3),
                "pipeline_build_ms_median": statistics.median(builds),
                "pipeline_build_share": statistics.median(builds) / latency,
                "monolithic_latency_ms_median": statistics.median(mono_ms),
                "monolithic_frames_per_s": BATCH * REQUESTS / (sum(mono_ms) / 1e3),
                "profiled_device_ms": device_ms,
                "device_ms": sum(device_ms.values()),
                "monolithic_device_ms": sum(mono_device.values()),
                "device_busy_share": sum(device_ms.values()) / latency,
                "cut_bytes_per_batch": cut_bytes(graph, gp.stage_plan, BATCH),
                "yardstick": yard_name,
                "max_rel_err": max(rel_err(torch, y, m) for y, m in zip(outs, yard)),
                "max_rel_err_vs_fp32_monolithic":
                    max(rel_err(torch, y, m) for y, m in zip(outs, mono)),
            })

    # the int8 weight datapath, monolithic and at the deepest cut
    gp = plans[STAGES[-1]]
    q, scales = api.quantize(params)
    plain = [api.apply_int8(q, scales, x, cfg) for x in xs]
    int8_mono, ms_mono, c_mono = counted(
        f"{family}/int8", lambda x: api.apply_int8(q, scales, x, cfg, plan=kp), kp)
    int8_staged, ms_staged, c_staged = counted(
        f"{family}/int8/S={STAGES[-1]}",
        lambda x: api.apply_int8(q, scales, x, cfg, plan=kp, partition=gp), kp)
    require(all(torch.equal(a, b) for a, b in zip(int8_mono, int8_staged)),
            f"{family}: int8 staged differs from int8 monolithic")
    errs = [rel_err(torch, y, p) for y, p in zip(int8_mono, plain)]
    require(max(errs) <= TOL, f"{family}: int8 logits vs plain path {max(errs)} > {TOL}")
    emit({
        "phase": "int8", "family": family, "stages": STAGES[-1], "batch": BATCH,
        "launches": {"monolithic": c_mono, "staged": c_staged},
        "staged_eq_monolithic": "bit-identical",
        "latency_ms_median": statistics.median(ms_mono),
        "staged_latency_ms_median": statistics.median(ms_staged),
        "f32_latency_ms_median": statistics.median(mono_ms),
        "max_rel_err_vs_plain_int8": max(errs), "tolerance": TOL,
        "max_rel_err_vs_f32_weights": max(rel_err(torch, a, b)
                                          for a, b in zip(int8_mono, mono)),
    })

    if family == "resnet18":
        best = best_replication(graph, RATE, n_stages=STAGES[-1])
        rep = {r.node: r.r for r in best.replications}
        require(rep, "best_replication kept the unreplicated plan")
        gpr = plan_graph(graph, RATE, n_stages=STAGES[-1], replicate=rep)
        kpr = gpr.kernel_plan(batch=BATCH)
        rparams = replicate_params(params, gpr.replications)
        outs, ms, counts = counted(
            f"{family}/replicated",
            lambda x: api.apply_staged(rparams, x, cfg, graph=gpr.graph, partition=gpr,
                                       plan=kpr), kpr)
        errs = [rel_err(torch, y, m) for y, m in zip(outs, mono)]
        require(max(errs) <= TOL,
                f"{family}/replicated: logits vs unreplicated {max(errs)} > {TOL}")
        emit({
            "phase": "replicated", "family": family, "stages": STAGES[-1],
            "replicate": rep, "stage_mults": gpr.stage_mults(),
            "unreplicated_stage_mults": gp.stage_mults(), "launches": counts,
            "latency_ms_median": statistics.median(ms),
            "monolithic_latency_ms_median": statistics.median(mono_ms),
            "max_rel_err_vs_unreplicated_monolithic": max(errs), "tolerance": TOL,
        })
    return total


def _plain(obj):
    """Builtins for a field-by-field comparison of two reports (dataclasses
    as their ``==`` fields, Fractions kept exact)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return tuple((f.name, _plain(getattr(obj, f.name)))
                     for f in dataclasses.fields(obj) if f.compare)
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(v) for v in obj)
    return obj


def padded_batches(torch, frames, rids, microbatch):
    """The engine's micro-batches: ``rids`` in admission order, in groups of
    ``microbatch``, the last zero-padded (the engine pads on the device)."""
    out = []
    for i in range(0, len(rids), microbatch):
        idx = rids[i:i + microbatch]
        b = frames[idx]
        if len(idx) < microbatch:
            b = torch.cat([b, torch.zeros((microbatch - len(idx), *b.shape[1:]),
                                          dtype=b.dtype, device=b.device)])
        out.append((idx, b))
    return out


def run_stream(torch, family, kernels_mod, gen):
    """The stream engine (``serving/cnn_stream.py``) on the card, runs a-e
    of one family at 224x224 (phase ``stream``); returns the launches of
    its counted runs, per kernel."""
    import warnings

    from repro_torch.obs import audit
    from repro_torch.serving import (CNNStreamEngine, PlanLadder, ServeConfig,
                                     ShedPolicy, SwitchPolicy, adversarial, bursty,
                                     constant)
    from repro_torch.serving.cnn_stream import best_rate_frames
    from repro_torch.models.registry import get_cnn_api

    api = get_cnn_api(family)
    cfg = api.make_config()
    graph = api.graph(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    frames_cpu = torch.randn((STREAM_FRAMES, *cfg.input_hw, 3), generator=gen)
    frames = frames_cpu.cuda()
    total = {k: 0 for k in KERNELS}

    t0 = time.perf_counter()
    ladder = PlanLadder.build(graph, RATE, n_stages=2, rate_factors=(1, 2))
    ladder_s = time.perf_counter() - t0
    runs = []
    for n_stages in (1, 2, 3):
        runs.append(("a", n_stages, None, "constant", None, {}))
    runs.append(("b", 3, "int8", "constant", None, {"link_dtype": "int8"}))
    runs.append(("c", 2, None, "adversarial", "shed", {}))
    runs.append(("d", 2, None, "bursty", "switch", {}))
    runs.append(("e", 2, None, "constant", "traced", {}))

    for run, n_stages, link, traffic, policy, dse in runs:
        label = f"{family}/stream/{run}/S={n_stages}/{link or 'fp32'}"
        gp = ladder.rungs[0].plan if policy == "switch" else api.partition(
            cfg, RATE, n_stages, **dse)
        br = best_rate_frames(gp)
        arrival = {"constant": constant(br), "adversarial": adversarial(br),
                   "bursty": bursty(2 * br, burst=32, gap=48)}[traffic]
        overload = {"shed": ShedPolicy(STREAM_DEADLINE),
                    "switch": SwitchPolicy(ladder, window_ticks=16)}.get(policy)
        kp = gp.kernel_plan(batch=STREAM_MICROBATCH)
        config = ServeConfig(microbatch=STREAM_MICROBATCH, kernel_plan=kp,
                             link_quant=True if link else None, arrival=arrival,
                             overload=overload, trace=policy == "traced")

        def engine(execute=True):
            eng = CNNStreamEngine(graph, params, gp, config.with_(execute=execute))
            if execute:
                eng.submit_all(frames_cpu)  # one copy of the whole stack
                torch.cuda.synchronize()
            else:
                for _ in range(STREAM_FRAMES):
                    eng.submit(None)
            return eng

        def serve(eng, syncs=None):
            """run() and outputs() on the host clock, up to the outputs
            synchronized; with ``syncs`` (a list), the run and the output
            stack under the sync debug mode, its warnings appended."""
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if syncs is not None:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    rep = eng.run()
                    out = eng.outputs()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if syncs is not None:
                syncs += [str(w.message) for w in caught
                          if "synchroniz" in str(w.message)]
            return rep, out, ms

        serve(engine())  # warm-up
        eng = engine()
        host_syncs = []
        reset_counts(kernels_mod)
        rep, out, wall_ms = serve(eng, host_syncs)
        counts = read_counts(kernels_mod)
        for k, v in counts.items():
            total[k] += v

        twin = engine(execute=False)
        t0 = time.perf_counter()
        twin_rep = twin.run()
        loop_ms = (time.perf_counter() - t0) * 1e3
        require(_plain(rep) == _plain(twin_rep)
                and rep._stage_intervals == twin_rep._stage_intervals,
                f"{label}: executing moved the clock (report != execute=False twin)")

        # micro-batches executed, per rung (stage 0 rows), and the launches
        batches = {}
        for row in rep.stages:
            if row.stage == 0:
                batches[row.rung] = batches.get(row.rung, 0) + row.batches_served
        want = {k: 0 for k in KERNELS}
        rung_plans = [r.plan for r in ladder.rungs] if policy == "switch" else [gp]
        for rung, nb in batches.items():
            for k, v in want_launches(rung_plans[rung].kernel_plan(
                    batch=STREAM_MICROBATCH), nb).items():
                want[k] += v
        require(counts == want, f"{label}: launches {counts} != nodes x batches {want}")

        served = sorted((r for r in eng._requests if r.t_shed is None),
                        key=lambda r: (r.t_admit, r.rid))
        rids = [r.rid for r in served]
        require(tuple(out.shape) == (len(rids), cfg.num_classes) and out.is_cuda
                and bool(torch.isfinite(out).all()), f"{label}: outputs {tuple(out.shape)}")
        by_rid = dict(zip(sorted(rids), out))

        # gate 1: bit for bit against apply_staged on the same padded batches
        # (run d: each rung's frames against that rung served alone)
        if policy == "switch":
            for rung in sorted(batches):
                mine = [r.rid for r in served if r.rung == rung]
                plan_r = ladder.rungs[rung].plan
                alone = CNNStreamEngine(plan_r.graph, params, plan_r, ServeConfig(
                    microbatch=STREAM_MICROBATCH,
                    kernel_plan=plan_r.kernel_plan(batch=STREAM_MICROBATCH)))
                alone.submit_all(frames_cpu[sorted(mine)])
                alone.run()
                require(torch.equal(torch.stack([by_rid[r] for r in sorted(mine)]),
                                    alone.outputs()),
                        f"{label}: rung {rung} differs from that rung served alone")
        else:
            chunks = padded_batches(torch, frames, rids, STREAM_MICROBATCH)
            for idx, b in chunks:
                y = api.apply_staged(params, b, cfg, partition=gp, plan=kp,
                                     link_quant=True if link else None)
                require(torch.equal(torch.stack([by_rid[r] for r in idx]), y[:len(idx)]),
                        f"{label}: served != apply_staged on the padded micro-batch")
            t0 = time.perf_counter()
            for _, b in chunks:
                api.apply_staged(params, b, cfg, partition=gp, plan=kp,
                                 link_quant=True if link else None)
            torch.cuda.synchronize()
            staged_ms = (time.perf_counter() - t0) * 1e3

        if policy is None or policy == "traced":
            require(rep.stall_free, f"{label}: stalled at the plan's BestRate")
        summary = rep.summary()
        row = {
            "phase": "stream", "family": family, "stages": n_stages,
            "links": link or "fp32", "traffic": traffic, "policy": policy,
            "run": run, "frames": STREAM_FRAMES, "microbatch": STREAM_MICROBATCH,
            "input_hw": list(cfg.input_hw), "rate": str(RATE),
            "wall_ms": wall_ms, "frames_per_s": len(rids) / (wall_ms / 1e3),
            "loop_ms": loop_ms, "loop_us_per_frame": loop_ms * 1e3 / STREAM_FRAMES,
            "best_rate": str(rep.best_rate), "admitted_rate": str(rep.admitted_rate),
            "stall_free": rep.stall_free, "max_queue": list(summary.max_queue),
            "caps": list(summary.queue_caps), "p50_ticks": rep.p50_latency(),
            "p99_ticks": rep.p99_latency(), "shed": rep.shed,
            "switches": [[str(t), a, b] for t, a, b in rep.switches],
            "batches": batches, "launches": counts, "bit_exact": True,
            "host_syncs_in_run": len(host_syncs), "host_sync_examples": host_syncs[:3],
            "report_eq_execute_false_twin": True,
        }
        if policy != "switch":
            row["staged_ms"] = staged_ms
            row["staged_frames_per_s"] = len(rids) / (staged_ms / 1e3)
        else:
            row["ladder"] = ladder.describe()
            row["ladder_plan_s"] = ladder_s
        if policy == "traced":
            ar = audit(rep.trace)
            require(ar.matches(summary) and ar.clean,
                    f"{label}: audit {ar.verdict_line()} disagrees with the summary")
            row["audit"] = ar.verdict_line()
            row["exec_spans"] = len(rep.trace.spans("exec", clock="host"))
        prof = engine()
        device_ms, _, _ = device_ms_by_kernel(torch, lambda: serve(prof))
        row["profiled_device_ms"] = device_ms
        row["device_busy_share"] = sum(device_ms.values()) / wall_ms if device_ms else None
        emit(row)
    return total


def bench_flash(torch, bench, gen):
    """The flash kernel at the LM paths' prefill shapes (qwen2-7b's heads
    and zamba2's shared-attention heads, bf16, each served prompt length),
    then extras off those paths (f32, group 1 at d 128, non-causal, GQA
    at d = 64, a length below one block; checked, not timed), then the
    bf16 kernel's time at every pair of blocks at the main-path shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    def case(label, h, hkv, s, d, dtype, causal=True, timed=True):
        q, k, v = (torch.randn((1, n, s, d), generator=gen).to("cuda", dtype)
                   for n in (h, hkv, hkv))
        kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
        block_q, block_k = fa.flash_blocks(h, s, dtype)
        pairs = s * (s + 1) // 2 if causal else s * s
        bf16 = dtype == torch.bfloat16
        bench.case(
            "flash_attention", label,
            lambda: fa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                                       block_k=block_k),
            lambda: fa.flash_attention_plain(q, k, v, causal=causal),
            lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=causal),
            4 * d * h * pairs, q.element_size() * (2 * q.numel() + 2 * k.numel()),
            timed=timed, tol=BF16_TOL if bf16 else TOL,
            elementwise=FLASH_TOL[str(dtype).removeprefix("torch.")],
            peak=bench.hw.peak_bf16_flops if bf16 else bench.hw.peak_fp32_flops,
            info={"design": fa.DESIGN[dtype], "block_q": block_q, "block_k": block_k},
        )

    for s in PROMPT_LENS:
        case(f"qwen2-7b/prefill{s}", 28, 4, s, 128, torch.bfloat16)
    for s in PROMPT_LENS:   # zamba2's shared-attention sites: MHA at d 64
        case(f"zamba2-1.2b/prefill{s}", 32, 32, s, 64, torch.bfloat16)
    case("extra/f32-s512", 28, 4, 512, 128, torch.float32, timed=False)
    case("extra/group1-s1024", 8, 8, 1024, 128, torch.bfloat16, timed=False)
    case("extra/noncausal-s512", 28, 4, 512, 128, torch.bfloat16, causal=False,
         timed=False)
    case("extra/d64-s768", 16, 4, 768, 64, torch.bfloat16, timed=False)
    case("extra/ragged-s9", 28, 4, 9, 128, torch.bfloat16, timed=False)

    # Every pair of blocks the bf16 kernel takes, at each main-path shape:
    # the data behind the rule flash_blocks keeps (not in the kernels line).
    blocks = fa.BLOCKS[torch.bfloat16]
    sweep = {}
    for name, h, hkv, d in (("qwen2-7b", 28, 4, 128), ("zamba2-1.2b", 32, 32, 64)):
        for s in PROMPT_LENS:
            q, k, v = (torch.randn((1, n, s, d), generator=gen).to("cuda", torch.bfloat16)
                       for n in (h, hkv, hkv))
            sweep[f"{name}/prefill{s}"] = {
                "rule": "x".join(map(str, fa.flash_blocks(h, s, torch.bfloat16))),
                **{f"{bq}x{bk}": cuda_ms(torch, lambda: fa.flash_attention(
                    q, k, v, block_q=bq, block_k=bk)) for bq in blocks for bk in blocks}}
    emit({"phase": "flash_block_sweep", "ms": sweep,
          "summed": {p: sum(r[p] for r in sweep.values()) for p in next(iter(sweep.values()))
                     if p != "rule"},
          "rule_summed": sum(r[r["rule"]] for r in sweep.values())})


def bench_ssd(torch, bench, gen):
    """The SSD kernels at the SSM path's prefill shapes (mamba2's 48 heads
    at N 128 and zamba2's 64 heads at N 64, each served prompt length
    padded to the chunk of 128), inputs drawn as the models make them
    (silu of the conv, dt from the dt_bias range, a = -(1..H)); then
    extras off that path (two groups, chunks 16 and 64, one chunk, two
    rows of the batch; checked, not timed); each shape again with bf16 x,
    dt, B and C (rows marked ``route`` "bf16").  There is no library
    call."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import ssd_chunk as sc

    def case(label, b, l, h, p, g, n, chunk, timed=True, dtype=torch.float32):
        def draw(*shape):
            return torch.randn(shape, generator=gen).cuda()

        u = torch.rand((h,), generator=gen) * (math.log(0.1) - math.log(0.001))
        dt0 = torch.exp(u + math.log(0.001))
        dt_bias = (dt0 + torch.log(-torch.expm1(-dt0))).cuda()
        x, bb, cc = F.silu(draw(b, l, h, p)), F.silu(draw(b, l, g, n)), F.silu(draw(b, l, g, n))
        dt = F.softplus(draw(b, l, h) + dt_bias)
        a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
        x, dt, bb, cc = (t.to(dtype) for t in (x, dt, bb, cc))
        # The scores C.B^T depend on the group only; the diagonal output
        # and the state's two products are per head.
        nc, tri = l // chunk, chunk * (chunk + 1) // 2
        flops = b * nc * (g * tri * n * 2 + h * (tri * p * 2 + 2 * chunk * n * p * 2))
        # The function's own bytes: x, dt, B, C and a read once, y and
        # the final state written once.  The f32 chunk-state workspace
        # [B, nc, H, P, N] (written by ssd_states, read and rewritten by
        # ssd_pass, read by ssd_output) belongs to this design, not to the
        # function; its traffic, counted as one write and one read, stands
        # beside the bound (workspace_bytes, bound_ms_with_workspace).
        nbytes = (x.element_size() * (2 * x.numel() + dt.numel() + 2 * bb.numel())
                  + 4 * (a.numel() + b * h * p * n))
        work = 4 * 2 * b * nc * h * p * n
        peak = bench.hw.peak_tf32_flops / TF32_TERMS
        bf16 = dtype == torch.bfloat16
        info = {"route": "bf16"} if bf16 else {}
        bench.case(
            "ssd_chunk", label + ("/bf16" if bf16 else ""),
            lambda: sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk),
            lambda: sc.ssd_chunk_plain(x, dt, a, bb, cc, chunk=chunk),
            None, flops, nbytes, timed=timed,
            elementwise=SSD_BF16_TOL if bf16 else SSD_TOL, peak=peak,
            info={**info, "workspace_bytes": work, "bound_ms_with_workspace": max(
                flops / peak, (nbytes + work) / bench.hw.hbm_bw) * 1e3},
        )

    for dtype in (torch.float32, torch.bfloat16):
        for s in PROMPT_LENS:
            padded = -(-s // 128) * 128
            case(f"mamba2-780m/prefill{s}", 1, padded, 48, 64, 1, 128, 128, dtype=dtype)
        for s in PROMPT_LENS:
            padded = -(-s // 128) * 128
            case(f"zamba2-1.2b/prefill{s}", 1, padded, 64, 64, 1, 64, 128, dtype=dtype)
    for dtype in (torch.float32, torch.bfloat16):
        case("extra/g2-h8", 1, 512, 8, 64, 2, 128, 128, timed=False, dtype=dtype)
        case("extra/chunk16", 1, 256, 8, 64, 1, 128, 16, timed=False, dtype=dtype)
        case("extra/chunk64", 1, 512, 16, 64, 1, 128, 64, timed=False, dtype=dtype)
        case("extra/one-chunk", 1, 128, 48, 64, 1, 128, 128, timed=False, dtype=dtype)
        case("extra/b2", 2, 384, 8, 64, 2, 64, 128, timed=False, dtype=dtype)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def run_serve(torch, kernels_mod, phase, cfg, mod, per_prefill, plain_routes,
              served_tol=BF16_TOL, f32_check=False):
    """``cfg`` served by the token engine on the card at full width and
    depth, random weights from a seeded CUDA generator: 4 prompts on 2
    slots, 16 new tokens each (smoke-size traffic), launch counts set to
    0 just before and read just after, each kernel launched exactly
    ``per_prefill[kernel]`` times a prefill; then each prompt's prefill
    logits on the kernels against the same prefill on their plain
    versions (``plain_routes``, keyword arguments of ``mod.prefill``),
    and one prefill and one decode step under ``torch.profiler``.

    The served dtype's logits are held at ``served_tol`` of their scale
    and, with ``f32_check``, an f32 copy of the same weights at TOL (see
    SSM_CHECK).  Each route is run once at each length before the prefill
    that is timed.  Returns the launch counts of the serve run."""
    import numpy as np

    from repro_torch.configs.base import param_count
    from repro_torch.models.registry import get_api
    from repro_torch.serving.engine import Engine, Request

    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    emit({"phase": f"{phase}_build", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "params": param_count(cfg),
          "param_bytes": _param_bytes(params), "init_s": time.perf_counter() - t0,
          "max_memory_allocated": torch.cuda.max_memory_allocated()})

    rng = np.random.default_rng(2026)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    warm = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN)
    warm.submit(Request(rid=-1, prompt=prompts[0][:64], max_new=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    eng = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN)
    reqs = [Request(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    reset_counts(kernels_mod)
    t_start = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    steps = []
    while eng.queue or eng.active:
        started = {r.rid for r in reqs if r.t_first is not None}
        active = {r.rid for r in eng.active.values()}
        t0 = time.perf_counter()
        eng.step()               # ends in a host read of the sampled tokens
        ms = (time.perf_counter() - t0) * 1e3
        admitted = {r.rid for r in reqs if r.t_first is not None} - started
        steps.append((ms, admitted, active | admitted))
    serve_s = time.perf_counter() - t_start
    counts = read_counts(kernels_mod)
    want = {k: per_prefill.get(k, 0) * len(reqs) for k in KERNELS}
    require(counts == want,
            f"{phase}: launches {counts} != per prefill {per_prefill} x {len(reqs)}")
    require(all(r.done and len(r.out) == MAX_NEW for r in reqs),
            f"{phase}: requests ended with {[len(r.out) for r in reqs]} tokens")
    decode_steps = [ms for ms, adm, _ in steps if not adm]
    per_request = []
    for r in reqs:
        mine = [ms for ms, adm, act in steps if not adm and r.rid in act]
        per_request.append({
            "rid": r.rid, "prompt_tokens": len(r.prompt), "new_tokens": len(r.out),
            "ttft_ms": (r.t_first - r.t_submit) * 1e3,
            "decode_step_ms_median": statistics.median(mine),
            "decode_tokens_per_s": (len(r.out) - 1) / (r.t_done - r.t_first),
        })
    emit({"phase": f"{phase}_serve", "model": cfg.name, "traffic": "smoke-size",
          "slots": SLOTS, "max_len": MAX_LEN, "requests": per_request,
          "launches": counts, "serve_s": serve_s,
          "tokens_per_s": sum(len(r.out) for r in reqs) / serve_s,
          "engine_steps": len(steps), "decode_step_ms_median": statistics.median(decode_steps),
          "max_memory_allocated": torch.cuda.max_memory_allocated()})

    # The prefill check: kernels against plain versions, at the served
    # dtype; with ``f32_check`` also on an f32 copy of the same weights.
    checks = [("served", cfg, params)]
    if f32_check:
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        checks.append(("f32", cfg32, _cast(params, torch.float32)))
    agree, rows = 0, []
    for r, p in zip(reqs, prompts):
        toks = torch.as_tensor(p, dtype=torch.long, device="cuda")[None]
        row = {"prompt_tokens": len(p)}
        for name, c, prm in checks:
            out = {}
            for route, kw in (("kernel", {}), ("plain", plain_routes)):
                for _ in range(2):          # warm at this length, then time
                    state = api.make_serve_state(c, 1, MAX_LEN)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, _ = mod.prefill(prm, toks, c, state, **kw)
                    torch.cuda.synchronize()
                out[route] = (logits, (time.perf_counter() - t0) * 1e3)
            got, want_ = out["kernel"][0], out["plain"][0]
            require(tuple(got.shape) == (1, 1, c.vocab) and got.dtype == torch.float32,
                    f"{phase}: logits {tuple(got.shape)} {got.dtype}")
            require(bool(torch.isfinite(got).all()), f"{phase}: non-finite prefill logits")
            scale = max(1.0, want_.abs().max().item())
            err = (got - want_).abs().max().item()
            tol = TOL if name == "f32" else served_tol
            require(err <= tol * scale,
                    f"{phase}/prefill{len(p)} ({name}): logits vs plain path "
                    f"max|err| {err} > {tol} x {scale}")
            same = int(got.argmax()) == int(want_.argmax())
            row[name] = {"dtype": c.param_dtype, "tolerance": tol,
                         "prefill_ms": out["kernel"][1], "plain_prefill_ms": out["plain"][1],
                         "logits_max_abs_err": err, "logits_scale": scale,
                         "greedy_agrees": same}
            if name == "served":
                agree += same
                row[name]["served_first_token_agrees"] = r.out[0] == int(got.argmax())
        rows.append(row)
    emit({"phase": f"{phase}_prefill_check", "prompts": rows,
          "gate": SSM_CHECK if f32_check else f"{cfg.param_dtype} at BF16_TOL",
          "plain_routes": sorted(plain_routes), "greedy_agree_share": agree / len(reqs)})
    del checks

    toks = torch.as_tensor(prompts[-1], dtype=torch.long, device="cuda")[None]
    state = api.make_serve_state(cfg, 1, MAX_LEN)
    pool = eng.state
    pos = np.asarray([len(p) + MAX_NEW for p in prompts[-SLOTS:]])
    step_toks = torch.zeros((SLOTS, 1), dtype=torch.long, device="cuda")
    calls = {"prefill": lambda: mod.prefill(params, toks, cfg, state),
             "decode": lambda: mod.decode_step(params, pool, step_toks, pos, cfg)}
    profile = {"prefill_tokens": len(prompts[-1]), "decode_slots": SLOTS,
               "decode_positions": pos.tolist()}
    for name, fn in calls.items():
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms, wall, top = device_ms_by_kernel(torch, fn, SERVE_DEVICE_FN)
        profile[name] = {
            "ms": statistics.median(host_ms), "profiled_wall_ms": wall,
            "device_ms": device_ms,
            "device_busy_share": sum(device_ms.values()) / statistics.median(host_ms),
            "top_device_fns": [(ms, n, key[:90]) for ms, n, key in top[:5]]}
    emit({"phase": f"{phase}_profile", **profile})
    return counts


def run_lm_paths(torch, kernels_mod):
    """The three served models, each through ``run_serve``: qwen2-7b (bf16
    KV cache: the config's int8 cache is not ported; the flash kernel
    once per layer per prefill), mamba2-780m (the SSD kernel once per
    layer) and zamba2-1.2b (the SSD kernel once per Mamba2 layer, the
    flash kernel once per shared-attention site).  Returns the summed
    launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ssd_chunk import ssd_chunk_plain
    from repro_torch.models import hybrid, lm, mamba

    def flash_plain(q, k, v):
        return flash_attention_plain(q, k, v, causal=True)

    qwen2 = dataclasses.replace(get_config("qwen2-7b"), kv_quant=False)
    mamba2, zamba2 = get_config("mamba2-780m"), get_config("zamba2-1.2b")

    def ssm_check(cfg):
        return {"served_tol": SSM_BF16_FACTOR * SSM_BF16_WITNESS[cfg.name], "f32_check": True}

    paths = [
        ("lm", qwen2, lm, {"flash_attention": qwen2.n_layers}, {"flash": flash_plain}, {}),
        ("ssm", mamba2, mamba, {"ssd_chunk": mamba2.n_layers}, {"ssd": ssd_chunk_plain},
         ssm_check(mamba2)),
        ("hybrid", zamba2, hybrid,
         {"ssd_chunk": zamba2.n_layers, "flash_attention": hybrid.n_sites(zamba2)},
         {"ssd": ssd_chunk_plain, "flash": flash_plain}, ssm_check(zamba2)),
    ]
    total = {k: 0 for k in KERNELS}
    for phase, cfg, mod, per_prefill, plain_routes, kw in paths:
        for k, v in run_serve(torch, kernels_mod, phase, cfg, mod, per_prefill,
                              plain_routes, **kw).items():
            total[k] += v
        torch.cuda.empty_cache()
    return total


def summarise(name, rows) -> dict:
    """One route's rows of kernel ``name``, summed over the timed shapes:
    ms, the plain version's and the library call's ms, the bound, and the
    largest error over every row, timed or checked."""
    timed = [r for r in rows if "ms" in r]
    ops = sum(r["ops_ms"] for r in timed)
    nbytes = sum(r["bytes_ms"] for r in timed)
    return {
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in timed),
        "plain_ms": sum(r["plain_ms"] for r in timed),
        "bound_ms": sum(r["bound_ms"] for r in timed),
        "bound_by": "operations" if ops >= nbytes else "bytes",
        "library_ms": None if name in NO_LIBRARY else sum(r["library_ms"] for r in timed),
        "shapes": len(timed),
        **({"bound_ms_with_workspace": sum(r["bound_ms_with_workspace"] for r in timed)}
           if timed and "bound_ms_with_workspace" in timed[0] else {}),
    }


def kernels_line(bench, launches) -> list:
    """The ``kernels`` line: each kernel's main route (f32 rows; flash in
    bf16) with the main path's launches, and its bf16 route beside it."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in bench.rows if r["kernel"] == name and "route" not in r]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], **summarise(name, rows)}
        if name in TF32_KERNELS:
            row["bound_ms_fp32"] = sum(r["bound_ms_fp32"] for r in rows if "ms" in r)
        if name in NO_LIBRARY:
            row["library_note"] = NO_LIBRARY[name]
        bf16 = [r for r in bench.rows if r["kernel"] == name and r.get("route") == "bf16"]
        if bf16:
            row["bf16"] = summarise(name, bf16)
        out.append(row)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    try:
        from repro_torch.core.graph import plan_graph  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e})", file=sys.stderr)
        return 1
    from repro_torch.core.hw import H100_SXM
    from repro_torch.kernels import _build, dw_conv, fcu_matmul, flash_attention, kpu_conv
    from repro_torch.kernels import ssd_chunk
    from repro_torch.models.registry import get_cnn_api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "tf32": False})

    t0 = time.perf_counter()
    lib = _build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib._name, root)})
    emit({"phase": "ptxas", "kernel": "flash_kernel_wgmma",
          "template": "<head dim, block_k, consumer warpgroups>",
          "registers_note": "with 2 consumer warpgroups, registers at entry; "
                            "setmaxnreg then gives the consumers 232 and the "
                            "producer warpgroup 40",
          "instances": ptxas_report(lib._name, "flash_kernel_wgmma")})
    templates = {
        "fcu_kernel": "<element, wgmma width BN, 64-row atoms a consumer warpgroup, "
                      "consumer warpgroups>",
        "kpu_kernel": "<element, wgmma width BN, 64-row atoms a consumer warpgroup, "
                      "consumer warpgroups>",
        "dw_kernel": "<element, channels a thread's vector (16 bytes, or 1 where "
                     "the tile is no whole number of them), stride> (3x3 taps)",
    }
    for kernel, template in templates.items():
        rows = ptxas_report(lib._name, kernel)
        for dtype in ("float32", "bfloat16"):
            mine = [r for r in rows if r["dtype"] == dtype]
            require(mine, f"{kernel}: no {dtype} instance in the build")
            emit({"phase": "ptxas", "kernel": kernel, "dtype": dtype,
                  "template": template, "instances": mine})
            require(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
                        for r in mine), f"{kernel} ({dtype}): ptxas reports spills")
    emit({"phase": "ptxas", "kernel": "ssd_chunk",
          "instances": {k: ptxas_report(lib._name, k)
                        for k in ("ssd_states", "ssd_pass", "ssd_output")}})

    kernels_mod = {"fcu_matmul": fcu_matmul, "kpu_conv": kpu_conv, "dw_conv": dw_conv,
                   "flash_attention": flash_attention, "ssd_chunk": ssd_chunk}
    gen = torch.Generator().manual_seed(2026)
    bench = KernelBench(torch, H100_SXM)
    emit({"phase": "kernels", "tolerance": TOL, "bound": BOUND,
          "tolerance_of": "max|kernel - plain| <= tolerance x max(1, max|plain|)",
          "bf16_tolerance": KERNEL_BF16_TOL,
          "flash_tolerance": FLASH_TOL, "ssd_tolerance": SSD_TOL,
          "ssd_bf16_tolerance": SSD_BF16_TOL,
          "flash_ssd_tolerance_of":
              "|kernel - plain| <= rtol x |plain| + atol + rms x rms(plain)"})
    for dtype in (None, torch.bfloat16):
        for family in ("mobilenet_v2", "resnet18"):
            api = get_cnn_api(family)
            cfg = api.make_config()
            kp = api.plan(cfg, RATE)
            bench_nodes(torch, bench, family, kp, api.graph(cfg), gen, dtype)
            # the staged phases run the batch-pinned plan: its other tiles too
            pinned = api.partition(cfg, RATE, STAGES[0]).kernel_plan(batch=BATCH)
            bench_nodes(torch, bench, family, pinned, api.graph(cfg), gen, dtype,
                        only=repinned_nodes(kp, pinned, api.graph(cfg)),
                        suffix="/pinned", timed=False)
    bench_extras(torch, bench, gen)
    wrapper_host_us(torch)
    bench_flash(torch, bench, gen)
    bench_ssd(torch, bench, torch.Generator().manual_seed(2027))

    launches = {k: 0 for k in KERNELS}
    for family in ("mobilenet_v2", "resnet18"):
        counts = run_slice(torch, family, kernels_mod, gen, bench)
        for k, v in counts.items():
            launches[k] += v
    for family in ("mobilenet_v2", "resnet18"):
        for k, v in run_staged(torch, family, kernels_mod, gen).items():
            launches[k] += v
    for family in ("mobilenet_v2", "resnet18"):
        for k, v in run_stream(torch, family, kernels_mod,
                               torch.Generator().manual_seed(2028)).items():
            launches[k] += v
    for k, v in run_lm_paths(torch, kernels_mod).items():
        launches[k] += v
    require(all(launches.values()), f"a kernel never launched on the main path: {launches}")
    for family in ("mobilenet_v2", "resnet18"):
        run_slice(torch, family, kernels_mod, gen, bench, torch.bfloat16)

    out = kernels_line(bench, launches)
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
