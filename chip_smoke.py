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
2. build — the kernels' nvcc build (``repro_torch.kernels._build``);
3. kernels — every kernel against its plain PyTorch version on the card
   at every shape its main path gives it (MobileNetV2 and ResNet-18 at
   224x224, batch 8, the rate-3 plan's tiles; qwen2-7b's prefill
   attention and mamba2's and zamba2's SSD scans at the served prompt
   lengths) plus odd-size extras; each with its time, the plain
   version's, the library call's (``torch.matmul`` / ``F.conv2d`` with
   TF32 off, and ``F.scaled_dot_product_attention``; none for the SSD)
   and the roofline bound;
4. slice — MobileNetV2, then ResNet-18, at 224x224: 4 requests of 8
   frames through ``api.apply(params, x, cfg, plan=kp)``, launch counts
   set to 0 just before and read just after, executed tile == plan on
   every arithmetic node, logits held against the plain path on the card;
   one more forward pass under ``torch.profiler`` gives the device time
   by kernel and the device's busy share of the batch latency;
5. lm, ssm, hybrid — qwen2-7b (bf16 KV cache: the config's int8 cache is
   not ported), then mamba2-780m, then zamba2-1.2b, each at full width
   and depth with random weights from a seeded CUDA generator: the token
   engine serves 4 prompts of 512-2048 tokens on 2 slots, 16 new tokens
   each, launch counts set to 0 just before and read just after (the
   flash kernel once per attention layer or site, the SSD kernel once
   per Mamba2 layer, per prefill); then each prompt's prefill logits on
   the kernels against the same prefill on their plain versions, and
   one prefill and one decode step under ``torch.profiler``;
6. the ``kernels`` line, the card line, and the final ``ok`` line.

Any failure raises: the script then exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
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
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
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
# products, the rest.
SERVE_DEVICE_FN = {"flash_attention": ("flash_kernel",), "ssd_chunk": ("ssd_kernel",),
                   "matmul": ("gemm", "gemv", "xmma", "cutlass", "splitK", "nvjet")}
BOUND = ("max(flops / peak of the operands' type on the H100 SXM (67 TFLOP/s "
         "fp32 CUDA cores, 989 TFLOP/s bf16 tensor cores); bytes / 3.35 TB/s "
         "HBM), each input read once, each output written once")


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
             tol=TOL, peak=None, elementwise=None):
        """``fn`` and ``plain`` return a tensor or a tuple of tensors, each
        held against its counterpart.  ``elementwise=(rtol, atol, rms)``
        holds the kernel to |y - plain| <= rtol x |plain| + atol + rms x
        rms(plain) everywhere instead of ``tol`` x the scale.  ``library``
        is None where no PyTorch call computes the function; else it is
        held at ``tol`` x the scale."""
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
        row = {"node": label, "kernel": kernel, "max_abs_err": err,
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
        self.rows.append(row)
        emit(row)


def bench_nodes(torch, bench, family, plan, graph, gen):
    """Every arithmetic node of ``family``'s main path, at its shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build, dw_conv, fcu_matmul, kpu_conv

    for name, ip in plan.items():
        if not ip.has_kernel:
            continue
        s, t = graph.spec(name), ip.tile
        kernel = KIND_KERNEL[s.kind]
        label = f"{family}/{name}"
        x = torch.randn((BATCH, *s.in_hw, s.d_in), generator=gen).cuda()
        macs = s.total_macs * BATCH
        out_elems = BATCH * s.out_hw[0] * s.out_hw[1] * s.d_out
        if s.kind in ("pointwise", "dense"):
            x2 = x.reshape(-1, s.d_in)
            w = torch.randn((s.d_in, s.d_out), generator=gen).cuda() / s.d_in ** 0.5
            bm = fcu_matmul._pick_bm(x2.shape[0], t.bm)
            bench.case(
                kernel, label,
                lambda: fcu_matmul.fcu_matmul(x2, w, bm=bm, bk=t.bk, bn=t.bn),
                lambda: fcu_matmul.fcu_matmul_plain(x2, w),
                lambda: torch.matmul(x2, w),
                2 * macs, 4 * (x2.numel() + w.numel() + out_elems),
            )
            continue
        kh, kw = s.kernel
        stride = s.stride[0]
        _, (pt, pb) = _build.same_pads(s.in_hw[0], kh, stride)
        _, (pl, pr) = _build.same_pads(s.in_hw[1], kw, stride)
        xp = F.pad(x, (0, 0, pl, pr, pt, pb)).permute(0, 3, 1, 2)
        if s.kind == "conv":
            w = torch.randn((kh, kw, s.d_in, s.d_out), generator=gen).cuda()
            w = w / (kh * kw * s.d_in) ** 0.5
            w_oihw = w.permute(3, 2, 0, 1)
            bench.case(
                kernel, label,
                lambda: kpu_conv.kpu_conv(x, w, stride=stride, bm=t.bm,
                                          bci=t.bk, bco=t.bn),
                lambda: kpu_conv.kpu_conv_plain(x, w, stride),
                lambda: F.conv2d(xp, w_oihw, stride=stride).permute(0, 2, 3, 1),
                2 * macs, 4 * (x.numel() + w.numel() + out_elems),
            )
        else:
            w = torch.randn((kh, kw, s.d_in), generator=gen).cuda() / (kh * kw) ** 0.5
            w_oihw = w.permute(2, 0, 1).unsqueeze(1)
            bench.case(
                kernel, label,
                lambda: dw_conv.dw_conv(x, w, stride=stride, bm=t.bm, bc=t.bk),
                lambda: dw_conv.dw_conv_plain(x, w, stride),
                lambda: F.conv2d(xp, w_oihw, stride=stride,
                                 groups=s.d_in).permute(0, 2, 3, 1),
                2 * macs, 4 * (x.numel() + w.numel() + out_elems),
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
    # one-row tiles whose block has fewer threads (16) than the staged
    # slice is wide (32 weight columns; 24 input features)
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


def device_ms_by_kernel(torch, fn, classes=DEVICE_FN):
    """One call of ``fn`` under ``torch.profiler``: device ms summed per
    class of device function (``classes``: name -> substrings of the
    function's name), the rest (bias, activation, joins, pooling, norms,
    copies) under "other" (empty if the profiler saw no device activity);
    the call's host-clock ms, ending in a synchronize; and the five
    device functions that took the longest, with their ms."""
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
        by_fn.append((e.device_time_total / 1e3, e.count, e.key[:90]))
    return out, wall, sorted(by_fn, reverse=True)[:5]


def reset_counts(kernels_mod) -> None:
    for name in KERNELS:
        getattr(kernels_mod[name], name).launches = 0


def read_counts(kernels_mod) -> dict:
    return {name: getattr(kernels_mod[name], name).launches for name in KERNELS}


def run_slice(torch, family, kernels_mod, gen, bench):
    """One family's main path: REQUESTS batches of BATCH frames through
    the rate-matched forward pass on the card."""
    from repro_torch.kernels.fcu_matmul import _pick_bm
    from repro_torch.models.registry import get_cnn_api

    api = get_cnn_api(family)
    cfg = api.make_config()
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
        require(tuple(y.shape) == (BATCH, cfg.num_classes), f"{family}: shape {y.shape}")
        require(bool(torch.isfinite(y).all()), f"{family}: non-finite logits")
        t0 = time.perf_counter()
        ref = api.apply(params, x, cfg)  # the plain versions, on the card
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        scale = max(1.0, ref.abs().max().item())
        err = (y - ref).abs().max().item()
        require(err <= TOL * scale,
                f"{family}: logits vs plain path max|err| {err} > {TOL} x {scale}")
        errs.append(err / scale)
    device_ms, _, _ = device_ms_by_kernel(
        torch, lambda: api.apply(params, xs[0], cfg, plan=kp))
    busy_ms = sum(device_ms.values())
    latency = statistics.median(latency_ms)
    isolated = {k: sum(r["ms"] for r in bench.rows if r["kernel"] == k
                       and r["node"].startswith(family + "/")) for k in KERNELS}
    row = {
        "phase": "slice", "family": family, "input_hw": list(cfg.input_hw),
        "batch": BATCH, "requests": REQUESTS, "rate": str(RATE),
        "arith_nodes": len(arith), "launches": counts,
        "executed_tile_eq_plan": True,
        "frames_per_s": BATCH * REQUESTS / (sum(latency_ms) / 1e3),
        "latency_ms": latency_ms, "latency_ms_median": latency,
        "plain_path_latency_ms_median": statistics.median(plain_ms),
        "profiled_device_ms": device_ms,
        "device_busy_share": busy_ms / latency if device_ms else None,
        "kernel_ms_isolated": isolated,
        "logits_max_rel_err": max(errs), "tolerance": TOL,
    }
    emit(row)
    return counts


def bench_flash(torch, bench, gen):
    """The flash kernel at the LM paths' prefill shapes (qwen2-7b's heads
    and zamba2's shared-attention heads, bf16, each served prompt length),
    then extras off those paths (f32, group 1 at d 128, non-causal, GQA
    at d = 64, a length below one block; checked, not timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    def case(label, h, hkv, s, d, dtype, causal=True, timed=True):
        q, k, v = (torch.randn((1, n, s, d), generator=gen).to("cuda", dtype)
                   for n in (h, hkv, hkv))
        kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
        block_q, block_k = fa.flash_blocks(h, s)
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


def bench_ssd(torch, bench, gen):
    """The SSD kernel at the SSM path's prefill shapes (mamba2's 48 heads
    at N 128 and zamba2's 64 heads at N 64, each served prompt length
    padded to the chunk of 128), inputs drawn as the models make them
    (silu of the conv, dt from the dt_bias range, a = -(1..H)); then
    extras off that path (two groups, chunks 16 and 64, one chunk, two
    rows of the batch; checked, not timed).  There is no library call."""
    import math

    import torch.nn.functional as F

    from repro_torch.kernels import ssd_chunk as sc

    def case(label, b, l, h, p, g, n, chunk, timed=True):
        def draw(*shape):
            return torch.randn(shape, generator=gen).cuda()

        u = torch.rand((h,), generator=gen) * (math.log(0.1) - math.log(0.001))
        dt0 = torch.exp(u + math.log(0.001))
        dt_bias = (dt0 + torch.log(-torch.expm1(-dt0))).cuda()
        x, bb, cc = F.silu(draw(b, l, h, p)), F.silu(draw(b, l, g, n)), F.silu(draw(b, l, g, n))
        dt = F.softplus(draw(b, l, h) + dt_bias)
        a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
        # The scores C.B^T depend on the group only; the diagonal output
        # and the state's two products are per head.
        nc, tri = l // chunk, chunk * (chunk + 1) // 2
        flops = b * nc * (g * tri * n * 2 + h * (tri * p * 2 + 2 * chunk * n * p * 2))
        nbytes = 4 * (2 * x.numel() + dt.numel() + a.numel() + 2 * bb.numel() + b * h * p * n)
        bench.case(
            "ssd_chunk", label,
            lambda: sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk),
            lambda: sc.ssd_chunk_plain(x, dt, a, bb, cc, chunk=chunk),
            None, flops, nbytes, timed=timed, elementwise=SSD_TOL,
        )

    for s in PROMPT_LENS:
        padded = -(-s // 128) * 128
        case(f"mamba2-780m/prefill{s}", 1, padded, 48, 64, 1, 128, 128)
    for s in PROMPT_LENS:
        padded = -(-s // 128) * 128
        case(f"zamba2-1.2b/prefill{s}", 1, padded, 64, 64, 1, 64, 128)
    case("extra/g2-h8", 1, 512, 8, 64, 2, 128, 128, timed=False)
    case("extra/chunk16", 1, 256, 8, 64, 1, 128, 16, timed=False)
    case("extra/chunk64", 1, 512, 16, 64, 1, 128, 64, timed=False)
    case("extra/one-chunk", 1, 128, 48, 64, 1, 128, 128, timed=False)
    case("extra/b2", 2, 384, 8, 64, 2, 64, 128, timed=False)


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
            "top_device_fns": top}
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

    kernels_mod = {"fcu_matmul": fcu_matmul, "kpu_conv": kpu_conv, "dw_conv": dw_conv,
                   "flash_attention": flash_attention, "ssd_chunk": ssd_chunk}
    gen = torch.Generator().manual_seed(2026)
    bench = KernelBench(torch, H100_SXM)
    emit({"phase": "kernels", "tolerance": TOL, "bound": BOUND,
          "tolerance_of": "max|kernel - plain| <= tolerance x max(1, max|plain|)",
          "flash_tolerance": FLASH_TOL, "ssd_tolerance": SSD_TOL,
          "flash_ssd_tolerance_of":
              "|kernel - plain| <= rtol x |plain| + atol + rms x rms(plain)"})
    for family in ("mobilenet_v2", "resnet18"):
        api = get_cnn_api(family)
        cfg = api.make_config()
        bench_nodes(torch, bench, family, api.plan(cfg, RATE), api.graph(cfg), gen)
    bench_extras(torch, bench, gen)
    bench_flash(torch, bench, gen)
    bench_ssd(torch, bench, torch.Generator().manual_seed(2027))

    launches = {k: 0 for k in KERNELS}
    for family in ("mobilenet_v2", "resnet18"):
        counts = run_slice(torch, family, kernels_mod, gen, bench)
        for k, v in counts.items():
            launches[k] += v
    for k, v in run_lm_paths(torch, kernels_mod).items():
        launches[k] += v
    require(all(launches.values()), f"a kernel never launched on the main path: {launches}")

    out = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in bench.rows if r["kernel"] == name]
        timed = [r for r in rows if "ms" in r]
        ops = sum(r["ops_ms"] for r in timed)
        nbytes = sum(r["bytes_ms"] for r in timed)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "library_ms": None if name in NO_LIBRARY else sum(r["library_ms"] for r in timed),
            "shapes": len(timed),
        }
        if name in NO_LIBRARY:
            row["library_note"] = NO_LIBRARY[name]
        out.append(row)
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
