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
   ptxas's registers and spills for each instance of the bf16 and f32
   flash kernels (``flash_kernel_wgmma``, ``flash_kernel``; no d = 256
   instance may spill), of the FCU and KPU tensor-core kernels
   (``fcu_kernel``, ``kpu_kernel``, f32 and bf16), of the depthwise
   kernel (``dw_kernel``, f32 and bf16) and of the SSD
   phases (``ssd_states``, ``ssd_pass``, ``ssd_output``) from the build's
   ``nvcc.log``; no FCU, KPU or depthwise instance may spill;
3. kernels — every kernel against its plain PyTorch version on the card
   at every shape its main path gives it (MobileNetV2 and ResNet-18 at
   224x224, batch 8, the rate-3 plan's tiles, in f32 and again in bf16;
   qwen2-7b's, gemma3-1b's global (d 256, also at 8192 tokens), grok-1's,
   llama4-maverick's, internvl2-2b's and seamless's encoder, decoder and
   cross prefill attention and its cross-attention at decode, mamba2's and
   zamba2's SSD scans, at the served lengths)
   plus odd-size extras (the SSD's also with
   bf16 inputs); each with its time, the plain version's, the library
   call's (``torch.matmul`` / ``F.conv2d`` with TF32 off, in the row's
   dtype, and ``F.scaled_dot_product_attention``; none for the SSD) and
   the roofline bound (``BOUND``); FCU and KPU rows name the cluster split
   the kernel's plan takes, KPU rows also the plan's pixel and column
   tiles a block runs (``group``), which follow the batch: so every
   ResNet-18 conv is also checked, untimed, at batch 64 in the plans at
   rates 3 and 3/32 (rows ``.../r3/b64``, ``.../r3_32/b64``); and the FCU
   wrapper's host µs a call beside ``torch.matmul``'s;
4. slice — MobileNetV2, then ResNet-18, at 224x224: 4 requests of 8
   frames through ``api.apply(params, x, cfg, plan=kp)``, launch counts
   set to 0 just before and read just after (the KPU's grouped launches
   too, held against ``kpu_conv.block_group``; the kernels line's
   ``grouped_launches_in_slices``), executed tile == plan on
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
   twin's loop ms, and the busy share of one profiled run; then run a at
   S = 2 again with ``execute="devices"`` (stages on CUDA streams of their
   own), traced, with fp32 and with int8 links: served == ``execute=True``
   bit for bit and each ``transfer_bytes{edge,dtype}`` == the plan's cut
   bytes x micro-batches;
7. devices, fleet — the device pipeline (``distributed/device_pipeline.py``)
   for MobileNetV2 and ResNet-18 at 224x224: DEVICES_FRAMES frames at
   micro-batch DEVICES_MICROBATCH through ``DevicePipeline.build(...,
   placement=True)`` at each of DEVICES_RUNS, every stage on cuda:0 on a
   stream of its own (placement, distinct streams); the launch counts set
   to 0 just before ``run()`` and read just after (nodes x micro-batches);
   bit for bit ``apply_staged`` on the same micro-batches, no host sync
   inside ``run()`` under ``set_sync_debug_mode("warn")``, two runs in a
   row on fresh frames identical; ``measure(warmup=1,
   repeats=DEVICES_REPEATS)`` and one profiled run whose timeline counts
   the kernel pairs of different streams that overlap.  Then the fleet
   (``fleet/``): MobileNetV2 at rate 3 and ResNet-18 at 3/4, 224x224,
   packed by ``plan_pool`` at S = 2 on two big-BRAM and four stock
   chips, FLEET_FRAMES frames each at BestRate, served with
   ``execute=True`` and then ``"devices"``, each with a shared tracer:
   stall-free, each tenant bit for bit its standalone engine, the reports
   equal the ``execute=False`` twin's, ``audit_fleet`` clean, launches ==
   nodes x micro-batches; chip occupancy and wall ms per tenant;
8. lm, lm_kvq, ssm, hybrid — qwen2-7b with a bf16 KV cache (``lm``) and,
   on the same weights, as shipped with its int8 KV cache (``lm_kvq``),
   then mamba2-780m, then zamba2-1.2b, each at full width and depth with
   random weights from a seeded CUDA generator: the token engine serves 4
   prompts of 512-2048 tokens on 2 slots, 16 new tokens each, launch
   counts set to 0 just before and read just after (the flash kernel once
   per attention layer or site, the SSD kernel once per Mamba2 layer, per
   prefill); then each prompt's prefill logits on the kernels against the
   same prefill on their plain versions, and one prefill and one decode
   step under ``torch.profiler``; ``lm_kvq_slot_gate`` holds a batched
   decode at positions 512 and 1000 row by row against each request
   alone and prints the int8 cache's bytes beside the bf16 cache's;
9. lm_window, moe, moe_shared, blockwise, moe_forms, vlm, encdec —
   gemma3-1b through the token engine as in 8 (``MAX_LEN`` > window 512:
   22 local layers on rings of 512 slots, the flash kernel in the 4
   global layers a prefill, none in decode), then its ring gate (as
   ``lm_kvq``'s slot gate); grok-1 (``moe``, 4 of 64 layers) and
   llama4-maverick (``moe_shared``, 2 of 48: one dense, one MoE layer with
   its shared expert) at full width from int8 serve weights as shipped
   (``lm.init(quantize=True)``: each layer quantized as it is drawn; the
   build line gives the int8 tree's bytes beside bf16's and the peak
   memory) through the engine as in 8, the flash kernel once per layer a
   prefill, each prefill check counting the tokens whose experts differ
   between the kernel and the plain run (a hook on the router's input);
   ``blockwise``: gemma3-1b on one BLOCKWISE_TOKENS-token prompt through
   ``get_api``'s prefill, 22 local layers on the blockwise route and the
   flash kernel in the 4 global ones, against ``impl="dense"``
   (BLOCKWISE_CHECK), each route's peak memory and device ms;
   ``moe_forms``: one grok-1 MoE layer in bf16 on MOE_FORM_TOKENS tokens at
   a dropless capacity under the einsum, scatter and ragged dispatch, held
   against each other at BF16_TOL, each form's device ms;
   internvl2-2b from ``quantize_tree``'s int8 weights (its tree's bytes
   against bf16's) and seamless-m4t-medium through ``get_api`` one request
   at a time (the engine serves neither): 4 requests (256 patches +
   256-1792 tokens; 512-2048 frames + 16 tokens), DECODE_STEPS greedy
   steps each, the flash kernel counted per prefill (24; 36) and per
   decode step (0; 12); each prefill's logits against the plain path, and
   one prefill and one decode step under ``torch.profiler``;
10. train_gemma3, train_mamba2, train_gates, paged_kv — the training path
   (``launch/train.py``): gemma3-1b and mamba2-780m as shipped (bf16
   params, f32 AdamW moments, remat), each at full size through
   ``build_train_step``, TRAIN_STEPS steps of SyntheticLM seed-0 batches
   of TRAIN_BATCH x TRAIN_SEQ tokens at lr TRAIN_LR: every param leaf's
   step-1 gradient finite and not all zero, no kernel launched in any
   step (the counts set to 0 before each step, read after), the mean loss
   of steps 6-8 below step 1's; step ms (median of steps 2-8), tokens/s,
   peak memory, one profiled step's device ms by kind and busy share, and
   the model-FLOP share of the bf16 dense peak; then, at a reduced size
   in f32 with TF32 off, every family's loss and grads on the card against
   the CPU at TOL, the bf16 head's backward against f32 products, resume
   (``train_loop`` stopped after its step-4 checkpoint and started again)
   against the uninterrupted run at RESUME_TOL, and the kernel guard (a
   flash call with q requiring grad raises); and the paged KV cache at
   qwen2-7b's widths, written token by token and gathered bit for bit;
11. mesh_ssd, mesh_prefill, mesh_collectives, mesh_pipeline, mesh_train,
   mesh_moe_train, mesh_serve_int8, examples —
   the mesh runtime, K ranks spawned on cuda:0 under gloo by the
   multi-rank tests' harness, ``tests/torch_ranks.py`` (NCCL takes one
   rank a card; the kernel library is built before they start): the
   sequence-parallel SSD scan at mamba2-780m's widths on MESH_TOKENS
   tokens, K in MESH_WORLDS, f32 and bf16 (one SSD launch a rank; y and
   the final state against one launch over the whole sequence and the
   plain scan, at the kernels phase's f32 and bf16 gates); mamba2-780m's prefill on a (1, 2) mesh (48 launches a
   rank; logits against the one-process prefill on an f32 copy at TOL,
   bf16 within the ssm phase's tolerance; host and device ms beside one
   process's); ``compressed_psum`` on 4 ranks at gemma3-1b's wq shape
   (bit for bit the CPU's every step, error feedback within the JAX
   package's test bounds); the ring pipeline (``pipeline_forward``) at K
   in MESH_WORLDS, MESH_PIPE_LAYERS qwen2-7b layers a stage at full width
   in bf16 through ``lm._block`` (the flash kernel once a layer a tick),
   MESH_PIPE_MICRO microbatches of 1 x MESH_PIPE_TOKENS tokens, each
   tick's shift through host buffers (gloo's send / recv take no CUDA
   tensor): flash launches == layers x ticks on every rank, the output
   within BF16_TOL of the same stages run one after another in one
   process, host ms a tick and the shift's share; gemma3-1b's sharded
   train step (4 of 26 layers, DTensor
   params, state and batch on a (1, 1) mesh of one NCCL rank) against the
   unsharded step (equal losses, no kernel launch, every leaf a DTensor,
   both steps' host ms); grok-1's sharded train step at full width
   (MESH_MOE_LAYERS of 64 layers, grad_accum cut to MESH_MOE_ACCUM; the
   MoE layer routing each rank's rows on its local tensors) against the
   unsharded step (losses, CE and aux losses at MESH_TRAIN_TOL, no kernel
   launch, every leaf a DTensor, host ms and peak GB); grok-1 from int8
   weights (MESH_SERVE_LAYERS of 64) prefilling one MESH_SERVE_TOKENS
   prompt and decoding DECODE_STEPS tokens on DTensor params and cache
   against the unsharded int8 serve (the flash kernel once a layer a
   prefill, the same tokens, prefill logits at BF16_TOL); then the
   port's eight entry points (``examples``): each
   ``examples/<name>_torch.py`` run in a subprocess on the card,
   EXAMPLE_WORKERS at a time, train_lm_torch.py twice so that the second
   run resumes from the first's checkpoint, each exiting 0, with its wall
   seconds;
12. dryrun, dryrun_ground — the dry run (``launch/dryrun.py``) on
   ``--device cuda``: ``run_cell`` traces qwen2-7b's train_4k on the
   16 x 16 production mesh, mamba2-780m's prefill_32k on 2 x 16 x 16,
   grok-1's train_4k on 16 x 16 (cut in depth, the cut printed) and
   internvl2-2b's decode_32k on 16 x 16 (int8 weights), the others as
   shipped (mamba2's the SSD kernel's
   route, through its custom op), each over a fake process group of 256 /
   512 ranks, fake tensors only, no kernel launched; each record on a line
   of its own.  Then the dry run's prediction of mesh_train's and
   mesh_moe_train's exact cells (gemma3-1b, MESH_TRAIN_LAYERS layers;
   grok-1, MESH_MOE_LAYERS layers at grad_accum MESH_MOE_ACCUM; each
   TRAIN_BATCH x TRAIN_SEQ on a (1, 1)
   mesh) against that step on the card: the counted FLOPs equal the real
   sharded step's (the same counter) and the unsharded step's
   ``FlopCounterMode`` count; the predicted peak within DRYRUN_PEAK_TOL of
   ``max_memory_allocated()`` over the step (less what was allocated
   before it that is not the step's input); the step's ms beside the
   roofline's bound (ungated);
13. the ``kernels`` line (the SSD and flash rows with each rank's
   launches in the mesh phases, mesh_pipeline's among the flash row's,
   as counted there), the card line, and the
   final ``ok`` line.

Any failure raises: the script then exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
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
# The devices phase: frames a run through DevicePipeline (8 micro-batches
# of 8, M = 8), the (stages, links) runs, and measure()'s repeats.
DEVICES_FRAMES = 64
DEVICES_MICROBATCH = 8
DEVICES_RUNS = ((2, None), (3, None), (3, "int8"))
DEVICES_REPEATS = 5
# The fleet phase: two tenants at 224x224 on a pool of two big-BRAM chips
# and four stock XCVU37Ps, planned at S = 2, 64 frames each.
FLEET_FRAMES = 64
# The serving phases: prompts (tokens), new tokens each, engine shape.
PROMPT_LENS = (512, 1000, 1536, 2048)
MAX_NEW = 16
SLOTS = 2
MAX_LEN = 2304
# The vlm and encdec phases, through get_api one request at a time (the
# engine serves neither): internvl2's patches ahead of PROMPT_LENS - 256
# text tokens; seamless's PROMPT_LENS frames and a prompt of ENCDEC_TOKENS
# tokens; DECODE_STEPS greedy steps each.
ENCDEC_TOKENS = 16
DECODE_STEPS = 16
# The MoE phases: grok-1 and llama4-maverick cut to the layers one 80 GB
# card holds with int8 weights (4 of 64: one MoE layer each; 2 of 48: one
# dense, one MoE), and moe_forms' tokens through one grok-1 layer.
MOE_LAYERS = {"grok-1-314b": 4, "llama4-maverick-400b-a17b": 2}
MOE_FORM_TOKENS = 2048
# The blockwise phase: one gemma3-1b prompt past dense_max (2048) squared.
# Its gate: the blockwise and dense routes are one function, held at TOL
# on an f32 copy of the weights; in bf16 each rounds its probabilities
# once (dense: normalised; blockwise: against the running maximum, as the
# JAX package's routes do), and after 26 layers over 8192 tokens the two
# bf16 routes' gap need not fall within BF16_TOL of each other, so the
# bf16 blockwise route is held at BF16_TOL of the f32 dense logits, and
# the bf16 gaps are printed.
BLOCKWISE_TOKENS = 8192
# Training (``launch/train.py``): two configs at full size, SyntheticLM
# seed-0 batches, the example's lr; then the reduced-size gates.
TRAIN = {"train_gemma3": "gemma3-1b", "train_mamba2": "mamba2-780m"}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 2048, 8, 1e-3
TRAIN_SMALL = dict(layers=2, d_model=64, vocab=512)
TRAIN_SMALL_SEQ = 64
TRAIN_PARITY_ARCHS = ("qwen2-7b", "gemma3-1b", "grok-1-314b", "mamba2-780m",
                      "zamba2-1.2b", "seamless-m4t-medium", "internvl2-2b")
RESUME_TOL = 1e-5
# The paged KV cache at qwen2-7b's widths.
PAGED_KV = dict(n_blocks=64, block_size=16, n_layers=28, n_kv=4, head_dim=128)
PAGED_KV_TOKENS = 200
BLOCKWISE_CHECK = ("f32 copy: blockwise vs dense at TOL; bf16 blockwise vs f32 dense at "
                   "BF16_TOL")
# The mesh phases (``launch/mesh.py``, ``distributed/``, ``nn.ssm.ssd_seq_parallel``):
# K ranks on cuda:0 under gloo (NCCL takes one rank a card), a FileStore
# rendezvous in a temporary directory, the kernel library built here
# before the ranks start.  K ranks share one card's SMs: a time here says
# nothing about K cards.  mesh_ssd: mamba2-780m's widths on MESH_TOKENS
# tokens; mesh_prefill: mamba2-780m on one MESH_TOKENS-token prompt on a
# (1, 2) mesh; mesh_collectives: compressed_psum on 4 ranks at gemma3-1b's
# wq shape, MESH_PSUM_STEPS steps of error feedback within the JAX
# package's test bounds (tests/distributed/test_substrate.py);
# mesh_train: gemma3-1b at full width, MESH_TRAIN_LAYERS of its 26
# layers, MESH_TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens on a
# (1, 1) mesh of one NCCL rank, against the unsharded step.
MESH_WORLDS = (2, 4)
MESH_TOKENS = 2048
MESH_SSD = dict(h=48, p=64, g=1, n=128, chunk=128)
MESH_PSUM_STEPS = 30
MESH_PSUM_BOUNDS = (0.05, 0.02)       # last step's mean, the mean over the steps
MESH_TRAIN_LAYERS, MESH_TRAIN_STEPS, MESH_TRAIN_TOL = 4, 3, 1e-5
# mesh_moe_train: grok-1 at full width, MESH_MOE_LAYERS of its 64 layers,
# its grad_accum cut from 16 to MESH_MOE_ACCUM (one row a microbatch),
# MESH_TRAIN_STEPS steps on a (1, 1) mesh of one NCCL rank; mesh_serve_int8:
# grok-1 at full width from int8 weights, MESH_SERVE_LAYERS of 64, one
# prompt of MESH_SERVE_TOKENS tokens and DECODE_STEPS greedy steps on a
# (1, 1) mesh, against the unsharded int8 serve.
MESH_MOE_LAYERS, MESH_MOE_ACCUM = 1, 2
MESH_SERVE_LAYERS, MESH_SERVE_TOKENS = 2, 2048
# mesh_pipeline: the ring pipeline on K in MESH_WORLDS gloo ranks on cuda:0,
# MESH_PIPE_LAYERS qwen2-7b layers (full width, bf16) a stage,
# MESH_PIPE_MICRO microbatches of 1 x MESH_PIPE_TOKENS tokens
MESH_PIPE_LAYERS, MESH_PIPE_MICRO, MESH_PIPE_TOKENS = 2, 8, 512
# examples: each entry point run as ``python examples/<name>_torch.py`` on
# the card, EXAMPLE_WORKERS at a time; train_lm_torch.py cut to
# EXAMPLE_TRAIN_STEPS steps, then run again to twice as many from the
# first run's last checkpoint
EXAMPLES = ("quickstart", "rate_sweep", "cnn_stream_demo", "pipeline_demo", "fleet_demo",
            "trace_demo", "serve_lm", "train_lm")
EXAMPLE_TRAIN_STEPS = 4
EXAMPLE_TIMEOUT = 300
EXAMPLE_WORKERS = 4
# the dry run's cells (arch, shape, multi-pod, layers: None as shipped, or
# the depth cut that keeps the trace near two minutes on the card's host),
# and the peak-memory gate of its prediction against the card
DRYRUN_CELLS = (("qwen2-7b", "train_4k", False, 8), ("mamba2-780m", "prefill_32k", True, None),
                ("grok-1-314b", "train_4k", False, 4), ("internvl2-2b", "decode_32k", False, None))
DRYRUN_PEAK_TOL = 0.10
DRYRUN_GROUND_STEPS = 3
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
            err = max(err, (y.float() - ref).abs().max().item())
            scale = max(scale, ref.abs().max().item())
            if elementwise is not None:
                worst = max(worst, worst_of_limit(torch, y, ref, elementwise))
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
                suffix="", timed=True, batch=BATCH):
    """Every arithmetic node of ``family``'s main path, at its shapes and
    ``batch`` frames; on bf16 operands with ``dtype=torch.bfloat16`` (rows
    marked ``route`` "bf16", labelled ``.../bf16``, at the JAX tests' bf16
    tolerances, the bound at 2-byte elements and the FCU's and KPU's
    products at 989 TFLOP/s).  ``only`` limits the rows to those nodes,
    labelled with ``suffix``; ``timed=False`` checks them without timing."""
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
        x = torch.randn((batch, *s.in_hw, s.d_in), generator=gen).to("cuda", dtype)
        macs = s.total_macs * batch
        out_elems = batch * s.out_hw[0] * s.out_hw[1] * s.d_out
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
            group = kpu_conv.block_group(x.shape, w.shape, stride=stride, bm=t.bm,
                                         bci=t.bk, bco=t.bn, dtype=dtype)
            bench.case(
                kernel, label,
                lambda: kpu_conv.kpu_conv(x, w, stride=stride, bm=t.bm,
                                          bci=t.bk, bco=t.bn),
                lambda: kpu_conv.kpu_conv_plain(x, w, stride),
                lambda: F.conv2d(xp, w_oihw, stride=stride).permute(0, 2, 3, 1),
                2 * macs, elem * (x.numel() + w.numel() + out_elems),
                tol=tol, peak=mma_peak,
                info={**info, "split": split, "group": list(group)}, timed=timed,
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
    back; and of the flash and SSD wrappers and their custom ops (the dry
    run's traced route) at tools/wrapper_host_times.py's shapes.  The
    launches here are outside every counted window."""
    from repro_torch.kernels import fcu_matmul, flash_attention, ssd_chunk

    x = torch.randn((8, 64), device="cuda")
    w = torch.randn((64, 8), device="cuda")
    q = torch.randn((1, 2, 64, 64), device="cuda").to(torch.bfloat16)
    xs = torch.randn((1, 64, 2, 16), device="cuda")
    dt = torch.rand((1, 64, 2), device="cuda")
    a = -torch.rand((2,), device="cuda")
    b = torch.randn((1, 64, 1, 16), device="cuda")
    out = {}
    for name, fn in (("fcu_matmul", lambda: fcu_matmul.fcu_matmul(x, w, bm=8, bk=64, bn=8)),
                     ("torch.matmul", lambda: torch.matmul(x, w)),
                     ("flash_attention", lambda: flash_attention.flash_attention(
                         q, q, q, block_q=64, block_k=64)),
                     ("flash_attention_op", lambda: torch.ops.repro_torch.flash_attention(
                         q, q, q, True, 64, 64)),
                     ("ssd_chunk", lambda: ssd_chunk.ssd_chunk(xs, dt, a, b, b, chunk=64)),
                     ("ssd_chunk_op", lambda: torch.ops.repro_torch.ssd_chunk(
                         xs, dt, a, b, b, 64))):
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
    kernels_mod["kpu_conv"].kpu_conv.grouped_launches = 0


def read_counts(kernels_mod) -> dict:
    return {name: getattr(kernels_mod[name], name).launches for name in KERNELS}


def run_slice(torch, family, kernels_mod, gen, bench, dtype=None):
    """One family's main path: REQUESTS batches of BATCH frames through
    the rate-matched forward pass on the card; with ``dtype=torch.bfloat16``
    the same forward in bf16 (weights, frames and logits; phase
    ``slice_bf16``, logits at BF16_TOL of their scale, off the main path:
    its launches stay out of the kernels line).  Returns the launches of
    its counted runs, per kernel, and the KPU's grouped launches among
    them (``kpu_conv.grouped_launches``)."""
    from repro_torch.kernels import kpu_conv
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
    grouped = kpu_conv.kpu_conv.grouped_launches

    arith = [n for n, ip in kp.items() if ip.has_kernel]
    want = {k: 0 for k in KERNELS}
    for n in arith:
        want[KIND_KERNEL[kp[n].kind]] += REQUESTS
    require(counts == want, f"{family}: launches {counts} != nodes x requests {want}")
    # the counter against the kernel's plan, as block_group reads it
    groups = {}
    for n in arith:
        spec, t = graph.spec(n), kp[n].tile
        if spec.kind == "conv":
            groups[n] = kpu_conv.block_group(
                (BATCH, *spec.in_hw, spec.d_in), (*spec.kernel, spec.d_in, spec.d_out),
                stride=spec.stride[0], bm=t.bm, bci=t.bk, bco=t.bn, dtype=cfg.dtype)
    want_grouped = REQUESTS * sum(r * c > 1 for r, c in groups.values())
    require(grouped == want_grouped,
            f"{family}: grouped KPU launches {grouped} != {want_grouped} from block_group")
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
        "kpu_grouped_launches": grouped,
        "kpu_groups": {n: list(g) for n, g in groups.items()},
    }
    emit(row)
    return counts, grouped


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


def edge_bytes(graph, stage_plan, batch: int, link) -> dict:
    """Bytes a batch moves on each placed cut edge ``u->s{stage}`` (one
    payload per producer and consuming stage), keyed as the engine's
    ``transfer_bytes{edge,dtype}`` counter: fp32, or the int8 payload
    (one int8 a feature plus the 4-byte scale), as ``cut_bytes`` prices
    a producer's stream."""
    stage_of = stage_plan.stage_index()
    out = {}
    for v in graph.topo_order():
        for u in graph.preds(v):
            if stage_of[u] != stage_of[v]:
                spec = graph.spec(u)
                feats = batch * spec.out_hw[0] * spec.out_hw[1] * spec.d_out
                key = (f"transfer_bytes{{dtype={'int8' if link else 'float32'},"
                       f"edge={u}->s{stage_of[v]}}}")
                out[key] = feats + 4 if link else 4 * feats
    return out


def transfer_counts(report) -> dict:
    return {k: v for k, v in report.metrics.snapshot().items()
            if k.startswith("transfer_bytes")}


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
    of one family at 224x224, and run a at S = 2 again with
    ``execute="devices"`` (phase ``stream``); returns the launches of its
    counted runs, per kernel."""
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
    # run a again with the stages on streams of their own, traced
    runs.append(("a", 2, None, "constant", "devices", {}))
    runs.append(("a", 2, "int8", "constant", "devices", {"link_dtype": "int8"}))

    for run, n_stages, link, traffic, policy, dse in runs:
        label = f"{family}/stream/{run}/S={n_stages}/{link or 'fp32'}/{policy}"
        mode = "devices" if policy == "devices" else True
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
                             overload=overload, trace=policy in ("traced", "devices"))

        def engine(execute=mode):
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
            if syncs is None:
                rep, out = eng.run(), eng.outputs()
            else:
                (rep, out), caught = sync_warnings(torch, lambda: (eng.run(), eng.outputs()))
                syncs += caught
            torch.cuda.synchronize()
            return rep, out, (time.perf_counter() - t0) * 1e3

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
            if mode == "devices":
                _, host_out, _ = serve(engine(True))
                require(torch.equal(out, host_out), f"{label}: served != execute=True's")
                want_bytes = {k: v * batches[0] for k, v in edge_bytes(
                    graph, gp.stage_plan, STREAM_MICROBATCH, link).items()}
                require(transfer_counts(rep) == want_bytes,
                        f"{label}: transfer_bytes {transfer_counts(rep)} != the plan's "
                        f"cut bytes x micro-batches {want_bytes}")
            t0 = time.perf_counter()
            for _, b in chunks:
                api.apply_staged(params, b, cfg, partition=gp, plan=kp,
                                 link_quant=True if link else None)
            torch.cuda.synchronize()
            staged_ms = (time.perf_counter() - t0) * 1e3

        if policy in (None, "traced", "devices"):
            require(rep.stall_free, f"{label}: stalled at the plan's BestRate")
        summary = rep.summary()
        row = {
            "phase": "stream", "family": family, "stages": n_stages,
            "links": link or "fp32", "traffic": traffic, "policy": policy,
            "run": run, "execute": mode, "frames": STREAM_FRAMES,
            "microbatch": STREAM_MICROBATCH,
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
        if mode == "devices":
            row["transfer_bytes"] = transfer_counts(rep)
            row["served_eq_execute_true"] = True
        if config.trace:
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


def kernel_overlaps(torch, fn):
    """One call of ``fn`` under ``torch.profiler``, ending in a synchronize:
    the host-clock ms; the device ms summed over kernels, copies and sets;
    the ms the device was busy (the union of those intervals); the kernels
    by CUDA stream; and the count of kernel pairs on different streams
    whose intervals overlap (from the trace's timeline)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e["dur"], e.get("cat"), e.get("args", {}).get("stream"))
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    kernels = [d for d in device if d[2] == "kernel"]
    pairs = 0
    for i, (start, end, _, stream) in enumerate(kernels):
        for start2, _, _, stream2 in kernels[i + 1:]:
            if start2 >= end:
                break
            pairs += stream2 != stream
    busy, cur_start, cur_end = 0.0, None, None
    for start, end, _, _ in device:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy += cur_end - cur_start
    by_stream = {}
    for _, _, _, stream in kernels:
        by_stream[str(stream)] = by_stream.get(str(stream), 0) + 1
    return {"wall_ms": wall, "device_ms": sum(e - b for b, e, _, _ in device) / 1e3,
            "device_busy_ms": busy / 1e3, "device_busy_share": busy / 1e3 / wall,
            "kernels": len(kernels), "kernels_by_stream": by_stream,
            "cross_stream_overlapping_kernel_pairs": pairs}


def sync_warnings(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("warn")``: its
    result and the host-sync warnings it raised."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, [str(w.message) for w in caught if "synchroniz" in str(w.message)]


def run_devices(torch, family, kernels_mod, gen):
    """The device pipeline (``distributed/device_pipeline.py``) of one
    family at 224x224 on the card (phase ``devices``): DEVICES_FRAMES
    frames at micro-batch DEVICES_MICROBATCH through the GPipe schedule,
    every stage on cuda:0 on a CUDA stream of its own; returns the
    launches of its counted runs, per kernel."""
    from repro_torch.distributed.device_pipeline import DevicePipeline
    from repro_torch.models.registry import get_cnn_api

    api = get_cnn_api(family)
    cfg = api.make_config()
    graph = api.graph(cfg)
    params = api.init(cfg, torch.Generator().manual_seed(0))
    shape = (DEVICES_FRAMES, *cfg.input_hw, 3)
    frames = torch.randn(shape, generator=gen).cuda()
    mb = DEVICES_MICROBATCH
    total = {k: 0 for k in KERNELS}
    for n_stages, link in DEVICES_RUNS:
        label = f"{family}/devices/S={n_stages}/{link or 'fp32'}"
        dse = {"link_dtype": link} if link else {}
        gp = api.partition(cfg, RATE, n_stages, **dse)
        kp = gp.kernel_plan(batch=mb)
        lq = True if link else None
        dp = DevicePipeline.build(graph, params, partition=gp, plan=kp, link_quant=lq)
        streams = [s.cuda_stream for s in dp.pipeline.streams]
        require(dp.placement_ordinals() == (0,) * n_stages and dp.n_devices() == 1,
                f"{label}: placed on {dp.placement_ordinals()}")
        require(len(set(streams)) == n_stages
                and torch.cuda.current_stream().cuda_stream not in streams,
                f"{label}: the stages do not own distinct streams")
        want = torch.cat([api.apply_staged(params, frames[i:i + mb], cfg, partition=gp,
                                           plan=kp, link_quant=lq)
                          for i in range(0, DEVICES_FRAMES, mb)])
        dp.run(frames, microbatch=mb)  # warm-up
        torch.cuda.synchronize()
        reset_counts(kernels_mod)
        t0 = time.perf_counter()
        out, syncs = sync_warnings(torch, lambda: dp.run(frames, microbatch=mb))
        counts = read_counts(kernels_mod)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
        for k, v in counts.items():
            total[k] += v
        require(counts == want_launches(kp, DEVICES_FRAMES // mb),
                f"{label}: launches {counts} != nodes x micro-batches")
        require(not syncs, f"{label}: host syncs inside run(): {syncs[:3]}")
        require(tuple(out.shape) == (DEVICES_FRAMES, cfg.num_classes)
                and bool(torch.isfinite(out).all()), f"{label}: logits {tuple(out.shape)}")
        require(torch.equal(out, want), f"{label}: run != apply_staged per micro-batch")
        # the record_stream check: two runs in a row on fresh frames, no
        # wait between them, while the allocator recycles their boundaries
        fresh = torch.randn(shape, generator=gen).cuda()
        a = dp.run(fresh, microbatch=mb)
        b = dp.run(fresh, microbatch=mb)
        torch.cuda.synchronize()
        require(torch.equal(a, b), f"{label}: two runs on the same frames differ")
        rep = dp.measure(frames, microbatch=mb, warmup=1, repeats=DEVICES_REPEATS)
        prof = kernel_overlaps(torch, lambda: dp.run(frames, microbatch=mb))
        emit({
            "phase": "devices", "family": family, "stages": n_stages,
            "links": link or "fp32", "frames": DEVICES_FRAMES, "microbatch": mb,
            "n_micro": rep.n_micro, "placement": list(rep.placement),
            "n_devices": rep.n_devices, "streams_distinct": True,
            "launches": counts, "bit_exact_vs_apply_staged": True,
            "host_syncs_in_run": len(syncs), "two_runs_identical": True,
            "run_ms": run_ms,
            "overlap_ms": rep.overlap_s * 1e3, "sequential_ms": rep.sequential_s * 1e3,
            "speedup": rep.speedup, "fps_overlap": rep.fps_overlap,
            "fps_sequential": rep.fps_sequential,
            "stage_busy_ms": [b * 1e3 for b in rep.stage_busy_s],
            "stage_busy_frac": list(rep.stage_busy_frac),
            "utilization_bound": rep.utilization_bound,
            "profiled": prof,
        })
    return total


def run_fleet(torch, kernels_mod, gen):
    """The fleet (``fleet/pool.py``, ``fleet/scheduler.py``) on the card
    (phase ``fleet``): two tenants at 224x224 packed on a chip pool at S =
    2, FLEET_FRAMES frames each at BestRate, served by one scheduler on
    one shared clock with ``execute=True`` and then ``"devices"``, each
    with a shared tracer; returns the launches of its counted runs."""
    from repro_torch.fleet import Chip, FleetScheduler, Tenant, TenantWorkload, chip_pool
    from repro_torch.fleet import plan_pool
    from repro_torch.models.registry import get_cnn_api
    from repro_torch.obs import audit_fleet
    from repro_torch.serving import CNNStreamEngine, ServeConfig, constant
    from repro_torch.serving.cnn_stream import best_rate_frames

    tenants = (Tenant("mnv2", "mobilenet_v2", RATE, input_hw=(224, 224), num_classes=1000),
               Tenant("r18", "resnet18", Fraction(3, 4), input_hw=(224, 224),
                      num_classes=1000))
    chips = (Chip("big0", bram36=4096), Chip("big1", bram36=4096)) + chip_pool(4)
    t0 = time.perf_counter()
    pool = plan_pool(tenants, chips, s_options=(2,))
    plan_s = time.perf_counter() - t0
    labels = {n: c.label for n, c in pool.chosen.items()}
    require(labels == {"mnv2": "mnv2:S2", "r18": "r18:S2"}, f"fleet: pool chose {labels}")
    params, frames, configs = {}, {}, {}
    for i, t in enumerate(tenants):
        cand = pool.candidate_for(t.name)
        params[t.name] = get_cnn_api(t.family).init(cand.cfg,
                                                    torch.Generator().manual_seed(i))
        frames[t.name] = torch.randn((FLEET_FRAMES, *t.input_hw, 3), generator=gen).cuda()
        configs[t.name] = ServeConfig(
            microbatch=STREAM_MICROBATCH,
            kernel_plan=cand.plan.kernel_plan(batch=STREAM_MICROBATCH),
            arrival=constant(best_rate_frames(cand.plan)))

    def serve(execute, trace=True):
        sched = FleetScheduler(pool, params=params,
                               config=ServeConfig(execute=execute, trace=trace))
        work = [TenantWorkload(n, frames[n], configs[n].with_(execute=execute))
                for n in frames]
        t0 = time.perf_counter()
        rep = sched.serve(work)
        torch.cuda.synchronize()
        return rep, (time.perf_counter() - t0) * 1e3

    twin, _ = serve(False, trace=False)
    want = {k: 0 for k in KERNELS}
    for name in frames:
        kp = configs[name].kernel_plan
        for k, v in want_launches(kp, FLEET_FRAMES // STREAM_MICROBATCH).items():
            want[k] += v
    total = {k: 0 for k in KERNELS}
    served = {}
    for execute in (True, "devices"):
        label = f"fleet/execute={execute}"
        serve(execute)  # warm-up
        reset_counts(kernels_mod)
        rep, wall_ms = serve(execute)
        counts = read_counts(kernels_mod)
        for k, v in counts.items():
            total[k] += v
        require(counts == want, f"{label}: launches {counts} != nodes x batches {want}")
        require(rep.all_stall_free, f"{label}: a tenant stalled at its BestRate")
        for name in frames:
            require(_plain(rep.reports[name]) == _plain(twin.reports[name])
                    and rep.reports[name]._stage_intervals
                    == twin.reports[name]._stage_intervals,
                    f"{label}/{name}: report != the execute=False twin's")
            out, cand = rep.outputs[name], pool.candidate_for(name)
            require(tuple(out.shape) == (FLEET_FRAMES, cand.cfg.num_classes) and out.is_cuda
                    and bool(torch.isfinite(out).all()), f"{label}/{name}: outputs")
            alone = CNNStreamEngine(cand.plan.graph, params[name], cand.plan,
                                    configs[name].with_(execute=execute))
            alone.submit_all(frames[name])
            alone.run()
            require(torch.equal(out, alone.outputs()),
                    f"{label}/{name}: fleet outputs != the standalone engine's")
            if execute == "devices":
                require(torch.equal(out, served[True].outputs[name]),
                        f"{label}/{name}: served != execute=True's")
                want_bytes = {k: v * (FLEET_FRAMES // STREAM_MICROBATCH)
                              for k, v in edge_bytes(cand.plan.graph, cand.plan.stage_plan,
                                                     STREAM_MICROBATCH, None).items()}
                require(transfer_counts(rep.reports[name]) == want_bytes,
                        f"{label}/{name}: transfer_bytes != the plan's cut bytes")
        require(rep.makespan_cycles == twin.makespan_cycles
                and rep.chip_occupancy == twin.chip_occupancy,
                f"{label}: makespan / occupancy != the twin's")
        audits = audit_fleet(rep.trace)
        require(sorted(audits) == sorted(frames)
                and all(a.clean and a.matches(rep.reports[n].summary())
                        for n, a in audits.items()),
                f"{label}: audit {[a.verdict_line() for a in audits.values()]}")
        served[execute] = rep
        emit({
            "phase": "fleet", "execute": execute, "frames_per_tenant": FLEET_FRAMES,
            "microbatch": STREAM_MICROBATCH, "plan_s": plan_s, "chosen": labels,
            "assignments": [[a.tenant, a.stage, a.chip] for a in pool.assignments],
            "chip_occupancy": rep.chip_occupancy,
            "tenant_wall_ms": {n: w * 1e3 for n, w in rep.tenant_wall_s.items()},
            "measured_fps": {n: rep.measured_fps(n) for n in frames},
            "fleet_wall_ms": wall_ms, "launches": counts,
            "stall_free": True, "eq_standalone": "bit-identical",
            "report_eq_execute_false_twin": True,
            "audit": {n: a.verdict_line() for n, a in audits.items()},
            "p99_ticks": {n: rep.p99_latency(n) for n in frames},
        })
    return total


def bench_flash(torch, bench, gen):
    """The flash kernel at the LM paths' prefill shapes (qwen2-7b's heads
    and zamba2's shared-attention heads, bf16, each served prompt length),
    at the windowed, vlm, MoE and encdec paths' shapes (gemma3-1b's global
    layers at d 256, also at the blockwise phase's 8192 tokens;
    internvl2-2b over 256 patches + text; grok-1's and maverick's heads; seamless's
    encoder, non-causal over T frames, its decoder's 16-token prompt, and
    its cross-attention, 16 queries or one against T keys), then extras
    off those paths (f32, also at d 256, group 1 at d 128, non-causal, GQA
    at d = 64, a length below one block; checked, not timed), then the
    bf16 kernel's time at every pair of blocks at the LM paths' shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    def case(label, h, hkv, s, d, dtype, causal=True, timed=True, sk=None):
        sk = s if sk is None else sk
        q = torch.randn((1, h, s, d), generator=gen).to("cuda", dtype)
        k, v = (torch.randn((1, hkv, sk, d), generator=gen).to("cuda", dtype)
                for _ in range(2))
        kx, vx = (t.repeat_interleave(h // hkv, dim=1) for t in (k, v))
        block_q, block_k = fa.flash_blocks(h, s, dtype, d)
        pairs = s * (s + 1) // 2 if causal else s * sk
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
    for s in PROMPT_LENS:   # gemma3's global layers (5, 11, 17, 23): d 256
        case(f"gemma3-1b/global-prefill{s}", 4, 1, s, 256, torch.bfloat16)
    for s in PROMPT_LENS:   # 256 patches + 256..1792 text tokens
        case(f"internvl2-2b/prefill{s}", 16, 8, s, 128, torch.bfloat16)
    for s in PROMPT_LENS:   # the MoE models' attention: 48 / 8 and 40 / 8 heads, d 128
        case(f"grok-1-314b/prefill{s}", 48, 8, s, 128, torch.bfloat16)
        case(f"llama4-maverick-400b-a17b/prefill{s}", 40, 8, s, 128, torch.bfloat16)
    case(f"gemma3-1b/global-prefill{BLOCKWISE_TOKENS}", 4, 1, BLOCKWISE_TOKENS, 256,
         torch.bfloat16)
    for t in PROMPT_LENS:   # seamless: T frames, ENCDEC_TOKENS prompt tokens
        case(f"seamless-m4t-medium/encoder{t}", 16, 16, t, 64, torch.bfloat16,
             causal=False)
        case(f"seamless-m4t-medium/cross-prefill{t}", 16, 16, ENCDEC_TOKENS, 64,
             torch.bfloat16, causal=False, sk=t)
        case(f"seamless-m4t-medium/cross-decode{t}", 16, 16, 1, 64, torch.bfloat16,
             causal=False, sk=t)
    case(f"seamless-m4t-medium/decoder-prefill{ENCDEC_TOKENS}", 16, 16, ENCDEC_TOKENS,
         64, torch.bfloat16)
    case("extra/f32-s512", 28, 4, 512, 128, torch.float32, timed=False)
    case("extra/f32-d256-s700", 4, 1, 700, 256, torch.float32, timed=False)
    case("extra/d256-ragged-s333", 4, 1, 333, 256, torch.bfloat16, timed=False)
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
                "rule": "x".join(map(str, fa.flash_blocks(h, s, torch.bfloat16, d))),
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


def profile_calls(torch, calls) -> dict:
    """Each of ``calls`` (name -> fn): the median host ms of 3 calls, each
    ending in a synchronize, then one call under ``torch.profiler`` for
    its device ms by kind (SERVE_DEVICE_FN) and busy share."""
    out = {}
    for name, fn in calls.items():
        host_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms, wall, top = device_ms_by_kernel(torch, fn, SERVE_DEVICE_FN)
        out[name] = {
            "ms": statistics.median(host_ms), "profiled_wall_ms": wall,
            "device_ms": device_ms,
            "device_busy_share": sum(device_ms.values()) / statistics.median(host_ms),
            "top_device_fns": [(ms, n, key[:90]) for ms, n, key in top[:5]]}
    return out


class RouteLog:
    """The experts each MoE layer's router picks, recorded while
    ``record()`` is open by a hook on the router's input
    (``nn.moe._route``, wrapped for the length of the phase), so that
    nothing in the model's signature changes."""

    def __init__(self):
        from repro_torch.nn import moe

        self.moe, self.route, self.calls = moe, moe._route, None

    def __enter__(self):
        def hooked(params, x2d, spec, *rest):
            out = self.route(params, x2d, spec, *rest)
            if self.calls is not None:
                self.calls.append(out[1].sort(dim=-1).values)
            return out

        self.moe._route = hooked
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def record(self):
        self.calls = []
        return self.calls

    @staticmethod
    def flips(got, want) -> dict:
        """Routed choices (token, layer: the set of k experts) that differ
        between two runs of the same prefill, per layer."""
        per_layer = [int((a != b).any(-1).sum()) for a, b in zip(got, want)]
        return {"tokens_rerouted_per_layer": per_layer, "tokens_rerouted": sum(per_layer),
                "routed_tokens": sum(a.shape[0] for a in got)}


def run_serve(torch, kernels_mod, phase, cfg, mod, per_prefill, plain_routes,
              served_tol=BF16_TOL, f32_check=False, gate=None, params=None, routes=None):
    """``cfg`` served by the token engine on the card at full width,
    random weights from a seeded CUDA generator (``params``, or
    ``api.init``'s): 4 prompts on 2 slots, 16 new tokens each (smoke-size
    traffic), launch counts set to 0 just before and read just after, each
    kernel launched exactly ``per_prefill[kernel]`` times a prefill; then
    each prompt's prefill logits on the kernels against the same prefill
    on their plain versions (``plain_routes``, keyword arguments of
    ``mod.prefill``), and one prefill and one decode step under
    ``torch.profiler``.

    The served dtype's logits are held at ``served_tol`` of their scale
    and, with ``f32_check``, an f32 copy of the same weights at TOL (see
    SSM_CHECK).  Each route is run once at each length before the prefill
    that is timed.  With ``routes`` (a RouteLog), each check also counts
    the MoE routing choices that differ between the two routes.
    ``gate(api, params, prompts)``, if given, runs last.  Returns the
    launch counts of the serve run."""
    import numpy as np

    from repro_torch.models.registry import get_api
    from repro_torch.serving.engine import Engine, Request

    api = get_api(cfg)
    if params is None:
        params = build_params(torch, phase, cfg)

    rng = np.random.default_rng(2026)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in PROMPT_LENS]
    warm = Engine(cfg, params, slots=SLOTS, max_len=MAX_LEN)
    warm.submit(Request(rid=-1, prompt=prompts[0][:64], max_new=2))
    warm.run_until_drained()
    del warm
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
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
                    chosen = routes.record() if routes is not None else None
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, _ = mod.prefill(prm, toks, c, state, **kw)
                    torch.cuda.synchronize()
                out[route] = (logits, (time.perf_counter() - t0) * 1e3, chosen)
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
            if routes is not None:
                row[name]["routing"] = RouteLog.flips(out["kernel"][2], out["plain"][2])
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
    emit({"phase": f"{phase}_profile", "prefill_tokens": len(prompts[-1]),
          "decode_slots": SLOTS, "decode_positions": pos.tolist(),
          **profile_calls(torch, calls)})
    if gate is not None:
        gate(api, params, prompts)
    return counts


def slot_gate(torch, phase, cfg, cache_kind):
    """The per-slot gate: the first two prompts prefilled alone, written
    into a pool of SLOTS rows and decoded in one step at their own
    positions (512 and 1000), held row by row against the same request
    decoded alone at one slot, at BF16_TOL of the logits' scale.  A cache
    written or masked at one position for the whole batch fails it.
    ``cache_kind``: "rings" (gemma3: 512-slot rings, one full and one
    wrapped at those positions) or "int8" (the int8 KV cache; its bytes,
    scales included, printed beside the bf16 cache's)."""
    import numpy as np

    from repro_torch.nn.quant import tree_bytes
    from repro_torch.serving.engine import _write_slot

    def gate(api, params, prompts):
        pool = api.make_serve_state(cfg, SLOTS, MAX_LEN)
        info = {}
        if cache_kind == "rings":
            require(isinstance(pool, list), f"{phase}: no per-layer ring caches at "
                    f"max_len {MAX_LEN} > window {cfg.window}")
            info = {"ring_layers": sum(1 for i in range(cfg.n_layers) if cfg.window_for_layer(i)),
                    "ring_slots": min(MAX_LEN, cfg.window)}
        else:
            require(len(pool) == 4 and pool[0].dtype == torch.int8,
                    f"{phase}: no int8 KV cache: {[t.dtype for t in pool]}")
            bf16 = api.make_serve_state(dataclasses.replace(cfg, kv_quant=False), SLOTS,
                                        MAX_LEN)
            info = {"cache_bytes": tree_bytes(list(pool)), "bf16_cache_bytes": tree_bytes(
                list(bf16)), "cache_shape": list(pool[0].shape)}
            info["cache_over_bf16"] = info["cache_bytes"] / info["bf16_cache_bytes"]
            del bf16
        alone, toks = [], []
        for slot, p in enumerate(prompts[:SLOTS]):
            one = api.make_serve_state(cfg, 1, MAX_LEN)
            logits, one = api.prefill(params, {"tokens": p[None]}, one, cfg)
            _write_slot(pool, one, slot)
            alone.append(one)
            toks.append(int(torch.argmax(logits[0, -1])))
        pos = np.asarray([len(p) for p in prompts[:SLOTS]])
        got, _ = api.decode(params, pool, {"tokens": [[t] for t in toks]}, pos, cfg)
        rows = []
        for slot in range(SLOTS):
            want, _ = api.decode(params, alone[slot], {"tokens": [[toks[slot]]]},
                                 int(pos[slot]), cfg)
            scale = max(1.0, want.abs().max().item())
            err = (got[slot] - want[0]).abs().max().item()
            require(err <= BF16_TOL * scale,
                    f"{phase}: row {slot} at position {pos[slot]} of a batched decode "
                    f"vs decoded alone: max|err| {err} > {BF16_TOL} x {scale}")
            rows.append({"position": int(pos[slot]), "max_abs_err": err, "scale": scale,
                         "greedy_agrees": int(got[slot].argmax()) == int(want[0].argmax())})
        name = "ring_gate" if cache_kind == "rings" else "slot_gate"
        emit({"phase": f"{phase}_{name}", "tolerance": BF16_TOL, "rows": rows, **info})

    return gate


def run_family_serve(torch, kernels_mod, phase, cfg, params, requests, per_prefill,
                     per_decode, prefill_on, info):
    """``cfg`` served through ``get_api`` one request at a time (the
    engine refuses the family): each of ``requests`` (a batch of one row
    on the card and its decode start position) prefilled, then
    DECODE_STEPS greedy decode steps, the flash kernel's launches counted
    per prefill and per decode step (``per_prefill`` and ``per_decode``),
    every other kernel's zero; TTFT, decode ms a step and tokens/s from
    the host clock around work ending in a host read of the sampled token.
    Then each request's prefill logits on the kernels against the same
    prefill on the plain versions (``prefill_on(batch, state, flash)`` ->
    logits), at BF16_TOL of their scale, and one prefill and one decode
    step under ``torch.profiler``.  Returns the launch counts."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.registry import get_api

    api = get_api(cfg)
    flash = kernels_mod["flash_attention"].flash_attention

    def serve(batch, pos, steps):
        state = api.make_serve_state(cfg, 1, MAX_LEN)
        t0 = time.perf_counter()
        logits, state = api.prefill(params, batch, state, cfg)
        out = [int(torch.argmax(logits[0, -1]))]
        ttft = (time.perf_counter() - t0) * 1e3
        launched = [flash.launches]
        step_ms = []
        for i in range(steps):
            t0 = time.perf_counter()
            logits, state = api.decode(params, state, {"tokens": [[out[-1]]]}, pos + i, cfg)
            out.append(int(torch.argmax(logits[0, -1])))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launched.append(flash.launches)
        return out, ttft, step_ms, launched, state

    serve(*requests[0], 2)                      # warm-up, outside the counts
    torch.cuda.synchronize()
    reset_counts(kernels_mod)
    t_start = time.perf_counter()
    per_request = []
    for batch, pos in requests:
        before = flash.launches
        out, ttft, step_ms, launched, _ = serve(batch, pos, DECODE_STEPS)
        steps = [b - a for a, b in zip(launched, launched[1:])]
        require(launched[0] - before == per_prefill and steps == [per_decode] * DECODE_STEPS,
                f"{phase}: flash launches {launched[0] - before} a prefill, {steps} a "
                f"decode step; want {per_prefill} and {per_decode}")
        per_request.append({"prompt_positions": pos, "new_tokens": len(out), "ttft_ms": ttft,
                            "decode_step_ms_median": statistics.median(step_ms),
                            "decode_tokens_per_s": DECODE_STEPS / (sum(step_ms) / 1e3),
                            "flash_launches_prefill": launched[0] - before,
                            "flash_launches_decode_step": per_decode})
    serve_s = time.perf_counter() - t_start
    counts = read_counts(kernels_mod)
    want = {k: 0 for k in KERNELS}
    want["flash_attention"] = (per_prefill + per_decode * DECODE_STEPS) * len(requests)
    require(counts == want, f"{phase}: launches {counts} != {want}")
    emit({"phase": f"{phase}_serve", "model": cfg.name, "traffic": "smoke-size",
          "requests": per_request, "launches": counts, "serve_s": serve_s,
          "tokens_per_s": sum(r["new_tokens"] for r in per_request) / serve_s,
          "decode_step_ms_median": statistics.median(
              r["decode_step_ms_median"] for r in per_request),
          "max_memory_allocated": torch.cuda.max_memory_allocated(), **info})

    def flash_plain(q, k, v, causal=True):
        return flash_attention_plain(q, k, v, causal=causal)

    rows = []
    for batch, pos in requests:
        out = {}
        for route, core in (("kernel", None), ("plain", flash_plain)):
            for _ in range(2):          # warm at this length, then time
                state = api.make_serve_state(cfg, 1, MAX_LEN)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = prefill_on(batch, state, core)
                torch.cuda.synchronize()
            out[route] = (logits, (time.perf_counter() - t0) * 1e3)
        got, want_ = out["kernel"][0], out["plain"][0]
        require(tuple(got.shape) == (1, 1, cfg.vocab) and got.dtype == torch.float32,
                f"{phase}: logits {tuple(got.shape)} {got.dtype}")
        require(bool(torch.isfinite(got).all()), f"{phase}: non-finite prefill logits")
        scale = max(1.0, want_.abs().max().item())
        err = (got - want_).abs().max().item()
        require(err <= BF16_TOL * scale, f"{phase}/prefill at {pos}: logits vs plain path "
                f"max|err| {err} > {BF16_TOL} x {scale}")
        rows.append({"prompt_positions": pos, "prefill_ms": out["kernel"][1],
                     "plain_prefill_ms": out["plain"][1], "logits_max_abs_err": err,
                     "logits_scale": scale,
                     "greedy_agrees": int(got.argmax()) == int(want_.argmax())})
    emit({"phase": f"{phase}_prefill_check", "prompts": rows, "tolerance": BF16_TOL,
          "gate": f"{cfg.param_dtype} at BF16_TOL", "plain_routes": ["flash"]})

    batch, pos = requests[-1]
    state = api.make_serve_state(cfg, 1, MAX_LEN)
    _, _, _, _, served = serve(batch, pos, 1)
    calls = {"prefill": lambda: api.prefill(params, batch, state, cfg),
             "decode": lambda: api.decode(params, served, {"tokens": [[1]]}, pos + 1, cfg)}
    emit({"phase": f"{phase}_profile", "prefill_positions": pos,
          **profile_calls(torch, calls)})
    return counts


def run_vlm(torch, kernels_mod):
    """internvl2-2b from int8 weights (``quantize_tree`` of random bf16
    weights): 4 requests of n_patches random patch embeddings and
    PROMPT_LENS - n_patches text tokens, the flash kernel once per layer a
    prefill and never in decode."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import vlm
    from repro_torch.models.registry import get_api
    from repro_torch.nn.quant import quantize_tree, tree_bytes

    cfg = get_config("internvl2-2b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    weights = get_api(cfg).init(cfg, gen)
    bf16_bytes = tree_bytes(weights)
    params = quantize_tree(weights)
    del weights
    torch.cuda.synchronize()
    int8_bytes = tree_bytes(params)
    emit({"phase": "vlm_build", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "init_and_quantize_s": time.perf_counter() - t0,
          "bf16_tree_bytes": bf16_bytes, "int8_tree_bytes": int8_bytes,
          "int8_over_bf16": int8_bytes / bf16_bytes})
    rng = np.random.default_rng(2026)
    requests = []
    for n in PROMPT_LENS:
        text = n - cfg.n_patches
        patches = torch.randn((1, cfg.n_patches, cfg.d_model), generator=gen,
                              device="cuda").to(cfg.dtype)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, text)), device="cuda")
        requests.append(({"tokens": toks, "patches": patches}, n))

    def prefill_on(batch, state, flash):
        return vlm.prefill(params, batch["tokens"], batch["patches"], cfg, state,
                           flash=flash)[0]

    counts = run_family_serve(torch, kernels_mod, "vlm", cfg, params, requests,
                              cfg.n_layers, 0, prefill_on,
                              {"weights": "int8 (quantize_tree)", "patches": cfg.n_patches})
    del params
    torch.cuda.empty_cache()
    return counts


def run_encdec(torch, kernels_mod):
    """seamless-m4t-medium: 4 requests of PROMPT_LENS random frames and
    ENCDEC_TOKENS prompt tokens, the flash kernel 3 x 12 times a prefill
    (encoder, decoder self, cross) and 12 times a decode step (cross)."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec
    from repro_torch.models.registry import get_api

    cfg = get_config("seamless-m4t-medium")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = get_api(cfg).init(cfg, gen)
    torch.cuda.synchronize()
    emit({"phase": "encdec_build", "model": cfg.name, "enc_layers": cfg.enc_layers,
          "dec_layers": cfg.dec_layers, "d_model": cfg.d_model,
          "param_bytes": _param_bytes(params), "init_s": time.perf_counter() - t0})
    rng = np.random.default_rng(2026)
    requests = []
    for t in PROMPT_LENS:
        frames = torch.randn((1, t, cfg.d_model), generator=gen, device="cuda").to(cfg.dtype)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(1, ENCDEC_TOKENS)),
                               device="cuda")
        requests.append(({"tokens": toks, "frames": frames}, ENCDEC_TOKENS))

    def prefill_on(batch, state, flash):
        return encdec.prefill(params, batch["tokens"], batch["frames"], cfg,
                              state["cache"], flash=flash)[0]

    counts = run_family_serve(torch, kernels_mod, "encdec", cfg, params, requests,
                              cfg.enc_layers + 2 * cfg.dec_layers, cfg.dec_layers, prefill_on,
                              {"frames": list(PROMPT_LENS), "prompt_tokens": ENCDEC_TOKENS})
    del params
    torch.cuda.empty_cache()
    return counts


def _bf16_bytes(tree) -> int:
    """The bytes of ``tree`` with each int8 leaf in bf16 instead."""
    if isinstance(tree, dict) and set(tree) == {"__q__", "__s__"}:
        return tree["__q__"].numel() * 2
    if isinstance(tree, dict):
        return sum(_bf16_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_bf16_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def build_params(torch, phase, cfg, quantize=False):
    """Random weights on the card from a seeded CUDA generator (``quantize``:
    int8 serve weights, each layer quantized as it is drawn, so no more
    than one layer is ever in bf16), and the phase's build line: the tree's
    bytes (int8 trees beside the same tree in bf16), seconds, peak memory."""
    from repro_torch.configs.base import param_count
    from repro_torch.models import lm
    from repro_torch.models.registry import get_api

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = (lm.init(cfg, gen, "cuda", quantize=True) if quantize
              else get_api(cfg).init(cfg, gen))
    torch.cuda.synchronize()
    line = {"phase": f"{phase}_build", "model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": param_count(cfg),
            "param_bytes": _param_bytes(params), "init_s": time.perf_counter() - t0,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
    if quantize:
        line.update(weights="int8 (lm.init(quantize=True), as shipped)",
                    bf16_param_bytes=_bf16_bytes(params),
                    int8_over_bf16=line["param_bytes"] / _bf16_bytes(params))
    emit(line)
    return params


def flash_plain(q, k, v):
    from repro_torch.kernels.flash_attention import flash_attention_plain

    return flash_attention_plain(q, k, v, causal=True)


def run_lm_paths(torch, kernels_mod):
    """The models the token engine serves without MoE layers, each through
    ``run_serve``: qwen2-7b with a bf16 KV cache (``lm``) and then, on the
    same weights, as shipped with its int8 KV cache (``lm_kvq``, then
    ``slot_gate``), the flash kernel once per layer per prefill;
    mamba2-780m (the SSD kernel once per layer), zamba2-1.2b (the SSD
    kernel once per Mamba2 layer, the flash kernel once per
    shared-attention site) and gemma3-1b (``lm_window``: 22 local layers on
    rings of 512 slots, the flash kernel in the 4 global layers, then the
    ring gate).  Returns the summed launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.ssd_chunk import ssd_chunk_plain
    from repro_torch.models import hybrid, lm, mamba

    qwen2q = get_config("qwen2-7b")
    qwen2 = dataclasses.replace(qwen2q, kv_quant=False)
    mamba2, zamba2 = get_config("mamba2-780m"), get_config("zamba2-1.2b")
    gemma3 = get_config("gemma3-1b")
    n_global = sum(gemma3.window_for_layer(i) == 0 for i in range(gemma3.n_layers))
    require(qwen2q.kv_quant, "qwen2-7b ships with kv_quant")

    def ssm_check(cfg):
        return {"served_tol": SSM_BF16_FACTOR * SSM_BF16_WITNESS[cfg.name], "f32_check": True}

    qwen2_params = build_params(torch, "lm", qwen2)
    paths = [
        ("lm", qwen2, lm, {"flash_attention": qwen2.n_layers}, {"flash": flash_plain},
         {"params": qwen2_params}),
        ("lm_kvq", qwen2q, lm, {"flash_attention": qwen2q.n_layers}, {"flash": flash_plain},
         {"params": qwen2_params, "gate": slot_gate(torch, "lm_kvq", qwen2q, "int8")}),
        ("ssm", mamba2, mamba, {"ssd_chunk": mamba2.n_layers}, {"ssd": ssd_chunk_plain},
         ssm_check(mamba2)),
        ("hybrid", zamba2, hybrid,
         {"ssd_chunk": zamba2.n_layers, "flash_attention": hybrid.n_sites(zamba2)},
         {"ssd": ssd_chunk_plain, "flash": flash_plain}, ssm_check(zamba2)),
        ("lm_window", gemma3, lm, {"flash_attention": n_global}, {"flash": flash_plain},
         {"gate": slot_gate(torch, "lm_window", gemma3, "rings")}),
    ]
    del qwen2_params
    total = {k: 0 for k in KERNELS}
    while paths:
        phase, cfg, mod, per_prefill, plain_routes, kw = paths.pop(0)
        for k, v in run_serve(torch, kernels_mod, phase, cfg, mod, per_prefill,
                              plain_routes, **kw).items():
            total[k] += v
        del kw
        torch.cuda.empty_cache()
    return total


def run_moe_paths(torch, kernels_mod):
    """grok-1 (``moe``, MoE every layer, 8 experts top-2) and
    llama4-maverick (``moe_shared``, a dense layer then an MoE layer of 128
    experts top-1 with a shared expert) at full width, cut to MOE_LAYERS,
    from int8 serve weights as shipped, through ``run_serve``: the flash
    kernel once per layer a prefill; each prefill check counts the routing
    choices that differ between the kernel and the plain run.  Returns the
    summed launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    total = {k: 0 for k in KERNELS}
    for phase, name in (("moe", "grok-1-314b"), ("moe_shared", "llama4-maverick-400b-a17b")):
        cfg = dataclasses.replace(get_config(name), n_layers=MOE_LAYERS[name])
        require(cfg.serve_weight_quant, f"{name} ships with int8 serve weights")
        params = build_params(torch, phase, cfg, quantize=True)
        with RouteLog() as routes:
            counts = run_serve(torch, kernels_mod, phase, cfg, lm,
                               {"flash_attention": cfg.n_layers}, {"flash": flash_plain},
                               params=params, routes=routes)
        for k, v in counts.items():
            total[k] += v
        del params
        torch.cuda.empty_cache()
    return total


def run_moe_forms(torch):
    """One grok-1 MoE layer at full width in bf16 on MOE_FORM_TOKENS tokens
    under each dispatch form, at a dropless capacity (capacity_factor =
    E / k, as the reference's einsum-vs-ragged test): the three outputs
    held against each other at BF16_TOL of their scale, the aux losses
    equal, each form's device ms (CUDA events)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.nn import moe

    cfg = get_config("grok-1-314b")
    spec = dataclasses.replace(lm._moe_spec(cfg), capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    gen = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    params = moe.init_moe(gen, spec, torch.bfloat16, "cuda")
    x = torch.randn((1, MOE_FORM_TOKENS, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    outs, rows = {}, {}
    for form in ("ragged", "einsum", "scatter"):
        sp = dataclasses.replace(spec, impl=form)
        y, aux = moe.moe(params, x, sp)
        torch.cuda.synchronize()
        require(y.shape == x.shape and y.dtype == torch.bfloat16
                and bool(torch.isfinite(y).all()), f"moe_forms/{form}: {y.shape} {y.dtype}")
        outs[form] = (y.float(), float(aux))
        rows[form] = {"ms": cuda_ms(torch, lambda sp=sp: moe.moe(params, x, sp), launches=3,
                                    repeats=3)}
    want, aux_want = outs["ragged"]
    scale = max(1.0, want.abs().max().item())
    for form, (y, aux) in outs.items():
        err = (y - want).abs().max().item()
        require(err <= BF16_TOL * scale, f"moe_forms: {form} vs ragged max|err| {err} > "
                f"{BF16_TOL} x {scale}")
        require(abs(aux - aux_want) <= 1e-5 * abs(aux_want), f"moe_forms: {form} aux {aux} "
                f"vs {aux_want}")
        rows[form].update(max_abs_err_vs_ragged=err, aux=aux)
    _, idx, _ = moe._route(params, x.reshape(-1, cfg.d_model), spec)
    emit({"phase": "moe_forms", "model": cfg.name, "tokens": MOE_FORM_TOKENS,
          "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
          "capacity_factor": spec.capacity_factor, "einsum_group": spec.group_size,
          "tolerance": BF16_TOL, "scale": scale, "forms": rows,
          "tokens_per_expert": torch.bincount(idx.reshape(-1), minlength=cfg.moe_experts)
          .tolist(), "max_memory_allocated": torch.cuda.max_memory_allocated()})


@contextlib.contextmanager
def attention_route(lm, impl):
    """``lm``'s attention spec with ``impl`` set while open."""
    spec_of = lm._attn_spec
    lm._attn_spec = lambda cfg: dataclasses.replace(spec_of(cfg), impl=impl)
    try:
        yield
    finally:
        lm._attn_spec = spec_of


def run_blockwise(torch, kernels_mod):
    """gemma3-1b at full width and depth, one BLOCKWISE_TOKENS-token prompt
    through ``get_api``'s prefill: its 22 local layers past dense_max² take
    the blockwise route (counted by a wrapper on ``_attend_blockwise``),
    its 4 global layers the flash kernel (launch counts set to 0 just
    before and read just after the bf16 run).  The same prefill with
    ``impl="dense"``, and both routes again on an f32 copy of the weights:
    the two routes held against each other at TOL in f32 (the same
    function), each bf16 route against the f32 dense logits at BF16_TOL,
    and the bf16 routes' gap printed (see BLOCKWISE_CHECK); each bf16
    route's peak memory, host ms and device ms by kind.  Returns the
    launch counts."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.models.registry import get_api
    from repro_torch.nn import attention

    cfg = get_config("gemma3-1b")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    toks = np.random.default_rng(2026).integers(0, cfg.vocab, (1, BLOCKWISE_TOKENS))
    n_local = sum(cfg.window_for_layer(i) > 0 for i in range(cfg.n_layers))
    routes = {"_attend_blockwise": 0, "_attend_dense": 0}
    originals = {name: getattr(attention, name) for name in routes}

    def counted(name):
        def fn(*args, **kwargs):
            routes[name] += 1
            return originals[name](*args, **kwargs)
        return fn

    def prefill(c=cfg, prm=params):
        state = api.make_serve_state(c, 1, BLOCKWISE_TOKENS)
        return api.prefill(prm, {"tokens": toks}, state, c)[0]

    for name in routes:
        setattr(attention, name, counted(name))
    try:
        prefill()                                      # warm, outside the counts
        torch.cuda.synchronize()
        out, peak, profiled, launches = {}, {}, {}, None
        for route, impl in (("blockwise", "auto"), ("dense", "dense")):
            with attention_route(lm, impl):
                routes.update({k: 0 for k in routes})
                reset_counts(kernels_mod)
                torch.cuda.reset_peak_memory_stats()
                out[route] = prefill()
                torch.cuda.synchronize()
                peak[route] = torch.cuda.max_memory_allocated()
                counts = read_counts(kernels_mod)
                want = {k: 0 for k in KERNELS}
                want["flash_attention"] = cfg.n_layers - n_local
                require(counts == want, f"blockwise/{route}: launches {counts} != {want}")
                require(routes[f"_attend_{route}"] == n_local and sum(routes.values()) == n_local,
                        f"blockwise/{route}: masked routes {routes}, want {n_local} {route}")
                launches = launches or counts
                profiled.update(profile_calls(torch, {route: prefill}))
        params32 = _cast(params, torch.float32)
        for route, impl in (("blockwise", "auto"), ("dense", "dense")):
            with attention_route(lm, impl):
                out[f"{route}_f32"] = prefill(cfg32, params32)
        del params32
    finally:
        for name, fn in originals.items():
            setattr(attention, name, fn)
    for key, logits in out.items():
        require(tuple(logits.shape) == (1, 1, cfg.vocab) and bool(torch.isfinite(logits).all()),
                f"blockwise/{key}: logits {tuple(logits.shape)}")

    def gap(a, b):
        scale = max(1.0, out[b].abs().max().item())
        err = (out[a] - out[b]).abs().max().item()
        return {"max_abs_err": err, "scale": scale, "share_of_scale": err / scale,
                "greedy_agrees": int(out[a].argmax()) == int(out[b].argmax())}

    gaps = {"blockwise_f32_vs_dense_f32": gap("blockwise_f32", "dense_f32"),
            "blockwise_vs_dense_f32": gap("blockwise", "dense_f32"),
            "dense_vs_dense_f32": gap("dense", "dense_f32"),
            "blockwise_vs_dense": gap("blockwise", "dense")}
    for name, tol in (("blockwise_f32_vs_dense_f32", TOL), ("blockwise_vs_dense_f32", BF16_TOL)):
        require(gaps[name]["share_of_scale"] <= tol,
                f"blockwise: {name} max|err| {gaps[name]['max_abs_err']} > {tol} x "
                f"{gaps[name]['scale']}")
    emit({"phase": "blockwise", "model": cfg.name, "prompt_tokens": BLOCKWISE_TOKENS,
          "local_layers_blockwise": n_local, "launches": launches, "gate": BLOCKWISE_CHECK,
          "gaps": gaps, "max_memory_allocated": peak, **profiled})
    del params
    torch.cuda.empty_cache()
    return launches


def _train_batch(cfg, rng, b, s):
    """A SyntheticLM-shaped batch for ``cfg``'s family (encdec: frames;
    vlm: patches ahead of s - n_patches text tokens)."""
    import numpy as np

    st = s - cfg.n_patches if cfg.family == "vlm" else s
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, st)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (b, st)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return batch


def train_flops(cfg, n_params: int, b: int, s: int) -> dict:
    """A step's model FLOPs: 6 x params x tokens (forward 2, backward 4),
    plus the attention's two products (q kᵀ and p v), 2 x 2 x Dh flops a
    (query, key) pair a head, forward and backward (x 3), over the pairs
    the mask keeps (causal; a local layer's window).  The recomputation
    of remat is not counted (model FLOPs).  The SSD scan's state
    products are not counted either."""
    pairs = 0
    if cfg.family == "lm":
        for i in range(cfg.n_layers):
            w = cfg.window_for_layer(i)
            pairs += sum(min(q + 1, w) if w else q + 1 for q in range(s))
    attn = 3 * 2 * 2 * cfg.head_dim * cfg.n_heads * b * pairs
    dense = 6 * n_params * b * s
    return {"dense_flops": dense, "attention_flops": attn, "model_flops": dense + attn}


def run_train(torch, kernels_mod, phase, arch):
    """``arch`` trained at full size on the card through
    ``launch.train.build_train_step``: ``api.init``'s random bf16 weights
    from a seeded CUDA generator, made trainable; AdamW as the config sets
    it (f32 moments) at lr TRAIN_LR; TRAIN_STEPS steps of SyntheticLM
    seed-0 batches of TRAIN_BATCH x TRAIN_SEQ tokens; remat as shipped.
    Gates: every param leaf gets a finite, not all-zero gradient in step 1
    (hooks on the leaves); no kernel launches in any step (the counts set
    to 0 before each step, read after); the mean loss of steps 6-8 below
    step 1's.  Prints step ms (host clock, each step ending in a
    synchronize; median of steps 2-8), tokens/s, peak memory, one more
    step under ``torch.profiler`` (device ms by kind; the busy share is
    their sum over the unprofiled median step, since the profiler
    stretches the profiled step's wall) and the model-FLOP share of the
    bf16 dense peak."""
    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.core.hw import H100_SXM
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt

    cfg = get_config(arch)
    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = train.trainable(api.init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    leaves = tree.leaves(params)
    n_params = sum(p.numel() for p in leaves)
    adam = train.adam_config_for(cfg, lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                                 warmup_steps=max(1, TRAIN_STEPS // 20))
    opt_state = opt.init(adam, params)
    step = train.build_train_step(cfg, adam)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)

    seen = [[] for _ in leaves]                  # step 1: (finite, nonzero) per grad
    handles = [p.register_hook(lambda g, i=i: seen[i].append(
        torch.stack([g.isfinite().all(), g.ne(0).any()]))) for i, p in enumerate(leaves)]
    losses, ms, launches = [], [], []
    for i in range(TRAIN_STEPS):
        batch = next(data)
        reset_counts(kernels_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(read_counts(kernels_mod))
        losses.append(loss)
        if i == 0:
            for h in handles:
                h.remove()
            flags = [torch.stack(f).all(0).tolist() if f else [False, False] for f in seen]
            bad = [j for j, (finite, nonzero) in enumerate(flags) if not (finite and nonzero)]
            require(not bad, f"{phase}: {len(bad)} of {len(leaves)} param leaves got no "
                             f"finite nonzero gradient in step 1 (leaves {bad[:8]})")
            grad_calls = sum(len(f) for f in seen)
    peak = torch.cuda.max_memory_allocated()
    require(all(not any(c.values()) for c in launches),
            f"{phase}: kernels launched in a train step: {launches}")
    require(all(map(math.isfinite, losses)), f"{phase}: losses {losses}")
    late = statistics.mean(losses[5:8])
    require(late < losses[0], f"{phase}: mean loss of steps 6-8 {late} not below "
                              f"step 1's {losses[0]}")

    batch = next(data)
    reset_counts(kernels_mod)
    box = {}

    def one_step():
        box["out"] = step(params, opt_state, batch)

    device_ms, wall, top = device_ms_by_kernel(torch, one_step, SERVE_DEVICE_FN)
    require(not any(read_counts(kernels_mod).values()), f"{phase}: kernels in the profiled step")
    del box
    step_ms = statistics.median(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    emit({"phase": phase, "model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "params": n_params, "param_dtype": cfg.param_dtype,
          "moments": [adam.mu_dtype, adam.nu_dtype], "grad_accum": cfg.grad_accum,
          "remat": cfg.remat, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "lr": TRAIN_LR,
          "data": "SyntheticLM seed 0", "losses": losses, "step_ms": ms,
          "step_ms_median_2_8": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
          "peak_gb": peak / 1e9, "kernel_launches": launches[0],
          "step1_grad_hook_calls": grad_calls, "step1_leaves": len(leaves),
          "profiled_step": {"wall_ms": wall, "device_ms": device_ms,
                            "device_busy_share": sum(device_ms.values()) / step_ms,
                            "device_busy_share_of": "step_ms_median_2_8 (unprofiled)",
                            "device_share_of_profiled_wall": sum(device_ms.values()) / wall,
                            "top_device_fns": [(t, n, k[:90]) for t, n, k in top[:6]]},
          **flops,
          "model_flop_share": flops["model_flops"] / (step_ms / 1e3) / H100_SXM.peak_bf16_flops,
          "model_flop_share_of": "the bf16 dense peak, 989 TFLOP/s (core/hw.py "
                                 "H100_SXM.peak_bf16_flops)"})
    del params, opt_state, step
    torch.cuda.empty_cache()


def run_train_gates(torch, kernels_mod):
    """The reduced-size gates of the training path (TRAIN_SMALL, seq
    TRAIN_SMALL_SEQ, f32, TF32 off): (1) for each of TRAIN_PARITY_ARCHS,
    ``loss_fn`` and its grads on the card against the same step on the
    CPU, the same weights and batch: the loss and every gradient leaf
    within TOL of its scale; (2) the card's bf16 head under autograd
    (``nn.embeddings._WideLogits``) against the f32 products of the same
    bf16 values, within one bf16 rounding of scale; (3) resume:
    ``train_loop`` stopped after the step-4 checkpoint and started again
    gives the uninterrupted run's losses of steps 5-8 within RESUME_TOL
    relative; (4) the kernel guard: a flash call on the card with q
    requiring grad raises."""
    import tempfile

    import numpy as np

    from repro_torch import tree
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import train
    from repro_torch.models.registry import get_api
    from repro_torch.nn.embeddings import unembed

    rows = []
    for arch in TRAIN_PARITY_ARCHS:
        cfg = reduced(get_config(arch), **TRAIN_SMALL)
        cpu = get_api(cfg, "cpu").init(cfg, torch.Generator().manual_seed(1))
        batch = _train_batch(cfg, np.random.default_rng(3), TRAIN_BATCH, TRAIN_SMALL_SEQ)
        out = {}
        for dev in ("cpu", "cuda"):
            params = train.trainable(tree.unflatten(
                cpu, [p.detach().clone().to(dev) for p in tree.leaves(cpu)]))
            reset_counts(kernels_mod)
            loss, _ = get_api(cfg, dev).loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, tree.leaves(params), materialize_grads=True)
            require(not any(read_counts(kernels_mod).values()),
                    f"train_gates/{arch}: a kernel launched under autograd")
            out[dev] = (loss.detach().cpu(), [g.cpu() for g in grads])
        loss_err = abs(float(out["cuda"][0]) - float(out["cpu"][0])) / abs(float(out["cpu"][0]))
        worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                    for a, b in zip(out["cuda"][1], out["cpu"][1]))
        require(loss_err <= TOL and worst <= TOL,
                f"train_gates/{arch}: card vs CPU loss {loss_err}, worst grad leaf "
                f"{worst} of its scale (> {TOL})")
        rows.append({"arch": arch, "family": cfg.family, "loss": float(out["cpu"][0]),
                     "loss_rel_err": loss_err, "worst_grad_err_of_scale": worst,
                     "leaves": len(out["cpu"][1])})

    # the bf16 head under autograd against f32 products of the same values
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((256, 1152), generator=gen, device="cuda").bfloat16().requires_grad_(True)
    table = (0.02 * torch.randn((4096, 1152), generator=gen, device="cuda")).bfloat16()
    table.requires_grad_(True)
    g_out = torch.randn((256, 4096), generator=gen, device="cuda")
    got = torch.autograd.grad(unembed(table, x), [x, table], g_out)
    want_logits = x.detach().float() @ table.detach().float().t()
    want = (g_out @ table.detach().float(), g_out.t() @ x.detach().float())
    head_errs = [(a.float() - b).abs().max().item() / b.abs().max().item()
                 for a, b in zip(got, want)]
    logits_err = (unembed(table, x).detach() - want_logits).abs().max().item()
    require(max(head_errs) <= 2.0 ** -8 and logits_err <= TOL * want_logits.abs().max().item(),
            f"train_gates: bf16 head grads {head_errs} of scale, logits {logits_err}")

    # resume at the reduced size on the card
    cfg = reduced(get_config("gemma3-1b"), **TRAIN_SMALL)
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq_len=TRAIN_SMALL_SEQ, lr=TRAIN_LR,
              ckpt_every=4, log_every=TRAIN_STEPS, device="cuda")

    class Preempted(Exception):
        pass

    def stop(step, metrics):
        if step == 5:
            raise Preempted

    with tempfile.TemporaryDirectory() as tmp:
        straight = train.train_loop(cfg, ckpt_dir=f"{tmp}/a", **kw)["losses"]
        try:
            train.train_loop(cfg, ckpt_dir=f"{tmp}/b", on_metrics=stop, **kw)
            require(False, "train_gates: the preempting callback did not stop the loop")
        except Preempted:
            pass
        resumed = train.train_loop(cfg, ckpt_dir=f"{tmp}/b", **kw)["losses"]
    resume_err = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[4:]))
    require(len(resumed) == 4 and resume_err <= RESUME_TOL,
            f"train_gates: resumed losses {resumed} vs {straight[4:]}")

    # the guard on the card
    q = torch.randn((1, 2, 64, 64), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn((1, 1, 64, 64), device="cuda", dtype=torch.bfloat16)
    reset_counts(kernels_mod)
    try:
        flash_attention(q, kv, kv, block_q=64, block_k=64)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    require(raised is not None and "no backward" in raised and not any(
        read_counts(kernels_mod).values()), f"train_gates: flash under autograd: {raised}")
    emit({"phase": "train_gates", "size": {**TRAIN_SMALL, "seq_len": TRAIN_SMALL_SEQ,
                                           "dtype": "float32", "tf32": False},
          "card_vs_cpu": rows, "tolerance": TOL,
          "tolerance_of": "loss: relative; grads: each leaf's max|card - cpu| over its max|cpu|",
          "bf16_head_grad_err_of_scale": head_errs, "bf16_head_tolerance": 2.0 ** -8,
          "resume": {"straight_5_8": straight[4:], "resumed_5_8": resumed,
                     "max_rel_err": resume_err, "tolerance": RESUME_TOL},
          "guard": raised})


def run_paged_kv(torch):
    """The paged KV cache (``serving/kv_cache.py``) on the card at
    qwen2-7b's widths: one sequence of PAGED_KV_TOKENS tokens allocated,
    written token by token (two sequences interleaved, so that their
    blocks interleave in the pool), gathered and held bit for bit against
    the written values, then freed."""
    from repro_torch.serving.kv_cache import PagedKVCache, PagedKVConfig

    cache = PagedKVCache(PagedKVConfig(**PAGED_KV), device="cuda")
    cfg = cache.cfg
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (PAGED_KV_TOKENS, cfg.n_layers, cfg.n_kv, cfg.head_dim)
    written = {s: [torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in "kv"]
               for s in (1, 2)}
    for s in (1, 2):
        cache.allocate(s, 1)
    for pos in range(PAGED_KV_TOKENS):
        for s in (1, 2):
            if pos:
                cache.extend(s, 1)
            cache.write_token(s, (written[s][0][pos], written[s][1][pos]), pos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    k, v = cache.gather_kv(1)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3
    for s in (1, 2):
        k, v = cache.gather_kv(s)
        require(torch.equal(k, written[s][0].transpose(0, 1))
                and torch.equal(v, written[s][1].transpose(0, 1)),
                f"paged_kv: sequence {s}'s gather differs from its writes")
    blocks = cache.blocks_needed(PAGED_KV_TOKENS)
    tables = [cache.table(1), cache.table(2)]
    require(cache.free_blocks == cfg.n_blocks - 2 * blocks and not set(tables[0]) & set(tables[1]),
            f"paged_kv: tables {tables}, {cache.free_blocks} free")
    cache.free(1)
    cache.free(2)
    require(cache.free_blocks == cfg.n_blocks, "paged_kv: blocks leaked")
    emit({"phase": "paged_kv", **PAGED_KV, "dtype": cfg.dtype, "tokens": PAGED_KV_TOKENS,
          "sequences": 2, "blocks_each": blocks, "tables": tables,
          "pool_bytes": 2 * cache.k.numel() * cache.k.element_size(),
          "gather_ms_host": gather_ms, "gather": "bit for bit the written values"})


def run_ranks(world, fn) -> list:
    """``fn(rank, world)`` on ``world`` spawned processes through the
    multi-rank tests' harness (``tests/torch_ranks.py``): every rank on
    cuda:0 in one gloo process group over a FileStore in a temporary
    directory; the ranks' results in rank order.  A rank that raises makes
    this raise with its traceback.  The kernel library must be built before
    (``_build.library`` in this process): the ranks load it and build
    nothing."""
    import tempfile

    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_ranks

    with tempfile.TemporaryDirectory() as tmp:
        return torch_ranks.result(
            torch_ranks.run_ranks(world, {"phase": fn}, tmp, device="cuda"), "phase")


def worst_of_limit(torch, got, want, tol) -> float:
    """The largest |got - want| / (rtol x |want| + atol + rms x rms(want))
    of ``tol = (rtol, atol, rms)``, the kernels phase's elementwise gate;
    <= 1 passes."""
    rtol, atol, rms = tol
    want = want.float()
    limit = rtol * want.abs() + atol + rms * want.square().mean().sqrt()
    return ((got.float() - want).abs() / limit).max().item()


def _mesh_ssd_inputs(torch, dtype):
    """mamba2-780m's SSD operands at MESH_TOKENS tokens, drawn as
    ``bench_ssd`` draws them, the same on every rank (one seed)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(11)
    h, p, g, n = (MESH_SSD[k] for k in "hpgn")

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    u = torch.rand((h,), generator=gen, device="cuda") * (math.log(0.1) - math.log(0.001))
    dt0 = torch.exp(u + math.log(0.001))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    x, bb, cc = (F.silu(draw(1, MESH_TOKENS, *s)) for s in ((h, p), (g, n), (g, n)))
    dt = F.softplus(draw(1, MESH_TOKENS, h) + dt_bias)
    a = -torch.arange(1, h + 1, dtype=torch.float32, device="cuda")
    return tuple(t.to(dtype) for t in (x, dt, bb, cc)), a


def _mesh_ssd_rank(rank, world):
    """One rank of ``mesh_ssd``: ``ssd_seq_parallel`` on the (1, K) mesh,
    in f32 and with bf16 operands; its ssd_chunk launches, and y and the
    final state against one ``ssd_chunk`` over the whole sequence and
    against ``ssd_chunk_plain``."""
    import torch

    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.nn.ssm import ssd_seq_parallel

    mesh = make_local_mesh(world)
    chunk = MESH_SSD["chunk"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        (x, dt, bb, cc), a = _mesh_ssd_inputs(torch, dtype)

        def run():
            return ssd_seq_parallel(x, dt, a, bb, cc, chunk=chunk, mesh=mesh)

        sc.ssd_chunk.launches = 0
        y, s = run()
        torch.cuda.synchronize()
        launches = sc.ssd_chunk.launches
        whole_y, whole_s = sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk)
        plain_y, plain_s = sc.ssd_chunk_plain(x, dt, a, bb, cc, chunk=chunk)
        tol = SSD_BF16_TOL if dtype == torch.bfloat16 else SSD_TOL
        errs = {"y_vs_kernel": worst_of_limit(torch, y, whole_y, tol),
                "state_vs_kernel": worst_of_limit(torch, s, whole_s, SSD_TOL),
                "y_vs_plain": worst_of_limit(torch, y, plain_y, tol),
                "state_vs_plain": worst_of_limit(torch, s, plain_s, SSD_TOL),
                "y_max_abs_err_vs_kernel": (y.float() - whole_y.float()).abs().max().item()}
        finite = bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
        ms = cuda_ms(torch, run, launches=3, repeats=3)
        whole_ms = cuda_ms(torch, lambda: sc.ssd_chunk(x, dt, a, bb, cc, chunk=chunk),
                           launches=3, repeats=3)
        out[str(dtype).removeprefix("torch.")] = {
            "launches": launches, "finite": finite, "worst_of_limit": errs,
            "ms": ms, "whole_sequence_kernel_ms": whole_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    return out


def run_mesh_ssd(torch):
    """``mesh_ssd``: ``ssd_seq_parallel`` at mamba2-780m's widths on
    MESH_TOKENS tokens, K in MESH_WORLDS ranks.  Gates, on every rank, in
    f32 and with bf16 operands: one ssd_chunk launch; y and the final
    state against one ``ssd_chunk`` over the whole sequence and against
    ``ssd_chunk_plain``, at SSD_TOL (f32) and SSD_BF16_TOL (bf16 y), the
    kernels phase's gates.  Returns the launches each rank's call made, by
    K and dtype."""
    launches = {}
    for world in MESH_WORLDS:
        ranks = run_ranks(world, _mesh_ssd_rank)
        for dtype in ("float32", "bfloat16"):
            rows = [r[dtype] for r in ranks]
            launches[f"K={world}/{dtype}"] = [r["launches"] for r in rows]
            for rank, row in enumerate(rows):
                require(row["launches"] == 1 and row["finite"],
                        f"mesh_ssd K={world} {dtype} rank {rank}: {row['launches']} "
                        f"ssd_chunk launches (want 1), finite {row['finite']}")
                worst = max(row["worst_of_limit"][k] for k in
                            ("y_vs_kernel", "state_vs_kernel", "y_vs_plain", "state_vs_plain"))
                require(worst <= 1.0, f"mesh_ssd K={world} {dtype} rank {rank}: "
                                      f"{row['worst_of_limit']}")
            emit({"phase": "mesh_ssd", "ranks": world, "mesh": [1, world], "dtype": dtype,
                  "tokens": MESH_TOKENS, **MESH_SSD, "device": "cuda:0 (every rank)",
                  "backend": "gloo", "launches_per_rank": [r["launches"] for r in rows],
                  "worst_of_limit": [r["worst_of_limit"] for r in rows],
                  "tolerance": SSD_BF16_TOL if dtype == "bfloat16" else SSD_TOL,
                  "ms_per_rank": [r["ms"] for r in rows],
                  "peak_gb_per_rank": [r["peak_gb"] for r in rows],
                  "whole_sequence_kernel_ms": rows[0]["whole_sequence_kernel_ms"],
                  "note": f"{world} ranks share one card's SMs: a time here says "
                          f"nothing about {world} cards"})
    return launches


def _mesh_prefill_rank(rank, world):
    """One rank of ``mesh_prefill``: mamba2-780m's prefill of one
    MESH_TOKENS-token prompt on the (1, K) mesh and in one process, bf16
    weights and an f32 copy; launches, logits, host and device ms."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api

    cfg = get_config("mamba2-780m")
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = _cast(params, torch.float32)
    toks = torch.as_tensor(np.random.default_rng(2026).integers(0, cfg.vocab, MESH_TOKENS),
                           dtype=torch.long, device="cuda")[None]
    mesh = make_local_mesh(world)
    out = {}
    for name, c, prm in (("bf16", cfg, params), ("f32", cfg32, params32)):
        for where in ("one_process", "mesh"):
            ctx = mesh if where == "mesh" else contextlib.nullcontext()
            host, dev = [], []
            for i in range(3):                      # warm, then two timed
                state = api.make_serve_state(c, 1, MESH_TOKENS)
                sc.ssd_chunk.launches = 0
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                with ctx:
                    logits, _ = api.prefill(prm, {"tokens": toks}, state, c)
                end.record()
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
                dev.append(start.elapsed_time(end))
            out[(name, where)] = {"logits": logits.float().cpu(),
                                  "launches": sc.ssd_chunk.launches,
                                  "host_ms": statistics.median(host[1:]),
                                  "device_ms": statistics.median(dev[1:])}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def run_mesh_prefill(torch):
    """``mesh_prefill``: mamba2-780m at full size (bf16 weights from a
    seeded CUDA generator), one MESH_TOKENS-token prompt, prefilled
    through ``ssm_forward`` on a (1, 2) mesh: every layer's scan on
    ``ssd_seq_parallel``.  Gates, on each rank: 48 ssd_chunk launches a
    prefill; the logits on an f32 copy of the weights against the
    one-process prefill at TOL of their scale, and the bf16 logits within
    the ssm phase's served tolerance (SSM_CHECK).  Prints each rank's host
    and device ms beside the one-process prefill's.  Returns each rank's
    launches a prefill on the mesh, by the weights' dtype."""
    from repro_torch.configs.registry import get_config

    world = 2
    ranks = run_ranks(world, _mesh_prefill_rank)
    n_layers = get_config("mamba2-780m").n_layers
    tol = {"f32": TOL, "bf16": SSM_BF16_FACTOR * SSM_BF16_WITNESS["mamba2-780m"]}
    rows = []
    for rank, out in enumerate(ranks):
        row = {"rank": rank}
        for name in ("bf16", "f32"):
            mesh, one = out[(name, "mesh")], out[(name, "one_process")]
            require(mesh["launches"] == n_layers and one["launches"] == n_layers,
                    f"mesh_prefill rank {rank} {name}: ssd_chunk launches "
                    f"{mesh['launches']} on the mesh, {one['launches']} in one process")
            got, want = mesh["logits"], one["logits"]
            require(tuple(got.shape) == (1, 1, 50280) and bool(got.isfinite().all()),
                    f"mesh_prefill rank {rank} {name}: logits {tuple(got.shape)}")
            scale = max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            require(err <= tol[name] * scale, f"mesh_prefill rank {rank} {name}: logits vs "
                    f"one process max|err| {err} > {tol[name]} x {scale}")
            row[name] = {"ssd_launches": mesh["launches"], "logits_max_abs_err": err,
                         "logits_scale": scale, "tolerance": tol[name],
                         "greedy_agrees": int(got.argmax()) == int(want.argmax()),
                         "host_ms": mesh["host_ms"], "device_ms": mesh["device_ms"],
                         "one_process_host_ms": one["host_ms"],
                         "one_process_device_ms": one["device_ms"]}
        row["peak_gb"] = out["peak_gb"]
        rows.append(row)
    emit({"phase": "mesh_prefill", "model": "mamba2-780m", "tokens": MESH_TOKENS,
          "mesh": [1, world], "backend": "gloo", "device": "cuda:0 (every rank)",
          "gate": SSM_CHECK, "ranks": rows,
          "note": f"{world} ranks share one card's SMs: a time here says nothing about "
                  f"{world} cards"})
    return {name: [out[(name, "mesh")]["launches"] for out in ranks]
            for name in ("bf16", "f32")}


def _mesh_psum_rank(rank, world, *, shape):
    """One rank of ``mesh_collectives``: MESH_PSUM_STEPS steps of
    ``compressed_psum`` on a CUDA grad, each held bit for bit against the
    same call on CPU copies of the payload (the same group)."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import compressed_psum

    g = torch.randn(shape, generator=torch.Generator(device="cuda").manual_seed(100 + rank),
                    device="cuda")
    true_mean = g.clone()
    dist.all_reduce(true_mean)
    true_mean /= world
    res, acc, exact = torch.zeros_like(g), torch.zeros_like(g), True
    times = []
    for _ in range(MESH_PSUM_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, new_res = compressed_psum(g, res)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        mean_c, res_c = compressed_psum(g.cpu(), res.cpu())
        exact &= torch.equal(mean.cpu(), mean_c) and torch.equal(new_res.cpu(), res_c)
        res = new_res
        acc += mean / MESH_PSUM_STEPS
    return {"bit_for_bit_cpu": exact,
            "last_err": (mean - true_mean).abs().max().item(),
            "mean_err": (acc - true_mean).abs().max().item(),
            "host_ms_median": statistics.median(times)}


def run_mesh_collectives(torch):
    """``mesh_collectives``: ``compressed_psum`` on 4 ranks with CUDA
    grads of gemma3-1b's wq shape [1152, 1024]: every step's mean and
    residual bit for bit the rank's CPU recomputation (the int8 divisor
    stays exact on the card), and error feedback within
    MESH_PSUM_BOUNDS of the true mean."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("gemma3-1b")
    shape = (cfg.d_model, cfg.n_heads * cfg.head_dim)
    world = 4
    ranks = run_ranks(world, functools.partial(_mesh_psum_rank, shape=shape))
    for rank, r in enumerate(ranks):
        require(r["bit_for_bit_cpu"], f"mesh_collectives rank {rank}: the card's int8 "
                                      "payload or residual differs from the CPU's")
        require(r["last_err"] < MESH_PSUM_BOUNDS[0] and r["mean_err"] < MESH_PSUM_BOUNDS[1],
                f"mesh_collectives rank {rank}: errors {r['last_err']}, {r['mean_err']} "
                f"past {MESH_PSUM_BOUNDS}")
    emit({"phase": "mesh_collectives", "ranks": world, "backend": "gloo",
          "device": "cuda:0 (every rank)", "shape": list(shape), "of": "gemma3-1b wq",
          "steps": MESH_PSUM_STEPS, "bounds": MESH_PSUM_BOUNDS,
          "per_rank": ranks, "check": "mean and residual bit for bit the CPU's, every step"})


def _pipeline_stages(torch, world):
    """qwen2-7b's config and MESH_PIPE_LAYERS x ``world`` of its layers at
    full width in bf16, drawn on the card from one seed (the same on every
    rank), stacked ``[S, L/S, ...]`` by ``stack_stage_params`` on
    ``plan_stages_for_layers``'s uniform plan.  The vocabulary is cut to
    256: the stages run layers only, and the embedding is no stage's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.pipeline_parallel import (plan_stages_for_layers,
                                                           stack_stage_params)
    from repro_torch.models import lm
    from repro_torch.tree import leaves, unflatten

    n = MESH_PIPE_LAYERS * world
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=n, vocab=256)
    blocks = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")["blocks"]
    stacked = unflatten(blocks[0], [torch.stack(ts) for ts in zip(*map(leaves, blocks))])
    del blocks
    staged = stack_stage_params(stacked, plan_stages_for_layers([1.0] * n, world))
    del stacked
    torch.cuda.empty_cache()
    return cfg, staged


def _mesh_pipeline_rank(rank, world):
    """One rank of ``mesh_pipeline``: ``pipeline_forward`` over the stage
    axis of a (K,) mesh of gloo ranks on cuda:0, its ``block_fn`` one
    stage's qwen2-7b layers through ``lm._block`` (causal from position 0:
    the flash kernel once a layer a tick); a warm-up run, then a timed run
    with the flash launches counted and each ring shift timed between two
    syncs; then the same ``block_fn`` stage after stage over the same
    microbatches in this process (rank 0 timed while the others wait).
    Returns launches, the largest difference, the routes and the times."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import pipeline_parallel as pp
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm
    from repro_torch.tree import leaves, unflatten

    cfg, staged = _pipeline_stages(torch, world)
    mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("stage",))
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((MESH_PIPE_MICRO, 1, MESH_PIPE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)

    def block_fn(ps, h):
        for i in range(MESH_PIPE_LAYERS):
            h, _, _ = lm._block(unflatten(ps, [t[i] for t in leaves(ps)]), h, None, cfg)
        return h

    ring_shift, shifts = pp._ring_shift, []

    def timed_shift(y, nxt, prv, group, route, host):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ring_shift(y, nxt, prv, group, route, host)
        torch.cuda.synchronize()
        shifts.append((route, time.perf_counter() - t0))
        return out

    with torch.no_grad():
        pp.pipeline_forward(block_fn, staged, x, mesh)          # warm-up
        pp._ring_shift = timed_shift
        try:
            fa.flash_attention.launches = 0
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            got = pp.pipeline_forward(block_fn, staged, x, mesh)
            torch.cuda.synchronize()
            ring_s = time.perf_counter() - t0
            launches = fa.flash_attention.launches
        finally:
            pp._ring_shift = ring_shift

        def one_process():
            outs = []
            for m in range(MESH_PIPE_MICRO):
                h = x[m]
                for s in range(world):
                    h = block_fn(unflatten(staged, [t[s] for t in leaves(staged)]), h)
                outs.append(h)
            return torch.stack(outs)

        one_s = None
        for turn in (0, 1):                   # rank 0 alone, then the others
            if (rank == 0) == (turn == 0):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                want = one_process()
                torch.cuda.synchronize()
                one_s = time.perf_counter() - t0
            dist.barrier()
    ticks = MESH_PIPE_MICRO + world - 1
    diff = (got.float() - want.float()).abs()
    return {"launches": launches, "ticks": ticks, "routes": sorted({r for r, _ in shifts}),
            "shifts": len(shifts), "max_abs_err": diff.max().item(),
            "bit_equal": torch.equal(got, want), "scale": want.float().abs().max().item(),
            "finite": bool(torch.isfinite(got).all()), "shape": list(got.shape),
            "ring_ms_per_tick": ring_s * 1e3 / ticks,
            "shift_ms_per_tick": sum(t for _, t in shifts) * 1e3 / ticks,
            "shift_share": sum(t for _, t in shifts) / ring_s,
            "one_process_ms_per_stage_call": one_s * 1e3 / (MESH_PIPE_MICRO * world),
            "ring_ms": ring_s * 1e3, "one_process_ms": one_s * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def run_mesh_pipeline(torch, smi):
    """``mesh_pipeline``: the ring pipeline (``pipeline_forward``) on K in
    MESH_WORLDS gloo ranks on cuda:0, one stage a rank, MESH_PIPE_LAYERS
    qwen2-7b layers a stage at full width in bf16, MESH_PIPE_MICRO
    microbatches of 1 x MESH_PIPE_TOKENS tokens.  The ranks share the card
    under gloo, so every tick's shift takes the host route
    (``pipeline_parallel.shift_route``).  Gates, on every rank: the host
    route on every shift; flash launches == layers a stage x ticks; the
    ring's output finite and within BF16_TOL of its scale of the same
    ``block_fn`` run stage after stage in one process (expected bit-equal:
    the same ops at the same shapes on the same card).  Prints host ms a
    tick beside one process's ms a stage call, and the shift's share of
    the ring's time.  Returns each rank's flash launches by K."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()          # the ranks draw 4-8 GB each beside this process
    launches = {}
    for world in MESH_WORLDS:
        ranks = run_ranks(world, _mesh_pipeline_rank)
        for rank, r in enumerate(ranks):
            want = MESH_PIPE_LAYERS * r["ticks"]
            require(r["routes"] == ["host"] and r["shifts"] == r["ticks"],
                    f"mesh_pipeline K={world} rank {rank}: shifts {r['shifts']} by "
                    f"{r['routes']} (want {r['ticks']} by the host route)")
            require(r["launches"] == want, f"mesh_pipeline K={world} rank {rank}: "
                    f"{r['launches']} flash launches (want {want})")
            limit = BF16_TOL * max(1.0, r["scale"])
            require(r["finite"] and r["max_abs_err"] <= limit,
                    f"mesh_pipeline K={world} rank {rank}: max|ring - one process| "
                    f"{r['max_abs_err']} > {limit} (finite {r['finite']})")
        launches[f"K={world}"] = [r["launches"] for r in ranks]
        emit({"phase": "mesh_pipeline", "ran": True, "ranks": world, "mesh": [world],
              "backend": "gloo", "device": "cuda:0 (every rank)", "model": "qwen2-7b",
              "layers_per_stage": MESH_PIPE_LAYERS, "microbatches": MESH_PIPE_MICRO,
              "microbatch_shape": [1, MESH_PIPE_TOKENS, ranks[0]["shape"][-1]],
              "dtype": "bfloat16", "shift_route": ranks[0]["routes"],
              "ticks": ranks[0]["ticks"], "flash_launches_per_rank": launches[f"K={world}"],
              "max_abs_err_per_rank": [r["max_abs_err"] for r in ranks],
              "bit_equal_per_rank": [r["bit_equal"] for r in ranks],
              "scale": ranks[0]["scale"], "tolerance": BF16_TOL,
              "gate": "max|ring - one process| <= tolerance x max(1, max|one process|)",
              "ring_ms_per_tick_per_rank": [r["ring_ms_per_tick"] for r in ranks],
              "shift_ms_per_tick_per_rank": [r["shift_ms_per_tick"] for r in ranks],
              "shift_share_per_rank": [r["shift_share"] for r in ranks],
              "one_process_ms_per_stage_call": ranks[0]["one_process_ms_per_stage_call"],
              "ring_ms_per_rank": [r["ring_ms"] for r in ranks],
              "one_process_ms": ranks[0]["one_process_ms"],
              "peak_gb_per_rank": [r["peak_gb"] for r in ranks], "card": smi,
              "note": f"host clock; {world} ranks share one card's SMs and its host "
                      f"link: a time here says nothing about {world} cards"})
    return launches


def run_examples(torch, smi):
    """``examples``: each of the port's entry points run as ``python
    examples/<name>_torch.py`` in a subprocess on the card (its default
    device), in a temporary working directory, EXAMPLE_WORKERS at a time
    (each run is mostly a fresh interpreter's imports and the card's
    context); train_lm_torch.py for EXAMPLE_TRAIN_STEPS steps with a
    checkpoint every other step among them, then, once it is done, again
    to twice as many, resuming.  Gates: exit code 0 from each, and the
    second training run resumes.  Prints each run's wall seconds and last
    line, and the phase's."""
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src")] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    torch.cuda.empty_cache()
    rows, lock = [], threading.Lock()
    with tempfile.TemporaryDirectory() as tmp:

        def run(name, extra):
            cmd = [sys.executable, os.path.join(root, "examples", f"{name}_torch.py"), *extra]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp, env=env,
                                 timeout=EXAMPLE_TIMEOUT)
            wall = time.perf_counter() - t0
            lines = out.stdout.strip().splitlines()
            row = {"script": f"examples/{name}_torch.py",
                   "args": [a.replace(tmp, "<tmp>") for a in extra],
                   "returncode": out.returncode, "wall_s": wall,
                   "last_line": lines[-1] if lines else ""}
            with lock:
                emit({"phase": "examples_run", **row})
                rows.append(row)
            require(out.returncode == 0, f"examples: {name}_torch.py {extra} exited "
                    f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
            return out.stdout

        train = ["--ckpt", os.path.join(tmp, "ckpt"), "--ckpt-every", "2",
                 "--log", os.path.join(tmp, "loss.json")]
        runs = [(name, []) for name in EXAMPLES if name != "train_lm"]
        runs.append(("train_lm", ["--steps", str(EXAMPLE_TRAIN_STEPS)] + train))
        t0 = time.perf_counter()
        with ThreadPoolExecutor(EXAMPLE_WORKERS) as pool:
            for done in [pool.submit(run, *r) for r in runs]:
                done.result()
        again = run("train_lm", ["--steps", str(2 * EXAMPLE_TRAIN_STEPS)] + train)
        phase_s = time.perf_counter() - t0
        resumed = f"[train] resumed from step {EXAMPLE_TRAIN_STEPS}"
        require(resumed in again, f"examples: the second train_lm_torch.py run did "
                f"not resume:\n{again[-2000:]}")
    emit({"phase": "examples", "device": "cuda (each script's default)",
          "wall_s": {f"{r['script']} {' '.join(r['args'])}".strip(): r["wall_s"] for r in rows},
          "phase_wall_s": phase_s, "workers": EXAMPLE_WORKERS, "card": smi,
          "note": f"wall seconds of the whole subprocess, interpreter start, imports and "
                  f"the card's context included, {EXAMPLE_WORKERS} runs at a time on one "
                  f"card and one host"})


@contextlib.contextmanager
def one_nccl_rank():
    """A world of one NCCL rank, this process, over a FileStore in a
    temporary directory; destroyed on exit."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def run_mesh_train(torch, kernels_mod):
    """``mesh_train``: a world of one NCCL rank on a (1, 1) mesh; gemma3-1b
    at full width, MESH_TRAIN_LAYERS of its 26 layers (bf16 params, f32
    AdamW moments), MESH_TRAIN_STEPS steps of SyntheticLM seed-0 batches of
    TRAIN_BATCH x TRAIN_SEQ tokens through ``build_train_step`` on DTensor
    params, state and batch, against the unsharded step on the same weights
    and batches.  Gates: every param and state leaf a DTensor after each
    step; no kernel launch; each loss within MESH_TRAIN_TOL relative of the
    unsharded step's.  Prints both steps' host ms (DTensor's dispatch
    cost)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt

    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=MESH_TRAIN_LAYERS)
    api = get_api(cfg)
    adam = train.adam_config_for(cfg, lr=TRAIN_LR, total_steps=MESH_TRAIN_STEPS,
                                 warmup_steps=1)
    params = api.init(cfg, torch.Generator(device="cuda").manual_seed(0))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [next(data) for _ in range(MESH_TRAIN_STEPS)]
    with one_nccl_rank():
        mesh = make_local_mesh()
        pshard = shd.params_shardings(params, mesh)
        sharded = train.trainable(shd.shard_tree(params, pshard))
        plain = train.trainable(tree.unflatten(params, [p.clone() for p in tree.leaves(params)]))
        del params
        state_plain = opt.init(adam, plain)
        state_sh = shd.shard_tree(opt.init(adam, plain),
                                  shd.opt_state_shardings(state_plain, plain, mesh))
        step_plain = train.build_train_step(cfg, adam)
        step_sh = train.build_train_step(cfg, adam, grad_shardings=pshard)
        rows = []
        for i, batch in enumerate(batches):
            row = {"step": i + 1}
            for name, fn, ctx in (("unsharded", lambda: step_plain(plain, state_plain, batch),
                                   contextlib.nullcontext()),
                                  ("sharded", lambda: step_sh(
                                      sharded, state_sh, shd.shard_tree(
                                          batch, shd.batch_specs(batch, mesh))), mesh)):
                reset_counts(kernels_mod)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx:
                    _, st, metrics = fn()
                loss = metrics["loss"]
                loss = float(loss.full_tensor() if isinstance(loss, DTensor) else loss)
                torch.cuda.synchronize()
                row[f"{name}_host_ms"] = (time.perf_counter() - t0) * 1e3
                row[f"{name}_loss"] = loss
                require(not any(read_counts(kernels_mod).values()),
                        f"mesh_train: kernels launched in the {name} step")
                if name == "sharded":
                    state_sh = st
                    leaves = tree.leaves(sharded) + tree.leaves(state_sh)
                    require(all(isinstance(t, DTensor) for t in leaves),
                            "mesh_train: a leaf is no DTensor after the step")
                else:
                    state_plain = st
            rel = abs(row["sharded_loss"] - row["unsharded_loss"]) / abs(row["unsharded_loss"])
            require(math.isfinite(row["sharded_loss"]) and rel <= MESH_TRAIN_TOL,
                    f"mesh_train step {i + 1}: loss {row['sharded_loss']} vs "
                    f"{row['unsharded_loss']} (relative {rel})")
            row["loss_rel_err"] = rel
            rows.append(row)
    emit({"phase": "mesh_train", "model": cfg.name, "layers": MESH_TRAIN_LAYERS,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "param_dtype": cfg.param_dtype,
          "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "mesh": [1, 1], "backend": "nccl",
          "steps": rows, "tolerance": MESH_TRAIN_TOL, "kernel_launches": 0,
          "host_ms_note": "sharded - unsharded host ms is DTensor's dispatch cost a step"})
    del plain, sharded, state_plain, state_sh
    torch.cuda.empty_cache()


def _full(t) -> float:
    from torch.distributed.tensor import DTensor

    return float(t.full_tensor() if isinstance(t, DTensor) else t)


def run_mesh_moe_train(torch, kernels_mod):
    """``mesh_moe_train``: grok-1-314b at full width, MESH_MOE_LAYERS of its
    64 layers, its grad_accum cut from 16 to MESH_MOE_ACCUM (one row a
    microbatch; the bf16 accumulator and factored Adam as shipped),
    MESH_TRAIN_STEPS steps of SyntheticLM seed-0 batches of TRAIN_BATCH x
    TRAIN_SEQ tokens through ``build_train_step`` on DTensor params, state
    and batch on a (1, 1) mesh of one NCCL rank (the MoE layer on each
    rank's rows, ``nn.moe._moe_on_mesh``), against the unsharded step on
    the same weights and batches.  The unsharded steps run first and keep
    their losses only; the sharded ones start from the same weights drawn
    again from the seeded generator, so two copies of the weights never
    sit beside a step.  Before each step the loss function runs without
    grad on its batch for the CE and the aux loss (a step at grad_accum >
    1 reports neither).  Gates: every param and state leaf a DTensor after
    each step; no kernel launch; each step's loss, CE and aux loss within
    MESH_TRAIN_TOL relative of the unsharded ones.  Prints each step's
    host ms and each mode's peak GB."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree
    from repro_torch.configs.base import param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt

    full = get_config("grok-1-314b")
    cfg = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS, grad_accum=MESH_MOE_ACCUM)
    api = get_api(cfg)
    adam = train.adam_config_for(cfg, lr=TRAIN_LR, total_steps=MESH_TRAIN_STEPS,
                                 warmup_steps=1)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [next(data) for _ in range(MESH_TRAIN_STEPS)]

    def weights():
        return train.trainable(api.init(cfg, torch.Generator(device="cuda").manual_seed(0)))

    def steps(name, params, state, inputs, step, ctx):
        torch.cuda.reset_peak_memory_stats()
        for row, batch in zip(rows, inputs):
            with ctx(), implicit_replication(), torch.no_grad():
                _, metrics = api.loss_fn(params, batch, cfg)
            row[f"{name}_ce"], row[f"{name}_aux"] = _full(metrics["ce"]), _full(metrics["aux"])
            reset_counts(kernels_mod)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx():
                _, state, metrics = step(params, state, batch)
            row[f"{name}_loss"] = _full(metrics["loss"])
            torch.cuda.synchronize()
            row[f"{name}_host_ms"] = (time.perf_counter() - t0) * 1e3
            require(not any(read_counts(kernels_mod).values()),
                    f"mesh_moe_train: kernels launched in the {name} step")
            if name == "sharded":
                require(all(isinstance(t, DTensor)
                            for t in tree.leaves(params) + tree.leaves(state)),
                        "mesh_moe_train: a leaf is no DTensor after the step")
        peak[name] = torch.cuda.max_memory_allocated() / 1e9

    rows = [{"step": i + 1} for i in range(MESH_TRAIN_STEPS)]
    peak = {}
    plain = weights()
    steps("unsharded", plain, opt.init(adam, plain), batches,
          train.build_train_step(cfg, adam), contextlib.nullcontext)
    with one_nccl_rank():
        mesh = make_local_mesh()
        pshard = shd.params_shardings(plain, mesh)
        del plain
        torch.cuda.empty_cache()
        params = weights()
        sharded = train.trainable(shd.shard_tree(params, pshard))
        state = opt.init(adam, params)
        state = shd.shard_tree(state, shd.opt_state_shardings(state, params, mesh))
        del params
        torch.cuda.empty_cache()
        steps("sharded", sharded, state, [shd.shard_tree(b, shd.batch_specs(b, mesh))
                                          for b in batches],
              train.build_train_step(cfg, adam, grad_shardings=pshard), lambda: mesh)
        del sharded, state
    torch.cuda.empty_cache()
    for row in rows:
        for key in ("loss", "ce", "aux"):
            a, b = row[f"unsharded_{key}"], row[f"sharded_{key}"]
            rel = abs(b - a) / abs(a)
            row[f"{key}_rel_err"] = rel
            require(math.isfinite(b) and rel <= MESH_TRAIN_TOL,
                    f"mesh_moe_train step {row['step']}: {key} {b} vs {a} (relative {rel})")
    emit({"phase": "mesh_moe_train", "model": cfg.name, "layers": MESH_MOE_LAYERS,
          "cuts": {"n_layers": [full.n_layers, MESH_MOE_LAYERS],
                   "grad_accum": [full.grad_accum, MESH_MOE_ACCUM]},
          "params": param_count(cfg), "d_model": cfg.d_model, "experts": cfg.moe_experts,
          "top_k": cfg.moe_top_k, "param_dtype": cfg.param_dtype,
          "grad_accum_dtype": cfg.grad_accum_dtype, "adam_factored": cfg.adam_factored,
          "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "mesh": [1, 1], "backend": "nccl",
          "steps": rows, "tolerance": MESH_TRAIN_TOL, "kernel_launches": 0,
          "peak_gb": peak,
          "loss_note": "ce and aux: loss_fn without grad on the step's batch before it"})


def run_mesh_serve_int8(torch, kernels_mod):
    """``mesh_serve_int8``: grok-1-314b at full width, MESH_SERVE_LAYERS of
    its 64 layers, from int8 weights as the ``moe`` phase builds them
    (``lm.init(quantize=True)``), one prompt of MESH_SERVE_TOKENS tokens
    prefilled then DECODE_STEPS greedy steps, first unsharded, then on
    DTensor params (the int8 leaves sharded like their parents, dequantized
    shard by shard), cache and tokens on a (1, 1) mesh of one NCCL rank.
    Gates: the flash kernel launched once a layer in each prefill; the
    sharded tokens equal the unsharded ones; the sharded prefill's logits
    within BF16_TOL of the unsharded logits' scale.  Prints the largest
    difference and both runs' host ms; returns the sharded prefill's
    launch counts."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api

    cfg = dataclasses.replace(get_config("grok-1-314b"), n_layers=MESH_SERVE_LAYERS)
    require(cfg.serve_weight_quant, f"{cfg.name} ships with int8 serve weights")
    api = get_api(cfg)
    params = build_params(torch, "mesh_serve_int8", cfg, quantize=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = {"tokens": torch.randint(0, cfg.vocab, (1, MESH_SERVE_TOKENS), generator=gen,
                                      device="cuda")}
    max_len = MESH_SERVE_TOKENS + DECODE_STEPS
    runs = {}

    def serve(p, state, tokens, ctx):
        reset_counts(kernels_mod)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx(), implicit_replication():
            logits, state = api.prefill(p, tokens(prompt), state, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(kernels_mod)
        first = logits.full_tensor() if isinstance(logits, DTensor) else logits
        out = [int(first[0, -1].argmax())]
        t0 = time.perf_counter()
        for i in range(DECODE_STEPS):
            tok = {"tokens": torch.tensor([[out[-1]]], device="cuda")}
            with ctx(), implicit_replication():
                logits, state = api.decode(p, state, tokens(tok), MESH_SERVE_TOKENS + i, cfg)
            step = logits.full_tensor() if isinstance(logits, DTensor) else logits
            out.append(int(step[0, -1].argmax()))
        torch.cuda.synchronize()
        return {"prefill_host_ms": prefill_ms, "launches": launches, "tokens": out,
                "decode_host_ms_a_step": (time.perf_counter() - t0) * 1e3 / DECODE_STEPS,
                "logits": first.float()}

    with torch.no_grad():
        runs["unsharded"] = serve(params, api.make_serve_state(cfg, 1, max_len),
                                  lambda b: b, contextlib.nullcontext)
        with one_nccl_rank():
            mesh = make_local_mesh()
            dparams = shd.shard_tree(params, shd.params_shardings(params, mesh))
            del params
            torch.cuda.empty_cache()
            state = api.make_serve_state(cfg, 1, max_len)
            dstate = shd.shard_tree(state, shd.serve_state_specs(state, mesh))
            del state
            require(isinstance(dparams["blocks"][0]["moe"]["w_up"]["__q__"], DTensor),
                    "mesh_serve_int8: the int8 leaves are no DTensors")
            runs["sharded"] = serve(dparams, dstate,
                                    lambda b: shd.shard_tree(b, shd.batch_specs(b, mesh)),
                                    lambda: mesh)
            del dparams, dstate
    torch.cuda.empty_cache()
    want, got = runs["unsharded"].pop("logits"), runs["sharded"].pop("logits")
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    for name, run in runs.items():
        require(run["launches"]["flash_attention"] == cfg.n_layers,
                f"mesh_serve_int8 ({name}): {run['launches']} launches a prefill")
    emit({"phase": "mesh_serve_int8", "model": cfg.name, "layers": cfg.n_layers,
          "weights": "int8 (lm.init(quantize=True))", "prompt_tokens": MESH_SERVE_TOKENS,
          "decode_steps": DECODE_STEPS, "mesh": [1, 1], "backend": "nccl",
          "prefill_logits_max_abs_err": err, "scale": scale, "tolerance": BF16_TOL,
          "tokens_equal": runs["sharded"]["tokens"] == runs["unsharded"]["tokens"], **runs})
    require(err <= BF16_TOL * scale, f"mesh_serve_int8: prefill logits max|err| {err} > "
            f"{BF16_TOL} x {scale}")
    require(runs["sharded"]["tokens"] == runs["unsharded"]["tokens"],
            "mesh_serve_int8: the sharded serve's tokens differ from the unsharded one's")
    return runs["sharded"]["launches"]


def run_dryrun(torch, kernels_mod):
    """``dryrun``: ``launch.dryrun.run_cell`` on ``--device cuda`` for
    DRYRUN_CELLS, as shipped or cut in depth where the cell says so, each
    over a fake process group of the production mesh's ranks; every record
    printed with its cut.  Gates: status ok, FLOPs, collectives and peak
    bytes above 0, no kernel launched, and the SSM prefill's trace
    reaching the SSD kernel's op."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun

    for arch, shape, multi_pod, layers in DRYRUN_CELLS:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, n_layers=layers)
        reset_counts(kernels_mod)
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, device="cuda", cfg=cfg)
        seconds = time.perf_counter() - t0
        require(rec["status"] == "ok", f"dryrun {arch} {shape}: {rec.get('error')}")
        require(not any(read_counts(kernels_mod).values()),
                f"dryrun {arch} {shape}: a kernel launched in the trace")
        require(rec["flops"]["counted_per_rank"] > 0 and rec["collectives"]["total_count"] > 0
                and rec["memory"]["peak_bytes"] > 0, f"dryrun {arch} {shape}: empty counts")
        if cfg.family == "ssm" and shape.startswith("prefill"):
            require("repro_torch.ssd_chunk" in rec["flops"]["counted_by_op"],
                    f"dryrun {arch} {shape}: the trace missed the SSD kernel's op")
        emit({"phase": "dryrun", "layers": cfg.n_layers,
              **({} if layers is None else {"cut": {"n_layers": [full.n_layers, layers]}}),
              "seconds": seconds, **rec})


def dryrun_ground_cells() -> list:
    """The cells ``dryrun_ground`` holds to the card: mesh_train's
    (gemma3-1b) and mesh_moe_train's (grok-1), each (cfg, phase name)."""
    from repro_torch.configs.registry import get_config

    return [(dataclasses.replace(get_config("gemma3-1b"), n_layers=MESH_TRAIN_LAYERS),
             "mesh_train"),
            (dataclasses.replace(get_config("grok-1-314b"), n_layers=MESH_MOE_LAYERS,
                                 grad_accum=MESH_MOE_ACCUM), "mesh_moe_train")]


def run_dryrun_ground(torch, kernels_mod, cfg, cell):
    """``dryrun_ground``: the dry run's prediction of ``cell``'s step
    (``cfg``, one step of TRAIN_BATCH x TRAIN_SEQ tokens on a (1, 1) mesh)
    against the step on the card, one NCCL rank.  Step 1 of the unsharded
    step runs under ``FlopCounterMode``, step 1 of the sharded one under
    the dry run's own counter (``StepCounter``); steps 2.. are timed, the
    peak of the last read after ``reset_peak_memory_stats``.  Gates: the
    three FLOP counts equal; the predicted peak within DRYRUN_PEAK_TOL of
    the measured one, which is ``max_memory_allocated`` less what was
    allocated before the step beside its inputs (their storages, rounded
    as the allocator rounds them)."""
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.hlo_analysis import StepCounter, storage_bytes
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt

    shape = ShapeSuite(cell, TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    rec = dryrun.run_cell(cfg.name, shape, cfg=cfg, mesh_shape=(1, 1), device="cuda")
    trace_s = time.perf_counter() - t0
    require(rec["status"] == "ok", f"dryrun_ground {cell}: the trace failed: {rec.get('error')}")

    api = get_api(cfg)
    adam = train.adam_config_for(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH, seed=0)
    batches = [next(data) for _ in range(1 + DRYRUN_GROUND_STEPS)]
    plain = train.trainable(api.init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    state = opt.init(adam, plain)
    fc = FlopCounterMode(display=False)
    with fc:
        train.build_train_step(cfg, adam)(plain, state, batches[0])
    unsharded_flops = fc.get_total_flops()
    with one_nccl_rank():
        mesh = make_local_mesh()
        pshard = shd.params_shardings(plain, mesh)
        params = train.trainable(shd.shard_tree(plain, pshard))
        state = shd.shard_tree(state, shd.opt_state_shardings(state, plain, mesh))
        del plain
        torch.cuda.empty_cache()
        step = train.build_train_step(cfg, adam, grad_shardings=pshard)
        placed = [shd.shard_tree(b, shd.batch_specs(b, mesh)) for b in batches]
        counter = StepCounter(mesh)
        reset_counts(kernels_mod)
        with mesh, counter:
            step(params, state, placed[0])
        sharded_flops = counter.flops
        del counter
        times = []
        for batch in placed[1:]:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            with mesh:
                _, _, metrics = step(params, state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
            peak = torch.cuda.max_memory_allocated()
            del metrics
        require(not any(read_counts(kernels_mod).values()),
                f"dryrun_ground {cell}: a kernel launched in a train step")
        held = sum(storage_bytes(t.to_local() if isinstance(t, DTensor) else t)
                   for t in tree.leaves([params, state, placed[-1]]) if torch.is_tensor(t))
        step_peak = peak - base + held
        del params, state, placed
    torch.cuda.empty_cache()
    predicted = rec["memory"]["peak_bytes"]
    flops = rec["flops"]["counted_per_rank"]
    step_ms = statistics.median(times)
    bound_ms = rec["roofline"]["bound_s"] * 1e3
    row = {"phase": "dryrun_ground", "cell": cell, "model": cfg.name, "layers": cfg.n_layers,
           "grad_accum": cfg.grad_accum, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "mesh": [1, 1], "trace_s": trace_s,
           "flops": {"dryrun": flops, "card_step_counter": sharded_flops,
                     "card_unsharded_flop_counter_mode": unsharded_flops,
                     "analytic": rec["flops"]["analytic_per_rank"]},
           "peak_bytes": {"dryrun": predicted, "card_step": step_peak,
                          "card_max_memory_allocated": peak, "card_allocated_before": base,
                          "card_step_inputs": held,
                          "dryrun_over_card": predicted / step_peak},
           "step_ms": times, "step_ms_median": step_ms, "roofline_bound_ms": bound_ms,
           "roofline_dominant": rec["roofline"]["dominant"],
           "bound_over_step": bound_ms / step_ms, "peak_tolerance": DRYRUN_PEAK_TOL}
    emit(row)
    require(flops == sharded_flops == unsharded_flops,
            f"dryrun_ground {cell}: FLOPs {flops} (dry run) against {sharded_flops} (card, "
            f"sharded step) and {unsharded_flops} (card, FlopCounterMode, unsharded)")
    require(abs(predicted - step_peak) <= DRYRUN_PEAK_TOL * step_peak,
            f"dryrun_ground {cell}: predicted peak {predicted} against {step_peak} on the card")


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


def kernels_line(bench, launches, kpu_grouped) -> list:
    """The ``kernels`` line: each kernel's main route (f32 rows; flash in
    bf16) with the main path's launches, and its bf16 route beside it;
    the KPU's also the slices' launches whose blocks ran more than one
    plan tile (``kpu_grouped``)."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in bench.rows if r["kernel"] == name and "route" not in r]
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], **summarise(name, rows)}
        if name == "kpu_conv":
            row["grouped_launches_in_slices"] = kpu_grouped
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
    flash_rows = {"flash_kernel_wgmma": ptxas_report(lib._name, "flash_kernel_wgmma"),
                  "flash_kernel": ptxas_report(lib._name, "flash_kernel")}
    emit({"phase": "ptxas", "kernel": "flash_kernel_wgmma",
          "template": "<head dim, block_k, consumer warpgroups>",
          "registers_note": "with 2 consumer warpgroups, registers at entry; "
                            "setmaxnreg then gives the consumers 232 and the "
                            "producer warpgroup 40",
          "instances": flash_rows["flash_kernel_wgmma"]})
    emit({"phase": "ptxas", "kernel": "flash_kernel", "dtype": "float32",
          "template": "<head dim>", "instances": flash_rows["flash_kernel"]})
    for kernel, rows in flash_rows.items():   # head dim 256 (gemma3), new in this build
        d256 = [r for r in rows if r["template"][:1] == [256]]
        require(d256 and all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0
                             for r in d256), f"{kernel}: a d = 256 instance spills: {d256}")
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
    # the KPU's groups and splits follow the batch: every ResNet-18 conv at
    # the benchmark's batch of 64, in its plans at rates 3 and 3/32
    api = get_cnn_api("resnet18")
    cfg = api.make_config()
    graph = api.graph(cfg)
    for rate in (RATE, Fraction(3, 32)):
        kp = api.plan(cfg, rate)
        convs = {n for n, ip in kp.items() if ip.has_kernel and graph.spec(n).kind == "conv"}
        bench_nodes(torch, bench, "resnet18", kp, graph, gen, only=convs,
                    suffix=f"/r{str(rate).replace('/', '_')}/b64", timed=False, batch=64)
    bench_extras(torch, bench, gen)
    wrapper_host_us(torch)
    bench_flash(torch, bench, gen)
    bench_ssd(torch, bench, torch.Generator().manual_seed(2027))

    launches, kpu_grouped = {k: 0 for k in KERNELS}, 0
    for family in ("mobilenet_v2", "resnet18"):
        counts, grouped = run_slice(torch, family, kernels_mod, gen, bench)
        kpu_grouped += grouped
        for k, v in counts.items():
            launches[k] += v
    for family in ("mobilenet_v2", "resnet18"):
        for k, v in run_staged(torch, family, kernels_mod, gen).items():
            launches[k] += v
    for family in ("mobilenet_v2", "resnet18"):
        for k, v in run_stream(torch, family, kernels_mod,
                               torch.Generator().manual_seed(2028)).items():
            launches[k] += v
    for family in ("mobilenet_v2", "resnet18"):
        for k, v in run_devices(torch, family, kernels_mod,
                                torch.Generator().manual_seed(2029)).items():
            launches[k] += v
    for k, v in run_fleet(torch, kernels_mod, torch.Generator().manual_seed(2030)).items():
        launches[k] += v
    for run in (run_lm_paths, run_moe_paths, run_blockwise):
        for k, v in run(torch, kernels_mod).items():
            launches[k] += v
    run_moe_forms(torch)
    for run in (run_vlm, run_encdec):
        for k, v in run(torch, kernels_mod).items():
            launches[k] += v
    require(all(launches.values()), f"a kernel never launched on the main path: {launches}")
    for family in ("mobilenet_v2", "resnet18"):
        run_slice(torch, family, kernels_mod, gen, bench, torch.bfloat16)
    for phase, arch in TRAIN.items():
        run_train(torch, kernels_mod, phase, arch)
    run_train_gates(torch, kernels_mod)
    run_paged_kv(torch)
    mesh_launches = {"mesh_ssd": run_mesh_ssd(torch), "mesh_prefill": run_mesh_prefill(torch)}
    run_mesh_collectives(torch)
    pipeline_launches = run_mesh_pipeline(torch, smi)
    run_mesh_train(torch, kernels_mod)
    run_mesh_moe_train(torch, kernels_mod)
    serve_int8_launches = run_mesh_serve_int8(torch, kernels_mod)
    run_examples(torch, smi)
    run_dryrun(torch, kernels_mod)
    for cfg, cell in dryrun_ground_cells():
        run_dryrun_ground(torch, kernels_mod, cfg, cell)

    out = kernels_line(bench, launches, kpu_grouped)
    for row in out:
        if row["name"] == "ssd_chunk":
            row["mesh_launches_per_rank"] = mesh_launches
        if row["name"] == "flash_attention":
            row["mesh_launches_per_rank"] = {
                "mesh_serve_int8": serve_int8_launches["flash_attention"],
                "mesh_pipeline": pipeline_launches}
    emit({"kernels": out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
