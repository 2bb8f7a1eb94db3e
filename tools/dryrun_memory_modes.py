#!/usr/bin/env python3
"""The peak memory of a train step on one CUDA card, run plainly and under
dispatch modes, beside the dry run's prediction of it.

    python3 tools/dryrun_memory_modes.py

Run from the root of a checkout on a machine with a CUDA card and the
CUDA toolkit.  The cell is ``chip_smoke.py``'s ``mesh_train`` /
``dryrun_ground`` cell: gemma3-1b at full width, 4 of its 26 layers, bf16
params, f32 AdamW moments, one step of 2 x 2048 SyntheticLM tokens.  The
dry run (``launch.dryrun.run_cell`` on a (1, 1) fake world, ``--device
cuda``) predicts the step's peak; then the step runs on the card, the
unsharded one and the sharded one on a (1, 1) NCCL mesh, each plainly,
under a dispatch mode that does nothing, and (sharded) under the dry
run's ``core.hlo_analysis.StepCounter``, after a warm-up step.  Each peak
is ``max_memory_allocated()`` after ``reset_peak_memory_stats()`` less
what was allocated before the step; the step's inputs (params, optimizer
state, batch) are added back for the comparison with the prediction,
which counts them.  A mode that changes the step's peak is one the dry
run's trace (itself under modes) would carry into its prediction.
Prints one JSON line, with the card's name and power limit as
``nvidia-smi`` gives them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("dryrun_memory_modes: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import tree
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.hlo_analysis import StepCounter, storage_bytes
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.registry import get_api
    from repro_torch.optim import optimizers as opt

    class NoOp(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=4)
    shape = ShapeSuite("mesh_train", 2048, 2, "train")
    predicted = dryrun.run_cell(cfg.name, shape, cfg=cfg, mesh_shape=(1, 1),
                                device="cuda")["memory"]["peak_bytes"]

    def peak(step, params, state, batch, mode, ctx) -> int:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with ctx, mode if mode is not None else contextlib.nullcontext():
            out = step(params, state, batch)
        torch.cuda.synchronize()
        del out
        return torch.cuda.max_memory_allocated() - base

    def inputs(*trees) -> int:
        return sum(storage_bytes(t.to_local() if isinstance(t, DTensor) else t)
                   for t in tree.leaves(list(trees)) if torch.is_tensor(t))

    api = get_api(cfg)
    adam = train.adam_config_for(cfg)
    batch = next(SyntheticLM(vocab=cfg.vocab, seq_len=2048, batch=2, seed=0))
    plain = train.trainable(api.init(cfg, torch.Generator(device="cuda").manual_seed(0)))
    pstate = opt.init(adam, plain)
    ustep = train.build_train_step(cfg, adam)
    none = contextlib.nullcontext()
    peak(ustep, plain, pstate, batch, None, none)                  # warm-up
    unsharded = {name: peak(ustep, plain, pstate, batch, mode, none)
                 for name, mode in (("plain", None), ("noop_mode", NoOp()))}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_local_mesh()
            pshard = shd.params_shardings(plain, mesh)
            params = train.trainable(shd.shard_tree(plain, pshard))
            state = shd.shard_tree(pstate, shd.opt_state_shardings(pstate, plain, mesh))
            del plain, pstate
            torch.cuda.empty_cache()
            step = train.build_train_step(cfg, adam, grad_shardings=pshard)
            dbatch = shd.shard_tree(batch, shd.batch_specs(batch, mesh))
            peak(step, params, state, dbatch, None, mesh)          # warm-up
            sharded = {name: peak(step, params, state, dbatch, mode, mesh)
                       for name, mode in (("plain", None), ("noop_mode", NoOp()),
                                          ("step_counter", StepCounter(mesh)))}
            held = inputs(params, state, dbatch)
        finally:
            dist.destroy_process_group()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"cell": "gemma3-1b, 4 layers, 2 x 2048, (1, 1)",
                      "unsharded_step_peak_bytes": unsharded,
                      "sharded_step_peak_bytes": sharded, "sharded_step_inputs": held,
                      "dryrun_predicted_peak_bytes": predicted,
                      "predicted_over_plain": predicted / (sharded["plain"] + held),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
