"""Training launcher: the train step and the loop; the port's copy of the
JAX package's ``launch/train.py``, on one device.

``build_train_step`` gives ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its grads over ``cfg.grad_accum``
microbatches under autograd (``optim.accumulate_grads``), then AdamW,
which updates the params and moments in place.  The loop wires in the
fault-tolerance pieces: asynchronous checkpoints and resume from the
latest one (the data stream's position rides along), the straggler
watchdog and the heartbeat.

**On a mesh** the step takes DTensor params, optimizer state and batch
(``distributed.sharding``: ``params_shardings``, ``opt_state_shardings``,
``batch_specs``; ``shard_tree`` places a tree) and is called inside the
mesh's ``with mesh:`` block, which the models' ``constrain`` calls read,
as the JAX package's step is traced under its mesh.  ``grad_shardings``
pins the grads to the FSDP layout.  The plain tensors a model makes
along the way (positions, masks, constants) join the DTensors as
replicated (``implicit_replication``).

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``).  The params get ``requires_grad_(True)`` here, not in
``init``, so that serving trees stay off autograd (and on the kernel
routes).  Under autograd the model takes the JAX package's plain routes
for attention and the SSD scan, so no kernel runs in a train step.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.distributed.fault_tolerance import Heartbeat, StragglerWatchdog
from repro_torch.models.registry import get_api, resolve_device
from repro_torch.optim import optimizers as opt
from repro_torch.tree import DTYPES, leaves

def trainable(params):
    """Mark every leaf of ``params`` as requiring grad, in place; returns
    the tree."""
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def build_train_step(cfg: ModelConfig, adam: opt.AdamWConfig,
                     device=None, grad_shardings=None) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Includes gradient accumulation (``cfg.grad_accum`` microbatches in a
    ``cfg.grad_accum_dtype`` accumulator), the activation-memory valve.
    ``batch`` leaves may be numpy arrays or tensors; the params' leaves
    require grad (``trainable``).  ``grad_shardings`` pins gradients to
    the FSDP layout (``optim.accumulate_grads``); DTensor params run the
    step on their mesh (module note)."""
    api = get_api(cfg, device)

    def loss(params, batch):
        return api.loss_fn(params, batch, cfg)

    def step(params, opt_state, batch):
        sharded = any(isinstance(p, DTensor) for p in leaves(params))
        with implicit_replication() if sharded else contextlib.nullcontext():
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        l, metrics, grads = opt.accumulate_grads(
            loss, params, batch, cfg.grad_accum, grad_shardings=grad_shardings,
            acc_dtype=DTYPES[cfg.grad_accum_dtype])
        params, opt_state, om = opt.apply_updates(adam, params, grads, opt_state)
        metrics = dict(metrics)
        metrics.update(om, loss=l)
        return params, opt_state, metrics

    return step


def adam_config_for(cfg: ModelConfig, **overrides) -> opt.AdamWConfig:
    base = dict(mu_dtype=cfg.adam_mu_dtype, nu_dtype=cfg.adam_nu_dtype,
                factored=cfg.adam_factored, momentum=cfg.adam_momentum)
    base.update(overrides)
    return opt.AdamWConfig(**base)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def train_loop(
    cfg: ModelConfig,
    *,
    steps: int,
    batch: int,
    seq_len: int,
    lr: float = 3e-4,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    seed: int = 0,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
    device=None,
) -> Dict[str, Any]:
    """Train ``steps`` steps of random-init ``cfg`` (weights drawn from
    ``seed`` on the device) on ``SyntheticLM`` batches; with ``ckpt_dir``,
    resume from its latest checkpoint and save every ``ckpt_every``
    steps.  Returns ``{"params", "losses"}`` (the losses of the steps this
    call ran).  A checkpoint write in flight is joined before the call
    returns or raises."""
    dev = resolve_device(device)
    api = get_api(cfg, dev)
    adam = adam_config_for(cfg, lr=lr, total_steps=steps,
                           warmup_steps=max(1, steps // 20))
    params = api.init(cfg, torch.Generator(dev).manual_seed(seed))
    opt_state = opt.init(adam, params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len, batch=batch, seed=seed)
    step_fn = build_train_step(cfg, adam, dev)

    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ck and ck.latest_step() is not None:
        (params, opt_state), extra = ck.restore(None, (params, opt_state))
        data.load_state_dict(extra["data"])
        start = extra["step"]
        print(f"[train] resumed from step {start}")
    trainable(params)

    wd = StragglerWatchdog()
    hb = Heartbeat(f"{ckpt_dir}/heartbeat.json") if ckpt_dir else None
    losses = []
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, next(data))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses.append(loss)
            if hb:
                hb.beat(step)
            if wd.observe(step, dt):
                print(f"[train] WARN straggling at step {step} "
                      f"({dt:.2f}s); flagged={wd.flagged_steps[-3:]}")
                wd.reset()
            if step % log_every == 0:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} {dt * 1e3:.0f}ms")
            if on_metrics:
                on_metrics(step, metrics)
            if ck and (step + 1) % ckpt_every == 0:
                ck.save(step + 1, (params, opt_state),
                        extra={"step": step + 1, "data": data.state_dict()})
    finally:
        if ck:
            ck.wait()
    return {"params": params, "losses": losses}
