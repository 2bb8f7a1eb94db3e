"""End-to-end training run on the PyTorch / CUDA port: train a small
LM for a few hundred steps.

Exercises the full production loop on the device: synthetic data
pipeline, AdamW, remat, async checkpointing with auto-resume, straggler
watchdog, heartbeat.  Kill it mid-run and start it again — it resumes
from the last checkpoint and the loss curve continues seamlessly (that's
the fault-tolerance drill, also tested in CI).

Default model: a reduced qwen2-style decoder (~12M params).  ``--preset
100m`` scales to ~100M params.

Usage:
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 [--device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300  # again: resumes
"""
import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs.base import param_count
from repro_torch.configs.registry import get_config, reduced
from repro_torch.launch.train import train_loop
from repro_torch.models.registry import resolve_device

PRESETS = {
    # (layers, d_model, vocab, seq, batch)
    "12m": (4, 256, 4096, 128, 8),
    "100m": (12, 768, 32000, 512, 8),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b",
                    help="architecture family to scale down")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="12m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="results/train_lm_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints")
    ap.add_argument("--log", default="results/train_lm_loss.json")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    layers, d_model, vocab, seq, batch = PRESETS[args.preset]
    cfg = reduced(get_config(args.arch), layers=layers, d_model=d_model,
                  vocab=vocab)
    cfg = dataclasses.replace(cfg, name=f"{args.arch}-{args.preset}")
    print(f"[train_lm] {cfg.name}: ~{param_count(cfg)/1e6:.1f}M params, "
          f"seq {seq}, batch {batch}, {args.steps} steps on {dev}")

    out = train_loop(cfg, steps=args.steps, batch=batch, seq_len=seq,
                     lr=args.lr, ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
                     device=dev)
    losses = out["losses"]
    Path(args.log).parent.mkdir(parents=True, exist_ok=True)
    Path(args.log).write_text(json.dumps({"losses": losses}))
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    print(f"[train_lm] loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first else 'check config'}) "
          f"| curve -> {args.log}")


if __name__ == "__main__":
    main()
