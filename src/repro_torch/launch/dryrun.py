"""Multi-pod dry run: trace every (arch x shape x mesh) cell; the port's
copy of the JAX package's ``launch/dryrun.py``.

For every enabled cell this script:
  1. makes a ``fake`` process group of 256 ranks (512 with
     ``--multi-pod``) in this one process and the production mesh on it
     (16x16 or 2x16x16, ``launch.mesh.make_production_mesh``);
  2. builds the step's inputs as fake DTensors under ``FakeTensorMode``
     (params, optimizer state, batch, caches: shapes and dtypes only, no
     allocation), placed by the sharding rules;
  3. runs one call of the step (the train step for train shapes, prefill
     or decode for serve shapes) under ``core.hlo_analysis.StepCounter``;
  4. records the rank's peak live bytes (against the H100's 80 GB), its
     counted FLOPs beside the analytic ``core.flops.step_flops`` over the
     ranks, the collectives by kind and by mesh axis, and the three
     roofline terms, into ``build/dryrun/<arch>__<shape>__<mesh>.json``.

The JAX package lowers and compiles instead; ``trace_s`` takes the place
of its ``lower_s`` / ``compile_s``.  Its CPU-backend ``temp_factor`` has
no counterpart: fake tensors carry their real dtypes.  ``--device``
(default ``cuda``) is the device the fake tensors name, so the trace takes
the routes that device runs: on ``cuda`` the serve cells reach the flash
and SSD kernels (their custom ops' fake implementations and FLOP
formulas); on ``cpu`` their plain versions.  A cell that raises is
recorded with ``status: "error"`` and the sweep goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-done]
  ... --device cpu          (a box without a card: the plain routes)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig, active_param_count, param_count
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSuite, cell_enabled, skip_reason
from repro_torch.core.flops import step_flops, step_hbm_bytes
from repro_torch.core.hlo_analysis import StepCounter, roofline_terms
from repro_torch.core.hw import H100_SXM
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import PRODUCTION, make_production_mesh
from repro_torch.launch.train import adam_config_for, build_train_step, trainable
from repro_torch.models import registry as models
from repro_torch.nn.quant import quantize_tree
from repro_torch.optim import optimizers as opt


def _tokens_per_step(cfg: ModelConfig, shape: ShapeSuite) -> int:
    if shape.kind == "train":
        return shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: 1 token per sequence


def model_flops(cfg: ModelConfig, shape: ShapeSuite) -> float:
    """6*N*D train / 2*N*D serve (N = active params for MoE)."""
    n = active_param_count(cfg)
    d = _tokens_per_step(cfg, shape)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d


def build_cell(cfg: ModelConfig, shape: ShapeSuite, mesh, device: str = "cuda"):
    """-> (step, args): the step and its fake DTensor inputs on ``mesh``
    (its device type is ``device``).  Runs under the caller's
    ``FakeTensorMode``."""
    api = models.get_api(cfg, device)
    abstract = models.get_api(cfg, "cpu")   # shapes only: drawn under the fake mode

    if shape.kind == "train":
        adam = adam_config_for(cfg)
        p_abs = abstract.init(cfg, torch.Generator().manual_seed(0))
        o_abs = opt.init(adam, p_abs)
        b_abs = models.train_batch_specs(cfg, shape)
        p_sh = shd.params_shardings(p_abs, mesh)
        step = build_train_step(cfg, adam, device, grad_shardings=p_sh)
        o_sh = shd.opt_state_shardings(o_abs, p_abs, mesh)
        b_sh = shd.batch_specs(b_abs, mesh)
        args = (trainable(shd.abstract_with_shardings(p_abs, p_sh)),
                shd.abstract_with_shardings(o_abs, o_sh),
                shd.abstract_with_shardings(b_abs, b_sh))
        return step, args

    p_abs = abstract.init(cfg, torch.Generator().manual_seed(0))
    if cfg.serve_weight_quant:
        p_abs = quantize_tree(p_abs)
    p_in = shd.abstract_with_shardings(p_abs, shd.params_shardings(p_abs, mesh))
    st_abs = models.serve_state_specs(cfg, shape)
    st_in = shd.abstract_with_shardings(st_abs, shd.serve_state_specs(st_abs, mesh))

    if shape.kind == "prefill":
        b_abs = models.prefill_batch_specs(cfg, shape)
        b_in = shd.abstract_with_shardings(b_abs, shd.batch_specs(b_abs, mesh))

        def prefill_step(params, batch, state):
            with implicit_replication():
                return api.prefill(params, batch, state, cfg)

        return prefill_step, (p_in, b_in, st_in)

    # decode: one token against a full cache
    b_abs = models.decode_batch_specs(cfg, shape)
    b_in = shd.abstract_with_shardings(b_abs, shd.batch_specs(b_abs, mesh))
    pos = shape.seq_len - 1

    def decode_step(params, state, batch, pos):
        with implicit_replication():
            return api.decode(params, state, batch, pos, cfg)

    return decode_step, (p_in, st_in, b_in, pos)


def trace_cell(cfg: ModelConfig, shape: ShapeSuite, mesh, *, device: str = "cuda") -> dict:
    """Trace one call of ``cfg``'s step at ``shape`` on ``mesh`` (a mesh of
    the current process group, real or fake) over fake inputs; returns the
    record's measured fields (``run_cell``)."""
    sizes = shd.mesh_sizes(mesh)
    chips = mesh.size()
    n_model = sizes.get("model", 1)
    n_data = sizes.get("data", 1) * sizes.get("pod", 1)
    counter = StepCounter(mesh)
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args = build_cell(cfg, shape, mesh, device)
        held = counter.hold(*args)
        with mesh, counter:
            out = fn(*args)
        del out
    trace_s = time.perf_counter() - t0
    ana_flops = step_flops(cfg, shape) / chips
    hbm = step_hbm_bytes(cfg, shape, n_model, n_data)
    terms = roofline_terms(counter.flops, hbm, counter.collectives, chips,
                           model_flops=model_flops(cfg, shape))
    return {
        "status": "ok",
        "device": device,
        "chips": chips,
        "trace_s": round(trace_s, 2),
        "memory": {
            "peak_bytes": counter.peak_bytes,
            "input_bytes": held,
            "hbm_bytes": H100_SXM.hbm_bytes,
            "fits_hbm": bool(counter.peak_bytes <= H100_SXM.hbm_bytes),
        },
        "flops": {
            "counted_per_rank": counter.flops,
            "analytic_per_rank": ana_flops,
            "counted_over_analytic": counter.flops / ana_flops if ana_flops else None,
            "counted_by_op": counter.flops_by_op,
        },
        "hbm_bytes_per_rank": hbm,
        "collectives": counter.collectives.summary(),
        "roofline": terms.summary(),
    }


@contextlib.contextmanager
def fake_world(world: int):
    """A ``fake`` process group of ``world`` ranks in this process (rank 0),
    destroyed on exit: collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name, *, multi_pod: bool = False, device: str = "cuda",
             cfg: Optional[ModelConfig] = None,
             mesh_shape: Optional[Tuple[int, int]] = None) -> dict:
    """One cell's record.  ``shape_name`` names a suite of ``SHAPES`` or is
    a ``ShapeSuite``; ``cfg`` replaces ``get_config(arch)`` (a reduced or
    cut config) and ``mesh_shape`` the production mesh by a ``(data,
    model)`` mesh of that many fake ranks."""
    cfg = cfg or get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    production = mesh_shape is None
    if production:
        mesh_shape = PRODUCTION[multi_pod][0]
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    else:
        mesh_name = "x".join(map(str, mesh_shape))
    record = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "params": param_count(cfg), "active_params": active_param_count(cfg),
        "model_flops": model_flops(cfg, shape),
        "tokens_per_step": _tokens_per_step(cfg, shape),
    }
    if not cell_enabled(cfg, shape):
        record.update(status="skipped", reason=skip_reason(cfg, shape))
        return record
    with fake_world(math.prod(mesh_shape)):
        mesh = (make_production_mesh(multi_pod=multi_pod, device_type=device) if production
                else init_device_mesh(device, mesh_shape, mesh_dim_names=("data", "model")))
        record.update(trace_cell(cfg, shape, mesh, device=device))
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args()

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    cells = []
    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    failures = 0
    for arch, shape, mp in cells:
        mesh_name = "pod2x16x16" if mp else "pod16x16"
        path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
        if args.skip_done and path.exists():
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[dryrun] {arch} x {shape} x {mesh_name}: cached")
                continue
        print(f"[dryrun] {arch} x {shape} x {mesh_name} ...", flush=True)
        try:
            rec = run_cell(arch, shape, multi_pod=mp, device=args.device)
        except Exception as e:  # record the failure, keep sweeping
            rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                   "device": args.device, "status": "error", "error": repr(e),
                   "traceback": traceback.format_exc()[-4000:]}
            failures += 1
        path.write_text(json.dumps(rec, indent=1))
        if rec["status"] == "ok":
            r, m, f = rec["roofline"], rec["memory"], rec["flops"]
            print(f"  ok: trace {rec['trace_s']}s | "
                  f"peak/rank {m['peak_bytes'] / 1e9:.2f} GB fits={m['fits_hbm']} | "
                  f"flops/rank {f['counted_per_rank']:.3e} "
                  f"(x{f['counted_over_analytic']:.3f} analytic) | "
                  f"compute {r['compute_s']:.3e}s mem {r['memory_s']:.3e}s "
                  f"coll {r['collective_s']:.3e}s -> {r['dominant']}",
                  flush=True)
            print(compiled_summary(rec), flush=True)
        elif rec["status"] == "skipped":
            print(f"  skipped: {rec['reason']}")
        else:
            print(f"  ERROR: {rec['error']}")
    if failures:
        raise SystemExit(f"{failures} cells failed")


def compiled_summary(rec: dict) -> str:
    r = rec["roofline"]
    return (f"  roofline_fraction={r['roofline_fraction']:.3f} "
            f"useful_flops={r['useful_flops_ratio']:.3f}")


if __name__ == "__main__":
    main()
