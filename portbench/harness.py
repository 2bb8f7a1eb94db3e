"""Run one cell of ``BENCHMARK.json`` and build its result line.

A cell names a configuration (the file its manifest entry gives; its layer
list from ``reference/<reference>.py``) and a traffic mix
(``traffic/<traffic>.json``, read by ``traffic.py``).  Every metric has a
reader of its own, ``metrics/<name>.py``, whose ``read(ctx)`` returns the
number or None where it finds nothing to read.  So a later cell or metric
is a new file, found by name.

A run: set-up (the kernel library, weights and frames from the seed on the
device, the plan, a warm-up of this cell's shapes), then the window of
``seconds`` on the host clock, then with ``trace`` a profiled sub-window,
then the peak memory, then the program's state dropped and the outputs
that the window produced, a sample drawn from the seed, held against the
plain reference (``reference/net.py``).
"""
import dataclasses
import gc
import importlib.util
import json
import math
import random
import re
import sys
import time
import types
from pathlib import Path

from portbench import devtrace, traffic as traffic_mod
from portbench.reference import net

# The share of the window's requests whose outputs are kept and compared;
# the last request's always are.
SAMPLE_SHARE = 1 / 8
# Module names that no process of the benchmark may hold: JAX and the JAX
# package, which the port must not need.
FOREIGN = ("jax", "jaxlib", "flax", "repro")
# Rows of frames the reference runs at once.
REFERENCE_ROWS = 64
# The standard deviation of the biases drawn with the weights: nonzero, so
# that a bias left out shows in the comparison.
BIAS_STD = 0.1


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_manifest(root):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def resolve_cell(root, manifest, name):
    """The cell ``name`` with its configuration, traffic and metrics."""
    root = Path(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; known: {', '.join(cells)}")
    w = cells[name]
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in names else [])]
    return Cell(root, name, w["chips"], config, traffic, e2e, per_layer)


def _load(path):
    name = "portbench_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[2])))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root, metric):
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    return _load(Path(root) / "portbench" / "metrics" / f"{metric}.py").read


def layers_of(root, config):
    """The configuration's layer list, from ``reference/<reference>.py``."""
    return _load(Path(root) / "portbench" / "reference"
                 / f"{config['reference']}.py").layers(config)


def make_weights(torch, layers, gen, device, dtype):
    """He-normal weights and N(0, BIAS_STD^2) biases in the port's layout,
    drawn on ``device`` from ``gen`` in two calls; each leaf a view of its
    buffer, starting at a multiple of 64 elements."""
    weighted = [lay for lay in layers if lay["kind"] in net.WEIGHTED]
    shapes = [net.weight_shape(lay) for lay in weighted]

    def offsets(sizes):
        out, at = [], 0
        for n in sizes:
            out.append(at)
            at += -(-n // 64) * 64
        return out, at

    w_off, w_total = offsets([math.prod(s) for s in shapes])
    b_off, b_total = offsets([lay["d_out"] for lay in weighted])
    w_all = torch.randn(w_total, generator=gen, device=device)
    b_all = torch.randn(b_total, generator=gen, device=device).mul_(BIAS_STD)
    params = {}
    for lay, shape, wo, bo in zip(weighted, shapes, w_off, b_off):
        w = w_all[wo: wo + math.prod(shape)].view(shape)
        w.mul_(math.sqrt(2.0 / net.fan_in(lay)))
        params[lay["name"]] = {"w": w.to(dtype),
                               "b": b_all[bo: bo + lay["d_out"]].to(dtype)}
    return params


def logit_err(got, want):
    """The worst row's largest gap of a logit, over that row's largest
    reference logit; inf for a wrong shape or a value that is not finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    gap = (got.float() - want).abs().amax(dim=1)
    err = (gap / want.abs().amax(dim=1).clamp_min(1e-30)).max().item()
    return err if math.isfinite(err) else math.inf


def foreign_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def prepare(cell, seed, device):
    """What a run makes from its seed before the program runs: the layer
    list, the weights, and ``frames(n, batch)``, which draws the frames
    after them from the same generator."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = cell.config
    dtype = getattr(torch, config["dtype"])
    layers = layers_of(cell.root, config)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 64)
    params = make_weights(torch, layers, gen, device, dtype)
    hw, channels = tuple(config["input_hw"]), config["in_channels"]

    def frames(n, batch):
        x = torch.randn((n, batch, *hw, channels), generator=gen, device=device)
        return x.to(dtype)

    return types.SimpleNamespace(layers=layers, params=params, frames=frames,
                                 dtype=dtype, hw=hw)


def control_reading(cell, seed, device, **other):
    """The control's number: the reference computed another way (by
    default in TF32, one precision below the configurations' float32 with
    TF32 off; ``other`` goes to ``net.forward``) put in the program's
    place over the frames a run of ``seed`` sends, against the reference."""
    import torch

    other = other or {"tf32_on": True}
    p = prepare(cell, seed, device)
    drv = traffic_mod.driver(p, cell.traffic)
    x = p.frames(*drv.pool_shape).flatten(0, 1)
    worst = 0.0
    for r in range(0, len(x), REFERENCE_ROWS):
        rows = x[r: r + REFERENCE_ROWS]
        want = net.forward(p.layers, p.params, rows)
        got = net.forward(p.layers, p.params, rows, **other)
        worst = max(worst, logit_err(got, want))
    del x, p
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return worst


def run_cell(cell, *, seed, seconds, trace, device, t_start):
    """Run ``cell`` and return the result line's object; its last key,
    ``checks``, holds each number compared beside its limit."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_cnn_api

    on_card = torch.device(device).type == "cuda"
    if on_card:
        # the kernel library's cache: a fixed directory inside the checkout
        _build.BUILD_ROOT = cell.root / "build" / "repro_torch"
        _build.library()
    config = cell.config
    env = prepare(cell, seed, device)
    env.api = api = get_cnn_api(config["family"], device)
    env.cfg = api.make_config(input_hw=env.hw, num_classes=config["num_classes"],
                              dtype=env.dtype)
    env.sync = torch.cuda.synchronize if on_card else (lambda: None)
    layers, params, dtype = env.layers, env.params, env.dtype
    drv = traffic_mod.driver(env, cell.traffic)
    drv.setup()
    env.sync()
    # Set-up's objects leave the collector's scans, so that a full
    # collection inside the window costs what the program's own objects
    # cost, not what the imports and the harness left behind.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    rng = random.Random(seed)
    records, kept = [], {}
    start = time.perf_counter()
    deadline, i = start + seconds, 0
    while True:
        t0, t1, t2, out = drv.request(i)
        records.append((t0, t1, t2))
        if rng.random() < SAMPLE_SHARE:
            kept[i] = out
        i += 1
        if t2 >= deadline:
            break
    kept[i - 1] = out
    window_s = t2 - start

    tr = None
    if trace:
        n = cell.traffic["trace_requests"]

        def sub_window():
            for j in range(n):
                drv.request(i + j)

        tr = devtrace.record(torch, sub_window, frames=n * drv.frames_per_request,
                             passes=n * drv.passes_per_request)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    # the program's state goes before the reference runs
    inputs = {j: drv.inputs(j) for j in kept}
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    worst = 0.0
    for j in sorted(kept):
        x = inputs[j]
        want = torch.cat([net.forward(layers, params, x[r: r + REFERENCE_ROWS])
                          for r in range(0, len(x), REFERENCE_ROWS)])
        worst = max(worst, logit_err(kept[j], want))
    limit = config["limits"]["logit_err"]

    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window_s, records=records, trace=tr,
        frames_per_request=drv.frames_per_request,
        launch_batch=drv.launch_batch, layers=layers,
        itemsize=torch.empty((), dtype=dtype).element_size())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(cell.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    attempted = len(records) * drv.frames_per_request
    result = {"correct": worst <= limit, "attempted": attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checks"] = {"logit_err": {"value": worst, "limit": limit}}
    return result
