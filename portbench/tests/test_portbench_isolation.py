"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program: each checked in a fresh process,
by top-level module names compared whole (``repro_torch`` begins with
``repro``)."""
import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.smallcell import CELLS, ROOT

CELL = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
from portbench import harness
from portbench.tests.smallcell import small_cell
for trace in (False, True):
    harness.run_cell(small_cell({name!r}), seed=5, seconds=0.2, trace=trace,
                     device="cpu", t_start=time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from portbench import harness
from portbench.reference import net
for name in ("resnet18", "mobilenet_v2"):
    config = json.loads(open({root!r} + f"/portbench/configs/{{name}}.json").read())
    config["input_hw"] = [32, 32]
    layers = harness.layers_of({root!r}, config)
    params = harness.make_weights(torch, layers, torch.Generator().manual_seed(1),
                                  "cpu", torch.float32)
    net.forward(layers, params, torch.randn(2, 32, 32, 3))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(script):
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_loads_no_jax(name):
    mods = _modules(CELL.format(src=str(ROOT / "src"), root=str(ROOT), name=name))
    assert "repro_torch" in mods
    assert not mods & set(harness.FOREIGN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(REFERENCE.format(root=str(ROOT)))
    assert "torch" in mods
    assert not mods & {"repro_torch", *harness.FOREIGN}
