"""The port's entry points, ``examples/<name>_torch.py``, on the CPU.

Each script's ``main(argv)`` runs in this process with ``--device cpu``
at its defaults (``train_lm_torch.py`` cut to 3 steps, then run again to
6 from the first run's checkpoint), in a temporary working directory;
each test asserts the script's closing line and the in-script checks it
prints.  Without ``--device`` a script resolves the card and raises
where CUDA is absent.  On the card ``chip_smoke.py``'s ``examples``
phase runs each one as a subprocess.
"""
import importlib
import os

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")

# script -> (the closing line's start, lines the run must print)
CLOSING = {
    "quickstart_torch": ("  OK — kernels are numerically neutral",
                         ["=== 3. PyTorch inference on cpu: plain vs KPU/FCU/DW kernels ==="]),
    "rate_sweep_torch": ("Every row is a valid continuous-flow implementation", []),
    "cnn_stream_demo_torch": ("  switch: served 200/200", []),
    "pipeline_demo_torch": ("Continuous flow at rack scale", [
        "  12 microbatches x 4 stages: max |pipeline - sequential| = 0.00e+00 "
        "(ring shift: p2p)"]),
    "fleet_demo_torch": ("  vision-b logits[0, :4] = [",
                         ["  all stall-free: True, queues bounded: True"]),
    "trace_demo_torch": ("  first drift: stage 1 drifted", ["  clean: False"]),
    "serve_lm_torch": ("[serve_lm] all requests completed", []),
    "train_lm_torch": ("[train_lm] loss ", []),
}


@pytest.fixture
def script(monkeypatch, tmp_path):
    """Import an example by name (the pipeline demo's spawned ranks import
    it again by that name), in ``tmp_path`` as the working directory."""
    monkeypatch.syspath_prepend(EXAMPLES)
    monkeypatch.chdir(tmp_path)
    return importlib.import_module


def _lines(capsys):
    return capsys.readouterr().out.rstrip("\n").splitlines()


@pytest.mark.parametrize("name", sorted(CLOSING))
def test_example_runs_on_the_cpu(script, capsys, tmp_path, name):
    mod = script(name)
    argv = ["--device", "cpu"]
    if name == "train_lm_torch":
        argv += ["--steps", "3", "--ckpt-every", "1", "--ckpt", str(tmp_path / "ckpt"),
                 "--log", str(tmp_path / "loss.json")]
    mod.main(argv)
    out = _lines(capsys)
    closing, wanted = CLOSING[name]
    assert out[-1].startswith(closing), out[-5:]
    for line in wanted:
        assert line in out, out
    if name == "cnn_stream_demo_torch":
        assert any(s.startswith("  served outputs match apply_graph: True") for s in out)
    if name == "trace_demo_torch":
        assert (tmp_path / "trace.json").stat().st_size > 0
    if name == "train_lm_torch":
        assert (tmp_path / "loss.json").exists()
        argv[argv.index("--steps") + 1] = "6"
        mod.main(argv)
        again = _lines(capsys)
        assert "[train] resumed from step 3" in again, again
        assert again[-1].startswith(closing)


def test_example_without_device_needs_cuda(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script("quickstart_torch").main([])
