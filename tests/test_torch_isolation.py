"""The port stands alone: no jax, nothing of ``repro``, no silent CPU path.

Importing every module of ``repro_torch`` and ``chip_smoke`` (which runs
nothing on import) in a fresh interpreter must leave ``jax`` and every
``repro`` module out of ``sys.modules``.  The entry point resolves its
device to the card and raises without CUDA; a kernel wrapper handed a
CUDA tensor launches its kernel or raises, and never falls back.
"""
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, dw_conv, fcu_matmul, flash_attention, kpu_conv  # noqa: E402
from repro_torch.kernels import ssd_chunk  # noqa: E402
from repro_torch.models import registry  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_repro():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.path[:0] = [{os.path.join(ROOT, 'src')!r}, {ROOT!r}]
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        import chip_smoke
        bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 15 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().endswith("[]"), out.stdout


def test_entry_point_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.get_cnn_api("mobilenet_v2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.get_cnn_api("resnet18", device="cuda")
    assert registry.get_cnn_api("resnet18", device="cpu").device.type == "cpu"


@pytest.mark.parametrize("which", ["fcu_matmul", "kpu_conv", "dw_conv",
                                   "flash_attention", "ssd_chunk"])
def test_cuda_request_without_build_raises(which, monkeypatch, tmp_path):
    """A CUDA request reaches the launch path, which needs the nvcc build:
    with no toolkit and no built library it raises, and the plain
    version is never taken (the launch counter stays put)."""
    monkeypatch.setattr(_build, "on_card", lambda t: True)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    _build.library.cache_clear()
    mod = {"fcu_matmul": fcu_matmul, "kpu_conv": kpu_conv, "dw_conv": dw_conv,
           "flash_attention": flash_attention, "ssd_chunk": ssd_chunk}[which]
    fn = getattr(mod, which)
    before = fn.launches
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            if which == "fcu_matmul":
                fn(torch.ones(4, 8), torch.ones(8, 8), bm=4, bk=8, bn=8)
            elif which == "flash_attention":
                fn(torch.ones(1, 2, 8, 16, dtype=torch.bfloat16),
                   *[torch.ones(1, 1, 8, 16, dtype=torch.bfloat16)] * 2,
                   block_q=16, block_k=16)
            elif which == "ssd_chunk":
                fn(torch.ones(1, 16, 2, 16), torch.ones(1, 16, 2), -torch.ones(2),
                   *[torch.ones(1, 16, 1, 16)] * 2, chunk=16)
            elif which == "kpu_conv":
                fn(torch.ones(1, 4, 4, 8), torch.ones(3, 3, 8, 8), stride=1,
                   bm=16, bci=8, bco=8)
            else:
                fn(torch.ones(1, 4, 4, 8), torch.ones(3, 3, 8), stride=1,
                   bm=4, bc=8)
    finally:
        _build.library.cache_clear()
    assert fn.launches == before


def test_other_devices_raise():
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for a tensor on meta"):
        fcu_matmul.fcu_matmul(x, torch.empty((8, 8), device="meta"),
                              bm=4, bk=8, bn=8)


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="float32"):
        fcu_matmul.fcu_matmul(torch.ones(4, 8, dtype=torch.float64),
                              torch.ones(8, 8, dtype=torch.float64), bm=4, bk=8, bn=8)
    with pytest.raises(ValueError, match="contiguous"):
        fcu_matmul.fcu_matmul(torch.ones(8, 4).t(), torch.ones(8, 8), bm=4, bk=8, bn=8)
    with pytest.raises(ValueError, match="divide"):
        kpu_conv.kpu_conv(torch.ones(1, 4, 4, 8), torch.ones(3, 3, 8, 8), stride=1,
                          bm=16, bci=3, bco=8)
    with pytest.raises(ValueError, match="whole output rows"):
        dw_conv.dw_conv(torch.ones(1, 4, 4, 8), torch.ones(3, 3, 8), stride=1,
                        bm=3, bc=8)
    flash = flash_attention.flash_attention
    q, kv = torch.ones(1, 4, 8, 16), torch.ones(1, 2, 8, 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash(q.half(), kv.half(), kv.half(), block_q=16, block_k=16)
    with pytest.raises(TypeError, match="operands of"):
        flash(q, kv.bfloat16(), kv.bfloat16(), block_q=16, block_k=16)
    with pytest.raises(ValueError, match="contiguous"):
        flash(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv,
              block_q=16, block_k=16)
    with pytest.raises(ValueError, match="KV heads"):
        flash(torch.ones(1, 3, 8, 16), kv, kv, block_q=16, block_k=16)
    with pytest.raises(ValueError, match="head dim"):
        flash(torch.ones(1, 4, 8, 48), *[torch.ones(1, 2, 8, 48)] * 2,
              block_q=16, block_k=16)
    with pytest.raises(ValueError, match="blocks"):
        flash(q, kv, kv, block_q=128, block_k=16)
