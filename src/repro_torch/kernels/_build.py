"""Build the port's CUDA kernels, bind them through ctypes, and hold the
checks and SAME-padding rule every kernel wrapper shares.

At first use, every ``csrc/*.cu`` is compiled for ``sm_90a`` — one nvcc
process per source, all started together — and linked into one shared
library with a plain C interface, which ``ctypes`` loads.  The library
lands in ``build/repro_torch/<hash>/`` at the root of the checkout, keyed
on a hash of the sources and flags, so an unchanged tree never rebuilds.
The ptxas report (registers, shared memory, spills per kernel) is kept
beside it as ``nvcc.log``.  A failed compile raises with nvcc's output.

The kernel modules (``fcu_matmul``, ``kpu_conv``, ``dw_conv``,
``flash_attention``, ``ssd_chunk``) import this module and none of each
other.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.core.hw import H100_SXM
from repro_torch.core.tiles import gemm_layout, gemm_smem_bytes

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu): pointers and the stream as c_void_p, ints as
# c_int, floats as c_float; each returns the cudaError_t of its launch.
SIGNATURES = {
    # x, w, y, m, d_in, d_out, bm, bk, bn, tx, ty, tm, tn, g, stream
    "fcu_matmul_f32": [_P, _P, _P] + [_I] * 11 + [_P],
    # x, w, y, n, h, w, d_in, ho, wo, d_out, kh, kw, stride, pad_t, pad_l,
    # bm, bci, bco, tx, ty, tm, tn, g, stream
    "kpu_conv_f32": [_P, _P, _P] + [_I] * 20 + [_P],
    # x, w, y, n, h, w, c, ho, wo, kh, kw, stride, pad_t, pad_l, rows, bc,
    # stream
    "dw_conv_f32": [_P, _P, _P] + [_I] * 13 + [_P],
    # q, k, v, o, batch, heads, group, sq, sk, d, block_q, block_k, causal,
    # scale, stream
    "flash_attention_f32": [_P] * 4 + [_I] * 9 + [_F, _P],
    "flash_attention_bf16": [_P] * 4 + [_I] * 9 + [_F, _P],
    # x, dt, a, b, c, y, state, batch, L, H, G, P, N, chunk, p_block, stream
    "ssd_chunk_f32": [_P] * 7 + [_I] * 8 + [_P],
}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built at first use on a machine with the CUDA "
        "toolkit"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` into the shared library (if not yet built)
    and return its path."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in sources:
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (out_dir / "nvcc.log").write_text("\n".join(logs))
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink()
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def on_card(t) -> bool:
    """A kernel wrapper's dispatch: False for a CPU tensor (the wrapper
    then runs the kernel's plain version), True for a CUDA tensor (it
    launches the kernel or raises); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel for a tensor on {t.device}")


def check_launch(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err:
        text = library().rt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({text})")


def check_operands(name: str, *ts: torch.Tensor,
                   dtypes: tuple = (torch.float32,)) -> None:
    """The kernels take contiguous tensors of one of ``dtypes``, all of
    one dtype and on one device."""
    dev = ts[0].device
    for t in ts:
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{name}: kernel takes {names}, got {t.dtype}")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: operands of {ts[0].dtype} and {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: operands on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def check_gemm_tile(name: str, bm: int, bk: int, bn: int, d_in: int,
                    d_out: int, *, conv: bool = False) -> tuple:
    """Validate a (bm, bk, bn) block tile of the FCU / KPU kernels against
    the dims and the kernels' limits; return its thread layout
    ``(tx, ty, tm, tn, g)``."""
    if bm < 1 or bk < 1 or bn < 1 or d_in % bk or d_out % bn:
        raise ValueError(
            f"{name}: tile (bm={bm}, bk={bk}, bn={bn}) must be positive and "
            f"divide (d_in={d_in}, d_out={d_out})"
        )
    layout = gemm_layout(bm, bn, bk)
    smem = gemm_smem_bytes(bm, bk, bn, conv=conv)
    if smem > H100_SXM.smem_per_block:
        raise ValueError(
            f"{name}: tile (bm={bm}, bk={bk}, bn={bn}) stages {smem} B, over "
            f"the {H100_SXM.smem_per_block} B a block may use"
        )
    return layout


def same_pads(size: int, k: int, s: int):
    """Output size and (low, high) padding of XLA's 'SAME' rule."""
    out = -(-size // s)
    total = max(0, (out - 1) * s + k - size)
    return out, (total // 2, total - total // 2)


def windows(x: torch.Tensor, kh: int, kw: int, stride: int, fill: float = 0.0):
    """SAME-pad NHWC ``x`` with ``fill`` and yield ``(dy, dx, window)``:
    the strided [N, Ho, Wo, C] view each tap reads (stride pruning)."""
    _, h, wd, _ = x.shape
    ho, (pt, pb) = same_pads(h, kh, stride)
    wo, (pl, pr) = same_pads(wd, kw, stride)
    xp = F.pad(x, (0, 0, pl, pr, pt, pb), value=fill)
    for dy in range(kh):
        for dx in range(kw):
            yield dy, dx, xp[
                :,
                dy: dy + (ho - 1) * stride + 1: stride,
                dx: dx + (wo - 1) * stride + 1: stride,
                :,
            ]
