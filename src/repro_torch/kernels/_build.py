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
from torch.distributed.tensor import DTensor

from repro_torch.tree import records_grad

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points (csrc/*.cu): pointers and the stream as c_void_p, ints as
# c_int, floats as c_float, int out-parameters as int*; each returns the
# cudaError_t of its launch.
SIGNATURES = {
    # x, w, y, m, d_in, d_out, bm, bk, bn, split (0: the rule), stream
    "fcu_matmul_f32": [_P, _P, _P] + [_I] * 7 + [_P],
    "fcu_matmul_bf16": [_P, _P, _P] + [_I] * 7 + [_P],
    # x, w, y, n, h, w, d_in, ho, wo, d_out, kh, kw, stride, pad_t, pad_l,
    # bm, bci, bco, split (0: the rule), the plan's pixel and column tiles
    # a block (0: the rule), int[2] <- the two the launch took, stream
    "kpu_conv_f32": [_P, _P, _P] + [_I] * 18 + [_IP, _P],
    "kpu_conv_bf16": [_P, _P, _P] + [_I] * 18 + [_IP, _P],
    # n, h, w, d_in, ho, wo, d_out, kh, kw, bm, bk, bn, element bytes, KPU
    # (1) or FCU (0), int[3] <- the rule's split, pixel and column tiles a
    # block -> 1, or 0 for a tile the kernels do not take
    "mma_plan": [_I] * 14 + [_IP],
    # x, w, y, n, h, w, c, ho, wo, kh, kw, stride, pad_t, pad_l, rows, bc,
    # stream
    "dw_conv_f32": [_P, _P, _P] + [_I] * 13 + [_P],
    "dw_conv_bf16": [_P, _P, _P] + [_I] * 13 + [_P],
    # q, k, v, o, batch, heads, group, sq, sk, d, block_q, block_k, causal,
    # scale, stream
    "flash_attention_f32": [_P] * 4 + [_I] * 9 + [_F, _P],
    "flash_attention_bf16": [_P] * 4 + [_I] * 9 + [_F, _P],
    # x, dt, a (f32), b, c, y, state, workspace, batch, L, H, G, P, N,
    # chunk, head_run, stream
    "ssd_chunk_f32": [_P] * 8 + [_I] * 8 + [_P],
    "ssd_chunk_bf16": [_P] * 8 + [_I] * 8 + [_P],
}
# The element types the FCU, KPU, depthwise and SSD kernels take, and the
# suffix of each one's C entry point.
FLOATS = (torch.float32, torch.bfloat16)
SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def mma_plan(n: int, h: int, wd: int, d_in: int, ho: int, wo: int, d_out: int,
             kh: int, kw: int, bm: int, bk: int, bn: int, elem: int, kpu: bool
             ) -> tuple[int, int, int]:
    """The FCU / KPU kernels' own host plan (``tile_mma.cuh::plan_tile``)
    of the (bm, bk, bn) tile of a call on the current card for
    ``elem``-byte elements: (blocks a tile along a cluster, the plan's
    pixel tiles a block, its column tiles a block); (0, 0, 0) for a tile
    the kernels do not take."""
    plan = (ctypes.c_int * 3)()
    if not library().mma_plan(n, h, wd, d_in, ho, wo, d_out, kh, kw, bm, bk, bn, elem,
                              int(kpu), plan):
        return 0, 0, 0
    return plan[0], plan[1], plan[2]


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, for a
    launch, through torch's C getter: a fraction of
    ``torch.cuda.current_stream``'s host cost, which matters for launches
    of a few µs."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


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
    one dtype and on one device.  No kernel has a backward: a call that
    autograd would record raises, on the CPU as on the card, where a
    launch into a fresh tensor would return an output with no
    ``grad_fn`` and lose the gradient without an error.  Nor does a
    kernel take a DTensor: its ``data_ptr`` is one rank's shard, so a
    mesh route hands the kernel ``to_local()`` shards itself."""
    for t in ts:
        if isinstance(t, DTensor):
            raise TypeError(f"{name}: a DTensor operand; a mesh route passes the "
                            "kernel its local shard (to_local())")
    if records_grad(*ts):
        raise RuntimeError(
            f"{name}: the kernel has no backward, and an operand requires grad "
            "with grad enabled; differentiate through the plain route "
            "(nn.attention / nn.ssm take it under autograd) or call under "
            "torch.no_grad()"
        )
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


def check_mma_tile(name: str, bm: int, bk: int, bn: int, d_in: int,
                   d_out: int) -> None:
    """Validate a (bm, bk, bn) block tile of the FCU / KPU kernels
    (``csrc/tile_mma.cuh``) against the dims and the kernels' limits:
    bm <= 512 rows in 64-row wgmma atoms, bn <= 256 padded to a power of
    two of at least 8, and at most 128 f32 accumulators a consumer thread
    beside one consumer warpgroup (bm <= 64), 64 beside two."""
    if bm < 1 or bk < 1 or bn < 1 or d_in % bk or d_out % bn:
        raise ValueError(
            f"{name}: tile (bm={bm}, bk={bk}, bn={bn}) must be positive and "
            f"divide (d_in={d_in}, d_out={d_out})"
        )
    atoms = 1 if bm <= 64 else 2 if bm <= 128 else 4 if bm <= 256 else 8
    width = max(8, 1 << (bn - 1).bit_length())
    per_thread = (atoms if atoms == 1 else atoms // 2) * width // 2
    if bm > 512 or bn > 256 or per_thread > (128 if atoms == 1 else 64):
        raise ValueError(
            f"{name}: tile (bm={bm}, bn={bn}) is past the kernel's block: "
            f"bm <= 512, bn <= 256, {per_thread} accumulators a thread"
        )


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
