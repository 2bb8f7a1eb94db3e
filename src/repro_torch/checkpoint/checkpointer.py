"""Fault-tolerant checkpointing; the port's copy of the JAX package's
``checkpoint/checkpointer.py``, with the same layout and guarantees.

  * **Atomicity** — writes go to ``step_N.tmp/`` and are renamed into
    place; a crash mid-write can never corrupt the latest checkpoint.
  * **Async** — tensors are fetched to the host synchronously, then
    written on a background thread; the next ``save`` or ``wait`` joins it
    (double-buffering), and an error in the writer is raised there.
  * **Self-describing** — ``manifest.json`` records the step, the leaves'
    keys (their paths in the tree), the dtype of every bf16 leaf and the
    caller's ``extra`` (the data stream's position rides along, so a
    restart resumes the exact stream).
  * **GC** — only the ``keep`` newest steps stay.

Trees are the port's: dicts, lists and tuples (``NamedTuple`` included,
as ``optim.AdamWState``) of tensors.  numpy has no bfloat16, so a bf16
leaf is stored as its ``uint16`` bits and its dtype in the manifest.
``restore(step, like)`` gives tensors of ``like``'s dtypes on ``like``'s
devices and raises on a shape mismatch.

**Sharded trees.**  Checkpoints are topology-agnostic: ``save`` gathers a
DTensor leaf whole (``full_tensor``, a collective every rank of its mesh
joins by calling ``save``) and only global rank 0 writes; the caller
waits for the write (``wait``, then a barrier) before other ranks
restore.  ``restore(..., shardings=)`` places every leaf on its
sharding's mesh and placements — the elastic re-mesh path, onto any mesh
shape.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.tree import leaves, leaves_with_paths, unflatten


def _to_host(t) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a numpy array of its own, and its dtype's name where numpy
    has none.  The copy is a snapshot: on the CPU ``.cpu()`` would share
    the leaf's storage, and the next train step updates params and
    moments in place while the writer thread still reads them."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _from_host(arr: np.ndarray, dtype_name: Optional[str]) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``.  Non-blocking by default: the
        tensors are fetched to the host here, then written on a daemon
        thread (by global rank 0 alone when the tree holds DTensors)."""
        self.wait()                       # double-buffer: previous save done
        sharded = any(isinstance(v, DTensor) for v in leaves(tree))
        writes = not sharded or dist.get_rank() == 0
        host, dtypes = {}, {}
        for k, v in leaves_with_paths(tree):
            if isinstance(v, DTensor):
                v = v.full_tensor()       # every rank joins the gather
            if writes:                    # and only the writer keeps a host copy
                host[k], name = _to_host(v)
                if name:
                    dtypes[k] = name
        if not writes:
            return
        meta = {"step": step, "keys": sorted(host), "dtypes": dtypes,
                "extra": extra or {}}

        def _write():
            try:
                tmp = self.dir / f"step_{step}.tmp"
                final = self.dir / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                np.savez(tmp / "arrays.npz",
                         **{k.replace("/", "|"): v for k, v in host.items()})
                (tmp / "manifest.json").write_text(json.dumps(meta))
                if final.exists():
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:            # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}")

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if p.is_dir() and not p.name.endswith(".tmp")]
        return max(steps) if steps else None

    def restore(self, step: Optional[int], like: Any, *,
                shardings: Any = None) -> Tuple[Any, dict]:
        """Restore into the structure of ``like``: each leaf in ``like``'s
        leaf's dtype, on its device, or with ``shardings`` (a tree of
        ``NamedSharding`` of the same structure) a DTensor on its
        sharding's mesh and placements.  ``step=None`` takes the
        latest."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step}"
        meta = json.loads((path / "manifest.json").read_text())
        dtypes = meta["dtypes"]
        restored = []
        places = leaves(shardings) if shardings is not None else None
        with np.load(path / "arrays.npz") as data:
            for i, (key, ref) in enumerate(leaves_with_paths(like)):
                arr = data[key.replace("/", "|")]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"{key}: checkpoint shape {arr.shape} != {tuple(ref.shape)}")
                t = _from_host(arr, dtypes.get(key))
                if places is None:
                    restored.append(t.to(ref.device, ref.dtype))
                else:
                    s = places[i]
                    restored.append(distribute_tensor(
                        t.to(s.mesh.device_type, ref.dtype), s.mesh, s.placements))
        return unflatten(like, restored), meta["extra"]

    # ------------------------------------------------------------------
    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
