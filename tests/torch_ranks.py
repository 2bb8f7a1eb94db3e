"""Run checks on K ranks of a ``torch.distributed`` world, for the port's
multi-rank tests (not a test module itself).

``run_ranks(world, checks, tmp_path)`` spawns ``world`` processes, joins
them in one process group over a ``FileStore`` under ``tmp_path`` (no
fixed port: xdist runs several files at once), runs every check of
``checks`` (``{name: fn(rank, world)}``, module-level functions) in each
rank in order, and returns ``{name: [result of rank 0, ...]}``.  A check
that raises gives ``CheckFailed`` with its traceback in the results, so
each test asserts its own check.  The ranks use the ``gloo`` backend,
their collectives time out, and the whole run is killed past
``deadline`` seconds.  ``TORCH_RANKS_DIR`` names a directory the ranks
share.
"""
import datetime
import os
import pickle
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class CheckFailed:
    def __init__(self, text: str):
        self.text = text

    def __repr__(self) -> str:
        return f"CheckFailed({self.text})"


def _rank_main(rank, world, store_path, out_dir, checks, device):
    torch.set_num_threads(1)
    os.environ["TORCH_RANKS_DIR"] = out_dir        # a directory the checks share
    if device == "cuda":
        torch.cuda.set_device(0)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    results = {}
    try:
        for name, fn in checks.items():
            try:
                results[name] = fn(rank, world)
            except Exception:
                results[name] = CheckFailed(traceback.format_exc())
                break                    # the other ranks may be inside a collective
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        dist.destroy_process_group()


def run_ranks(world: int, checks: dict, tmp_path, *, device: str = "cpu",
              deadline: float = 300.0) -> dict:
    out_dir = str(tmp_path)
    store_path = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_rank_main, args=(world, store_path, out_dir, checks, device),
                             nprocs=world, join=False, start_method="spawn")
    try:
        import time
        end = time.monotonic() + deadline
        while not ctx.join(timeout=max(1.0, end - time.monotonic())):
            if time.monotonic() > end:
                raise TimeoutError(f"{world} ranks still running after {deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = {name: [] for name in checks}
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            got = pickle.load(f)
        for name in checks:
            out[name].append(got.get(name, CheckFailed("not run: an earlier check failed")))
    return out


def result(results: dict, name: str) -> list:
    """The per-rank results of one check; fails the test with the first
    rank's traceback if a rank raised."""
    per_rank = results[name]
    for r, got in enumerate(per_rank):
        if isinstance(got, CheckFailed):
            raise AssertionError(f"rank {r}: {got.text}")
    return per_rank
