"""The port's training substrate on the CPU: the data streams against the
JAX package's, bit for bit, and their resume; the checkpointer (round
trip with bf16 leaves, GC, a non-blocking save's snapshot, atomicity,
async errors, shape checks); the straggler watchdog and the heartbeat
(the cases of the JAX package's ``tests/distributed/test_substrate.py``);
and the preemption drill:
``train_loop`` stopped after a checkpoint and started again gives the
uninterrupted run's losses and params bit for bit."""
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.configs.registry import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import (PackedFileDataset, SyntheticLM,  # noqa: E402
                                       write_packed_file)
from repro_torch.distributed.fault_tolerance import Heartbeat, StragglerWatchdog  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_synthetic_stream_is_the_references(shard):
    kw = dict(vocab=97, seq_len=8, batch=3, seed=7, shard_id=shard[0], num_shards=shard[1])
    ref, port = ref_pipeline.SyntheticLM(**kw), SyntheticLM(**kw)
    for _ in range(4):
        a, b = next(ref), next(port)
        for k in ("tokens", "labels"):
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k])
    assert port.state_dict() == ref.state_dict()


def test_synthetic_resumes_from_state_dict():
    a = SyntheticLM(vocab=64, seq_len=8, batch=2, seed=7)
    b1 = next(a)
    next(a)
    st = a.state_dict()
    b3 = next(a)
    fresh = SyntheticLM(vocab=64, seq_len=8, batch=2, seed=7)
    fresh.load_state_dict(st)
    np.testing.assert_array_equal(next(fresh)["tokens"], b3["tokens"])
    np.testing.assert_array_equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    s0 = SyntheticLM(vocab=64, seq_len=8, batch=2, seed=7, shard_id=0, num_shards=2)
    s1 = SyntheticLM(vocab=64, seq_len=8, batch=2, seed=7, shard_id=1, num_shards=2)
    assert not np.array_equal(next(s0)["tokens"], next(s1)["tokens"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticLM(vocab=64, seq_len=8, batch=2, seed=8).load_state_dict(st)


@pytest.mark.parametrize("vocab", [97, 70000])
def test_packed_file_stream_is_the_references(tmp_path, vocab):
    toks = (np.arange(9 * 23, dtype=np.int64) * 7919) % vocab
    path = str(tmp_path / "toks.bin")
    write_packed_file(path, toks, vocab=vocab)
    ref_path = str(tmp_path / "ref.bin")
    ref_pipeline.write_packed_file(ref_path, toks, vocab=vocab)
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    kw = dict(path=path, vocab=vocab, seq_len=8, batch=2, seed=3, shard_id=1, num_shards=2)
    ref, port = ref_pipeline.PackedFileDataset(**kw), PackedFileDataset(**kw)
    for _ in range(7):                                   # past an epoch
        a, b = next(ref), next(port)
        np.testing.assert_array_equal(b["tokens"], a["tokens"])
        np.testing.assert_array_equal(b["labels"], a["labels"])
    st = port.state_dict()
    want = next(port)
    again = PackedFileDataset(**kw)
    again.load_state_dict(st)
    np.testing.assert_array_equal(next(again)["tokens"], want["tokens"])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "n": {"b": torch.ones(4), "h": torch.linspace(-3, 3, 7).to(torch.bfloat16)},
            "layers": [{"w": torch.full((2,), 2.0)}, {"w": torch.full((2,), -1.5)}],
            "step": torch.tensor(3, dtype=torch.int32)}


def _scaled(tree, s):
    return {"a": tree["a"] * s, "n": {"b": tree["n"]["b"] * s, "h": tree["n"]["h"] * s},
            "layers": [{"w": layer["w"] * s} for layer in tree["layers"]],
            "step": tree["step"] * s}


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        ck.save(step, _scaled(tree, step), extra={"data": {"step": step}})
    ck.wait()
    assert ck.latest_step() == 3
    restored, extra = ck.restore(None, tree)
    want = _scaled(tree, 3)
    for got, w in zip(leaves(restored), leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w)
    assert restored["n"]["h"].dtype == torch.bfloat16
    assert extra["data"]["step"] == 3
    assert sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*")) == [2, 3]
    meta = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert meta["dtypes"] == {"n/h": "bfloat16"} and "layers/1/w" in meta["keys"]
    older, _ = ck.restore(2, tree)
    assert torch.equal(older["a"], tree["a"] * 2)


def test_nonblocking_save_snapshots_the_tree(tmp_path, monkeypatch):
    """A non-blocking save keeps the values the tree held at the call: the
    writer thread is held until the tree has been updated in place, as
    the next train step updates params and moments, and the restore
    still gives the saved values, ``AdamWState`` and its factored
    (row, col) pair included."""
    written = np.savez
    updated = threading.Event()

    def savez_after_update(*args, **kwargs):
        assert updated.wait(timeout=30)
        return written(*args, **kwargs)

    monkeypatch.setattr(np, "savez", savez_after_update)
    tree = _tree()
    tree["opt"] = opt.AdamWState(step=torch.tensor(2, dtype=torch.int32),
                                 mu={"w": torch.ones(2, 3)},
                                 nu={"w": (torch.ones(2), torch.ones(3))})
    want = [t.clone() for t in leaves(tree)]
    ck = Checkpointer(str(tmp_path))
    ck.save(1, tree)
    with torch.no_grad():
        for t in leaves(tree):
            t.add_(1)
    updated.set()
    ck.wait()
    restored, _ = ck.restore(1, tree)
    assert isinstance(restored["opt"], opt.AdamWState)
    assert isinstance(restored["opt"].nu["w"], tuple)
    for got, w in zip(leaves(restored), want):
        assert got.dtype == w.dtype and torch.equal(got, w)


def test_restore_takes_the_likes_dtypes_and_checks_shapes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.linspace(0, 1, 5)}, blocking=True)
    got, _ = ck.restore(1, {"w": torch.zeros(5, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], torch.linspace(0, 1, 5).to(torch.bfloat16))
    with pytest.raises(ValueError, match="checkpoint shape"):
        ck.restore(1, {"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(None, {"w": torch.zeros(5)})


def test_checkpoint_atomicity_partial_write(tmp_path):
    """A leftover .tmp dir (a crash mid-write) is never visible, not even
    when its step is the highest."""
    ck = Checkpointer(str(tmp_path))
    (tmp_path / "step_9.tmp").mkdir()
    (tmp_path / "step_9.tmp" / "manifest.json").write_text("{}")
    ck.save(1, {"a": torch.ones(2)}, blocking=True)
    assert ck.latest_step() == 1
    got, _ = ck.restore(None, {"a": torch.zeros(2)})
    assert torch.equal(got["a"], torch.ones(2))


def test_async_write_errors_surface_at_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"a": torch.ones(2)}, extra={"bad": object()})     # not JSON
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        ck.wait()
    assert ck.latest_step() is None
    ck.wait()                                          # the error is raised once


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

def test_straggler_watchdog():
    wd = StragglerWatchdog(threshold=1.5, patience=3)
    fired = False
    for step in range(20):
        t = 1.0 if step < 10 else 2.5      # node goes bad at step 10
        fired = wd.observe(step, t)
        if fired:
            break
    assert fired and step == 12
    assert wd.flagged_steps == [10, 11, 12]


def test_watchdog_tolerates_single_hiccup():
    wd = StragglerWatchdog(threshold=1.5, patience=3)
    for step in range(20):
        assert not wd.observe(step, 3.0 if step == 7 else 1.0)


def test_heartbeat(tmp_path):
    hb = Heartbeat(str(tmp_path / "hb.json"), stale_after=0.05)
    assert hb.last() is None and not hb.is_stale()
    hb.beat(4)
    assert hb.last()["step"] == 4 and not hb.is_stale()
    time.sleep(0.1)
    assert hb.is_stale()


# ---------------------------------------------------------------------------
# the preemption drill
# ---------------------------------------------------------------------------

class Preempted(Exception):
    pass


def test_preemption_drill(tmp_path):
    """``train_loop`` on a 2-layer qwen2-style model: stopped during step
    6 (after the checkpoint of step 4), then started again on the same
    directory, it resumes at step 4 with the data stream's position and
    gives the uninterrupted run's last 4 losses and final params bit for
    bit."""
    cfg = reduced(get_config("qwen2-7b"), layers=2, d_model=32, vocab=128)
    kw = dict(steps=8, batch=2, seq_len=16, lr=1e-3, ckpt_every=4, log_every=100,
              device="cpu")
    straight = train.train_loop(cfg, ckpt_dir=str(tmp_path / "a"), **kw)

    def stop(step, metrics):
        if step == 5:
            raise Preempted

    with pytest.raises(Preempted):
        train.train_loop(cfg, ckpt_dir=str(tmp_path / "b"), on_metrics=stop, **kw)
    assert Checkpointer(str(tmp_path / "b")).latest_step() == 4
    resumed = train.train_loop(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert len(resumed["losses"]) == 4
    assert resumed["losses"] == straight["losses"][4:]
    for a, b in zip(leaves(resumed["params"]), leaves(straight["params"])):
        assert torch.equal(a, b)
    assert json.loads((tmp_path / "b" / "heartbeat.json").read_text())["step"] == 7
