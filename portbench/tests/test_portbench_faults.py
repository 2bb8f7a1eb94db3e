"""A run driven on the CPU past the harness's look for a card, with the
timed path sound and then broken underneath: an answer altered where it is
produced, and half of a batch left out (its rows a copy of the other
half's).  The broken runs must read ``correct`` false."""
import time

import pytest

from portbench import harness
from portbench.tests.smallcell import CELLS, small_cell


def _broken(forward, fault, limit):
    def node_forward(spec, operands, p, impls):
        y = forward(spec, operands, p, impls)
        if spec.name != "fc":
            return y
        y = y.clone()
        if fault == "answer_altered":
            y[0, 0] += 10 * limit * y[0].abs().max()
        else:
            half = len(y) // 2
            y[len(y) - half:] = y[:half]
        return y
    return node_forward


@pytest.mark.parametrize("fault", [None, "answer_altered", "half_batch_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_reads_not_correct(name, fault, monkeypatch):
    from repro_torch.models import cnn

    cell = small_cell(name)
    if fault is not None:
        limit = cell.config["limits"]["logit_err"]
        monkeypatch.setattr(cnn, "_node_forward",
                            _broken(cnn._node_forward, fault, limit))
    result = harness.run_cell(cell, seed=2 ** 31 + 11, seconds=0.3,
                              trace=False, device="cpu", t_start=time.perf_counter())
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks"
