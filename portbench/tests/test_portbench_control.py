"""The control comes out not correct: the reference computed in TF32, one
precision below the configurations' float32 with TF32 off, put in the
program's place at each cell's own size, reads above the limit on three
seeds.  Needs the card (TF32 exists only there)."""
import pytest

from portbench import harness
from portbench.tests.smallcell import CELLS, MANIFEST, ROOT


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 runs only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_above_the_limit(card, name):
    cell = harness.resolve_cell(ROOT, MANIFEST, name)
    limit = cell.config["limits"]["logit_err"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        assert harness.control_reading(cell, seed, "cuda") > limit
