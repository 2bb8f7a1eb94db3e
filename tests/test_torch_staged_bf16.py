"""The bf16 forward's staged run in the port, port against port: a bf16
forward decodes its links to bf16 (the reference decodes to f32 whatever
the forward's dtype), so staged equals the monolithic forward bit for bit
with fp32, int8 and bf16 links, at 32x32, 10 classes.  The other staged
checks are ``tests/test_torch_staged.py``.
"""
from fractions import Fraction as F

import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import cnn  # noqa: E402
from repro_torch.models.registry import get_cnn_api  # noqa: E402

HW = (32, 32)


def _port(family, dtype):
    pa = get_cnn_api(family, device="cpu")
    pc = pa.make_config(input_hw=HW, num_classes=10, dtype=dtype)
    params = pa.init(pc, torch.Generator().manual_seed(3))
    x = torch.randn((3, *HW, 3), generator=torch.Generator().manual_seed(4))
    return pa, pc, params, x


@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("family", ["mobilenet_v2", "resnet18"])
def test_bf16_forward_staged_equals_monolithic(family, n_stages):
    """A bf16 forward decodes its links to bf16 (the reference decodes to
    f32 whatever the forward's dtype), so it is held port against port."""
    pa, pc, params, x = _port(family, torch.bfloat16)
    gp = pa.partition(pc, F(3), n_stages)
    for link in (None, "int8", "bf16"):
        y = pa.apply_staged(params, x, pc, partition=gp, link_quant=link,
                            check_monolithic=True)
        assert y.dtype == torch.bfloat16
        emap = cnn.cut_edge_dtypes(pa.graph(pc), gp, link) if link else None
        mono = cnn.apply_graph(params, x, pa.graph(pc), dtype=torch.bfloat16,
                               link_quant=emap)
        assert torch.equal(y, mono), link
