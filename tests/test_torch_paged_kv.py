"""The port's paged KV cache (``serving/kv_cache.py``) on the CPU: the
cases of the JAX package's ``tests/distributed/test_paged_kv.py`` on the
port, the fragmentation property under hypothesis, and one sequence of
alloc / extend / write / gather / free run on both packages: the same
block tables, free counts and gathered values, bit for bit;
``capacity_for`` equal to the reference's."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax").numpy

from repro.serving import kv_cache as ref_kv  # noqa: E402
from repro_torch.serving.kv_cache import PagedKVCache, PagedKVConfig, capacity_for  # noqa: E402


def _cache(n_blocks=16, block_size=4, dtype="float32"):
    return PagedKVCache(PagedKVConfig(n_blocks=n_blocks, block_size=block_size, n_layers=2,
                                      n_kv=2, head_dim=8, dtype=dtype), device="cpu")


def test_storage_is_block_major_on_the_given_device():
    c = _cache(dtype="bfloat16")
    assert c.k.shape == c.v.shape == (16, 2, 4, 2, 8)
    assert c.k.dtype == torch.bfloat16 and c.k.device.type == "cpu"


def test_alloc_extend_free_roundtrip():
    c = _cache()
    c.allocate(1, 6)                 # 2 blocks
    assert c.free_blocks == 14
    assert len(c.table(1)) == 2
    assert c.extend(1) is None       # within the partial block
    assert c.extend(1) is None       # len 8 = exactly 2 blocks
    assert c.extend(1) is not None   # len 9 -> 3rd block
    assert c.free_blocks == 13
    c.free(1)
    assert c.free_blocks == 16


def test_admission_is_capacity_bound():
    c = _cache(n_blocks=4, block_size=4)
    assert c.can_admit(16)
    assert not c.can_admit(17)
    c.allocate(1, 12)
    assert c.can_admit(4) and not c.can_admit(5)
    with pytest.raises(MemoryError):
        c.allocate(2, 8)
    c.allocate(3, 4)
    with pytest.raises(MemoryError, match="pool exhausted"):
        c.extend(3, 1)


@given(lengths=st.lists(st.integers(min_value=1, max_value=30), min_size=1, max_size=8))
@settings(max_examples=30, deadline=None)
def test_fragmentation_bounded(lengths):
    c = _cache(n_blocks=128, block_size=4)
    for i, n in enumerate(lengths):
        c.allocate(i, n)
    frag = c.fragmentation()
    alloc = sum(len(c.table(i)) for i in range(len(lengths))) * 4
    assert frag * alloc < len(lengths) * 4          # waste < 1 block a sequence
    owned = [b for i in range(len(lengths)) for b in c.table(i)]
    assert len(owned) == len(set(owned))           # no block leaked or shared
    assert len(owned) + c.free_blocks == 128


def test_write_gather_roundtrip():
    c = _cache()
    c.allocate(7, 6)
    toks = []
    for pos in range(6):
        k = torch.full((2, 2, 8), float(pos + 1))
        c.write_token(7, (k, -k), pos)
        toks.append(float(pos + 1))
    k, v = c.gather_kv(7)
    assert k.shape == (2, 6, 2, 8)
    np.testing.assert_array_equal(k[0, :, 0, 0].numpy(), toks)
    assert torch.equal(v, -k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_tables_and_values_as_the_reference(dtype):
    """Three sequences allocated, grown token by token across block
    boundaries, one freed and its blocks reused: every table and free
    count equal the reference's, and every gather equals it bit for bit
    (bf16 rounding included)."""
    kw = dict(n_blocks=12, block_size=4, n_layers=3, n_kv=2, head_dim=8, dtype=dtype)
    ref, port = ref_kv.PagedKVCache(ref_kv.PagedKVConfig(**kw)), \
        PagedKVCache(PagedKVConfig(**kw), device="cpu")
    rng = np.random.default_rng(0)
    lengths = {}

    def both(name, *args):
        a, b = getattr(ref, name)(*args), getattr(port, name)(*args)
        assert a == b, name

    def write(seq, pos):
        k = rng.standard_normal((3, 2, 8)).astype(np.float32)
        v = rng.standard_normal((3, 2, 8)).astype(np.float32)
        ref.write_token(seq, (jnp.asarray(k), jnp.asarray(v)), pos)
        port.write_token(seq, (torch.from_numpy(k), torch.from_numpy(v)), pos)

    for seq, n in ((1, 5), (2, 3), (3, 9)):
        both("allocate", seq, n)
        lengths[seq] = n
        for pos in range(n):
            write(seq, pos)
    for _ in range(4):
        for seq in (1, 2, 3):
            both("extend", seq, 1)
            write(seq, lengths[seq])
            lengths[seq] += 1
    both("free", 2)
    both("allocate", 4, 7)
    for pos in range(7):
        write(4, pos)
    for seq in (1, 3, 4):
        assert ref.table(seq) == port.table(seq)
        assert ref.length(seq) == port.length(seq)
        for want, got in zip(ref.gather_kv(seq), port.gather_kv(seq)):
            want = np.asarray(want.astype(jnp.float32))
            np.testing.assert_array_equal(got.float().numpy(), want)
    assert ref.free_blocks == port.free_blocks
    assert ref.fragmentation() == port.fragmentation()


@pytest.mark.parametrize("rate,residency,block", [(1000, 2.0, 16), (37.5, 0.3, 4),
                                                  (0.0, 5.0, 16), (1e6, 0.25, 128)])
def test_capacity_sizing_equals_the_references(rate, residency, block):
    assert capacity_for(rate, residency, block) == ref_kv.capacity_for(rate, residency, block)
    assert capacity_for(1000, 2.0, 16) == 157
