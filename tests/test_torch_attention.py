"""The port's attention kernel module and LM layers against the JAX package.

The same numpy inputs go through the JAX function (its Pallas flash
kernel in interpret mode, as ``tests/kernels/test_flash_attention.py``
runs it) and the port's counterpart on the CPU, where the kernel wrapper
runs its plain PyTorch version.  fp32 throughout, at the
``reduced(qwen2-7b, layers=2, d_model=64, vocab=128)`` size (4 heads on 2
KV heads, head_dim 16); the flash kernel is held at the reference kernel
test's 2e-5, the layers at 1e-4 of their output's scale (the two sides
sum in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.attention import attention_ref, flash_attention as ref_flash  # noqa: E402
from repro.nn import attention as ref_attn  # noqa: E402
from repro.nn.embeddings import rope as ref_rope  # noqa: E402
from repro.nn.embeddings import unembed as ref_unembed  # noqa: E402
from repro.nn.layers import apply_dense as ref_apply_dense  # noqa: E402
from repro.nn.layers import ffn as ref_ffn  # noqa: E402
from repro.nn.norms import layer_norm as ref_layer_norm  # noqa: E402
from repro.nn.norms import rms_norm as ref_rms_norm  # noqa: E402
from repro_torch.core.hw import H100_SXM  # noqa: E402
from repro_torch.core.tiles import TileChoice  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BLOCKS, attention_impl, fits, flash_attention, flash_blocks)
from repro_torch.nn import attention as port_attn  # noqa: E402
from repro_torch.nn.embeddings import rope, unembed  # noqa: E402
from repro_torch.nn.layers import apply_dense, ffn  # noqa: E402
from repro_torch.nn.norms import layer_norm, rms_norm  # noqa: E402

FLASH_TOL = 2e-5
TOL = 1e-4
H, HKV, DH, D_MODEL = 4, 2, 16, 64


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# -- the flash kernel module -------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [64, 128, 256])
def test_flash_matches_jax_flash(s, d, causal):
    q, k, v = (_rand(i, 2, 2, s, d) for i in range(3))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=64, block_k=64)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                     block_q=64, block_k=64)
    _close(got, want, FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_grouped_kv_matches_jax_on_repeated_kv(causal):
    """group = 2: query head h reads KV head h // 2, as JAX's flash kernel
    does on KV repeated per group."""
    q, k, v = _rand(3, 1, 4, 128, 32), _rand(4, 1, 2, 128, 32), _rand(5, 1, 2, 128, 32)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=32, block_k=64)
    rep = [jnp.repeat(jnp.asarray(a), 2, axis=1) for a in (k, v)]
    want = ref_flash(jnp.asarray(q), *rep, causal=causal, block_q=64, block_k=64)
    _close(got, want, FLASH_TOL)


@pytest.mark.parametrize("s,sk,causal", [(100, 100, True), (37, 37, False),
                                         (9, 9, True), (48, 200, False)])
def test_flash_ragged_lengths_match_attention_ref(s, sk, causal):
    """Lengths no block divides (which JAX's flash kernel refuses)."""
    q, k, v = _rand(6, 1, 4, s, 16), _rand(7, 1, 2, sk, 16), _rand(8, 1, 2, sk, 16)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, block_q=64, block_k=64)
    rep = [np.repeat(a, 2, axis=1).reshape(4, sk, 16) for a in (k, v)]
    want = attention_ref(jnp.asarray(q.reshape(4, s, 16)), *map(jnp.asarray, rep),
                         causal=causal).reshape(1, 4, s, 16)
    _close(got, want, FLASH_TOL)


def test_attention_impl_tile_record_protocol():
    """The adapter shares the CNN adapters' tile/record protocol: a
    TileChoice pins (block_q, block_k) and the executed blocking is
    reported through the record callback."""
    q, k, v = (_t(_rand(9 + i, 1, 2, 64, 32)) for i in range(3))
    tile = TileChoice(bm=32, bk=64, bn=1, smem_bytes=0, acc_per_thread=0)
    seen = {}
    got = attention_impl(causal=True, tile=tile, record=lambda **kw: seen.update(kw))(q, k, v)
    want = flash_attention(q, k, v, causal=True, block_q=32, block_k=64)
    assert seen == {"block_q": 32, "block_k": 64, "seq": 64}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq", [(28, 512), (28, 2048), (28, 100), (1, 9), (8, 64)])
def test_flash_blocks_fill_the_card(bh, sq, dtype):
    blocks = BLOCKS[dtype]
    block_q, block_k = flash_blocks(bh, sq, dtype, 128)
    assert block_q in blocks and block_k == max(blocks)
    # the widest query tile that still gives every SM a block
    wider = [b for b in blocks if b > block_q]
    assert all(bh * -(-sq // b) < H100_SXM.sms for b in wider)
    assert block_q == blocks[0] or bh * -(-sq // block_q) >= H100_SXM.sms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq", [(4, 2048), (4, 512), (1, 9)])
def test_flash_blocks_fit_shared_memory_at_head_dim_256(bh, sq, dtype):
    """At d = 256 the bf16 kernel's two stages of 128 keys (256 KiB) do not
    fit a block's 227 KiB: block_k 64, and the wrapper refuses 128 before
    any launch; every f32 pair fits."""
    block_q, block_k = flash_blocks(bh, sq, dtype, 256)
    assert fits(dtype, 256, block_q, block_k)
    assert block_k == (64 if dtype == torch.bfloat16 else max(BLOCKS[dtype]))
    assert all(fits(torch.float32, 256, a, b) for a in BLOCKS[torch.float32]
               for b in BLOCKS[torch.float32])
    q = torch.zeros(1, 2, 8, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        flash_attention(q, q, q, block_q=64, block_k=128)
    got = flash_attention(q, q, q, block_q=64, block_k=64)
    assert got.shape == q.shape


def _split_p_flash(q, k, v, *, causal, block_k=128, terms=2):
    """The bf16 kernel's arithmetic in plain PyTorch: f32 scores of bf16 q
    and k (exact products, f32 sums), online softmax over ``block_k``-key
    tiles, and P against bf16 v as ``p_hi + p_lo`` (``terms=2``) or one
    bf16 rounding of p (``terms=1``), into an f32 accumulator."""
    group = q.shape[1] // k.shape[1]
    k, v = (a.repeat_interleave(group, dim=1).float() for a in (k, v))
    q = q.float()
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    m = torch.full((*q.shape[:3], 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        kt, vt = k[:, :, k0:k0 + block_k], v[:, :, k0:k0 + block_k]
        s = torch.matmul(q, kt.transpose(-1, -2)) * (1.0 / d ** 0.5)
        if causal:
            s = torch.where(torch.arange(k0, k0 + kt.shape[2])[None, :] > rows, -1e30, s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = torch.matmul(p_hi, vt)
        if terms == 2:
            pv = pv + torch.matmul((p - p_hi).bfloat16().float(), vt)
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


def test_split_p_keeps_the_reference_within_the_bf16_gate():
    """P in two bf16 terms (the wgmma kernel's design) holds every element
    within 2^-7 |plain| + 1e-4 of ``flash_attention_plain`` at a reduced
    qwen2 shape (group 7, d 128); one bf16 rounding of P, as SDPA and
    FlashAttention do, leaves that limit on the same mixed-sign v."""
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, h, 300, 128)).astype(np.float32))
               .bfloat16() for h in (7, 1, 1))
    assert bool((v < 0).any()) and bool((v > 0).any())
    want = flash_attention(q, k, v, causal=True, block_q=64, block_k=128).float()
    limit = 2.0 ** -7 * want.abs() + 1e-4

    def worst(terms):
        got = _split_p_flash(q, k, v, causal=True, terms=terms).float()
        return ((got - want).abs() / limit).max().item()

    assert worst(2) <= 1.0
    assert worst(1) > 1.0


# -- layers -------------------------------------------------------------------

@pytest.mark.parametrize("zero_centered", [False, True])
def test_rms_norm_matches_jax(zero_centered):
    x, g = _rand(20, 2, 5, D_MODEL, scale=3.0), _rand(21, D_MODEL)
    got = rms_norm(_t(x), _t(g), eps=1e-6, zero_centered=zero_centered)
    want = ref_rms_norm(jnp.asarray(x), jnp.asarray(g), eps=1e-6,
                        zero_centered=zero_centered)
    _close(got, want)


def test_layer_norm_matches_jax():
    x, g, b = _rand(27, 2, 5, D_MODEL, scale=3.0), _rand(28, D_MODEL), _rand(29, D_MODEL)
    _close(layer_norm(_t(x), _t(g), _t(b)),
           ref_layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))


@pytest.mark.parametrize("bias", [False, True])
def test_apply_dense_matches_jax(bias):
    p = {"w": _rand(36, D_MODEL, 32, scale=0.2)}
    if bias:
        p["b"] = _rand(37, 32)
    x = _rand(38, 3, D_MODEL)
    _close(apply_dense({n: _t(a) for n, a in p.items()}, _t(x)),
           ref_apply_dense({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("rotary_dim", [None, 8])
def test_rope_matches_jax(rotary_dim):
    x = _rand(22, 2, 9, H, DH)
    pos = np.stack([np.arange(9), np.arange(40, 49)]).astype(np.int32)
    got = rope(_t(x), torch.from_numpy(pos), theta=1e6, rotary_dim=rotary_dim)
    want = ref_rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6, rotary_dim=rotary_dim)
    _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unembed_matches_jax(dtype):
    """f32 logits from the storage dtype; a bf16 table on the CPU is turned
    into f32 by vocabulary chunks (9000 rows: two chunks)."""
    table = _t(_rand(24, 9000, D_MODEL, scale=0.02)).to(dtype)
    x = _t(_rand(25, 2, 3, D_MODEL)).to(dtype)
    got = unembed(table, x)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 9000)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = ref_unembed(jnp.asarray(table.float().numpy()).astype(jdt),
                       jnp.asarray(x.float().numpy()).astype(jdt))
    _close(got, want)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_ffn_matches_jax(kind):
    """geglu and gelu hold the tanh-approximate gelu (jax.nn.gelu's
    default) against the JAX package."""
    p = {"w_up": _rand(23, D_MODEL, 128, scale=0.2),
         "w_down": _rand(24, 128, D_MODEL, scale=0.1)}
    if kind != "gelu":
        p["w_gate"] = _rand(25, D_MODEL, 128, scale=0.2)
    x = _rand(26, 2, 7, D_MODEL, scale=2.0)
    got = ffn({n: _t(a) for n, a in p.items()}, _t(x), kind=kind)
    want = ref_ffn({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), kind=kind)
    _close(got, want)


def _attn_params():
    p = ref_attn.init_attention(jax.random.key(0), D_MODEL, H, HKV, DH, qkv_bias=True)
    p = {n: np.asarray(a) for n, a in p.items()}
    for i, n in enumerate(("bq", "bk", "bv")):   # the reference inits them to 0
        p[n] = _rand(30 + i, *p[n].shape, scale=0.3)
    return p


def _both(p, x, pos, cache=None, cache_len=None, flash=None, port_positions=True):
    spec_r = ref_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, rope_theta=1e6,
                               qkv_bias=True)
    spec_p = port_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, rope_theta=1e6,
                                qkv_bias=True)
    want, want_cache = ref_attn.attention(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jnp.asarray(pos),
        spec_r, kv_cache=None if cache is None else tuple(map(jnp.asarray, cache)),
        cache_len=None if cache_len is None else jnp.asarray(cache_len, jnp.int32))
    got, got_cache = port_attn.attention(
        {n: _t(a) for n, a in p.items()}, _t(x),
        torch.from_numpy(pos) if port_positions else None, spec_p,
        kv_cache=None if cache is None else tuple(map(_t, cache)),
        cache_len=cache_len, flash=flash)
    _close(got, want)
    if cache is not None:
        for g, w in zip(got_cache, want_cache):
            _close(g, w)


def _recorder():
    seen = []
    return seen, attention_impl(causal=True, record=lambda **kw: seen.append(kw))


@pytest.mark.parametrize("port_positions", [True, False])
def test_attention_without_cache_matches_jax_on_the_kernel_route(port_positions):
    """Positions 0..S-1, given (checked on the host) or None (the port's
    way of saying so without a check)."""
    p, x = _attn_params(), _rand(40, 2, 24, D_MODEL)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24)).copy()
    seen, impl = _recorder()
    _both(p, x, pos, flash=impl, port_positions=port_positions)
    assert [kw["seq"] for kw in seen] == [24]


@pytest.mark.parametrize("cached", [False, True])
def test_attention_with_queries_off_zero_matches_jax_on_the_dense_path(cached):
    """Queries not at 0..S-1 (here row 1 starts at 7) are masked by their
    positions, as in the JAX package: the kernel route is not taken."""
    p, x = _attn_params(), _rand(47, 2, 24, D_MODEL)
    pos = (np.arange(24, dtype=np.int32) + np.asarray([[0], [7]], np.int32)).copy()
    cache = (_rand(48, 2, 32, HKV, DH), _rand(49, 2, 32, HKV, DH)) if cached else None
    seen, impl = _recorder()
    _both(p, x, pos, cache, 0 if cached else None, flash=impl)
    assert seen == []


@pytest.mark.parametrize("start", [0, 5])
def test_attention_scalar_cache_matches_jax(start):
    """From position 0 the cached prefill runs the kernel on the first S
    keys; from a later start it is the dense masked path."""
    p, x = _attn_params(), _rand(41, 2, 11, D_MODEL)
    pos = np.broadcast_to(np.arange(start, start + 11, dtype=np.int32), (2, 11)).copy()
    cache = (_rand(42, 2, 32, HKV, DH), _rand(43, 2, 32, HKV, DH))
    seen, impl = _recorder()
    _both(p, x, pos, cache, start, flash=impl)
    assert len(seen) == (1 if start == 0 else 0)


def test_attention_per_slot_cache_matches_jax():
    """The engine's decode: one query per row at the row's own position."""
    p, x = _attn_params(), _rand(44, 3, 1, D_MODEL)
    starts = np.asarray([3, 17, 0], np.int32)
    cache = (_rand(45, 3, 32, HKV, DH), _rand(46, 3, 32, HKV, DH))
    seen, impl = _recorder()
    _both(p, x, starts[:, None].copy(), cache, starts, flash=impl)
    assert seen == []


@pytest.mark.parametrize("cache_len", [30, np.asarray([0, 32])])
def test_cache_write_past_the_end_raises(cache_len):
    """The JAX package's dynamic_update_slice clamps such a write; the
    port refuses it."""
    p = {n: _t(a) for n, a in _attn_params().items()}
    spec = port_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, qkv_bias=True)
    sq = 1 if np.ndim(cache_len) else 4
    cache = tuple(torch.zeros(2, 32, HKV, DH) for _ in range(2))
    with pytest.raises(ValueError, match="outside the cache"):
        port_attn.attention(p, torch.zeros(2, sq, D_MODEL),
                            torch.zeros(2, sq, dtype=torch.long), spec,
                            kv_cache=cache, cache_len=cache_len)


@pytest.mark.parametrize("cache", ["int8"])
def test_unported_caches_raise(cache):
    """Named for the gap it held until the int8 KV cache was ported (a
    4-tuple cache raised ``NotImplementedError``): a decode step at
    position 5 against an int8 cache written by a prefill, both against
    the JAX package at 1e-4, the int8 values within one step of its."""
    p, x = _attn_params(), _rand(53, 2, 6, D_MODEL)
    spec_r = ref_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, rope_theta=1e6,
                               qkv_bias=True)
    spec_p = port_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, rope_theta=1e6,
                                qkv_bias=True)
    ref_kv = (jnp.zeros((2, 8, HKV, DH), jnp.int8),) * 2 + (jnp.zeros((2, 8, HKV)),) * 2
    kv = tuple(torch.zeros(2, 8, HKV, DH, dtype=torch.int8) for _ in range(2)) + tuple(
        torch.zeros(2, 8, HKV) for _ in range(2))
    for xs, start in ((x[:, :5], 0), (x[:, 5:], 5)):
        pos = np.broadcast_to(np.arange(start, start + xs.shape[1]), xs.shape[:2]).copy()
        want, ref_kv = ref_attn.attention({n: jnp.asarray(a) for n, a in p.items()},
                                          jnp.asarray(xs), jnp.asarray(pos), spec_r,
                                          kv_cache=ref_kv, cache_len=jnp.asarray(start))
        got, kv = port_attn.attention({n: _t(a) for n, a in p.items()}, _t(xs),
                                      torch.from_numpy(pos), spec_p, kv_cache=kv,
                                      cache_len=start)
        _close(got, want)
    assert kv[0].dtype == torch.int8 and len(kv) == 4
    for g, w in zip(kv[:2], ref_kv[:2]):
        assert np.abs(g.numpy().astype(np.int32) - np.asarray(w)).max() <= 1


@pytest.mark.parametrize("sq", [1, 16])
def test_cross_attention_matches_jax_on_the_kernel_route(sq):
    """Cross-attention (non-causal, every key valid): Sq queries against
    29 keys of another sequence, at a decode step (1) and a prefill (16),
    runs the kernel route."""
    p, x = _attn_params(), _rand(50, 2, sq, D_MODEL)
    mem = _rand(51, 2, 29, D_MODEL)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32) + 5, (2, sq)).copy()
    spec_r = ref_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, causal=False, qkv_bias=True)
    spec_p = port_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, causal=False, qkv_bias=True)
    want, _ = ref_attn.attention({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                                 jnp.asarray(pos), spec_r, x_kv=jnp.asarray(mem))
    seen, impl = _recorder()
    got, _ = port_attn.attention({n: _t(a) for n, a in p.items()}, _t(x),
                                 torch.from_numpy(pos), spec_p, x_kv=_t(mem), flash=impl)
    _close(got, want)
    assert [kw["seq"] for kw in seen] == [sq]


def test_windowed_and_non_causal_cached_calls_take_the_dense_path():
    """A window, or a cache under a non-causal mask, lies outside the
    kernel's contract."""
    p = {n: _t(a) for n, a in _attn_params().items()}
    x = _t(_rand(52, 2, 12, D_MODEL))
    seen, impl = _recorder()
    spec = port_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, qkv_bias=True)
    port_attn.attention(p, x, None, spec, window=4, flash=impl)
    spec_nc = port_attn.AttnSpec(n_heads=H, n_kv=HKV, head_dim=DH, causal=False,
                                 qkv_bias=True)
    cache = tuple(torch.zeros(2, 16, HKV, DH) for _ in range(2))
    port_attn.attention(p, x, None, spec_nc, kv_cache=cache, cache_len=0, flash=impl)
    assert seen == []
