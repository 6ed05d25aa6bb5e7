"""Paged KV cache + paged decode vs the dense decode path.

The paged kernel is the SAME kernel as dense decode with a block-table
indirection in the index maps, so given identical tokens the outputs must
match the dense path exactly (not just the jnp oracle)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.decode import decode_attention, decode_attention_chunk
from flashattn_tpu.ops.kvcache import init_cache, update_cache
from flashattn_tpu.ops.paged import (
    PageAllocator,
    append_paged,
    init_paged_cache,
    paged_decode_attention,
    paged_decode_attention_chunk,
    pages_needed,
    set_block_table,
)
from flashattn_tpu.utils.verify import verify_results

B, HQ, HKV, D = 2, 4, 2, 128
PAGE = 128
# max_len = 1024: the harness appends one sequence at a time with `active`
# masks, and the DENSE cache's convention writes dead tokens at inactive
# slots' current length — headroom keeps those in-range (the paged cache
# drops them entirely; see test_inactive_append_never_corrupts).
MAX_PAGES = 8


def make_pair(lengths, quant=None, seed=0):
    """Dense cache + paged cache holding the same tokens, with the paged
    copy living in a deliberately scrambled page assignment."""
    s_max = PAGE * MAX_PAGES
    dense = init_cache(B, HKV, s_max, D, dtype=jnp.float32, quant=quant)
    paged = init_paged_cache(B, HKV, num_pages=B * MAX_PAGES + 3, page_size=PAGE,
                             head_dim=D, max_pages_per_seq=MAX_PAGES,
                             dtype=jnp.float32, quant=quant)
    # Scrambled non-contiguous page assignment (pages 3.. in reverse order).
    perm = np.arange(3, 3 + B * MAX_PAGES)[::-1].reshape(B, MAX_PAGES)
    for bi in range(B):
        paged = set_block_table(paged, bi, jnp.asarray(perm[bi], jnp.int32), 0)

    kk = jax.random.split(jax.random.PRNGKey(seed), 2 * B)
    for bi, ln in enumerate(lengths):
        k_new = jax.random.normal(kk[2 * bi], (1, HKV, ln, D))
        v_new = jax.random.normal(kk[2 * bi + 1], (1, HKV, ln, D))
        # dense: per-sequence append via masked batch update
        mask = jnp.arange(B) == bi
        kb = jnp.where(mask[:, None, None, None],
                       jnp.broadcast_to(k_new, (B, HKV, ln, D)), 0.0)
        vb = jnp.where(mask[:, None, None, None],
                       jnp.broadcast_to(v_new, (B, HKV, ln, D)), 0.0)
        dense = update_cache(dense, kb, vb, active=mask)
        paged = append_paged(paged, kb, vb, active=mask)
    return dense, paged


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_paged_matches_dense_single(quant):
    lengths = [300, 170]
    dense, paged = make_pair(lengths, quant=quant)
    np.testing.assert_array_equal(np.asarray(dense.length),
                                  np.asarray(paged.length))
    q = jax.random.normal(jax.random.PRNGKey(7), (B, HQ, D))
    o_dense = decode_attention(q, dense)
    o_paged = paged_decode_attention(q, paged)
    r = verify_results(o_dense, o_paged, atol=1e-6, rtol=1e-6)
    assert r.passed, r


def test_paged_matches_dense_chunk():
    t = 8
    lengths = [256 + t, 130 + t]
    dense, paged = make_pair(lengths)
    q = jax.random.normal(jax.random.PRNGKey(8), (B, HQ, t, D))
    o_dense = decode_attention_chunk(q, dense)
    o_paged = paged_decode_attention_chunk(q, paged)
    r = verify_results(o_dense, o_paged, atol=1e-6, rtol=1e-6)
    assert r.passed, r


def test_paged_window():
    lengths = [420, 200]
    dense, paged = make_pair(lengths)
    q = jax.random.normal(jax.random.PRNGKey(9), (B, HQ, D))
    o_dense = decode_attention(q, dense, window=256)
    o_paged = paged_decode_attention(q, paged, window=256)
    r = verify_results(o_dense, o_paged, atol=1e-6, rtol=1e-6)
    assert r.passed, r


def test_paged_append_across_page_boundary():
    """A chunk append that straddles a page boundary lands split across the
    two physical pages the table names."""
    dense, paged = make_pair([PAGE - 3, 10])
    k_new = jax.random.normal(jax.random.PRNGKey(10), (B, HKV, 7, D))
    v_new = jax.random.normal(jax.random.PRNGKey(11), (B, HKV, 7, D))
    dense = update_cache(dense, k_new, v_new)
    paged = append_paged(paged, k_new, v_new)
    q = jax.random.normal(jax.random.PRNGKey(12), (B, HQ, D))
    o_dense = decode_attention(q, dense)
    o_paged = paged_decode_attention(q, paged)
    r = verify_results(o_dense, o_paged, atol=1e-6, rtol=1e-6)
    assert r.passed, r


def test_allocator_reuse():
    a = PageAllocator(8)
    p1 = a.alloc(pages_needed(300, PAGE))  # 3 pages
    assert a.free_pages == 5
    p2 = a.alloc(2)
    a.release(p1)
    assert a.free_pages == 6
    p3 = a.alloc(4)  # reuses released pages
    assert set(p3) & set(p1), "released pages must be reusable"
    assert not (set(p3) & set(p2))
    with pytest.raises(MemoryError):
        a.alloc(5)


def test_inactive_append_never_corrupts():
    """An inactive slot sitting at capacity must survive other slots'
    appends bit-exactly (the scatter drops dead writes; the dense cache's
    clamped dynamic-slice convention would clobber here)."""
    dense, paged = make_pair([PAGE * MAX_PAGES, 100])  # slot 0 full
    q = jax.random.normal(jax.random.PRNGKey(13), (B, HQ, D))
    before = paged_decode_attention(q, paged)
    k_new = jax.random.normal(jax.random.PRNGKey(14), (B, HKV, 64, D))
    v_new = jax.random.normal(jax.random.PRNGKey(15), (B, HKV, 64, D))
    active = jnp.asarray([False, True])
    paged = append_paged(paged, k_new, v_new, active=active)
    after = paged_decode_attention(q, paged)
    np.testing.assert_array_equal(np.asarray(before[0]),
                                  np.asarray(after[0]))
    assert int(paged.length[0]) == PAGE * MAX_PAGES
    assert int(paged.length[1]) == 164


def test_set_block_table_admission():
    """Admission installs a fresh page list + resets length; the old slot
    content is dead regardless of what the pool holds."""
    _, paged = make_pair([200, 100])
    new_pages = jnp.asarray([1, 0, 2, 1, 0, 0, 0, 0],
                            jnp.int32)  # padded tail is dead
    paged = set_block_table(paged, 1, new_pages, 150)
    assert int(paged.length[1]) == 150
    np.testing.assert_array_equal(np.asarray(paged.block_table[1]),
                                  np.asarray(new_pages))


def test_chunked_prefill_into_pages():
    """Chunked prefill straight into a paged cache + paged decode steps
    reproduce the dense-cache generation path exactly."""
    from flashattn_tpu.models import generate, llama
    from flashattn_tpu.models.config import ModelConfig
    from flashattn_tpu.ops.paged import init_paged_cache, set_block_table

    cfg = ModelConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=512,
        dtype=jnp.float32)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 256), 0,
                                cfg.vocab_size, jnp.int32)

    dense = generate.init_caches(cfg, 1, 512)
    ld, dense = generate.chunked_prefill(params, tokens, dense, cfg, chunk=128)

    paged = [
        init_paged_cache(1, cfg.num_kv_heads, num_pages=4, page_size=128,
                         head_dim=cfg.head_dim, max_pages_per_seq=4,
                         dtype=jnp.float32)
        for _ in range(cfg.num_layers)
    ]
    paged = [set_block_table(c, 0, jnp.asarray([2, 0, 3, 1], jnp.int32), 0)
             for c in paged]
    lp, paged = generate.chunked_prefill(params, tokens, paged, cfg, chunk=128)
    np.testing.assert_allclose(np.asarray(lp), np.asarray(ld),
                               rtol=1e-5, atol=1e-5)
    # one decode step on each path
    tok = jnp.argmax(ld, -1).astype(jnp.int32)
    pos = jnp.full((1,), 256, jnp.int32)
    ld2, _ = generate.decode_step(params, tok, pos, dense, cfg)
    lp2, _ = generate.decode_step(params, tok, pos, paged, cfg)
    np.testing.assert_allclose(np.asarray(lp2), np.asarray(ld2),
                               rtol=1e-5, atol=1e-5)


def test_paged_sink():
    """Attention sinks compose with the paged table: matches dense decode
    with the same window+sink."""
    lengths = [900, 400]
    dense, paged = make_pair(lengths)
    q = jax.random.normal(jax.random.PRNGKey(16), (B, HQ, D))
    o_dense = decode_attention(q, dense, window=256, sink=16)
    o_paged = paged_decode_attention(q, paged, window=256, sink=16)
    r = verify_results(o_dense, o_paged, atol=1e-6, rtol=1e-6)
    assert r.passed, r
