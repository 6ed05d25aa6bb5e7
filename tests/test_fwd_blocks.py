"""Forward kernel across block configurations: the Triton index arithmetic
(block offsets, masked/mask-free loop split, padding, GQA head folding)
changes with the tiles, so every oracle case runs under several (block_q,
block_kv) pairs, including ones where q and kv tiles differ."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_fwd import flash_attention_forward
from flashattn_tpu.ops.reference import (
    reference_attention,
    reference_attention_with_lse,
)
from flashattn_tpu.utils.verify import verify_results

BLOCKS = [(16, 16), (32, 64), (64, 32)]


def make_qkv(b, hq, hkv, s_q, s_k, d, dtype=jnp.float32, seed=3):
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(kq, (b, hq, s_q, d), dtype)
    k = jax.random.normal(kk, (b, hkv, s_k, d), dtype)
    v = jax.random.normal(kv, (b, hkv, s_k, d), dtype)
    return q, k, v


def blocks(bq, bkv):
    return BlockSizes(block_q=bq, block_kv=bkv)


def assert_matches(o, lse, o_ref, lse_ref, tol=1e-5):
    assert verify_results(o_ref, o, atol=tol, rtol=tol).passed
    assert verify_results(lse_ref, lse, atol=tol, rtol=tol).passed


@pytest.mark.parametrize("bq,bkv", BLOCKS)
@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize(
    "s_q,s_k",
    [
        (64, 64),
        (32, 96),  # cross-attention, S_q < S_k
        (96, 32),  # S_q > S_k: zero-visible-key rows under causal
        (50, 50),  # ragged tails
        (64, 50),
    ],
)
def test_blocks_match_oracle(bq, bkv, is_causal, s_q, s_k):
    q, k, v = make_qkv(2, 2, 2, s_q, s_k, 64)
    o, lse = flash_attention_forward(q, k, v, is_causal=is_causal,
                                     block_sizes=blocks(bq, bkv))
    assert_matches(o, lse, *reference_attention_with_lse(
        q, k, v, is_causal=is_causal))


@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 1)])
def test_blocks_dims_and_gqa(d, hq, hkv):
    q, k, v = make_qkv(1, hq, hkv, 64, 64, d)
    o, lse = flash_attention_forward(q, k, v, is_causal=True,
                                     block_sizes=blocks(32, 16))
    assert_matches(o, lse, *reference_attention_with_lse(
        q, k, v, is_causal=True))


def offset_oracle(q, k, v, offset):
    """Causal attention with row r seeing cols <= r + offset (O and LSE;
    rows with no visible key give O = 0, LSE = -inf)."""
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k,
                   precision=jax.lax.Precision.HIGHEST) / np.sqrt(q.shape[-1])
    r = jnp.arange(q.shape[2])[:, None]
    c = jnp.arange(k.shape[2])[None, :]
    s = jnp.where(c <= r + offset, s, -jnp.inf)
    lse = jax.scipy.special.logsumexp(s, axis=-1)
    p = jnp.where(jnp.isfinite(lse)[..., None], jnp.exp(s - lse[..., None]),
                  0.0)
    return jnp.einsum("bhqk,bhkd->bhqd", p, v,
                      precision=jax.lax.Precision.HIGHEST), lse


@pytest.mark.parametrize("bq,bkv", BLOCKS)
@pytest.mark.parametrize("pos_offset", [-32, 0, 40])
def test_blocks_pos_offset(bq, bkv, pos_offset):
    """Static global alignment (ring hops): rows see cols <= r + offset,
    including negative offsets that leave leading rows empty."""
    q, k, v = make_qkv(1, 2, 2, 64, 96, 64)
    o, lse = flash_attention_forward(q, k, v, is_causal=True,
                                     block_sizes=blocks(bq, bkv),
                                     pos_offset=pos_offset)
    o_ref, lse_ref = offset_oracle(q, k, v, pos_offset)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(lse), np.asarray(lse_ref),
                               atol=1e-5, rtol=1e-5)


def test_blocks_dyn_pos_offset_matches_static():
    """The traced alignment drives the same loop bounds and masks as the
    static one, causal and windowed."""
    q, k, v = make_qkv(1, 2, 2, 64, 96, 64)
    for kw in ({"is_causal": True}, {"is_causal": True, "window": 24}):
        o_s, lse_s = flash_attention_forward(
            q, k, v, block_sizes=blocks(16, 32), pos_offset=20, **kw)
        o_d, lse_d = flash_attention_forward(
            q, k, v, block_sizes=blocks(16, 32),
            dyn_pos_offset=jnp.int32(20), **kw)
        np.testing.assert_array_equal(np.asarray(o_s), np.asarray(o_d))
        np.testing.assert_array_equal(np.asarray(lse_s), np.asarray(lse_d))


VARIANTS = {
    "segments": {},
    "window": {"window": 24},
    "alibi": {"alibi": True},
    "softcap": {"logit_softcap": 5.0},
}


@pytest.mark.parametrize("bq,bkv", [(16, 16), (64, 32)])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_blocks_variants(bq, bkv, variant):
    q, k, v = make_qkv(1, 4, 2, 96, 96, 64)
    kw = dict(VARIANTS[variant])
    if variant == "segments":
        seg = (jnp.arange(96) // 40).astype(jnp.int32)[None, :]
        kw["segment_ids"] = (seg, seg)
    o, lse = flash_attention_forward(q, k, v, is_causal=True,
                                     block_sizes=blocks(bq, bkv), **kw)
    assert_matches(o, lse, *reference_attention_with_lse(
        q, k, v, is_causal=True, **kw))


def test_blocks_dropout_pattern_is_tile_independent():
    """The dropout keep mask is keyed on GLOBAL (row, col): any tiling
    reproduces the same output (only the summation order differs), and
    the LSE stays the clean (dropout-free) normalizer."""
    q, k, v = make_qkv(1, 2, 2, 96, 96, 64)
    outs = [flash_attention_forward(q, k, v, is_causal=True,
                                    dropout_rate=0.3, dropout_seed=7,
                                    block_sizes=blocks(bq, bkv))
            for bq, bkv in BLOCKS]
    for o, lse in outs[1:]:
        assert verify_results(outs[0][0], o, atol=1e-5, rtol=1e-5).passed
        assert verify_results(outs[0][1], lse, atol=1e-5, rtol=1e-5).passed
    _, lse_ref = reference_attention_with_lse(q, k, v, is_causal=True)
    assert verify_results(lse_ref, outs[0][1], atol=1e-5, rtol=1e-5).passed


@pytest.mark.parametrize("bq,bkv", BLOCKS)
def test_blocks_need_lse_false(bq, bkv):
    q, k, v = make_qkv(1, 2, 2, 80, 80, 64)
    bs = blocks(bq, bkv)
    o_full, _ = flash_attention_forward(q, k, v, is_causal=True,
                                        block_sizes=bs)
    o_min, lse = flash_attention_forward(q, k, v, is_causal=True,
                                         block_sizes=bs, need_lse=False)
    assert lse is None
    np.testing.assert_array_equal(np.asarray(o_full), np.asarray(o_min))


def test_blocks_launch_params_do_not_change_numerics():
    """num_warps / num_stages are launch parameters only."""
    q, k, v = make_qkv(1, 2, 2, 64, 64, 64)
    base = blocks(32, 32)
    o0, _ = flash_attention_forward(q, k, v, is_causal=True, block_sizes=base)
    o1, _ = flash_attention_forward(
        q, k, v, is_causal=True,
        block_sizes=dataclasses.replace(base, num_warps=8, num_stages=3))
    np.testing.assert_array_equal(np.asarray(o0), np.asarray(o1))
    o_ref = reference_attention(q, k, v, is_causal=True)
    assert verify_results(o_ref, o0, atol=1e-5, rtol=1e-5).passed
