"""Oracle-alignment tests for the Pallas flash forward (SURVEY.md §4):
fp32 interpret-mode runs vs the pure-jnp oracle, over the reference's config
sampling style — causal × non-causal, S_q ≠ S_k, D ∈ {64, 128}, deliberate
non-multiples of the block size (reference Phase_3.md:259-263), GQA."""

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_fwd import flash_attention_forward
from flashattn_tpu.ops.reference import (
    reference_attention,
    reference_attention_with_lse,
)
from flashattn_tpu.utils.verify import verify_results

BS = BlockSizes(block_q=128, block_kv=128)


def make_qkv(b, hq, hkv, s_q, s_k, d, dtype=jnp.float32, seed=42):
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    q = jax.random.normal(kq, (b, hq, s_q, d), dtype)
    k = jax.random.normal(kk, (b, hkv, s_k, d), dtype)
    v = jax.random.normal(kv, (b, hkv, s_k, d), dtype)
    return q, k, v


@pytest.mark.parametrize("is_causal", [False, True])
@pytest.mark.parametrize(
    "s_q,s_k",
    [
        (256, 256),
        (128, 384),  # cross-attention, S_q < S_k
        (384, 128),  # S_q > S_k
        (200, 200),  # ragged: not a block multiple (reference S=500 trick)
        (256, 200),
    ],
)
def test_fwd_matches_oracle(is_causal, s_q, s_k):
    q, k, v = make_qkv(2, 2, 2, s_q, s_k, 64)
    o, lse = flash_attention_forward(q, k, v, is_causal=is_causal, block_sizes=BS)
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, is_causal=is_causal)
    assert verify_results(o_ref, o, atol=1e-5, rtol=1e-5).passed
    assert verify_results(lse_ref, lse, atol=1e-5, rtol=1e-5).passed


@pytest.mark.parametrize("d", [64, 128])
def test_fwd_head_dims(d):
    q, k, v = make_qkv(1, 2, 2, 256, 256, d)
    o, lse = flash_attention_forward(q, k, v, is_causal=True, block_sizes=BS)
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, is_causal=True)
    assert verify_results(o_ref, o, atol=1e-5, rtol=1e-5).passed
    assert verify_results(lse_ref, lse, atol=1e-5, rtol=1e-5).passed


@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 1)])
def test_fwd_gqa_mqa(hq, hkv):
    q, k, v = make_qkv(1, hq, hkv, 256, 256, 64)
    o, lse = flash_attention_forward(q, k, v, is_causal=True, block_sizes=BS)
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, is_causal=True)
    assert verify_results(o_ref, o, atol=1e-5, rtol=1e-5).passed
    assert verify_results(lse_ref, lse, atol=1e-5, rtol=1e-5).passed


def test_fwd_bf16_reference_gate():
    """bf16 run against the fp32 oracle with the reference-style gate
    (allclose + cosine; atol loosened for bf16's 8-bit mantissa)."""
    q, k, v = make_qkv(2, 2, 2, 256, 256, 64, dtype=jnp.bfloat16)
    o, _ = flash_attention_forward(q, k, v, is_causal=True, block_sizes=BS)
    o_ref, _ = reference_attention_with_lse(q, k, v, is_causal=True)
    assert verify_results(o_ref, o, rtol=2e-2, atol=2e-2).passed


def test_fwd_custom_scale():
    q, k, v = make_qkv(1, 2, 2, 256, 256, 64)
    o, _ = flash_attention_forward(q, k, v, scale=0.5, block_sizes=BS)
    o_ref, _ = reference_attention_with_lse(q, k, v, scale=0.5)
    assert verify_results(o_ref, o, atol=1e-5, rtol=1e-5).passed


@pytest.mark.parametrize("d", [80, 96, 256])
def test_fwd_odd_head_dims(d):
    """Head dims that are not powers of two (D=80/96 models exist): the
    launcher zero-pads D to the Triton tile; numerics must be exact."""
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    q, k, v = (jax.random.normal(kk, (1, 2, 256, d)) for kk in keys)
    o, _ = flash_attention_forward(q, k, v, is_causal=True, block_sizes=BS)
    o_ref = reference_attention(q, k, v, is_causal=True)
    r = verify_results(o_ref, o, atol=1e-5, rtol=1e-5)
    assert r.passed, r


@pytest.mark.parametrize("is_causal", [False, True])
def test_fwd_need_lse_false(is_causal):
    """need_lse=False (the custom_vjp primal's inference path) compiles the
    LSE output stream out of the kernel; O must be identical to the
    need_lse=True run."""
    q, k, v = make_qkv(1, 2, 2, 300, 300, 64)
    o_full, _ = flash_attention_forward(q, k, v, is_causal=is_causal,
                                        block_sizes=BS)
    o_min, lse = flash_attention_forward(q, k, v, is_causal=is_causal,
                                         block_sizes=BS, need_lse=False)
    assert lse is None
    import numpy as np

    np.testing.assert_array_equal(np.asarray(o_full), np.asarray(o_min))
