"""Two-kernel backward (dQ, then dK/dV reusing its delta) vs jax.grad of the
jnp oracle across block configurations and the full feature matrix. The
dQ and dK/dV tiles are independent, so the configurations also mix them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward
from flashattn_tpu.ops.reference import reference_attention

BLOCKS = {
    "16": BlockSizes(block_q=16, block_kv=16, block_q_dq=16, block_kv_dq=16,
                     block_q_dkv=16, block_kv_dkv=16),
    "mixed": BlockSizes(block_q=32, block_kv=64, block_q_dq=64,
                        block_kv_dq=32, block_q_dkv=32, block_kv_dkv=64),
    "64": BlockSizes(block_q=64, block_kv=32, block_q_dq=32, block_kv_dq=64,
                     block_q_dkv=64, block_kv_dkv=32),
}


def grads(bs, b=1, hq=2, hkv=2, s_q=64, s_k=64, d=64, causal=True,
          segments=False, **kw):
    ks = jax.random.split(jax.random.PRNGKey(17), 4)
    q = jax.random.normal(ks[0], (b, hq, s_q, d))
    k = jax.random.normal(ks[1], (b, hkv, s_k, d))
    v = jax.random.normal(ks[2], (b, hkv, s_k, d))
    do = jax.random.normal(ks[3], (b, hq, s_q, d))
    seg_ids = None
    if segments:
        sq = jnp.asarray(np.arange(s_q) * 4 // s_q)[None].repeat(b, 0)
        sk = jnp.asarray(np.arange(s_k) * 4 // s_k)[None].repeat(b, 0)
        seg_ids = (sq.astype(jnp.int32), sk.astype(jnp.int32))
    o, lse = flash_attention_forward(q, k, v, is_causal=causal,
                                     segment_ids=seg_ids, block_sizes=bs,
                                     **kw)
    ours = flash_attention_backward(q, k, v, o, do, lse, is_causal=causal,
                                    segment_ids=seg_ids, block_sizes=bs, **kw)
    oracle = None
    if "dropout_rate" not in kw:
        def ref_loss(q, k, v):
            r = reference_attention(q, k, v, is_causal=causal,
                                    segment_ids=seg_ids, **kw)
            return jnp.sum(r * do)
        oracle = jax.grad(ref_loss, (0, 1, 2))(q, k, v)
    return ours, oracle


def assert_close(ours, oracle, rel=1e-4):
    for a, b_, nm in zip(ours, oracle, ("dQ", "dK", "dV")):
        err = float(jnp.max(jnp.abs(a - b_)))
        den = float(jnp.max(jnp.abs(b_))) + 1e-6
        assert np.isfinite(err) and err / den < rel, f"{nm} rel={err / den}"


@pytest.mark.parametrize("blocks", list(BLOCKS))
@pytest.mark.parametrize("causal,s_q,s_k", [
    (False, 64, 64),
    (True, 64, 64),
    (True, 32, 96),   # cross-attention, S_q < S_k
    (True, 96, 32),   # S_q > S_k: rows with no visible key
    (True, 50, 70),   # ragged tails on both axes
])
def test_bwd_blocks_match_oracle(blocks, causal, s_q, s_k):
    assert_close(*grads(BLOCKS[blocks], s_q=s_q, s_k=s_k, causal=causal))


@pytest.mark.parametrize("variant,kw", [
    ("gqa", dict(hq=8, hkv=2)),
    ("window", dict(window=24)),
    ("softcap", dict(logit_softcap=5.0)),
    ("alibi", dict(alibi=True)),
    ("segments", dict(segments=True)),
    ("feature_stack", dict(hq=8, hkv=2, window=24, alibi=True)),
])
def test_bwd_blocks_variants(variant, kw):
    assert_close(*grads(BLOCKS["mixed"], s_q=96, s_k=96, **kw))


def test_bwd_dropout_is_tile_independent():
    """No oracle for dropout; the keep mask is regenerated from global
    (row, col), so every tiling must give the same gradients."""
    kw = dict(dropout_rate=0.2, dropout_seed=7, hq=4, hkv=2, s_q=96, s_k=96)
    runs = [grads(bs, **kw)[0] for bs in BLOCKS.values()]
    for other in runs[1:]:
        assert_close(other, runs[0])
