"""Sliding-window attention tests: masking AND wavefront pruning (blocks
left of the window must not even be enumerated)."""

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu import flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_fwd import kv_block_range
from flashattn_tpu.ops.reference import reference_attention
from flashattn_tpu.utils.verify import verify_results

BS = BlockSizes(
    block_q=128, block_kv=128,
    block_q_dq=128, block_kv_dq=128,
    block_q_dkv=128, block_kv_dkv=128,
)


def make_inputs(b, h, s, d, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    return tuple(jax.random.normal(kk, (b, h, s, d)) for kk in keys)


@pytest.mark.parametrize("window", [1, 64, 128, 300, 1000])
def test_window_forward(window):
    q, k, v, _ = make_inputs(1, 2, 768, 64)
    o = flash_attention(q, k, v, is_causal=True, window=window,
                        block_sizes=BS)
    o_ref = reference_attention(q, k, v, is_causal=True, window=window)
    r = verify_results(o_ref, o, atol=1e-5, rtol=1e-5)
    assert r.passed, f"window={window}: {r}"


@pytest.mark.parametrize("window", [64, 300])
def test_window_grads(window):
    q, k, v, do = make_inputs(1, 2, 512, 64, seed=3)
    ours = lambda q, k, v: flash_attention(
        q, k, v, is_causal=True, window=window, block_sizes=BS)
    ref = lambda q, k, v: reference_attention(
        q, k, v, is_causal=True, window=window)
    g = lambda fn: jax.grad(
        lambda q, k, v: jnp.sum(fn(q, k, v) * do), argnums=(0, 1, 2)
    )(q, k, v)
    for name, a, b in zip(("dQ", "dK", "dV"), g(ref), g(ours)):
        r = verify_results(a, b, atol=1e-5, rtol=1e-5)
        assert r.passed, f"{name} window={window}: {r}"


def test_window_prunes_wavefront():
    """A small window must shrink each q block's K/V loop, not just mask."""

    def visited(qi, window):
        lo, _, _, hi = kv_block_range(
            qi, block_q=128, block_kv=128, num_kv_blocks=16, s_k=2048,
            offset=0, causal=True, window=window)
        return hi - lo

    full = sum(visited(qi, None) for qi in range(16))
    windowed = [visited(qi, 256) for qi in range(16)]
    assert sum(windowed) < full // 2
    # Every q block visits at most ceil(256/128)+1 = 3 kv blocks.
    assert max(windowed) <= 3 and min(windowed) >= 1


def test_window_larger_than_seq_equals_causal():
    q, k, v, _ = make_inputs(1, 2, 384, 64, seed=5)
    o_w = flash_attention(q, k, v, is_causal=True, window=10_000,
                          block_sizes=BS)
    o_c = flash_attention(q, k, v, is_causal=True, block_sizes=BS)
    assert jnp.allclose(o_w, o_c, atol=1e-6)


def test_window_with_ragged_tail():
    """S not a multiple of the block exercises window + tail masks at once."""
    q, k, v, _ = make_inputs(1, 2, 500, 64, seed=7)
    o = flash_attention(q, k, v, is_causal=True, window=200, block_sizes=BS)
    o_ref = reference_attention(q, k, v, is_causal=True, window=200)
    r = verify_results(o_ref, o, atol=1e-5, rtol=1e-5)
    assert r.passed, r


def test_windowed_model_train_decode_agree():
    """attn_window threads through both the training forward and the decode
    path: teacher-forced logits must agree between them."""
    import numpy as np
    from flashattn_tpu.models import generate, llama
    from flashattn_tpu.models.config import ModelConfig

    cfg = ModelConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=2, num_kv_heads=2, head_dim=32, max_seq_len=256,
        dtype=jnp.float32, attn_window=40,
    )
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 96), 0,
                                cfg.vocab_size, jnp.int32)
    train_logits = llama.forward(params, tokens, cfg)  # [1, S, V]

    caches = generate.init_caches(cfg, 1, 128)
    logits, caches = generate.prefill(params, tokens[:, :1], caches, cfg)
    np.testing.assert_allclose(np.asarray(logits),
                               np.asarray(train_logits[:, 0]),
                               rtol=2e-4, atol=2e-4)
    for t in range(1, 96):
        positions = jnp.full((1,), t, jnp.int32)
        logits, caches = generate.decode_step(
            params, tokens[:, t], positions, caches, cfg)
        np.testing.assert_allclose(
            np.asarray(logits), np.asarray(train_logits[:, t]),
            rtol=2e-4, atol=2e-4, err_msg=f"position {t}")


@pytest.mark.parametrize("t_chunk", [1, 4])
def test_decode_attention_sinks(t_chunk):
    """StreamingLLM attention sinks: sliding window PLUS the first `sink`
    tokens always visible. Oracle = softmax over exactly that key set."""
    import numpy as np

    from flashattn_tpu.ops.decode import (
        decode_attention, decode_attention_chunk)
    from flashattn_tpu.ops.kvcache import init_cache, update_cache

    b, hq, hkv, d, s_max = 2, 4, 2, 64, 1024
    length, window, sink = 900, 256, 16
    cache = init_cache(b, hkv, s_max, d, dtype=jnp.float32)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, length, d))
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, length, d))
    cache = update_cache(cache, kn, vn)
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, t_chunk, d))

    if t_chunk == 1:
        o = decode_attention(q[:, :, 0], cache, window=window, sink=sink)
        o = o[:, :, None]
    else:
        o = decode_attention_chunk(q, cache, window=window, sink=sink)

    # dense oracle per chunk row
    qe = np.asarray(q).reshape(b, hkv, hq // hkv, t_chunk, d)
    kn_, vn_ = np.asarray(kn), np.asarray(vn)
    out = np.zeros((b, hkv, hq // hkv, t_chunk, d), np.float32)
    for bi in range(b):
        for h in range(hkv):
            for g in range(hq // hkv):
                for t in range(t_chunk):
                    row_pos = length - t_chunk + t
                    vis = [p for p in range(length)
                           if p <= row_pos and (
                               p >= row_pos - window + 1 or p < sink)]
                    s = qe[bi, h, g, t] @ kn_[bi, h, vis].T / np.sqrt(d)
                    p = np.exp(s - s.max()); p /= p.sum()
                    out[bi, h, g, t] = p @ vn_[bi, h, vis]
    o_ref = out.reshape(b, hq, t_chunk, d)
    np.testing.assert_allclose(np.asarray(o), o_ref, atol=1e-5, rtol=1e-5)
