"""Decode + quantized KV cache tests: decode vs the dense oracle over the
dequantized cache (ragged lengths), quantization error bounds, and
decode-path vs training-path logits parity on the tiny model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.models import generate, llama
from flashattn_tpu.models.config import TINY
from flashattn_tpu.ops.decode import decode_attention, decode_attention_chunk
from flashattn_tpu.ops.kvcache import dequantize, init_cache, quantize_tokens, update_cache
from flashattn_tpu.ops.reference import reference_attention
from flashattn_tpu.utils.verify import verify_results


@pytest.mark.parametrize("quant", [None, "int8", "fp8"])
def test_decode_matches_oracle_ragged(quant):
    b, hq, hkv, d, smax = 2, 8, 4, 64, 512
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    cache = init_cache(b, hkv, smax, d, quant=quant)
    k_toks = jax.random.normal(keys[0], (b, hkv, 300, d), jnp.bfloat16)
    v_toks = jax.random.normal(keys[1], (b, hkv, 300, d), jnp.bfloat16)
    cache = update_cache(cache, k_toks, v_toks)
    cache = dataclasses.replace(cache, length=jnp.array([200, 300], jnp.int32))
    q = jax.random.normal(keys[2], (b, hq, d), jnp.bfloat16)

    o = decode_attention(q, cache)
    k_d = dequantize(cache.k, cache.k_scale).astype(jnp.float32)
    v_d = dequantize(cache.v, cache.v_scale).astype(jnp.float32)
    for bi, length in enumerate([200, 300]):
        o_ref = reference_attention(
            q[bi : bi + 1, :, None, :].astype(jnp.float32),
            k_d[bi : bi + 1, :, :length],
            v_d[bi : bi + 1, :, :length],
        )[:, :, 0]
        r = verify_results(o_ref, o[bi : bi + 1], rtol=2e-2, atol=2e-2)
        assert r.passed, f"quant={quant} b={bi}: {r}"


@pytest.mark.parametrize("quant,max_err", [("int8", 0.02), ("fp8", 0.1)])
def test_quantize_roundtrip_error(quant, max_err):
    dtype = jnp.int8 if quant == "int8" else jnp.float8_e4m3fn
    x = jax.random.normal(jax.random.PRNGKey(0), (1, 2, 64, 32), jnp.bfloat16)
    q, s = quantize_tokens(x, dtype)
    assert s.shape == (1, 2, 1, 64)
    x_rt = dequantize(q, s)
    rel = float(
        jnp.max(jnp.abs(x_rt.astype(jnp.float32) - x.astype(jnp.float32)))
        / jnp.max(jnp.abs(x.astype(jnp.float32)))
    )
    assert rel < max_err, rel


def test_decode_path_matches_forward():
    """Greedy decode must track the training-path forward logits: compare
    logits at each step against full re-forward (the SDPA-alignment idea
    applied across code paths)."""
    cfg = TINY
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    b, s = 2, 16
    prompt = jax.random.randint(jax.random.PRNGKey(1), (b, s), 0, cfg.vocab_size)

    caches = generate.init_caches(cfg, b, 128)
    logits_pf, caches = generate.prefill(params, prompt, caches, cfg)
    logits_full = llama.forward(params, prompt, cfg)[:, -1]
    r = verify_results(logits_full, logits_pf, rtol=3e-2, atol=5e-2)
    assert r.passed, f"prefill: {r}"

    tokens = prompt
    token = jnp.argmax(logits_pf, -1).astype(jnp.int32)
    for i in range(3):
        tokens = jnp.concatenate([tokens, token[:, None]], axis=1)
        positions = jnp.full((b,), s + i, jnp.int32)
        logits_dec, caches = generate.decode_step(params, token, positions, caches, cfg)
        logits_ref = llama.forward(params, tokens, cfg)[:, -1]
        r = verify_results(logits_ref, logits_dec, rtol=3e-2, atol=5e-2)
        assert r.passed, f"step {i}: {r}"
        token = jnp.argmax(logits_dec, -1).astype(jnp.int32)


def test_generate_shapes_and_quant_agreement():
    cfg = TINY
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, cfg.vocab_size)
    out_bf16 = generate.generate(params, prompt, cfg, max_new_tokens=8)
    assert out_bf16.shape == (2, 8)
    out_int8 = generate.generate(params, prompt, cfg, max_new_tokens=8, quant="int8")
    # Random-init logits are near-uniform, so argmax can flip; require most
    # tokens to agree between bf16 and int8-KV decode.
    agree = float(jnp.mean((out_bf16 == out_int8).astype(jnp.float32)))
    assert agree >= 0.5, agree


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_sliding_window(quant):
    """Windowed decode matches the oracle restricted to the last W tokens,
    per-sequence (ragged lengths)."""
    import numpy as np
    from flashattn_tpu.ops.decode import decode_attention, decode_attention_chunk
    from flashattn_tpu.ops.kvcache import dequantize, init_cache, update_cache
    from flashattn_tpu.ops.reference import reference_attention
    from flashattn_tpu.utils.verify import verify_results

    b, hq, hkv, d, s_max, w = 3, 4, 2, 64, 512, 100
    lens = [512, 200, 60]
    cache = init_cache(b, hkv, s_max, d, quant=quant)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, s_max, d),
                           jnp.bfloat16)
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, s_max, d),
                           jnp.bfloat16)
    cache = update_cache(cache, kn, vn)
    cache = dataclasses.replace(cache,
                                length=jnp.asarray(lens, jnp.int32))
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, d), jnp.bfloat16)

    o = decode_attention(q, cache, window=w)
    kd = dequantize(cache.k, cache.k_scale).astype(jnp.float32)
    vd = dequantize(cache.v, cache.v_scale).astype(jnp.float32)
    for i, ln in enumerate(lens):
        lo = max(0, ln - w)
        o_ref = reference_attention(
            q[i:i + 1, :, None].astype(jnp.float32),
            kd[i:i + 1, :, lo:ln], vd[i:i + 1, :, lo:ln])
        r = verify_results(o_ref[:, :, 0], o[i:i + 1],
                           atol=3e-2, rtol=3e-2)
        assert r.passed, f"seq {i}: {r}"


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_chunked(quant):
    """Chunked decode: T new tokens attend cache + themselves causally; must
    equal the full-attention oracle rows."""
    from flashattn_tpu.ops.decode import decode_attention_chunk
    from flashattn_tpu.ops.kvcache import dequantize, init_cache, update_cache
    from flashattn_tpu.ops.reference import reference_attention
    from flashattn_tpu.utils.verify import verify_results

    b, hq, hkv, d, s_max, t = 2, 4, 2, 64, 512, 16
    prior = 100
    cache = init_cache(b, hkv, s_max, d, quant=quant)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, prior + t, d),
                           jnp.bfloat16)
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, prior + t, d),
                           jnp.bfloat16)
    cache = update_cache(cache, kn, vn)  # length = prior + t
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, t, d), jnp.bfloat16)

    o = decode_attention_chunk(q, cache)
    kd = dequantize(cache.k, cache.k_scale)[:, :, :prior + t].astype(
        jnp.float32)
    vd = dequantize(cache.v, cache.v_scale)[:, :, :prior + t].astype(
        jnp.float32)
    # Oracle: causal cross-attention of the t chunk rows vs all keys
    # (causal offset s_k - s_q aligns the chunk to the key tail).
    o_ref = reference_attention(q.astype(jnp.float32), kd, vd,
                                is_causal=True)
    r = verify_results(o_ref, o, atol=3e-2, rtol=3e-2)
    assert r.passed, r


def test_chunked_prefill_matches_prefill():
    from flashattn_tpu.models import generate, llama
    from flashattn_tpu.models.config import ModelConfig
    import numpy as np

    cfg = ModelConfig(
        vocab_size=64, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=2, num_kv_heads=2, head_dim=32, max_seq_len=256,
        dtype=jnp.float32,
    )
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 128), 0,
                                cfg.vocab_size, jnp.int32)
    caches_a = generate.init_caches(cfg, 2, 256)
    logits_a, caches_a = generate.prefill(params, tokens, caches_a, cfg)
    caches_b = generate.init_caches(cfg, 2, 256)
    logits_b, caches_b = generate.chunked_prefill(params, tokens, caches_b,
                                                  cfg, chunk=32)
    np.testing.assert_allclose(np.asarray(logits_b), np.asarray(logits_a),
                               rtol=2e-4, atol=2e-4)
    for ca, cb in zip(caches_a, caches_b):
        np.testing.assert_allclose(np.asarray(cb.k), np.asarray(ca.k),
                                   rtol=1e-5, atol=1e-5)
        assert jnp.array_equal(ca.length, cb.length)


@pytest.mark.parametrize("t_chunk", [1, 8])
def test_dead_cache_garbage_cannot_poison(t_chunk):
    """NaN/Inf in DEAD cache positions (beyond `length`) must not reach the
    output: P is 0 there, but 0*NaN = NaN would poison the P.V dot without
    the kernel's dead-row V guard. Recycled serving slots reset `length`
    without wiping the tail, so this is a reachable state, not a fuzz case."""
    import dataclasses

    b, hq, hkv, d, s_max, length = 1, 4, 2, 64, 256, 100
    cache = init_cache(b, hkv, s_max, d, dtype=jnp.float32)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, length, d))
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, length, d))
    cache = update_cache(cache, kn, vn)
    # poison everything beyond the live region
    poison = jnp.full((b, hkv, s_max - length, d), jnp.nan)
    cache = dataclasses.replace(
        cache,
        k=cache.k.at[:, :, length:].set(poison),
        v=cache.v.at[:, :, length:].set(poison),
    )
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, t_chunk, d))
    if t_chunk == 1:
        o = decode_attention(q[:, :, 0], cache)[:, :, None]
    else:
        o = decode_attention_chunk(q, cache)
    assert bool(jnp.isfinite(o).all()), "dead-region NaN leaked into output"
    o_ref = reference_attention(q, kn, vn, is_causal=True)
    r = verify_results(o_ref, o, atol=1e-5, rtol=1e-5)
    assert r.passed, r


@pytest.mark.parametrize("quant,kw", [
    ("int8", {"alibi": True}),
    ("fp8", {"alibi": True}),
    ("int8", {"logit_softcap": 30.0}),
    ("fp8", {"logit_softcap": 30.0}),
])
def test_decode_quant_variant_combinations(quant, kw):
    """Quantized caches compose with ALiBi / softcap: kernel vs the
    dequantized-cache oracle under the bf16 gate."""
    b, hq, hkv, d, s_max, length = 2, 4, 2, 64, 512, 300
    cache = init_cache(b, hkv, s_max, d, quant=quant)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, length, d),
                           jnp.bfloat16)
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, length, d),
                           jnp.bfloat16)
    cache = update_cache(cache, kn, vn)
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, d), jnp.bfloat16)
    o = decode_attention(q, cache, **kw)
    kd = dequantize(cache.k, cache.k_scale)[:, :, :length]
    vd = dequantize(cache.v, cache.v_scale)[:, :, :length]
    o_ref = reference_attention(q[:, :, None], kd, vd, is_causal=True,
                                **kw)[:, :, 0]
    r = verify_results(o_ref, o, rtol=2e-2, atol=5e-2)
    assert r.passed, r


@pytest.mark.parametrize("quant", [None, "int8"])
def test_decode_lse_matches_oracle(quant):
    """The LSE output (what sequence-sharded decode merges on) against the
    oracle's logsumexp over the live, dequantized cache."""
    from flashattn_tpu.ops.decode import _decode_attention
    from flashattn_tpu.ops.reference import reference_attention_with_lse

    b, hq, hkv, d, s_max, lens = 2, 4, 2, 64, 256, [256, 90]
    cache = init_cache(b, hkv, s_max, d, quant=quant)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, s_max, d),
                           jnp.bfloat16)
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, s_max, d),
                           jnp.bfloat16)
    cache = dataclasses.replace(update_cache(cache, kn, vn),
                                length=jnp.asarray(lens, jnp.int32))
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, 1, d), jnp.bfloat16)
    o, lse = _decode_attention(q, cache, with_lse=True)
    kd = dequantize(cache.k, cache.k_scale).astype(jnp.float32)
    vd = dequantize(cache.v, cache.v_scale).astype(jnp.float32)
    for i, ln in enumerate(lens):
        o_ref, lse_ref = reference_attention_with_lse(
            q[i:i + 1].astype(jnp.float32), kd[i:i + 1, :, :ln],
            vd[i:i + 1, :, :ln])
        assert verify_results(o_ref, o[i:i + 1], atol=2e-2, rtol=2e-2).passed
        np.testing.assert_allclose(np.asarray(lse[i:i + 1]),
                                   np.asarray(lse_ref), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("quant", [None, "fp8"])
def test_decode_chunk_window(quant):
    """Chunk rows each keep their OWN window edge (row t's window ends at
    its own position), against the causal-window oracle."""
    b, hq, hkv, d, s_max, t, w = 2, 4, 2, 64, 256, 8, 40
    cache = init_cache(b, hkv, s_max, d, quant=quant)
    n = 150
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, n, d),
                           jnp.bfloat16)
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, n, d),
                           jnp.bfloat16)
    cache = update_cache(cache, kn, vn)
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, t, d), jnp.bfloat16)
    o = decode_attention_chunk(q, cache, window=w)
    kd = dequantize(cache.k, cache.k_scale)[:, :, :n].astype(jnp.float32)
    vd = dequantize(cache.v, cache.v_scale)[:, :, :n].astype(jnp.float32)
    o_ref = reference_attention(q.astype(jnp.float32), kd, vd,
                                is_causal=True, window=w)
    r = verify_results(o_ref, o, atol=3e-2, rtol=3e-2)
    assert r.passed, r


def test_decode_alibi_matches_oracle():
    b, hq, hkv, d, s_max, length = 2, 8, 2, 64, 256, 200
    cache = init_cache(b, hkv, s_max, d, dtype=jnp.float32)
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, length, d))
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, length, d))
    cache = update_cache(cache, kn, vn)
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, d))
    o = decode_attention(q, cache, alibi=True)
    o_ref = reference_attention(q[:, :, None], kn, vn, is_causal=True,
                                alibi=True)[:, :, 0]
    r = verify_results(o_ref, o, atol=1e-5, rtol=1e-5)
    assert r.passed, r


def test_dead_cache_scale_garbage_cannot_poison():
    """NaN scales in dead positions of a quantized cache (a recycled slot's
    stale tail) must not reach the output either."""
    b, hq, hkv, d, s_max, length = 1, 4, 2, 64, 256, 100
    cache = init_cache(b, hkv, s_max, d, quant="int8")
    kn = jax.random.normal(jax.random.PRNGKey(0), (b, hkv, length, d),
                           jnp.bfloat16)
    vn = jax.random.normal(jax.random.PRNGKey(1), (b, hkv, length, d),
                           jnp.bfloat16)
    clean = update_cache(cache, kn, vn)
    poisoned = dataclasses.replace(
        clean,
        k_scale=clean.k_scale.at[..., length:].set(jnp.nan),
        v_scale=clean.v_scale.at[..., length:].set(jnp.nan),
    )
    q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, d), jnp.bfloat16)
    o = decode_attention(q, poisoned)
    assert bool(jnp.isfinite(o.astype(jnp.float32)).all())
    np.testing.assert_array_equal(np.asarray(o, np.float32),
                                  np.asarray(decode_attention(q, clean),
                                             np.float32))
