"""Weight-only INT8/INT4 matmul tests: kernel vs dequantized-oracle matmul,
packing roundtrip, ragged M, and block-size invariance (the int4 nibble
pairing must hold for every K tiling)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.utils.verify import verify_results

from flashattn_tpu.ops.quant_matmul import (
    dequantize_weights,
    quant_matmul,
    quantize_weights,
)


def make(m, k, n, seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x = jax.random.normal(k1, (m, k), jnp.bfloat16)
    w = jax.random.normal(k2, (k, n), jnp.float32) * 0.02
    return x, w


@pytest.mark.parametrize("bits", [8, 4])
def test_kernel_matches_dequant_oracle(bits):
    x, w = make(64, 1024, 512)
    qw = quantize_weights(w, bits=bits)
    y = quant_matmul(x, qw)
    y_oracle = jnp.dot(x.astype(jnp.float32), dequantize_weights(qw))
    rel = float(
        jnp.max(jnp.abs(y.astype(jnp.float32) - y_oracle))
        / (float(jnp.max(jnp.abs(y_oracle))) + 1e-9)
    )
    assert rel < 5e-2, rel


@pytest.mark.parametrize("bits,tol", [(8, 0.01), (4, 0.1)])
def test_dequant_roundtrip(bits, tol):
    _, w = make(8, 256, 256)
    qw = quantize_weights(w, bits=bits)
    w_rt = dequantize_weights(qw)
    rel = float(jnp.max(jnp.abs(w_rt - w)) / jnp.max(jnp.abs(w)))
    assert rel < tol, rel


def test_int4_tiling_invariance():
    """The half-split nibble pairing: packed row r carries original rows r
    and r + K/2, and the product must pair each plane with its own half of
    x — identical to the f32 product against the dequantized weights."""
    x, w = make(16, 1024, 256)
    qw = quantize_weights(w, bits=4)
    y = quant_matmul(x.astype(jnp.float32), qw)
    y_ref = x.astype(jnp.float32) @ dequantize_weights(qw)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               atol=1e-4, rtol=1e-4)


def test_ragged_m():
    x, w = make(13, 512, 256)
    qw = quantize_weights(w, bits=8)
    y = quant_matmul(x, qw)
    assert y.shape == (13, 256)
    y_oracle = jnp.dot(x.astype(jnp.float32), dequantize_weights(qw))
    rel = float(
        jnp.max(jnp.abs(y.astype(jnp.float32) - y_oracle))
        / float(jnp.max(jnp.abs(y_oracle)))
    )
    assert rel < 5e-2, rel


@pytest.mark.parametrize("k,n", [(5632, 2048), (2048, 32000)])
def test_quant_matmul_awkward_real_dims(k, n):
    """LLAMA-1B's real projection dims (5632 = 512*11, 32000 = 256*125) are
    128-multiples but not powers of two; block sizes must adapt."""
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (4, k), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(1), (k, n), jnp.float32) * 0.02
    qw = quantize_weights(w, bits=8)
    y = quant_matmul(x, qw)
    y_ref = x @ dequantize_weights(qw)
    r = verify_results(y_ref, y, atol=1e-3, rtol=1e-3)
    assert r.passed, r


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_matmul_a8(bits):
    """W8A8 / W4A8: int8 x int8 product with per-row activation quantization —
    accuracy budget is looser (activation quant noise ~0.4%)."""
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(key, (16, 512), jnp.float32)
    w = jax.random.normal(jax.random.PRNGKey(4), (512, 256), jnp.float32) * 0.05
    qw = quantize_weights(w, bits=bits)
    y = quant_matmul(x, qw, quantize_activations=True)
    y_ref = x @ dequantize_weights(qw)
    r = verify_results(y_ref, y, atol=5e-2, rtol=5e-2)
    assert r.passed, r
