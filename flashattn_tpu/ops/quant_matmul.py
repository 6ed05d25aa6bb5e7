"""Weight-only INT8/INT4 quantized matmuls (SURVEY.md §2.3 T8).

Absent from the reference (north_star: "weight-only INT8/INT4 matmuls for
the surrounding projections"). Decode-time projections are weight-streaming
bound, so halving/quartering weight bytes in device memory is the win.

Layout decisions:
  - scales are per-output-channel f32 [1, N] and multiply the [M, N]
    result — nothing touches the weights but the convert.
  - INT4 is nibble-packed along the CONTRACTION dim with a half-split
    permutation: byte row r holds original row r (low nibble) and row
    r + K/2 (high nibble). Unpacking yields the two contiguous K-halves
    directly, so the activations just slice [:, :K/2] / [:, K/2:] — no
    interleave relayout on either operand.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

INT8_MAX = 127.0
INT4_MAX = 7.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedLinear:
    """Weight-only quantized [K, N] projection."""

    w: jnp.ndarray  # int8: [K, N]; int4: [K/2, N] nibble-packed int8
    scale: jnp.ndarray  # [1, N] f32 — per-output-channel
    bits: int = dataclasses.field(metadata=dict(static=True), default=8)
    k: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def out_features(self) -> int:
        return self.w.shape[1]


def quantize_weights(w: jnp.ndarray, bits: int = 8) -> QuantizedLinear:
    """Symmetric per-output-channel quantization of w [K, N]."""
    k, n = w.shape
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=0, keepdims=True)  # [1, N]
    if bits == 8:
        scale = jnp.maximum(amax / INT8_MAX, 1e-10)
        q = jnp.clip(jnp.round(wf / scale), -INT8_MAX, INT8_MAX).astype(jnp.int8)
        return QuantizedLinear(w=q, scale=scale, bits=8, k=k)
    if bits == 4:
        assert k % 2 == 0, "int4 packing needs even K"
        scale = jnp.maximum(amax / INT4_MAX, 1e-10)
        q = jnp.clip(jnp.round(wf / scale), -INT4_MAX - 1, INT4_MAX).astype(jnp.int32)
        lo = q[: k // 2] & 0xF  # original rows [0, K/2)
        hi = q[k // 2 :] & 0xF  # original rows [K/2, K)
        packed = (lo | (hi << 4)).astype(jnp.uint8).view(jnp.int8)
        return QuantizedLinear(w=packed, scale=scale, bits=4, k=k)
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def dequantize_weights(qw: QuantizedLinear) -> jnp.ndarray:
    """Oracle dequant -> f32 [K, N]."""
    if qw.bits == 8:
        return qw.w.astype(jnp.float32) * qw.scale
    lo, hi = _unpack_int4(qw.w, jnp.float32)
    return jnp.concatenate([lo, hi], axis=0) * qw.scale


def _unpack_int4(w: jnp.ndarray, dtype) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Nibble-packed [K/2, N] -> the two contiguous K-halves in `dtype`."""
    raw = w.view(jnp.uint8).astype(jnp.int32)
    lo = ((raw & 0xF) ^ 8) - 8  # rows [0, K/2)
    hi = ((raw >> 4) ^ 8) - 8  # rows [K/2, K)
    return lo.astype(dtype), hi.astype(dtype)


def _dot(x, w, acc):
    precision = jax.lax.Precision.HIGHEST if x.dtype == jnp.float32 else None
    return jax.lax.dot_general(
        x, w, dimension_numbers=(((1,), (0,)), ((), ())),
        precision=precision, preferred_element_type=acc)


@functools.partial(jax.jit,
                   static_argnames=("out_dtype", "quantize_activations"))
def quant_matmul(
    x: jnp.ndarray,  # [M, K] bf16
    qw: QuantizedLinear,
    out_dtype=None,
    quantize_activations: bool = False,
) -> jnp.ndarray:
    """y = x @ dequant(qw): the int8/int4 weights convert to the activation
    dtype inside the product (XLA fuses the convert into the GEMM's operand
    load, so the weights cross memory at 1 or 1/2 byte per element) and the
    per-channel scale multiplies the [M, N] result.

    quantize_activations=True (W8A8 / W4A8): activations quantize per row
    (symmetric int8) and the product runs int8 x int8 -> int32; both scales
    fold into the result. Adds ~0.4% activation quantization noise.
    """
    m, k = x.shape
    assert k == qw.k, (k, qw.k)
    if out_dtype is None:
        out_dtype = x.dtype
    if quantize_activations:
        amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=1, keepdims=True)
        x_scale = jnp.maximum(amax / INT8_MAX, 1e-10)  # [M, 1]
        x = jnp.clip(jnp.round(x.astype(jnp.float32) / x_scale),
                     -INT8_MAX, INT8_MAX).astype(jnp.int8)
        cdt, acc = jnp.int8, jnp.int32
    else:
        x_scale = None
        cdt, acc = x.dtype, jnp.float32
    if qw.bits == 8:
        y = _dot(x, qw.w.astype(cdt), acc)
    else:
        lo, hi = _unpack_int4(qw.w, cdt)
        y = _dot(x[:, : k // 2], lo, acc) + _dot(x[:, k // 2:], hi, acc)
    y = y.astype(jnp.float32) * qw.scale
    if x_scale is not None:
        y = y * x_scale
    return y.astype(out_dtype)
