"""KV cache with optional FP8/INT8 quantization (SURVEY.md §2.3 T6).

The reference defers everything decode-related; BASELINE.json's north_star
specifies a decode path with FP8/INT8 quantized KV cache and the dequant
folded into the QKᵀ and PV products.

Quantization scheme:
  - per-token, per-kv-head symmetric scales: scale = amax(|k_t|) / qmax
  - scales are stored [B, Hkv, 1, S] (token dim last) so decode folds them
    into the logits / probabilities AFTER the dots:
        S  = (q̃ · K_q^T) ⊙ k_scale      (k dequant folded into logits)
        O  = (P ⊙ v_scale) · V_q         (v dequant folded into P)
    leaving only the int8/fp8 -> bf16 convert on the cache operand.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

FP8_DTYPE = jnp.float8_e4m3fn
FP8_MAX = 448.0
INT8_MAX = 127.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """Functional KV cache for one layer. All updates return a new pytree."""

    k: jnp.ndarray  # [B, Hkv, Smax, D] — bf16 | int8 | fp8
    v: jnp.ndarray  # [B, Hkv, Smax, D]
    k_scale: jnp.ndarray | None  # [B, Hkv, 1, Smax] f32 (None if bf16)
    v_scale: jnp.ndarray | None
    length: jnp.ndarray  # [B] int32 — valid tokens per sequence

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def store_dtype_for(quant: str | None, dtype):
    """(storage dtype, has_scales) for a KV quant mode — the single
    dispatch shared by the dense and paged cache constructors."""
    if quant is None:
        return dtype, False
    if quant == "int8":
        return jnp.int8, True
    if quant == "fp8":
        return FP8_DTYPE, True
    raise ValueError(f"unknown quant mode {quant!r}")


def init_cache(
    batch: int,
    num_kv_heads: int,
    max_len: int,
    head_dim: int,
    dtype=jnp.bfloat16,
    quant: str | None = None,  # None | "int8" | "fp8"
) -> KVCache:
    store_dtype, scales = store_dtype_for(quant, dtype)
    shape = (batch, num_kv_heads, max_len, head_dim)
    zeros = jnp.zeros(shape, store_dtype)
    scale = (
        jnp.ones((batch, num_kv_heads, 1, max_len), jnp.float32)
        if scales else None
    )
    return KVCache(
        k=zeros,
        v=jnp.zeros_like(zeros),
        k_scale=scale,
        v_scale=None if scale is None else jnp.ones_like(scale),
        length=jnp.zeros((batch,), jnp.int32),
    )


def quantize_tokens(x: jnp.ndarray, store_dtype) -> tuple[jnp.ndarray, jnp.ndarray]:
    """x [B, Hkv, T, D] -> (values [B,Hkv,T,D] quantized, scales [B,Hkv,1,T])."""
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1)  # [B,Hkv,T]
    qmax = INT8_MAX if store_dtype == jnp.int8 else FP8_MAX
    scale = jnp.maximum(amax / qmax, 1e-8)
    scaled = x.astype(jnp.float32) / scale[..., None]
    if store_dtype == jnp.int8:
        q = jnp.clip(jnp.round(scaled), -INT8_MAX, INT8_MAX).astype(jnp.int8)
    else:
        q = scaled.astype(store_dtype)
    return q, scale[:, :, None, :]  # scales [B,Hkv,1,T]


def update_cache(
    cache: KVCache,
    k_new: jnp.ndarray,
    v_new: jnp.ndarray,
    active: jnp.ndarray | None = None,
    assume_fits: bool = False,
) -> KVCache:
    """Append T new tokens per sequence at the current length.

    k_new/v_new: [B, Hkv, T, D] in compute dtype (bf16). Quantizes on insert
    when the cache is quantized. `active` [B] bool (continuous batching):
    inactive sequences do not advance AND their buffers are preserved
    bit-exactly — the slice at their length is read back and re-written, so
    a masked append can never clobber live data (the clamped
    dynamic_update_slice otherwise shifts into the live region for slots
    within T of capacity).

    Appends past capacity are DROPPED (the row's buffer and length are
    preserved), mirroring append_paged's semantics — the clamped
    dynamic_update_slice would otherwise silently overwrite the row's last
    T live tokens. The drop guard needs the same read-back masking as
    `active`; callers that guarantee capacity (prefill into a fresh cache,
    admission-checked appends) pass `assume_fits=True` to keep the
    write-only fast path — the read-back would double a prefill's cache
    memory traffic.
    """
    b, hkv, t, d = k_new.shape
    assert t <= cache.k.shape[2], (t, cache.k.shape)
    if not assume_fits:
        fits = cache.length + t <= cache.k.shape[2]
        active = fits if active is None else (active & fits)
    if cache.quantized:
        k_q, k_s = quantize_tokens(k_new, cache.k.dtype)
        v_q, v_s = quantize_tokens(v_new, cache.v.dtype)
    else:
        k_q, v_q = k_new.astype(cache.k.dtype), v_new.astype(cache.v.dtype)
        k_s = v_s = None

    def upd_one(buf, new, length):
        # per-sequence dynamic slice update at its own length
        def body(buf_b, new_b, len_b, act_b):
            if active is not None:
                cur = jax.lax.dynamic_slice(
                    buf_b, (0, len_b, 0), new_b.shape)
                new_b = jnp.where(act_b, new_b, cur)
            return jax.lax.dynamic_update_slice(
                buf_b, new_b, (0, len_b, 0)
            )
        act = (jnp.ones((b,), bool) if active is None else active)
        return jax.vmap(body)(buf, new, length, act)

    k = upd_one(cache.k, k_q, cache.length)
    v = upd_one(cache.v, v_q, cache.length)
    if cache.quantized:
        def upd_scale(buf, new, length):
            def body(buf_b, new_b, len_b, act_b):
                if active is not None:
                    cur = jax.lax.dynamic_slice(
                        buf_b, (0, 0, len_b), new_b.shape)
                    new_b = jnp.where(act_b, new_b, cur)
                return jax.lax.dynamic_update_slice(buf_b, new_b, (0, 0, len_b))
            act = (jnp.ones((b,), bool) if active is None else active)
            return jax.vmap(body)(buf, new, length, act)

        k_scale = upd_scale(cache.k_scale, k_s, cache.length)
        v_scale = upd_scale(cache.v_scale, v_s, cache.length)
    else:
        k_scale = v_scale = None
    advance = t if active is None else t * active.astype(jnp.int32)
    return KVCache(
        k=k, v=v, k_scale=k_scale, v_scale=v_scale,
        length=cache.length + advance,
    )


def dequantize(values: jnp.ndarray, scales: jnp.ndarray | None) -> jnp.ndarray:
    """Reference dequant (oracle path): [B,Hkv,S,D] x [B,Hkv,1,S] -> bf16."""
    if scales is None:
        return values
    out = values.astype(jnp.float32) * scales.transpose(0, 1, 3, 2)
    return out.astype(jnp.bfloat16)


def write_slot(batch: KVCache, single: KVCache, slot) -> KVCache:
    """Install a single-sequence cache (B=1, same Smax/layout) into `slot`
    of a batch cache — continuous-batching admission. The slot's previous
    contents are logically dead (length resets), so only [0, single.length)
    matters; the whole buffer row is copied for a static shape."""
    assert single.k.shape[0] == 1 and single.k.shape[1:] == batch.k.shape[1:]
    assert (single.k_scale is None) == (batch.k_scale is None)
    slot = jnp.asarray(slot, jnp.int32)

    def put(buf, new):
        return jax.lax.dynamic_update_slice(
            buf, new.astype(buf.dtype), (slot,) + (0,) * (buf.ndim - 1))

    return KVCache(
        k=put(batch.k, single.k),
        v=put(batch.v, single.v),
        k_scale=None if batch.k_scale is None else put(batch.k_scale,
                                                       single.k_scale),
        v_scale=None if batch.v_scale is None else put(batch.v_scale,
                                                       single.v_scale),
        length=batch.length.at[slot].set(single.length[0]),
    )
