"""Decode attention: new tokens attend a (quantized) KV cache, in plain
`jax.numpy`.

Decode reads the whole cache once per step for a few query rows, so it sits
far below the GPU's compute/bandwidth ridge: the only lever is the bytes
moved, and XLA's fusion of the masked dot -> softmax -> dot chain already
reads each cache byte once. The quantized caches store int8/fp8 values with
per-token scales (kvcache.py); the dequantization folds into the small
tensors instead of the cache:

    S  = (q̃ · K_qᵀ) ⊙ k_scale      (k scale on the logits)
    O  = (P ⊙ v_scale) · V_q        (v scale on P)

and the int8/fp8 -> bf16 convert feeds the dot directly. Logits and the
softmax accumulate in float32.

Queries of one KV group decode together ([B, Hkv, G·T, D] rows), so GQA
reads each cache head once, not q_per_kv times.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.kvcache import KVCache


def _decode_rows(q, k, v, k_scale, v_scale, length, *, scale, window, sink,
                 logit_softcap, slopes, with_lse):
    """Shared decode math over a dense [B, Hkv, S, D] view of the cache.

    q: [B, Hq, T, D] — token t of the chunk sits at position length - T + t
    and attends positions <= its own (and within the window, if any).
    """
    b, hq, t_chunk, d = q.shape
    _, hkv, s_max, _ = k.shape
    group = hq // hkv
    rows = group * t_chunk
    compute = jnp.float32 if k.dtype == jnp.float32 else jnp.bfloat16
    qg = q.reshape(b, hkv, rows, d).astype(compute)
    s = jnp.einsum("bhrd,bhsd->bhrs", qg, k.astype(compute),
                   preferred_element_type=jnp.float32)
    if k_scale is not None:
        s = s * k_scale  # [B, Hkv, 1, S]: per-token k dequant
    s = s * scale
    if logit_softcap:
        s = logit_softcap * jnp.tanh(s / logit_softcap)

    pos = jnp.arange(s_max, dtype=jnp.int32)  # [S]
    t_idx = jnp.arange(rows, dtype=jnp.int32) % t_chunk  # row -> chunk token
    row_pos = (length[:, None] - t_chunk + t_idx[None, :])  # [B, rows]
    row_pos = row_pos[:, None, :, None]  # [B, 1, rows, 1]
    if slopes is not None:
        # Per-row slope: rows are head-major, chunk-minor.
        row_slope = jnp.repeat(slopes.astype(jnp.float32).reshape(hkv, group),
                               t_chunk, axis=1)[None, :, :, None]
        s = s + row_slope * (pos - row_pos).astype(jnp.float32)
    live = pos <= row_pos
    if window is not None:
        in_win = pos > row_pos - window
        if sink:  # StreamingLLM: the first `sink` tokens never evict
            in_win = in_win | (pos < sink)
        live = live & in_win
    s = jnp.where(live, s, -jnp.inf)

    m = jnp.max(s, axis=-1, keepdims=True)
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.where(live, jnp.exp(s - m_safe), 0.0)
    l = jnp.sum(p, axis=-1, keepdims=True)
    if v_scale is not None:
        p = jnp.where(live, p * v_scale, 0.0)  # [B, Hkv, 1, S]
    # Positions at or past `length` may hold anything (a recycled slot keeps
    # its old tail): P is 0 there, but 0 * NaN would poison the dot.
    v = jnp.where((pos < length[:, None])[:, None, :, None], v,
                  jnp.zeros((), v.dtype))
    o = jnp.einsum("bhrs,bhsd->bhrd", p.astype(compute), v.astype(compute),
                   preferred_element_type=jnp.float32)
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = (o / l_safe).astype(q.dtype).reshape(b, hq, t_chunk, d)
    if not with_lse:
        return o
    lse = jnp.where(l == 0.0, -jnp.inf, m_safe + jnp.log(l_safe))
    return o, lse.reshape(b, hq, t_chunk)


def _slopes(alibi, alibi_slopes, hq):
    if not alibi:
        return None
    if alibi_slopes is None:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        alibi_slopes = default_alibi_slopes(hq)
    return alibi_slopes


def _decode_attention(
    q: jnp.ndarray,  # [B, Hq, T, D]
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    with_lse: bool = False,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,
):
    assert sink == 0 or window is not None, "sink requires window"
    b, hq, t_chunk, d = q.shape
    _, hkv, _, dk = cache.k.shape
    assert dk == d and hq % hkv == 0
    assert not (alibi and logit_softcap), "alibi + softcap: pick one"
    return _decode_rows(
        q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.length,
        scale=1.0 / (d**0.5) if scale is None else scale, window=window,
        sink=sink, logit_softcap=logit_softcap,
        slopes=_slopes(alibi, alibi_slopes, hq), with_lse=with_lse)


_STATIC = ("scale", "window", "sink", "logit_softcap", "alibi")


@functools.partial(jax.jit, static_argnames=_STATIC)
def decode_attention(
    q: jnp.ndarray,  # [B, Hq, D] — one new token per sequence
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,  # (Hq,) f32; None = standard
) -> jnp.ndarray:
    """Single-step decode attention against the cache -> [B, Hq, D].

    The new token's K/V must already be appended (kvcache.update_cache), so
    position t attends tokens [0, length) including itself — or only the
    last `window` of them (sliding window). sink > 0 (requires window) keeps
    the first `sink` tokens always visible in addition to the window —
    StreamingLLM-style attention sinks.
    """
    return _decode_attention(q[:, :, None], cache, scale, window, sink,
                             logit_softcap=logit_softcap, alibi=alibi,
                             alibi_slopes=alibi_slopes)[:, :, 0]


@functools.partial(jax.jit, static_argnames=_STATIC)
def decode_attention_chunk(
    q: jnp.ndarray,  # [B, Hq, T, D] — T new tokens per sequence
    cache: KVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,  # (Hq,) f32; None = standard
) -> jnp.ndarray:
    """Chunked decode: T new tokens attend the cache + themselves causally
    (chunked prefill / speculative-verification primitive) -> [B, Hq, T, D].

    The chunk's K/V must already be appended: token t of the chunk sits at
    position length - T + t and attends positions <= its own."""
    return _decode_attention(q, cache, scale, window, sink,
                             logit_softcap=logit_softcap, alibi=alibi,
                             alibi_slopes=alibi_slopes)
