"""Multi-chip serving: KV caches sharded ACROSS devices (north_star:
"heads/KV-cache sharded over mesh axis").

Two modes:
  - Heads (TP): the decode kernel is mesh-oblivious per KV head — plain
    shard_map over the head dim, no new math (tests/test_decode_sharded.py).
  - Sequence: each device holds a contiguous SLICE of every sequence's
    cache (caches n× longer than one device's memory allows). Every device runs
    flash-decode over its slice with an LSE output, and the partials merge
    with the associative online-softmax algebra — the same correction the
    kernels apply per tile and ring attention applies per hop, here as two
    psums + a pmax.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from flashattn_tpu.ops.decode import _decode_attention
from flashattn_tpu.ops.kvcache import KVCache


def local_cache_lengths(global_len: jnp.ndarray, n_shards: int,
                        cap_local: int) -> jnp.ndarray:
    """[B] global lengths -> [n_shards, B] per-shard local lengths for a
    contiguous split: shard i owns positions [i·cap, (i+1)·cap)."""
    i = jnp.arange(n_shards)[:, None]
    return jnp.clip(global_len[None] - i * cap_local, 0, cap_local)


def sequence_sharded_decode(
    q: jnp.ndarray,  # [B, Hq, D] — replicated across the axis
    cache: KVCache,  # the LOCAL shard: [B, Hkv, cap_local, D], local length
    axis_name: str,
    scale: float | None = None,
    window: int | None = None,
) -> jnp.ndarray:
    """Decode against a sequence-sharded cache; call INSIDE shard_map.

    Window note: positions are shard-local, so `window` is only supported
    when it covers the full live range (pass None for sharded windows)."""
    assert window is None, "sliding window + sequence sharding: use TP/heads"
    o_p, lse_p = _decode_attention(q[:, :, None], cache, scale,
                                   with_lse=True)
    o_p, lse_p = o_p[:, :, 0], lse_p[:, :, 0]  # [B,Hq,D], [B,Hq]
    m = lax.pmax(lse_p, axis_name)
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w = jnp.where(jnp.isneginf(lse_p), 0.0, jnp.exp(lse_p - m_safe))
    num = lax.psum(w[..., None] * o_p.astype(jnp.float32), axis_name)
    den = lax.psum(w, axis_name)
    den = jnp.where(den == 0.0, 1.0, den)
    return (num / den[..., None]).astype(q.dtype)


def shard_cache(cache: KVCache, n_shards: int) -> KVCache:
    """Global-view helper: re-layout a [B, Hkv, S, D] cache so a contiguous
    shard_map split over the S dim hands each device its slice with the
    right LOCAL length stored alongside (lengths become [n, B] and are
    split over the same axis via PartitionSpec)."""
    b, hkv, s, d = cache.k.shape
    assert s % n_shards == 0
    cap = s // n_shards
    lengths = local_cache_lengths(cache.length, n_shards, cap)  # [n, B]
    return dataclasses.replace(cache, length=lengths)


def cache_specs(seq_axis: str) -> KVCache:
    """PartitionSpecs for a sequence-sharded cache (after shard_cache)."""
    return KVCache(
        k=P(None, None, seq_axis), v=P(None, None, seq_axis),
        k_scale=P(None, None, None, seq_axis),
        v_scale=P(None, None, None, seq_axis),
        length=P(seq_axis),
    )


def sharded_decode_attention(
    q: jnp.ndarray,  # [B, Hq, D]
    cache: KVCache,  # global view [B, Hkv, S, D] with global lengths
    mesh,
    seq_axis: str = "sp",
    scale: float | None = None,
) -> jnp.ndarray:
    """Global-view convenience: split the cache over `seq_axis` and decode."""
    n = mesh.shape[seq_axis]
    cache_n = shard_cache(cache, n)

    def body(q, c):
        c = dataclasses.replace(c, length=c.length[0])
        return sequence_sharded_decode(q, c, seq_axis, scale=scale)

    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), cache_specs(seq_axis)),
        out_specs=P(),
        check_vma=False,
    )(q, cache_n)
