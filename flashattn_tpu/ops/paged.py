"""Paged KV cache + paged decode (vLLM-style block tables).

Production serving extension beyond the reference's scope (the reference has
no decode path at all). A contiguous per-slot cache (`ops/kvcache.py`)
reserves Smax tokens of device memory per sequence; a paged cache shares one
pool of fixed-size pages, so memory holds the *sum of live context*, not
`batch · Smax`:

  - `k_pages`/`v_pages`: [num_pages, Hkv, page_size, D] shared pool.
  - `block_table`: [B, max_pages_per_seq] int32 — logical block j of
    sequence b lives in physical page `block_table[b, j]`.
  - Decode gathers each slot's pages through the table into the dense
    layout and runs the dense decode math (`ops/decode.py`) unchanged, in
    logical positions — so paged and dense decode agree exactly.

Page allocation is host-side (`PageAllocator`): admission/eviction decide
page ownership in Python; the jitted steps only consume device arrays —
block tables are control plane, not data plane.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.decode import _decode_attention
from flashattn_tpu.ops.kvcache import (quantize_tokens,
                                        store_dtype_for)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVCache:
    """Functional paged KV cache for one layer (pool shared by all slots)."""

    k_pages: jnp.ndarray  # [P, Hkv, page, D] — bf16 | int8 | fp8
    v_pages: jnp.ndarray  # [P, Hkv, page, D]
    k_scale: jnp.ndarray | None  # [P, Hkv, 1, page] f32 (None if bf16)
    v_scale: jnp.ndarray | None
    block_table: jnp.ndarray  # [B, max_pages_per_seq] int32 physical pages
    length: jnp.ndarray  # [B] int32 — valid tokens per sequence

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def max_len(self) -> int:
        return self.block_table.shape[1] * self.page_size

    @property
    def batch(self) -> int:
        return self.block_table.shape[0]


def init_paged_cache(
    batch: int,
    num_kv_heads: int,
    num_pages: int,
    page_size: int,
    head_dim: int,
    max_pages_per_seq: int,
    dtype=jnp.bfloat16,
    quant: str | None = None,  # None | "int8" | "fp8"
) -> PagedKVCache:
    """Allocate the page pool + an all-zeros block table. Smaller pages
    share memory at finer grain; larger pages gather in fewer pieces."""
    store_dtype, scales = store_dtype_for(quant, dtype)
    shape = (num_pages, num_kv_heads, page_size, head_dim)
    zeros = jnp.zeros(shape, store_dtype)
    scale = (
        jnp.ones((num_pages, num_kv_heads, 1, page_size), jnp.float32)
        if scales else None
    )
    return PagedKVCache(
        k_pages=zeros,
        v_pages=jnp.zeros_like(zeros),
        k_scale=scale,
        v_scale=None if scale is None else jnp.ones_like(scale),
        block_table=jnp.zeros((batch, max_pages_per_seq), jnp.int32),
        length=jnp.zeros((batch,), jnp.int32),
    )


class PageAllocator:
    """Host-side reference-counted page allocator (control plane).

    The server owns one allocator per model (pages are shared across layers
    via identical tables, so allocation is per-sequence, not per-layer).
    Reference counts exist for prefix caching: a shared system-prompt's
    pages are retained once per sequence using them and freed when the last
    reference releases.
    """

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, -1, -1))
        self._rc = [0] * num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    def retain(self, pages: list[int]) -> None:
        """Add a reference to already-allocated pages (prefix sharing)."""
        for p in pages:
            assert self._rc[p] > 0, f"retain of free page {p}"
            self._rc[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            self._rc[p] -= 1
            assert self._rc[p] >= 0, f"double free of page {p}"
            if self._rc[p] == 0:
                self._free.append(p)


def pages_needed(tokens: int, page_size: int) -> int:
    return -(-tokens // page_size)


@jax.jit
def set_block_table(cache: PagedKVCache, slot, pages: jnp.ndarray,
                    length) -> PagedKVCache:
    """Install a sequence's page list + length into `slot` (admission).

    `pages` must be padded to max_pages_per_seq; entries past the length
    are gathered but masked (their positions are never visible).
    """
    return dataclasses.replace(
        cache,
        block_table=cache.block_table.at[slot].set(pages),
        length=cache.length.at[slot].set(length),
    )


@functools.partial(jax.jit, static_argnames=("first_block",))
def write_pages(
    cache: PagedKVCache,
    single,  # dense KVCache, B=1, same Hkv/D/quant (a prefill result)
    pages: jnp.ndarray,  # [n_blocks] int32; entries >= num_pages dropped
    first_block: int = 0,
) -> PagedKVCache:
    """Shard a single-sequence DENSE cache into pool pages (no table/length
    update — the pool-only half of admission, also used to install shared
    prefix pages that belong to no slot). Logical block first_block+j of
    the dense buffer lands in physical page `pages[j]` (first_block > 0 =
    install only a suffix, e.g. after a prefix-seeded prefill); entries
    >= num_pages are dropped by the scatter, so a caller only ever writes
    pages it owns."""
    p, hkv, page, d = cache.k_pages.shape
    nb = pages.shape[0]
    lo = first_block * page
    assert single.k.shape[0] == 1
    assert single.k.shape[2] >= lo + nb * page, (single.k.shape, nb, page)

    def shard(buf):  # [1, Hkv, S, D] -> [nb, Hkv, page, D]
        return buf[0, :, lo:lo + nb * page].reshape(
            hkv, nb, page, d).transpose(1, 0, 2, 3)

    k_pages = cache.k_pages.at[pages].set(shard(single.k), mode="drop")
    v_pages = cache.v_pages.at[pages].set(shard(single.v), mode="drop")
    if cache.quantized:
        def shard_s(buf):  # [1, Hkv, 1, S] -> [nb, Hkv, 1, page]
            return buf[0, :, 0, lo:lo + nb * page].reshape(
                hkv, nb, page).transpose(1, 0, 2)[:, :, None, :]
        k_scale = cache.k_scale.at[pages].set(shard_s(single.k_scale),
                                              mode="drop")
        v_scale = cache.v_scale.at[pages].set(shard_s(single.v_scale),
                                              mode="drop")
    else:
        k_scale = v_scale = None
    return dataclasses.replace(
        cache, k_pages=k_pages, v_pages=v_pages,
        k_scale=k_scale, v_scale=v_scale,
    )


def write_slot_paged(
    cache: PagedKVCache,
    single,  # dense KVCache, B=1, same Hkv/D/quant (a prefill result)
    slot,
    pages: jnp.ndarray,  # [max_pages_per_seq] int32; unowned entries >= P
) -> PagedKVCache:
    """Install a prefilled single-sequence DENSE cache into `slot`'s pages
    (continuous-batching admission: prefill runs contiguous B=1, then the
    filled cache shards into the pool page by page). The dense buffer's
    max_len must equal max_pages_per_seq * page_size."""
    maxp = cache.block_table.shape[1]
    assert single.k.shape[2] == maxp * cache.page_size, (
        single.k.shape, maxp, cache.page_size)
    cache = write_pages(cache, single, pages)
    return set_block_table(cache, slot, pages, single.length[0])


@functools.partial(jax.jit, static_argnames=("max_len",))
def pages_to_dense(
    cache: PagedKVCache,
    pages: jnp.ndarray,  # [n_blocks] int32 — pages holding the content
    max_len: int = 0,  # static: dense capacity
    length: jnp.ndarray | int = 0,
):
    """Gather pool pages back into a single-sequence DENSE KVCache of
    capacity max_len (raw quantized payload + scales copied verbatim — no
    requantization). Used to seed a suffix prefill with a shared prefix's
    K/V: positions [0, n_blocks·page) hold the gathered pages."""
    from flashattn_tpu.ops.kvcache import KVCache

    p, hkv, page, d = cache.k_pages.shape
    nb = pages.shape[0]
    n = nb * page
    assert max_len >= n, (max_len, n)

    def gather(buf):  # [P, Hkv, page, D] -> [1, Hkv, nb*page, D]
        g = buf[pages].transpose(1, 0, 2, 3).reshape(1, hkv, n, d)
        pad = jnp.zeros((1, hkv, max_len - n, d), buf.dtype)
        return jnp.concatenate([g, pad], axis=2)

    if cache.quantized:
        def gather_s(buf):  # [P, Hkv, 1, page] -> [1, Hkv, 1, max_len]
            g = buf[pages][:, :, 0].transpose(1, 0, 2).reshape(1, hkv, 1, n)
            pad = jnp.ones((1, hkv, 1, max_len - n), buf.dtype)
            return jnp.concatenate([g, pad], axis=3)
        k_scale, v_scale = gather_s(cache.k_scale), gather_s(cache.v_scale)
    else:
        k_scale = v_scale = None
    return KVCache(
        k=gather(cache.k_pages), v=gather(cache.v_pages),
        k_scale=k_scale, v_scale=v_scale,
        length=jnp.asarray([length], jnp.int32).reshape(1),
    )


@functools.partial(jax.jit, static_argnames=())
def append_paged(
    cache: PagedKVCache,
    k_new: jnp.ndarray,  # [B, Hkv, T, D] compute dtype
    v_new: jnp.ndarray,
    active: jnp.ndarray | None = None,  # [B] bool — continuous batching
) -> PagedKVCache:
    """Append T tokens per sequence at its current length, through the table.

    Token t of sequence b lands in physical page
    `table[b, (len_b + t) // page]` at row `(len_b + t) % page`. The write
    is one XLA scatter over the flattened (B·T) token list. Sequences must
    own enough pages (the server allocates ahead of the step). Inactive and
    past-capacity tokens are DROPPED (scatter mode="drop", index = P), so a
    masked append can never corrupt the pool — stronger than the dense
    cache's write-then-overwrite convention, whose clamped dynamic slice
    can clobber live data when an inactive slot sits near capacity.
    """
    b, hkv, t, d = k_new.shape
    page = cache.page_size
    if cache.quantized:
        k_q, k_s = quantize_tokens(k_new, cache.k_pages.dtype)
        v_q, v_s = quantize_tokens(v_new, cache.v_pages.dtype)
    else:
        k_q = k_new.astype(cache.k_pages.dtype)
        v_q = v_new.astype(cache.v_pages.dtype)
        k_s = v_s = None

    pos = cache.length[:, None] + jnp.arange(t)[None, :]  # [B, T] logical
    logical = pos // page  # [B, T] block index
    offs = (pos % page).reshape(-1)  # [B*T]
    max_pages_per_seq = cache.block_table.shape[1]
    pids = jnp.take_along_axis(
        cache.block_table,
        jnp.minimum(logical, max_pages_per_seq - 1), axis=1)  # [B, T]
    # Route dead writes to page index P: out of bounds -> scatter drops them.
    num_pages = cache.k_pages.shape[0]
    dead = logical >= max_pages_per_seq
    if active is not None:
        dead = dead | ~active[:, None]
    pids = jnp.where(dead, num_pages, pids).reshape(-1)  # [B*T]

    # [B, Hkv, T, D] -> [B*T, Hkv, D] scatter rows
    def put(pages_buf, vals):
        rows = vals.transpose(0, 2, 1, 3).reshape(b * t, hkv, d)
        return pages_buf.at[pids, :, offs, :].set(rows, mode="drop")

    k_pages = put(cache.k_pages, k_q)
    v_pages = put(cache.v_pages, v_q)
    if cache.quantized:
        def put_scale(buf, s):  # s: [B, Hkv, 1, T] -> rows [B*T, Hkv]
            rows = s[:, :, 0].transpose(0, 2, 1).reshape(b * t, hkv)
            return buf.at[pids, :, 0, offs].set(rows, mode="drop")
        k_scale = put_scale(cache.k_scale, k_s)
        v_scale = put_scale(cache.v_scale, v_s)
    else:
        k_scale = v_scale = None
    advance = t if active is None else t * active.astype(jnp.int32)
    return dataclasses.replace(
        cache, k_pages=k_pages, v_pages=v_pages,
        k_scale=k_scale, v_scale=v_scale,
        length=cache.length + advance,
    )


def gather_pages(cache: PagedKVCache):
    """The dense [B, Hkv, max_pages·page, D] view of every slot's pages (and
    scales), in logical order through the block table."""
    b, maxp = cache.block_table.shape
    _, hkv, page, d = cache.k_pages.shape

    def gather(buf):  # [P, Hkv, page, X] -> [B, Hkv, maxp·page, X]
        g = jnp.take(buf, cache.block_table, axis=0)  # [B, maxp, Hkv, page, X]
        return g.transpose(0, 2, 1, 3, 4).reshape(
            b, hkv, maxp * page, buf.shape[-1])

    def gather_scale(buf):  # [P, Hkv, 1, page] -> [B, Hkv, 1, maxp·page]
        if buf is None:
            return None
        return gather(buf.transpose(0, 1, 3, 2)).transpose(0, 1, 3, 2)

    return (gather(cache.k_pages), gather(cache.v_pages),
            gather_scale(cache.k_scale), gather_scale(cache.v_scale))


_STATIC = ("scale", "window", "sink", "logit_softcap", "alibi")


@functools.partial(jax.jit, static_argnames=_STATIC)
def paged_decode_attention(
    q: jnp.ndarray,  # [B, Hq, D] — one new token per sequence
    cache: PagedKVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,  # (Hq,) f32; None = standard
) -> jnp.ndarray:
    """Single-step decode against the paged cache -> [B, Hq, D]: the pages
    are gathered through the block table into the dense layout, then the
    dense decode math runs unchanged (logical positions throughout)."""
    return _paged_decode(q[:, :, None], cache, scale, window, sink,
                         logit_softcap, alibi, alibi_slopes)[:, :, 0]


@functools.partial(jax.jit, static_argnames=_STATIC)
def paged_decode_attention_chunk(
    q: jnp.ndarray,  # [B, Hq, T, D] — T new tokens per sequence
    cache: PagedKVCache,
    scale: float | None = None,
    window: int | None = None,
    sink: int = 0,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,  # (Hq,) f32; None = standard
) -> jnp.ndarray:
    """Chunked decode (chunked prefill / speculative verification) against
    the paged cache; the chunk's K/V must already be appended."""
    return _paged_decode(q, cache, scale, window, sink, logit_softcap, alibi,
                         alibi_slopes)


def _paged_decode(q, cache, scale, window, sink, logit_softcap, alibi,
                  alibi_slopes):
    from flashattn_tpu.ops.kvcache import KVCache

    assert q.shape[0] == cache.batch, (q.shape, cache.batch)
    # The barrier keeps the gather out of the decode's fusions, so the
    # decode math compiles exactly as on a dense cache (bit-equal results).
    k, v, k_scale, v_scale = jax.lax.optimization_barrier(gather_pages(cache))
    dense = KVCache(k=k, v=v, k_scale=k_scale, v_scale=v_scale,
                    length=cache.length)
    return _decode_attention(q, dense, scale, window, sink,
                             logit_softcap=logit_softcap, alibi=alibi,
                             alibi_slopes=alibi_slopes)
