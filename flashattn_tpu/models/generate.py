"""Prefill + decode generation on the Llama stack (SURVEY.md §2.3 T6/T12).

Functional inference engine: per-layer KVCache pytrees threaded through a
lax.scan-free greedy loop (jit one step; the Python loop is dispatch-only),
prefill through the fused training-path kernel, decode through
`ops/decode.py` with optional FP8/INT8 quantized caches.
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp

from flashattn_tpu.models import llama
from flashattn_tpu.models.config import ModelConfig
from flashattn_tpu.ops.decode import decode_attention
from flashattn_tpu.ops.kvcache import KVCache, init_cache, update_cache
from flashattn_tpu.ops.paged import (
    PagedKVCache,
    append_paged,
    paged_decode_attention,
    paged_decode_attention_chunk,
)

Params = dict[str, Any]


def init_caches(
    cfg: ModelConfig, batch: int, max_len: int, quant: str | None = None
) -> list[KVCache]:
    return [
        init_cache(batch, cfg.num_kv_heads, max_len, cfg.head_dim,
                   dtype=cfg.dtype, quant=quant)
        for _ in range(cfg.num_layers)
    ]


@functools.partial(jax.jit, static_argnames=("cfg", "return_all"))
def prefill(
    params: Params,
    tokens: jnp.ndarray,  # [B, S] int32
    caches: list[KVCache],
    cfg: ModelConfig,
    return_all: bool = False,
) -> tuple[jnp.ndarray, list[KVCache]]:
    """Run the prompt through the training-path kernels, filling the caches.
    Returns (logits [B, vocab] for the LAST position — or [B, S, vocab] for
    every position when return_all (padded-prompt serving) — and caches)."""
    b, s = tokens.shape
    x = llama.embed_tokens(params, tokens, cfg)
    positions = jnp.arange(s)
    cos, sin = ((None, None) if cfg.use_alibi
                else llama.rope_tables(cfg, positions))

    new_caches = []
    for i, (layer, cache) in enumerate(zip(params["layers"], caches)):
        xn = llama.rms_norm(x, layer["attn_norm"], cfg.norm_eps,
                            cfg.norm_offset)
        q = llama.qkv_proj(xn, layer, cfg, "q").reshape(
            b, s, cfg.num_heads, cfg.head_dim)
        k = llama.qkv_proj(xn, layer, cfg, "k").reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        v = llama.qkv_proj(xn, layer, cfg, "v").reshape(
            b, s, cfg.num_kv_heads, cfg.head_dim)
        q, k = llama.apply_qk_norm(q, k, layer, cfg)
        q, k, v = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
        if not cfg.use_alibi:
            q = llama.apply_rope(q, cos, sin)
            k = llama.apply_rope(k, cos, sin)
        if isinstance(cache, PagedKVCache):
            new_caches.append(append_paged(cache, k, v))
        else:
            # Prefill fills a fresh cache and admission bounds the prompt,
            # so the drop guard's read-back is skipped (write-only path).
            new_caches.append(update_cache(cache, k, v, assume_fits=True))
        from flashattn_tpu.ops.attention import flash_attention

        o = flash_attention(q, k, v, is_causal=True,
                            window=llama.layer_window(cfg, i),
                            scale=cfg.attn_scale,
                            logit_softcap=cfg.logit_softcap,
                            alibi=cfg.use_alibi)
        o = o.transpose(0, 2, 1, 3).reshape(b, s, cfg.num_heads * cfg.head_dim)
        a = llama.proj(o, layer["wo"])
        if cfg.use_post_norms:
            a = llama.rms_norm(a, layer["post_attn_norm"], cfg.norm_eps,
                               cfg.norm_offset)
        x = x + a
        m = llama._mlp_block(layer, x, cfg)
        if cfg.use_post_norms:
            m = llama.rms_norm(m, layer["post_mlp_norm"], cfg.norm_eps,
                               cfg.norm_offset)
        x = x + m

    logits = llama.lm_logits(x if return_all else x[:, -1], params, cfg)
    return logits, new_caches


@functools.partial(jax.jit, static_argnames=("cfg",))
def decode_step(
    params: Params,
    token: jnp.ndarray,  # [B] int32 — the token just sampled
    positions: jnp.ndarray,  # [B] int32 — its position index
    caches: list[KVCache],
    cfg: ModelConfig,
    active: jnp.ndarray | None = None,  # [B] bool — continuous batching
) -> tuple[jnp.ndarray, list[KVCache]]:
    """One decode step -> (logits [B, vocab], updated caches).

    Inactive slots (active=False) compute but do not advance their cache —
    their logits are garbage and must be ignored by the caller.

    Caches may be dense (KVCache) or paged (PagedKVCache): the dispatch is
    on pytree structure, i.e. static at trace time."""
    b = token.shape[0]
    x = llama.embed_tokens(params, token, cfg)  # [B, H]
    cos, sin = ((None, None) if cfg.use_alibi
                else llama.rope_tables(cfg, positions))  # [B, hd/2]

    new_caches = []
    for i, (layer, cache) in enumerate(zip(params["layers"], caches)):
        paged = isinstance(cache, PagedKVCache)
        xn = llama.rms_norm(x, layer["attn_norm"], cfg.norm_eps,
                            cfg.norm_offset)
        q = llama.qkv_proj(xn, layer, cfg, "q").reshape(
            b, cfg.num_heads, 1, cfg.head_dim)
        k = llama.qkv_proj(xn, layer, cfg, "k").reshape(
            b, cfg.num_kv_heads, 1, cfg.head_dim)
        v = llama.qkv_proj(xn, layer, cfg, "v").reshape(
            b, cfg.num_kv_heads, 1, cfg.head_dim)
        q, k = llama.apply_qk_norm(q, k, layer, cfg)
        if not cfg.use_alibi:
            q = llama.apply_rope(q, cos[:, None], sin[:, None])
            k = llama.apply_rope(k, cos[:, None], sin[:, None])
        cache = (append_paged if paged else update_cache)(
            cache, k, v, active=active)
        new_caches.append(cache)
        attn = paged_decode_attention if paged else decode_attention
        win = llama.layer_window(cfg, i)
        o = attn(q[:, :, 0], cache, scale=cfg.attn_scale,
                 window=win, sink=cfg.attn_sink if win else 0,
                 logit_softcap=cfg.logit_softcap,
                 alibi=cfg.use_alibi)  # [B, Hq, D]
        o = o.reshape(b, cfg.num_heads * cfg.head_dim)
        a = llama.proj(o, layer["wo"])
        if cfg.use_post_norms:
            a = llama.rms_norm(a, layer["post_attn_norm"], cfg.norm_eps,
                               cfg.norm_offset)
        x = x + a
        m = llama._mlp_block(layer, x[:, None], cfg)[:, 0]
        if cfg.use_post_norms:
            m = llama.rms_norm(m, layer["post_mlp_norm"], cfg.norm_eps,
                               cfg.norm_offset)
        x = x + m

    logits = llama.lm_logits(x, params, cfg)
    return logits, new_caches


def generate(
    params: Params,
    prompt: jnp.ndarray,  # [B, S] int32
    cfg: ModelConfig,
    max_new_tokens: int = 32,
    max_len: int | None = None,
    quant: str | None = None,
    sampling=None,  # SamplingParams; None = greedy
    rng: jax.Array | None = None,
) -> jnp.ndarray:
    """Greedy (default) or sampled generation -> [B, max_new_tokens]."""
    from flashattn_tpu.models.sampling import SamplingParams, sample

    b, s = prompt.shape
    if max_len is None:
        max_len = -(-(s + max_new_tokens) // 128) * 128
    if sampling is None:
        sampling = SamplingParams(temperature=0.0)
    if rng is None:
        rng = jax.random.PRNGKey(0)
    caches = init_caches(cfg, b, max_len, quant=quant)
    logits, caches = prefill(params, prompt, caches, cfg)
    rng, sub = jax.random.split(rng)
    token = sample(logits, sub, sampling)
    out = [token]
    for i in range(max_new_tokens - 1):
        positions = jnp.full((b,), s + i, jnp.int32)
        logits, caches = decode_step(params, token, positions, caches, cfg)
        rng, sub = jax.random.split(rng)
        token = sample(logits, sub, sampling)
        out.append(token)
    return jnp.stack(out, axis=1)


@functools.partial(jax.jit, static_argnames=("cfg",))
def chunk_step(
    params: Params,
    piece: jnp.ndarray,  # [B, C] int32 — C new tokens per sequence
    positions: jnp.ndarray,  # [C] or [B, C] int32 — their position indices
    caches: list[KVCache],
    cfg: ModelConfig,
    active: jnp.ndarray | None = None,  # [B] bool — continuous batching
) -> tuple[jnp.ndarray, list[KVCache]]:
    """Process C new tokens against the caches (appending them): the
    multi-token analogue of decode_step, via the chunked-decode kernel.
    Caches may be dense or paged (chunked prefill straight into pages).
    Inactive rows compute but do not advance (chunked admission runs one
    slot's prefill chunk while the rest of the batch holds still).
    Returns (logits [B, C, vocab] for every chunk position, caches)."""
    from flashattn_tpu.ops.decode import decode_attention_chunk

    b, chunk = piece.shape
    x = llama.embed_tokens(params, piece, cfg)  # [B, C, H]
    cos, sin = ((None, None) if cfg.use_alibi
                else llama.rope_tables(cfg, positions))
    new_caches = []
    for i, (layer, cache) in enumerate(zip(params["layers"], caches)):
        paged = isinstance(cache, PagedKVCache)
        xn = llama.rms_norm(x, layer["attn_norm"], cfg.norm_eps,
                            cfg.norm_offset)
        q = llama.qkv_proj(xn, layer, cfg, "q").reshape(
            b, chunk, cfg.num_heads, cfg.head_dim)
        k = llama.qkv_proj(xn, layer, cfg, "k").reshape(
            b, chunk, cfg.num_kv_heads, cfg.head_dim)
        v = llama.qkv_proj(xn, layer, cfg, "v").reshape(
            b, chunk, cfg.num_kv_heads, cfg.head_dim)
        q, k = llama.apply_qk_norm(q, k, layer, cfg)
        q, k, v = (t.transpose(0, 2, 1, 3) for t in (q, k, v))
        if not cfg.use_alibi:
            q = llama.apply_rope(q, cos, sin)
            k = llama.apply_rope(k, cos, sin)
        cache = (append_paged if paged else update_cache)(
            cache, k, v, active=active)
        new_caches.append(cache)
        attn = (paged_decode_attention_chunk if paged
                else decode_attention_chunk)
        win = llama.layer_window(cfg, i)
        o = attn(q, cache, scale=cfg.attn_scale,
                 window=win, sink=cfg.attn_sink if win else 0,
                 logit_softcap=cfg.logit_softcap,
                 alibi=cfg.use_alibi)
        o = o.transpose(0, 2, 1, 3).reshape(
            b, chunk, cfg.num_heads * cfg.head_dim)
        a = llama.proj(o, layer["wo"])
        if cfg.use_post_norms:
            a = llama.rms_norm(a, layer["post_attn_norm"], cfg.norm_eps,
                               cfg.norm_offset)
        x = x + a
        m = llama._mlp_block(layer, x, cfg)
        if cfg.use_post_norms:
            m = llama.rms_norm(m, layer["post_mlp_norm"], cfg.norm_eps,
                               cfg.norm_offset)
        x = x + m
    logits = llama.lm_logits(x, params, cfg)
    return logits, new_caches


def chunked_prefill(
    params: Params,
    tokens: jnp.ndarray,  # [B, S] int32
    caches: list[KVCache],
    cfg: ModelConfig,
    chunk: int = 256,
) -> tuple[jnp.ndarray, list[KVCache]]:
    """Prefill in fixed-size chunks through the chunked-decode kernel:
    activation memory is O(chunk · S) instead of O(S²) and each chunk
    attends the cache so far + itself causally — the serving-side prefill
    for long prompts (and the schedule continuous batching interleaves with
    decode steps). Returns (last-position logits [B, vocab], caches).

    Requires S % chunk == 0 (pad prompts to the chunk grid)."""
    b, s = tokens.shape
    assert s % chunk == 0, (s, chunk)
    logits = None
    for c0 in range(0, s, chunk):
        piece = tokens[:, c0:c0 + chunk]
        positions = jnp.arange(c0, c0 + chunk)
        logits, caches = chunk_step(params, piece, positions, caches, cfg)
    return logits[:, -1], caches
