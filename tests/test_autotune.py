"""Autotuner tests (ops/autotune.py) — the reference analogue is
@triton.autotune with key=['S_q','S_k','D','is_causal']
(``code/_flash_attention_kernel_optimized.py:18-32``); ours adds a
persistent cache (each trial is a compile) and independent dQ/dKV/launch
winners. Runs in interpret mode on CPU with tiny shapes — timings are
meaningless there, but the sweep/caching/selection machinery is identical.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest

from flashattn_tpu.ops import autotune as at
from flashattn_tpu.ops.common import BlockSizes


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune.json"
    monkeypatch.setenv(at._CACHE_ENV, str(path))
    at._memory_cache.clear()
    monkeypatch.setattr(at, "_memory_cache_loaded", True)
    yield path
    at._memory_cache.clear()


def small_qkv(s=64, d=64):
    # s=64 clamps every candidate tile to 64, so a sweep compiles few trials.
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    return tuple(jax.random.normal(k, (1, 2, s, d)) for k in ks)


def test_default_block_sizes_table():
    # No cache entry: the Triton defaults (measured tiles and launch
    # parameters), every tile a power of two >= 16.
    bs = at.lookup_block_sizes(1, 8, 8, 16384, 16384, 128, True,
                               jnp.bfloat16)
    assert bs == BlockSizes()
    assert (bs.num_warps, bs.num_stages) == (4, 2)
    clamped = BlockSizes().clamp(40, 200)
    assert clamped.block_q == 64 and clamped.block_kv == 128
    assert BlockSizes(block_q=16).clamp(8, 8).block_q == 16


def test_autotune_returns_valid_blocks_and_caches(tmp_cache):
    q, k, v = small_qkv()
    bs = at.autotune(q, k, v, is_causal=True)
    assert isinstance(bs, BlockSizes)
    for f in dataclasses.fields(BlockSizes):
        val = getattr(bs, f.name)
        if f.name == "num_warps":
            assert val in (4, 8)
        elif f.name == "num_stages":
            assert val in (2, 3)
        else:
            assert val >= 16 and val & (val - 1) == 0, (f.name, val)
    # Persisted: one entry with the independent dQ/dKV and launch winners.
    data = json.loads(tmp_cache.read_text())
    assert len(data) == 1
    entry = next(iter(data.values()))
    assert {"block_q", "block_kv", "block_q_dq", "block_kv_dq",
            "block_q_dkv", "block_kv_dkv", "num_warps",
            "num_stages"} <= set(entry)
    # The default (block_sizes=None) resolution path returns the winner.
    hit = at.lookup_block_sizes(1, 2, 2, q.shape[2], k.shape[2],
                                q.shape[3], True, q.dtype)
    assert hit == bs


def test_autotune_cache_hit_skips_measurement(tmp_cache, monkeypatch):
    q, k, v = small_qkv()
    bs1 = at.autotune(q, k, v, is_causal=False, tune_backward=False)

    def boom(*a, **kw):
        raise AssertionError("timed a trial on a cache hit")

    monkeypatch.setattr(at, "_time", boom)
    bs2 = at.autotune(q, k, v, is_causal=False)
    assert bs1 == bs2


def test_autotune_key_separates_shapes_and_causality(tmp_cache):
    q, k, v = small_qkv()
    at.autotune(q, k, v, is_causal=True, tune_backward=False)
    at.autotune(q, k, v, is_causal=False, tune_backward=False)
    q2, k2, v2 = small_qkv(s=32)
    at.autotune(q2, k2, v2, is_causal=True, tune_backward=False)
    assert len(json.loads(tmp_cache.read_text())) == 3


def test_lookup_block_sizes_resolves_cache_then_defaults(tmp_cache):
    q, k, v = small_qkv()
    # No cache entry: falls back to the defaults.
    miss = at.lookup_block_sizes(1, 2, 2, 64, 64, 64, True, q.dtype)
    assert miss == BlockSizes()
    # After a sweep, the default (block_sizes=None) path returns the winner.
    won = at.autotune(q, k, v, is_causal=True, tune_backward=False)
    hit = at.lookup_block_sizes(1, 2, 2, 64, 64, 64, True, q.dtype)
    assert hit == won


def test_cache_file_persists_across_processes(tmp_cache, monkeypatch):
    """A fresh process (empty memory cache) resolves winners from the file
    another process wrote."""
    q, k, v = small_qkv()
    won = at.autotune(q, k, v, is_causal=True, tune_backward=False)
    at._memory_cache.clear()
    monkeypatch.setattr(at, "_memory_cache_loaded", False)
    hit = at.lookup_block_sizes(1, 2, 2, 64, 64, 64, True, q.dtype)
    assert hit == won


def test_unreadable_cache_file_falls_back_to_defaults(tmp_cache,
                                                      monkeypatch):
    tmp_cache.write_text("{not json")
    at._memory_cache.clear()
    monkeypatch.setattr(at, "_memory_cache_loaded", False)
    assert at.lookup_block_sizes(1, 2, 2, 64, 64, 64, True,
                                 jnp.float32) == BlockSizes()


def test_to_block_sizes_ignores_extra_keys():
    bs = at._to_block_sizes({"block_q": 32, "bwd_impl": "fused",
                             "some_future_field": 1})
    assert bs.block_q == 32 and bs.block_kv == BlockSizes().block_kv
