"""Block-size autotuner — the reference's @triton.autotune
(``code/_flash_attention_kernel_optimized.py:18-32,148-162,275-289``).

Same structure as the reference: a config list per kernel, keyed on the
problem shape (reference ``key=['S_q','S_k','D','is_causal']``, ``:31``,
here with batch, heads, dtype and the device kind added), forward and
backward tuned separately (``Phase_5.md:160-162``), then the launch
parameters (num_warps, num_stages). Each trial compiles a kernel, so winners
persist in a JSON cache that later processes read without sweeping.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.utils.compile_cache import REPO_ROOT
from flashattn_tpu.utils.timing import median_seconds

# Candidate tiles (powers of two; the reference's 32/64 space plus the
# 128-wide tiles Hopper's register file affords at D <= 128).
FWD_CONFIGS = [(128, 128), (128, 64), (64, 64)]
BWD_CONFIGS = [(64, 128), (64, 64), (32, 64)]
# (num_warps, num_stages).
LAUNCH_CONFIGS = [(4, 2), (4, 3), (8, 2)]

_CACHE_ENV = "FLASHATTN_AUTOTUNE_CACHE"
_DEFAULT_CACHE = REPO_ROOT / ".autotune_cache.json"

# Winners measured in this environment, loaded once from the cache file.
_memory_cache: dict[str, dict] = {}
_memory_cache_loaded = False


def _cache_path() -> pathlib.Path:
    return pathlib.Path(os.environ.get(_CACHE_ENV, str(_DEFAULT_CACHE)))


def _load_cache() -> dict:
    global _memory_cache_loaded
    if not _memory_cache_loaded:
        _memory_cache_loaded = True
        path = _cache_path()
        if path.exists():
            try:
                _memory_cache.update(json.loads(path.read_text()))
            except (OSError, ValueError) as e:
                print(f"[autotune] ignoring unreadable cache {path}: {e}",
                      file=sys.stderr)
    return _memory_cache


def _save_cache() -> None:
    p = _cache_path()
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(_memory_cache, indent=1))


def _key(b, hq, hkv, s_q, s_k, d, is_causal, dtype) -> str:
    kind = jax.devices()[0].device_kind.replace(" ", "")
    return (f"{kind}|b{b}h{hq}/{hkv}|sq{s_q}sk{s_k}d{d}|c{int(is_causal)}"
            f"|{jnp.dtype(dtype).name}")


def lookup_block_sizes(b: int, hq: int, hkv: int, s_q: int, s_k: int,
                       d: int, is_causal: bool, dtype) -> BlockSizes:
    """Block sizes for a default (block_sizes=None) kernel call: the
    autotune winner if `autotune()` ever ran this shape on this device kind,
    else the defaults."""
    entry = _load_cache().get(_key(b, hq, hkv, s_q, s_k, d, is_causal,
                                   dtype))
    return _to_block_sizes(entry) if entry else BlockSizes()


def _time(fn, *args) -> float:
    return median_seconds(fn, *args, warmup=1, reps=5)


def _best(candidates, time_one, label, verbose):
    """The candidate with the least time; ones that fail to compile or run
    (e.g. too much shared memory) are skipped and reported."""
    best, best_t = None, float("inf")
    for cand in candidates:
        try:
            t = time_one(cand)
        except Exception as e:  # a config the compiler refuses is a loser
            print(f"[autotune {label}] {cand}: failed "
                  f"({type(e).__name__}: {str(e)[:200]})", file=sys.stderr)
            continue
        if verbose:
            print(f"[autotune {label}] {cand}: {t * 1e3:.4f} ms",
                  file=sys.stderr)
        if t < best_t:
            best, best_t = cand, t
    assert best is not None, f"no {label} config ran"
    return best


def autotune(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    is_causal: bool = False,
    scale: float | None = None,
    tune_backward: bool = True,
    verbose: bool = False,
    force: bool = False,
) -> BlockSizes:
    """Time candidate configs on the live device and cache the winner.

    Like the reference autotuner this launches real trials per config;
    unlike it, winners persist across processes because each trial costs a
    compile. Sweeps forward tiles, then dQ tiles (dK/dV pinned), then dK/dV
    tiles, then the launch parameters on the whole tuned call.
    """
    from flashattn_tpu.ops.flash_bwd import flash_attention_backward
    from flashattn_tpu.ops.flash_fwd import flash_attention_forward

    b, hq, s_q, d = q.shape
    _, hkv, s_k, _ = k.shape
    key = _key(b, hq, hkv, s_q, s_k, d, is_causal, q.dtype)
    hit = _load_cache().get(key)
    if hit is not None and not force:
        return _to_block_sizes(hit)

    def distinct(bss):
        seen, out = set(), []
        for bs in bss:
            c = bs.clamp(s_q, s_k)
            if c not in seen:
                seen.add(c)
                out.append(c)
        return out

    def fwd(bs):
        return jax.jit(lambda q, k, v: flash_attention_forward(
            q, k, v, is_causal=is_causal, scale=scale, block_sizes=bs))

    base = BlockSizes()
    best = _best(
        distinct(dataclasses.replace(base, block_q=bq, block_kv=bkv)
                 for bq, bkv in FWD_CONFIGS),
        lambda bs: _time(fwd(bs), q, k, v), "fwd", verbose)

    if tune_backward:
        o, lse = fwd(best)(q, k, v)
        do = q  # any same-shaped array works for timing

        def bwd(bs):
            return jax.jit(lambda *a: flash_attention_backward(
                *a, is_causal=is_causal, scale=scale, block_sizes=bs))

        def time_bwd(bs):
            return _time(bwd(bs), q, k, v, o, do, lse)

        best = _best(
            distinct(dataclasses.replace(best, block_q_dq=bq, block_kv_dq=bkv)
                     for bq, bkv in BWD_CONFIGS), time_bwd, "dq", verbose)
        best = _best(
            distinct(dataclasses.replace(best, block_q_dkv=bq,
                                         block_kv_dkv=bkv)
                     for bq, bkv in BWD_CONFIGS), time_bwd, "dkv", verbose)

        def time_launch(bs):
            return _time(fwd(bs), q, k, v) + time_bwd(bs)
    else:
        def time_launch(bs):
            return _time(fwd(bs), q, k, v)

    best = _best(
        distinct(dataclasses.replace(best, num_warps=w, num_stages=st)
                 for w, st in LAUNCH_CONFIGS), time_launch, "launch", verbose)
    result = dataclasses.asdict(best)
    _load_cache()[key] = result
    try:
        _save_cache()
    except OSError as e:
        print(f"[autotune] could not save {_cache_path()}: {e}",
              file=sys.stderr)
    return best


def _to_block_sizes(entry: dict) -> BlockSizes:
    fields = {f.name for f in dataclasses.fields(BlockSizes)}
    return BlockSizes(**{k: v for k, v in entry.items() if k in fields})
