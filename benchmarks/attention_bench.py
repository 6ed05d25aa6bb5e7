"""Attention benchmark sweep — the reference harness
(``code/Performance_Comparison.py:9-166``) in JAX.

Providers:
  - ``flash``: our Pallas (Triton) kernels, via the differentiable public API
  - ``xla``:   jax.nn.dot_product_attention(implementation="xla") — what
               XLA makes of the plain version
  - ``cudnn``: jax.nn.dot_product_attention(implementation="cudnn") — the
               library's fused kernel, the reference's SDPA role (GPU only)
  - ``naive``: unfused jnp oracle (reference ``naive_attention``, OOMs first)

Modes: fwd, fwd_bwd, and bwd measured as fwd_bwd − fwd (reference ``:92-95``).
Every row names the device it ran on; sol_frac (against the published peak
of the device's kind) is only given on a GPU.

Usage:  python benchmarks/attention_bench.py [--quick] [--seqs 128]
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")  # repo root

from flashattn_tpu import flash_attention  # noqa: E402
from flashattn_tpu.ops.common import BlockSizes  # noqa: E402
from flashattn_tpu.ops.reference import reference_attention  # noqa: E402
from flashattn_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flashattn_tpu.utils.roofline import (  # noqa: E402
    attention_bwd_roofline,
    attention_fwd_roofline,
    device_fields,
    gpu_chip,
)
from flashattn_tpu.utils.timing import (  # noqa: E402
    attention_flops,
    measure_auto,
    tflops,
)


def _provider_fn(provider: str, is_causal: bool, block_sizes=None):
    if provider == "flash":
        return functools.partial(
            flash_attention, is_causal=is_causal, block_sizes=block_sizes
        )
    if provider in ("xla", "cudnn"):
        def dpa_fn(q, k, v):
            # [B,H,S,D] -> [B,S,H,D] layout expected by jax.nn API
            o = jax.nn.dot_product_attention(
                q.swapaxes(1, 2), k.swapaxes(1, 2), v.swapaxes(1, 2),
                is_causal=is_causal, implementation=provider,
            )
            return o.swapaxes(1, 2)
        return dpa_fn
    if provider == "naive":
        return functools.partial(reference_attention, is_causal=is_causal)
    raise ValueError(provider)


def benchmark_attention(
    provider: str,
    mode: str,
    b: int = 4,
    h: int = 8,
    s_q: int = 4096,
    s_k: int = 4096,
    d: int = 128,
    is_causal: bool = True,
    dtype=jnp.bfloat16,
    warmup: int = 10,
    repeat: int = 30,
    block_sizes: BlockSizes | None = None,
) -> tuple[float, float]:
    """Returns (ms, tflops) — same contract as the reference harness (:9-109)."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    q = jax.random.normal(keys[0], (b, h, s_q, d), dtype)
    k = jax.random.normal(keys[1], (b, h, s_k, d), dtype)
    v = jax.random.normal(keys[2], (b, h, s_k, d), dtype)
    do = jax.random.normal(keys[3], (b, h, s_q, d), dtype)

    attn = _provider_fn(provider, is_causal, block_sizes)

    fwd = jax.jit(attn)

    @jax.jit
    def fwd_bwd(q, k, v):
        loss = lambda q, k, v: jnp.sum((attn(q, k, v) * do).astype(jnp.float32))
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    if mode == "fwd":
        sec = measure_auto(fwd, q, k, v, warmup=warmup, repeat=repeat)
    elif mode == "fwd_bwd":
        sec = measure_auto(fwd_bwd, q, k, v, warmup=warmup, repeat=repeat)
    elif mode == "bwd":
        # bwd = fwd_bwd − fwd (reference :92-95)
        sec = measure_auto(
            fwd_bwd, q, k, v, warmup=warmup, repeat=repeat
        ) - measure_auto(fwd, q, k, v, warmup=warmup, repeat=repeat)
    else:
        raise ValueError(mode)

    fl = attention_flops(b, h, s_q, s_k, d, mode=mode, is_causal=is_causal)
    return sec * 1e3, tflops(fl, sec)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--providers", default="flash,xla")
    ap.add_argument("--modes", default="fwd,fwd_bwd")
    ap.add_argument("--causal", type=int, default=1)
    ap.add_argument("--seqs", default=None,
                    help="comma-separated S values (default: full sweep)")
    ap.add_argument("--autotune", action="store_true",
                    help="sweep tile configs per shape before measuring "
                         "(winners persist in the autotune cache)")
    args = ap.parse_args()

    enable_compile_cache()
    chip = gpu_chip()
    dev = device_fields()
    print(f"# device: {dev}; peaks: {chip}", file=sys.stderr)

    seqs = [2048, 4096] if args.quick else [512, 1024, 2048, 4096, 8192, 16384]
    if args.seqs:
        seqs = [int(x) for x in args.seqs.split(",")]
    b, h, d = 4, 8, args.d
    causal = bool(args.causal)
    results = []
    for s in seqs:
        tuned = None
        if args.autotune:
            from flashattn_tpu.ops.autotune import autotune

            keys = jax.random.split(jax.random.PRNGKey(0), 3)
            qa = jax.random.normal(keys[0], (b, h, s, d), jnp.bfloat16)
            ka = jax.random.normal(keys[1], (b, h, s, d), jnp.bfloat16)
            va = jax.random.normal(keys[2], (b, h, s, d), jnp.bfloat16)
            tuned = autotune(qa, ka, va, is_causal=causal, verbose=True)
            print(f"# tuned S={s}: {tuned}", file=sys.stderr)
        for provider in args.providers.split(","):
            measured: dict[str, float] = {}
            # bwd last so it can reuse this sweep's fwd/fwd_bwd timings.
            modes = sorted(args.modes.split(","), key=lambda m: m == "bwd")
            for mode in modes:
                note = None
                if mode == "bwd" and {"fwd", "fwd_bwd"} <= measured.keys():
                    # Derive bwd from THIS sweep's fwd/fwd_bwd measurements
                    # (reference convention, :92-95) instead of re-measuring
                    # both — re-measurement noise at sub-ms scales can flip
                    # the subtraction negative.
                    ms = measured["fwd_bwd"] - measured["fwd"]
                    if ms <= 0:
                        # Physically impossible: fwd_bwd <= fwd is timing
                        # noise at sub-ms scales. Null the row rather than
                        # record negative throughput (ADVICE r2).
                        note = (f"fwd_bwd ({measured['fwd_bwd']:.3f} ms) <= "
                                f"fwd ({measured['fwd']:.3f} ms): subtraction "
                                "non-positive, row nulled")
                        tf = None
                    else:
                        fl = attention_flops(b, h, s, s, d, mode="bwd",
                                             is_causal=causal)
                        tf = tflops(fl, ms / 1e3)
                else:
                    try:
                        ms, tf = benchmark_attention(
                            provider, mode, b=b, h=h, s_q=s, s_k=s, d=d,
                            is_causal=causal,
                            warmup=3 if args.quick else 10,
                            repeat=10 if args.quick else 30,
                            block_sizes=tuned if provider == "flash" else None,
                        )
                        measured[mode] = ms
                    except Exception as e:
                        # A provider that cannot run a shape (XLA's unfused
                        # attention runs out of memory on the S x S scores
                        # at long S — the reference's naive provider story,
                        # Performance_Comparison.py floor) must not kill the
                        # sweep: record the failure and move on.
                        note = f"{type(e).__name__}: {e}"[:200]
                        ms, tf = None, None
                bad = tf is None
                rec = {
                    "provider": provider, "mode": mode, "S": s, "D": d,
                    "causal": causal,
                    "ms": None if bad else round(ms, 3),
                    "tflops": None if bad else round(tf, 2),
                    "sol_frac": None,
                    **dev,
                }
                if chip is not None and mode != "fwd_bwd" and not bad:
                    roof = (attention_fwd_roofline if mode == "fwd"
                            else attention_bwd_roofline)(
                        b, h, h, s, s, d, causal, chip=chip)
                    rec["sol_frac"] = round(roof.sol_seconds / (ms / 1e3), 3)
                if note:
                    rec["note"] = note
                results.append(rec)
                print(json.dumps(rec))
    return results


if __name__ == "__main__":
    main()
