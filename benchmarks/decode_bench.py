"""Decode benchmark — decode attention memory throughput + model tokens/s
(BASELINE.json north_star: quantized-inference engine; decode is
bandwidth-bound, so the roofline metric is achieved GB/s vs the device's
published peak, given on a GPU only). Every row names its device.

Usage:
  python benchmarks/decode_bench.py                # sweep, bf16/int8/fp8
  python benchmarks/decode_bench.py --model 1b     # end-to-end decode tokens/s
  python benchmarks/decode_bench.py --seqs 256 --model tiny   # CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from flashattn_tpu.models import generate, llama  # noqa: E402
from flashattn_tpu.models.config import LLAMA_1B, LLAMA_8B, TINY  # noqa: E402
from flashattn_tpu.ops.decode import decode_attention  # noqa: E402
from flashattn_tpu.ops.kvcache import init_cache, update_cache  # noqa: E402
from flashattn_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flashattn_tpu.utils.roofline import device_fields, gpu_chip  # noqa: E402
from flashattn_tpu.utils.timing import (  # noqa: E402
    measure,
    measure_looped_slope,
)


def cache_bytes(b, hkv, s_live, d, quant):
    elem = 1 if quant in ("int8", "fp8") else 2
    kv = 2 * b * hkv * s_live * d * elem
    scales = 2 * b * hkv * s_live * 4 if quant else 0
    return kv + scales


def kernel_sweep(args):
    chip = gpu_chip()
    b, hq, hkv, d = args.batch, 32, 8, 128
    results = []
    for s in args.seqs:
        for quant in (None, "int8", "fp8"):
            cache = init_cache(b, hkv, s, d, quant=quant)
            k_new = jax.random.normal(jax.random.PRNGKey(0),
                                      (b, hkv, s, d), jnp.bfloat16)
            v_new = jax.random.normal(jax.random.PRNGKey(1),
                                      (b, hkv, s, d), jnp.bfloat16)
            cache = update_cache(cache, k_new, v_new)
            q = jax.random.normal(jax.random.PRNGKey(2), (b, hq, d),
                                  jnp.bfloat16)
            # Sub-millisecond step: on-device chain slope (cancels the
            # fixed dispatch + sync cost).
            sec = measure_looped_slope(decode_attention, q, cache)
            gbs = cache_bytes(b, hkv, s, d, quant) / sec / 1e9
            rec = {
                "bench": "decode_attention", "B": b, "Hq": hq, "Hkv": hkv,
                "S": s, "D": d, "quant": quant or "bf16",
                "us": round(sec * 1e6, 1),
                "gbps": round(gbs, 1),
                "hbm_frac": (round(gbs / chip.hbm_gbps, 3)
                             if chip is not None else None),
                **device_fields(),
            }
            results.append(rec)
            print(json.dumps(rec))
    return results


def model_tokens_per_s(args):
    cfg = {"1b": LLAMA_1B, "8b": LLAMA_8B, "tiny": TINY}[args.model]
    b, s_cache = args.batch, 2048
    if args.model == "8b":
        # Build 8B params on the host and quantize the projection weights
        # there, then ship the int8/int4 pytree (~8/4 GB + norms/scales):
        # the bf16 params never need to sit on the device.
        with jax.default_device(jax.local_devices(backend="cpu")[0]):
            params = llama.init_params(cfg, jax.random.PRNGKey(0))
            params = llama.quantize_params(params, bits=args.wbits)
        params = jax.device_put(params, jax.devices()[0])
        kv_quants = ("int8",)
    else:
        params = llama.init_params(cfg, jax.random.PRNGKey(0))
        kv_quants = (None, "fp8")
    results = []
    for quant in kv_quants:
        caches = generate.init_caches(cfg, b, s_cache, quant=quant)
        # Fill the cache to s_cache - 1 so the step attends a full cache.
        k0 = jax.random.normal(
            jax.random.PRNGKey(1),
            (b, cfg.num_kv_heads, s_cache - 1, cfg.head_dim), jnp.bfloat16)
        caches = [update_cache(c, k0, k0) for c in caches]
        token = jnp.zeros((b,), jnp.int32)
        positions = jnp.full((b,), s_cache - 1, jnp.int32)

        def step(token, caches):
            logits, caches = generate.decode_step(
                params, token, positions, caches, cfg)
            return jnp.argmax(logits, -1).astype(jnp.int32), caches

        sec = measure(step, token, caches, warmup=3)
        rec = {
            "bench": "decode_model", "model": args.model, "B": b,
            "cache_len": s_cache, "quant": quant or "bf16",
            "wbits": args.wbits if args.model == "8b" else 16,
            "ms_per_step": round(sec * 1e3, 3),
            "tokens_per_s": round(b / sec, 1),
            **device_fields(),
        }
        results.append(rec)
        print(json.dumps(rec))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=None,
                    choices=[None, "1b", "8b", "tiny"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--wbits", type=int, default=8, choices=[4, 8],
                    help="weight-only quantization bits for --model 8b")
    ap.add_argument("--seqs", default="2048,8192,32768",
                    help="comma-separated cache lengths for the sweep")
    args = ap.parse_args()
    args.seqs = [int(x) for x in args.seqs.split(",")]
    enable_compile_cache()
    print(f"# device: {device_fields()}; peaks: {gpu_chip()}",
          file=sys.stderr)
    if args.model:
        return model_tokens_per_s(args)
    return kernel_sweep(args)


if __name__ == "__main__":
    main()
