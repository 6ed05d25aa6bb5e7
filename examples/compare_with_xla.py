"""Correctness check vs the platform's fused attention — the counterpart
of the reference's SDPA alignment entry point
(``code/My_FlashAttention_optimized.py:172-226``, ``compare_with_sdpa``):
run our kernel AND the platform baseline fwd+bwd on identical inputs and
``verify_results`` each of O, dQ, dK, dV with the reference thresholds.

Baseline here is ``jax.nn.dot_product_attention`` (XLA's path), the JAX
counterpart of torch SDPA. Default config mirrors the reference's
``__main__`` (B=4, H=8, S=256, D=64, causal) with bf16 in place of fp16.

  python examples/compare_with_xla.py
  python examples/compare_with_xla.py --S 4096 --D 128 --no-causal
"""

from __future__ import annotations

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=4)
    ap.add_argument("--H", type=int, default=8)
    ap.add_argument("--S", type=int, default=256)
    ap.add_argument("--D", type=int, default=64)
    ap.add_argument("--no-causal", action="store_true")
    args = ap.parse_args()
    causal = not args.no_causal

    import jax
    import jax.numpy as jnp

    from flashattn_tpu import flash_attention, verify_results
    from flashattn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    keys = jax.random.split(jax.random.PRNGKey(42), 4)
    shape = (args.B, args.H, args.S, args.D)
    q, k, v, do = (jax.random.normal(kk, shape, jnp.bfloat16) for kk in keys)

    def run(fn):
        def loss(q, k, v):
            return jnp.sum((fn(q, k, v) * do).astype(jnp.float32))
        o = fn(q, k, v)
        dq, dk, dv = jax.grad(loss, (0, 1, 2))(q, k, v)
        return o, dq, dk, dv

    ours = run(lambda q, k, v: flash_attention(q, k, v, is_causal=causal))
    base = run(lambda q, k, v: jax.nn.dot_product_attention(
        # jax.nn API is [B, S, H, D]
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), is_causal=causal,
    ).transpose(0, 2, 1, 3))

    # Reference pass gate (SURVEY §4: allclose ∧ cosine > 0.999), with bf16
    # in place of the reference's fp16 — atol loosened for the 8-bit
    # mantissa, same normalized-error methodology (_verify_func.py:17-20).
    ok = True
    for name, a, b in zip(("O", "dQ", "dK", "dV"), base, ours):
        r = verify_results(a, b, rtol=2e-2, atol=5e-2)
        print(f"{name}: {r}")
        ok &= r.passed
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
