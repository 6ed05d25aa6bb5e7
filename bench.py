"""Headline benchmark — prints ONE JSON line for the driver.

Metric: flash-attention fwd+bwd TFLOPS per device at the reference's headline
config (B=4, H=8, D=128, causal, S=16384 — BASELINE.md: reference achieves
~33.5 TFLOPS on an RTX 5060 Ti; FLOPs convention 4·B·H·S²·D ÷2 causal,
fwd+bwd = 3.5×). vs_baseline is our TFLOPS / 33.5.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from flashattn_tpu import flash_attention  # noqa: E402
from flashattn_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flashattn_tpu.utils.roofline import device_fields  # noqa: E402
from flashattn_tpu.utils.timing import (  # noqa: E402
    attention_flops,
    measure_auto,
    tflops,
)

REFERENCE_TFLOPS = 33.5  # fwd+bwd D=128 causal @S=16384, RTX 5060 Ti (BASELINE.md)


def main():
    enable_compile_cache()
    b, h, s, d = 4, 8, 16384, 128
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    q = jax.random.normal(keys[0], (b, h, s, d), jnp.bfloat16)
    k = jax.random.normal(keys[1], (b, h, s, d), jnp.bfloat16)
    v = jax.random.normal(keys[2], (b, h, s, d), jnp.bfloat16)
    do = jax.random.normal(keys[3], (b, h, s, d), jnp.bfloat16)

    @jax.jit
    def fwd_bwd(q, k, v):
        loss = lambda q, k, v: jnp.sum(
            (flash_attention(q, k, v, is_causal=True) * do).astype(jnp.float32)
        )
        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    # measure_auto = fixed-overhead-cancelling chain slope.
    sec = measure_auto(fwd_bwd, q, k, v, warmup=5, repeat=20)
    fl = attention_flops(b, h, s, s, d, mode="fwd_bwd", is_causal=True)
    tf = tflops(fl, sec)
    print(
        json.dumps(
            {
                "metric": "flash_attention fwd+bwd TFLOPS (B=4,H=8,S=16384,D=128,causal,bf16)",
                "value": round(tf, 2),
                "unit": "TFLOPS",
                "vs_baseline": round(tf / REFERENCE_TFLOPS, 3),
                **device_fields(),
            }
        )
    )


if __name__ == "__main__":
    main()
