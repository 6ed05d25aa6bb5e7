"""Speculative decoding demo: a 1-layer draft accelerates the target's
greedy decode; output is verified identical to plain greedy.

  python examples/speculate_demo.py
"""

from __future__ import annotations

import dataclasses
import sys
import time

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models import generate, llama
    from flashattn_tpu.models.config import TINY
    from flashattn_tpu.models.speculate import speculative_generate
    from flashattn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = dataclasses.replace(TINY, dtype=jnp.float32)
    draft_cfg = dataclasses.replace(cfg, num_layers=1)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    draft = llama.init_params(draft_cfg, jax.random.PRNGKey(7))
    prompt = jnp.asarray([[5, 9, 42, 7]], jnp.int32)

    t0 = time.perf_counter()
    plain = generate.generate(params, prompt, cfg, max_new_tokens=24,
                              max_len=256)
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec, rate = speculative_generate(params, cfg, draft, draft_cfg, prompt,
                                      max_new_tokens=24, k=4)
    t_spec = time.perf_counter() - t0
    assert [int(t) for t in spec[0]] == [int(t) for t in plain[0]]
    print(f"greedy == speculative ({[int(t) for t in spec[0][:8]]}...)")
    print(f"draft acceptance rate: {rate:.2f}")
    print(f"plain {t_plain:.2f}s vs speculative {t_spec:.2f}s "
          "(incl. compiles; speedup needs a trained draft that agrees)")


if __name__ == "__main__":
    main()
