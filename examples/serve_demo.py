"""Continuous-batching serving demo: submit a handful of requests with
different prompt/generation lengths against a (optionally quantized) model.

  python examples/serve_demo.py
  python examples/serve_demo.py --quant int8 --weight-bits 8
  python examples/serve_demo.py --paged --prefix     # page pool + shared prefix
"""

from __future__ import annotations

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quant", default=None, choices=[None, "int8", "fp8"])
    ap.add_argument("--weight-bits", type=int, default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--paged", action="store_true",
                    help="block-table page pool backend")
    ap.add_argument("--prefix", action="store_true",
                    help="register a shared system prompt (implies --paged)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp  # noqa: F401

    from flashattn_tpu.models import llama
    from flashattn_tpu.models.config import TINY
    from flashattn_tpu.models.serve import InferenceServer, Request
    from flashattn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    params = llama.init_params(TINY, jax.random.PRNGKey(0))
    if args.weight_bits:
        params = llama.quantize_params(params, bits=args.weight_bits)
    srv = InferenceServer(params, TINY, max_slots=args.slots, max_len=512,
                          quant=args.quant,
                          paged=args.paged or args.prefix, page_size=128)
    pid = None
    if args.prefix:
        system = [7] * 130  # >= one page; shared read-only by every request
        pid = srv.register_prefix(system)
        base = system
    else:
        base = []
    reqs = [
        Request(uid=1, prompt=base + [3, 1, 4, 1, 5], max_new_tokens=12,
                prefix_id=pid),
        Request(uid=2, prompt=base + [2, 7], max_new_tokens=20, prefix_id=pid),
        Request(uid=3, prompt=base + list(range(40)), max_new_tokens=8,
                prefix_id=pid),
        Request(uid=4, prompt=base + [99], max_new_tokens=16, prefix_id=pid),
        Request(uid=5, prompt=base + [10, 20, 30], max_new_tokens=10,
                prefix_id=pid),
    ]
    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    out = srv.run()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in out.values())
    for uid in sorted(out):
        print(f"request {uid}: {out[uid]}")
    print(f"{total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s incl. compiles)")
    if args.paged or args.prefix:
        print("server stats:", srv.stats())


if __name__ == "__main__":
    main()
