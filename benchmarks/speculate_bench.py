"""Speculative-decoding device-time benchmark.

Every shipped path carries a measured number (reference discipline,
``Phase_5.md:13-70``). Two kinds of rows:

1. ``spec_components`` — device time of each step in a speculation round
   (draft decode step, target verify chunk of k+1, draft re-ingest chunk),
   measured with the on-device scan loop (all are sub-ms: a dispatch loop
   would report the host's dispatch rate). From these the device-bound
   tokens/s is a FUNCTION of the acceptance rate alpha:

       tok/s(alpha) = (alpha*k + 1) / (k*t_draft + t_verify_k + t_ingest_k)

   and the breakeven alpha* is where that equals the plain-decode bound
   1/t_target. Acceptance itself is a property of the WEIGHTS (draft/target
   agreement), not the kernels — with this repo's random-init params any
   real draft accepts ~nothing — so the record reports the measured
   hardware curve plus alpha* per k, which is exactly "where speculation
   wins on this hardware".

2. ``spec_e2e`` — an actual speculative_generate run per (draft, k):
   measured acceptance rate + wall tokens/s (includes the host; device
   rows are the bound) + the greedy-exactness check against plain
   generate. draft="self" (target as its own draft) accepts 100 % in
   interpret mode (tests/test_speculate.py). With RANDOM-INIT weights a
   compiled run may accept less than 100 % greedily: the verifier's chunked
   decode and the generator's single-token decode round differently in
   bf16, and random-init logits have ~zero top-1/top-2 margins, so argmax
   flips on near-ties (not measured on the GPU yet).

  python benchmarks/speculate_bench.py --out speculate.jsonl
  python benchmarks/speculate_bench.py --model tiny --ks 2 --prompt-len 32 \
      --new-tokens 8 --iters 4          # CPU rehearsal
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="1b", choices=["tiny", "1b"])
    ap.add_argument("--ks", type=str, default="2,4,8")
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--iters", type=int, default=200,
                    help="on-device scan length for component timing")
    ap.add_argument("--out", type=str, default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models import generate, llama
    from flashattn_tpu.models.config import LLAMA_1B, LLAMA_150M, TINY
    from flashattn_tpu.models.sampling import SamplingParams
    from flashattn_tpu.models.speculate import speculative_generate
    from flashattn_tpu.utils.compile_cache import enable_compile_cache
    from flashattn_tpu.utils.roofline import device_fields
    from flashattn_tpu.utils.timing import measure_looped_slope

    enable_compile_cache()
    dev = device_fields()
    if args.model == "1b":
        t_cfg, d_cfg = LLAMA_1B, LLAMA_150M
    else:
        import dataclasses

        t_cfg = TINY
        d_cfg = dataclasses.replace(TINY, num_layers=1)
    ks = [int(x) for x in args.ks.split(",")]

    t_params = llama.init_params(t_cfg, jax.random.PRNGKey(0))
    d_params = llama.init_params(d_cfg, jax.random.PRNGKey(1))

    rows = []

    def emit(rec):
        rec = {**rec, **dev}
        rows.append(rec)
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # ---- component device times at a fixed context ----
    s0 = args.prompt_len
    max_len = -(-(s0 + args.new_tokens + max(ks) + 2) // 128) * 128
    prompt = jax.random.randint(jax.random.PRNGKey(2), (1, s0), 0,
                                t_cfg.vocab_size)

    # params/caches ride as CHAIN ARGUMENTS, never closures: closing over
    # them bakes ~2.2 GB of weights into the traced HLO as constants and
    # kills the remote-compile transport (the round-3 serve-bench disease;
    # tests/test_serve.py pins the same rule for the server calibrations).
    def step_time(params, cfg):
        caches = generate.init_caches(cfg, 1, max_len)
        _, caches = generate.prefill(params, prompt, caches, cfg)
        pos = jnp.asarray([s0], jnp.int32)

        def f(tok, params, caches):
            return generate.decode_step(params, tok, pos, caches, cfg)[0]

        tok = jnp.asarray([11], jnp.int32)
        return measure_looped_slope(f, tok, params, caches)

    def chunk_time(params, cfg, c):
        caches = generate.init_caches(cfg, 1, max_len)
        _, caches = generate.prefill(params, prompt, caches, cfg)
        positions = jnp.arange(s0, s0 + c)

        def f(piece, params, caches):
            return generate.chunk_step(params, piece, positions, caches,
                                       cfg)[0]

        piece = jnp.full((1, c), 11, jnp.int32)
        return measure_looped_slope(f, piece, params, caches)

    t_target = step_time(t_params, t_cfg)
    t_draft = step_time(d_params, d_cfg)
    base_tps = 1.0 / t_target
    for k in ks:
        t_verify = chunk_time(t_params, t_cfg, k + 1)
        t_ingest = chunk_time(d_params, d_cfg, k + 1)
        round_s = k * t_draft + t_verify + t_ingest

        def tps(alpha):
            return (alpha * k + 1) / round_s

        # breakeven: (alpha*k + 1)/round = 1/t_target
        alpha_star = (round_s / t_target - 1) / k
        emit({
            "bench": "spec_components", "model": args.model, "k": k,
            "context": s0,
            "t_target_step_ms": round(t_target * 1e3, 3),
            "t_draft_step_ms": round(t_draft * 1e3, 3),
            "t_verify_chunk_ms": round(t_verify * 1e3, 3),
            "t_draft_ingest_ms": round(t_ingest * 1e3, 3),
            "plain_decode_tok_s": round(base_tps, 1),
            "spec_tok_s_alpha0": round(tps(0.0), 1),
            "spec_tok_s_alpha50": round(tps(0.5), 1),
            "spec_tok_s_alpha80": round(tps(0.8), 1),
            "spec_tok_s_alpha100": round(tps(1.0), 1),
            "breakeven_alpha": round(alpha_star, 3),
        })

    # ---- end-to-end runs: acceptance + greedy-exactness ----
    # Greedy plain-decode oracle for exactness.
    ref_tokens = generate.generate(
        t_params, prompt, t_cfg, max_new_tokens=args.new_tokens,
        max_len=max_len)
    ref_list = [int(x) for x in jax.device_get(ref_tokens[0])]

    for label, dp, dc in (("self", t_params, t_cfg),
                          ("150m" if args.model == "1b" else "trunc",
                           d_params, d_cfg)):
        for k in ks:
            for mode in ("greedy", "sampled"):
                sampling = (None if mode == "greedy"
                            else SamplingParams(temperature=0.8, top_p=0.95))
                t0 = time.perf_counter()
                toks, rate = speculative_generate(
                    t_params, t_cfg, dp, dc, prompt,
                    max_new_tokens=args.new_tokens, k=k, max_len=max_len,
                    sampling=sampling, rng=jax.random.PRNGKey(5))
                wall = time.perf_counter() - t0
                rec = {
                    "bench": "spec_e2e", "model": args.model, "draft": label,
                    "k": k, "mode": mode, "accept_rate": round(rate, 3),
                    "wall_tok_s": round(args.new_tokens / wall, 2),
                }
                if mode == "greedy":
                    got = [int(x) for x in jax.device_get(toks[0])]
                    rec["greedy_exact"] = got == ref_list
                emit(rec)


if __name__ == "__main__":
    main()
