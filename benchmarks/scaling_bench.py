"""Mesh-scaling benchmark — tokens/s efficiency across device counts
(BASELINE.json north_star: >=85 % tokens/s scaling at 2 hosts; SURVEY.md M7
"scaling benchmarks at 1 device / 1 host / >=2 hosts").

Runs the full training step (dp x sp over the ring-attention model) and a
ring-attention weak-scaling sweep on however many devices this process has —
virtual CPU devices validate the path, real GPUs measure it. Prints
one JSON line per point with tokens/s and efficiency vs the 1-device run.

Usage:
  python benchmarks/scaling_bench.py --mode train --devices 1,2,4,8
  python benchmarks/scaling_bench.py --quick --cpu   # 8 virtual CPU devices
"""

from __future__ import annotations

import argparse
import functools
import json
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default=None,
                    help="comma list of device counts (default: 1..all)")
    ap.add_argument("--mode", default="train", choices=["train", "ring"])
    ap.add_argument("--batch-per-dp", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on 8 virtual CPU devices (validation mode)")
    args = ap.parse_args()

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from flashattn_tpu.models import llama
    from flashattn_tpu.models.config import TINY
    from flashattn_tpu.utils.compile_cache import enable_compile_cache
    from flashattn_tpu.utils.roofline import device_fields
    from flashattn_tpu.utils.timing import measure

    enable_compile_cache()

    all_devs = jax.devices()
    counts = (
        [int(x) for x in args.devices.split(",")]
        if args.devices
        else [n for n in (1, 2, 4, 8, 16) if n <= len(all_devs)]
    )
    print(f"# platform={jax.default_backend()} devices={len(all_devs)} "
          f"mode={args.mode}", file=sys.stderr)

    cfg = TINY
    results = []
    base_tps = None
    for n in counts:
        if args.mode == "train":
            # dp grows with n (weak scaling: global batch = batch_per_dp*dp).
            sp = 2 if n % 2 == 0 and n >= 2 else 1
            dp = n // sp
            mesh = Mesh(
                np.array(all_devs[:n]).reshape(dp, 1, sp),
                ("data", "model", "sp"),
            )
            params = llama.init_params(cfg, jax.random.PRNGKey(0))
            shardings = jax.tree_util.tree_map(
                lambda spec: NamedSharding(mesh, spec),
                llama.param_shardings(cfg),
                is_leaf=lambda x: isinstance(x, P),
            )
            params = jax.device_put(params, shardings)
            b = args.batch_per_dp * dp
            tokens = jax.device_put(
                jax.random.randint(jax.random.PRNGKey(1),
                                   (b, args.seq + 1), 0, cfg.vocab_size,
                                   jnp.int32),
                NamedSharding(mesh, P("data", None)),
            )

            @jax.jit
            def step(params, tokens):
                return llama.sgd_train_step(params, tokens, cfg, mesh=mesh)

            sec = measure(step, params, tokens,
                          warmup=2, n1=2, n2=5 if args.quick else 10)
            tps = b * args.seq / sec
        else:  # ring weak scaling: fixed S per device; causal work grows
            # quadratically with n, so the fair metric is FLOPs/s.
            from flashattn_tpu.parallel import (
                make_mesh, sharded_ring_attention)
            from flashattn_tpu.utils.timing import attention_flops

            mesh = make_mesh({"sp": n}, devices=all_devs[:n])
            s = args.seq * n
            keys = jax.random.split(jax.random.PRNGKey(0), 3)
            q, k, v = (jax.random.normal(kk, (1, 4, s, 64), jnp.bfloat16)
                       for kk in keys)
            fn = jax.jit(functools.partial(
                sharded_ring_attention, mesh=mesh, is_causal=True,
                batch_axis=None, head_axis=None))
            sec = measure(fn, q, k, v,
                          warmup=2, n1=2, n2=5 if args.quick else 10)
            tps = attention_flops(1, 4, s, s, 64, "fwd", True) / sec

        if base_tps is None:
            base_tps = tps / n  # per-device baseline at the smallest count
        eff = tps / (n * base_tps)
        unit = "tokens/s" if args.mode == "train" else "flops/s"
        rec = {"mode": args.mode, "devices": n,
               "throughput": round(tps, 1), "unit": unit,
               "scaling_efficiency": round(eff, 3), **device_fields()}
        results.append(rec)
        print(json.dumps(rec))
    return results


if __name__ == "__main__":
    main()
