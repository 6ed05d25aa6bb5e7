"""End-to-end training demo: train a tiny Llama-style model on synthetic
data with AdamW + Orbax checkpointing, optionally over a dp x tp x sp mesh.

  python examples/train_demo.py --steps 50
  python examples/train_demo.py --steps 50 --mesh 2,2,2 --cpu   # 8 virtual
"""

from __future__ import annotations

import argparse
import sys

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--mesh", default=None, help="data,model,sp e.g. 2,2,2")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=8")
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models import llama, train
    from flashattn_tpu.models.config import TINY
    from flashattn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    cfg = TINY
    mesh = None
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    if args.mesh:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from flashattn_tpu.parallel.distributed import pod_mesh

        d, m, sp = (int(x) for x in args.mesh.split(","))
        mesh = pod_mesh(data=d, model=m, sp=sp)
        shardings = jax.tree_util.tree_map(
            lambda spec: NamedSharding(mesh, spec),
            llama.param_shardings(cfg),
            is_leaf=lambda x: isinstance(x, P))
        params = jax.device_put(params, shardings)

    def batches():
        key = jax.random.PRNGKey(1)
        while True:
            key, sub = jax.random.split(key)
            yield jax.random.randint(sub, (args.batch, args.seq + 1), 0,
                                     cfg.vocab_size, jnp.int32)

    tc = train.TrainConfig(learning_rate=3e-4, warmup_steps=10,
                           total_steps=args.steps)
    state, history = train.train(
        params, batches(), cfg, tc, steps=args.steps, mesh=mesh,
        ckpt_dir=args.ckpt, log_every=10)
    for h in history:
        print(h)
    print(f"done at step {int(state['step'])}")


if __name__ == "__main__":
    main()
