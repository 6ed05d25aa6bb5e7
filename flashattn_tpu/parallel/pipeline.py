"""Pipeline parallelism (GPipe-style) over a mesh axis — SURVEY.md T10.

Design: no scheduler process, no send/recv library. The pipeline
IS a shard_map program — each device holds one STAGE of layers (params
sharded on the 'pp' axis), microbatch activations rotate stage-to-stage with
``lax.ppermute``, and the classic GPipe schedule (M microbatches through n
stages in M + n - 1 ticks) runs as a ``lax.scan`` over ticks — compile time
is independent of M, and the scan body is the remat boundary. Because
``ppermute`` has a transpose rule, ``jax.grad`` through the pipeline
produces the reverse-schedule backward automatically — no hand-written
1F1B machinery (bubble fraction (n-1)/(M+n-1), amortized by M).

Memory: with ``remat=True`` each tick's residual is just its input
activation (the stage recomputes internals in the backward), so live
activations are bounded by microbatches-in-flight — the property 1F1B buys
with schedule complexity, bought here with recompute (the same trade the
flash kernels themselves make, reference ``Phase_4.md:172-180``).

Devices outside their active window compute garbage that is masked out of
the rotation — the standard cost of an SPMD pipeline (every device runs the
same program every tick).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x) -> x, applied by EVERY stage
    stage_params,  # this device's stage parameters (pytree)
    x: jnp.ndarray,  # [M, mb, ...] microbatched input (replicated)
    axis_name: str,
    remat: bool = False,
) -> jnp.ndarray:
    """Run x through n pipeline stages; call INSIDE shard_map.

    Args:
      stage_fn: the per-stage computation; stages must share a signature
        (same activation shape in/out).
      stage_params: the local shard of the stage-stacked parameters.
      x: [M, microbatch, ...] — M microbatches; every device passes the
        same x (only stage 0 reads it).
      remat: checkpoint each pipeline tick — backward recomputes stage
        internals from the tick's input, bounding live activations to one
        per in-flight microbatch.

    Returns:
      [M, microbatch, ...] outputs of the LAST stage (valid on every device
      — the result is rotated back to close the ring).
    """
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    m = x.shape[0]
    mb_shape = x.shape[1:]
    perm = [(i, (i + 1) % n) for i in range(n)]

    fn = jax.checkpoint(stage_fn) if remat else stage_fn

    def tick(carry, t):
        carry_act, outs = carry
        # Stage 0 injects microbatch t; everyone else consumes the rotation.
        inject = lax.dynamic_index_in_dim(
            x, jnp.minimum(t, m - 1), 0, keepdims=False)
        inp = jnp.where(idx == 0, inject, carry_act)
        out = fn(stage_params, inp)
        # The last stage's output for microbatch (t - n + 1) is ready.
        outs = lax.cond(
            t >= n - 1,
            lambda o: lax.dynamic_update_index_in_dim(
                o, out, jnp.maximum(t - (n - 1), 0), 0),
            lambda o: o,
            outs,
        )
        return (lax.ppermute(out, axis_name, perm), outs), None

    init = (jnp.zeros(mb_shape, x.dtype), jnp.zeros_like(x))
    (_, outs), _ = lax.scan(tick, init, jnp.arange(m + n - 1))
    # outs rows are only valid on the LAST stage; rotate them home to all
    # devices (one collective; replicated output keeps the caller simple).
    last = n - 1
    valid = jnp.where(idx == last, outs, jnp.zeros_like(outs))
    return lax.psum(valid, axis_name)


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage axis
    (shard it with PartitionSpec('pp', ...) so each device gets its stage)."""
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *per_stage_params
    )


def unstack_stage_params(stacked):
    """Inside shard_map: drop the (local, length-1) stage axis."""
    return jax.tree_util.tree_map(lambda x: x[0], stacked)
