"""Public flash-attention API with custom-VJP autograd integration.

Counterpart of the reference's autograd layer
(``code/My_FlashAttention_optimized.py:130-170``): ``jax.custom_vjp``
replaces ``torch.autograd.Function``; residuals (Q, K, V, O, LSE) mirror
``ctx.save_for_backward`` (``:145-147``); the backward calls the two-kernel
recompute backward with delta reuse (``:62-128``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_fwd import flash_attention_forward
from flashattn_tpu.ops.flash_bwd import flash_attention_backward


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8, 9, 10, 11, 12, 13)
)
def _flash_attention(q, k, v, seed, slopes, is_causal, scale, block_sizes,
                     interpret, dropout_rate, window, logit_softcap, alibi,
                     pos_offset):
    # PRIMAL (no grad taken — inference/serving): the LSE output stream is
    # compiled out of the kernel entirely (need_lse=False), matching
    # jax_flash's save_residuals=False forward. Under jax.grad the _fwd
    # rule below runs instead and keeps LSE as a residual.
    o, _ = flash_attention_forward(
        q, k, v, is_causal=is_causal, scale=scale,
        block_sizes=block_sizes, interpret=interpret,
        dropout_rate=dropout_rate, dropout_seed=seed, window=window,
        logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=slopes,
        pos_offset=pos_offset, need_lse=False,
    )
    return o


def _fwd(q, k, v, seed, slopes, is_causal, scale, block_sizes, interpret,
         dropout_rate, window, logit_softcap, alibi, pos_offset):
    o, lse = flash_attention_forward(
        q, k, v, is_causal=is_causal, scale=scale,
        block_sizes=block_sizes, interpret=interpret,
        dropout_rate=dropout_rate, dropout_seed=seed, window=window,
        logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=slopes,
        pos_offset=pos_offset,
    )
    # Name the saved residuals so a jax.checkpoint names-policy can keep
    # exactly these across the backward (selective activation
    # checkpointing: llama.py remat="attn" saves the flash residuals —
    # skipping the attention-kernel recompute, the FLOPs-heavy part of a
    # layer replay — while everything else rematerializes). No-op outside
    # a names-aware policy.
    from jax.ad_checkpoint import checkpoint_name

    tag = lambda x: checkpoint_name(x, "flash_resid")
    return o, (tag(q), tag(k), tag(v), seed, slopes, tag(o), tag(lse))


def _bwd(is_causal, scale, block_sizes, interpret, dropout_rate, window,
         logit_softcap, alibi, pos_offset, residuals, do):
    q, k, v, seed, slopes, o, lse = residuals
    dq, dk, dv = flash_attention_backward(
        q, k, v, o, do, lse, is_causal=is_causal, scale=scale,
        block_sizes=block_sizes, interpret=interpret,
        dropout_rate=dropout_rate, dropout_seed=seed, window=window,
        logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=slopes,
        pos_offset=pos_offset,
    )
    return (dq, dk, dv, np.zeros(seed.shape, dtype=jax.dtypes.float0),
            jnp.zeros_like(slopes))


_flash_attention.defvjp(_fwd, _bwd)


def flash_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    is_causal: bool = False,
    scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    interpret: bool | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: jnp.ndarray | int | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,
    pos_offset: int | None = None,
) -> jnp.ndarray:
    """Differentiable fused flash attention (public entry point, mirroring
    the reference ``flash_attention`` at ``My_FlashAttention_optimized.py:169-170``).

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] (Hkv | Hq for GQA/MQA).
      is_causal: causal mask aligned to the end of the key sequence.
      scale: softmax scale, default 1/sqrt(D).
      block_sizes: kernel tile sizes (autotunable).
      interpret: Pallas interpreter mode (default: True on the CPU backend,
        False on the GPU; any other backend raises).
      dropout_rate: attention-probability dropout in [0, 1); masks are
        regenerated from a counter-based hash in fwd AND bwd — never stored
        (the reference's deferred Philox design, ``Phase_6.md:54-114``).
      dropout_seed: int32 scalar; required when dropout_rate > 0. Vary it
        per training step.
      window: sliding-window size (requires is_causal): query i attends
        keys in (i - window, i] — blocks left of the window are pruned from
        the kernels' loops, not just masked.
      logit_softcap: Gemma-style logit soft-capping cap·tanh(S/cap) applied
        to the raw logits before the softmax (fwd and bwd agree exactly).
      alibi: add ALiBi position bias slope_h·(k_pos - q_pos) with the
        standard 2^(-8(h+1)/H) slopes.
      alibi_slopes: optional (Hq,) f32 per-head slope table overriding the
        standard one — REQUIRED under head sharding (pass the global table
        sharded with the heads so each shard indexes its local slice).
        Slopes are NOT differentiable: the gradient is explicitly stopped
        (a trainable-slopes use case would silently get zeros otherwise).
      pos_offset: static global q/k alignment override (global position of
        q row r = r + pos_offset in k column coordinates) driving the causal
        mask, window edge, and ALiBi distance alike; defaults to S_k - S_q.
        Used by ring/context parallelism for per-hop shard alignment.

    Returns:
      O: [B, Hq, S_q, D] in q.dtype.
    """
    assert q.ndim == 4 and k.ndim == 4 and v.ndim == 4, "expected [B,H,S,D]"
    seed = jnp.asarray(
        0 if dropout_seed is None else dropout_seed, jnp.int32
    )
    if alibi and alibi_slopes is None:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        alibi_slopes = default_alibi_slopes(q.shape[1])
    if alibi_slopes is None:
        alibi_slopes = jnp.zeros((q.shape[1],), jnp.float32)  # unused
    # Slopes are a position-bias table, not a parameter: stop the gradient
    # so autodiff records the non-differentiability instead of silently
    # propagating the custom-VJP's zero cotangent into an optimizer.
    alibi_slopes = jax.lax.stop_gradient(alibi_slopes)
    return _flash_attention(q, k, v, seed, alibi_slopes, is_causal, scale,
                            block_sizes, interpret, dropout_rate, window,
                            logit_softcap, alibi, pos_offset)


# Re-exported for API parity with the reference's launcher layer.
__all__ = [
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_backward",
]
