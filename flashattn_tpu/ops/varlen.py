"""Variable-length (packed / cu_seqlens) flash attention — SURVEY.md T7.

The reference defers varlen as a documented design (``Phase_6.md:118-178``,
``README.md:138-143``): pack the batch into one long sequence, carry a
``cu_seqlens`` prefix-sum, and add "one more layer of boundary checks" per
program. The realization here is **segment IDs** instead of per-program
range lookups: every token carries an int32 sequence id, the kernels mask on
``seg_q[i] == seg_k[j]``, and the grid/shapes stay fully static — one
compiled executable serves every packing (no retrace per batch, which is
the difference between a kernel and a compile storm). ``cu_seqlens`` is
supported as a thin conversion layer for API parity with the reference's
planned interface.

Conventions: query padding gets id -1 and key padding -2, so padded rows
match nothing (O = 0, LSE = -inf) and padded keys are invisible — replacing
the reference's explicit boundary masks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward


def segment_ids_from_cu_seqlens(cu_seqlens: jnp.ndarray,
                                total_len: int) -> jnp.ndarray:
    """cu_seqlens [N+1] (monotone prefix sums, cu[0]=0) -> segment ids
    [total_len] int32; positions at/after cu[-1] get -1 (padding).

    The reference's planned per-program binary search over cu_seqlens
    (``Phase_6.md:139-157``) becomes one vectorized searchsorted outside the
    kernel — the ids are what the kernel actually needs.
    """
    pos = jnp.arange(total_len, dtype=jnp.int32)
    ids = jnp.searchsorted(cu_seqlens.astype(jnp.int32), pos, side="right") - 1
    return jnp.where(pos < cu_seqlens[-1], ids.astype(jnp.int32), -1)


@functools.partial(jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10, 11, 12))
def _flash_attention_varlen(q, k, v, seg_q, seg_k, slopes, is_causal, scale,
                            block_sizes, interpret, logit_softcap, alibi,
                            window):
    o, _ = flash_attention_forward(
        q, k, v, is_causal=is_causal, scale=scale, block_sizes=block_sizes,
        interpret=interpret, segment_ids=(seg_q, seg_k),
        logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=slopes,
        window=window,
    )
    return o


def _varlen_fwd(q, k, v, seg_q, seg_k, slopes, is_causal, scale, block_sizes,
                interpret, logit_softcap, alibi, window):
    o, lse = flash_attention_forward(
        q, k, v, is_causal=is_causal, scale=scale, block_sizes=block_sizes,
        interpret=interpret, segment_ids=(seg_q, seg_k),
        logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=slopes,
        window=window,
    )
    return o, (q, k, v, seg_q, seg_k, slopes, o, lse)


def _varlen_bwd(is_causal, scale, block_sizes, interpret, logit_softcap,
                alibi, window, residuals, do):
    q, k, v, seg_q, seg_k, slopes, o, lse = residuals
    dq, dk, dv = flash_attention_backward(
        q, k, v, o, do, lse, is_causal=is_causal, scale=scale,
        block_sizes=block_sizes, interpret=interpret,
        segment_ids=(seg_q, seg_k),
        logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=slopes,
        window=window,
    )
    zero_q = np.zeros(seg_q.shape, dtype=jax.dtypes.float0)
    zero_k = np.zeros(seg_k.shape, dtype=jax.dtypes.float0)
    return (dq, dk, dv, zero_q, zero_k,
            None if slopes is None else jnp.zeros_like(slopes))


_flash_attention_varlen.defvjp(_varlen_fwd, _varlen_bwd)


def flash_attention_varlen(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    segment_ids: jnp.ndarray | tuple[jnp.ndarray, jnp.ndarray] | None = None,
    cu_seqlens: jnp.ndarray | None = None,
    is_causal: bool = False,
    scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    interpret: bool | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,
    window: int | None = None,
) -> jnp.ndarray:
    """Differentiable packed-sequence flash attention.

    ``window`` (sliding window, requires is_causal) composes exactly with
    packing for the same reason ALiBi does: the window condition depends
    only on (q_pos - k_pos), which is translation-invariant, so the global
    window restricted by segment equality IS the per-document window.

    ALiBi composes exactly with packing: the bias depends only on
    (k_pos - q_pos), which is translation-invariant, so global positions
    inside a packed document give the per-document bias and cross-document
    pairs are segment-masked (test_varlen_alibi_composition).

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] (usually B=1, everything
        packed along S).
      segment_ids: [B, S] shared q/k ids, or a (seg_q [B,S_q], seg_k [B,S_k])
        pair for packed cross-attention. Ids < 0 are padding.
      cu_seqlens: alternative to segment_ids — [N+1] prefix sums over the
        packed length (requires B == 1 and S_q == S_k), reference-parity API.
      is_causal: causal within each segment (positions are monotone inside a
        packed segment, so the global causal mask restricted by segment
        equality IS the per-sequence causal mask).

    Returns:
      O [B, Hq, S_q, D]; fully-padded rows are 0.
    """
    assert (segment_ids is None) != (cu_seqlens is None), (
        "pass exactly one of segment_ids / cu_seqlens")
    if cu_seqlens is not None:
        b, _, s_q, _ = q.shape
        assert b == 1 and q.shape[2] == k.shape[2], (
            "cu_seqlens mode packs one batch row with S_q == S_k")
        ids = segment_ids_from_cu_seqlens(cu_seqlens, s_q)[None]
        seg_q = seg_k = ids
    elif isinstance(segment_ids, tuple):
        seg_q, seg_k = segment_ids
    else:
        seg_q = seg_k = segment_ids
    # Padding (any id < 0) must never match itself across q/k: canonicalize
    # q-side padding to -1 and k-side to -2 so pad rows see zero keys.
    seg_q = jnp.where(seg_q < 0, -1, seg_q).astype(jnp.int32)
    seg_k = jnp.where(seg_k < 0, -2, seg_k).astype(jnp.int32)
    if alibi and alibi_slopes is None:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        alibi_slopes = default_alibi_slopes(q.shape[1])
    if alibi_slopes is not None:
        alibi_slopes = jax.lax.stop_gradient(alibi_slopes)
    return _flash_attention_varlen(
        q, k, v, seg_q, seg_k, alibi_slopes, is_causal, scale, block_sizes,
        interpret, logit_softcap, alibi, window,
    )
