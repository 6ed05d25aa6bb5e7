"""Flash-attention backward (Pallas, Triton route): two-kernel recompute with
delta reuse.

The reference backward (``code/_flash_attention_kernel_optimized.py:164-386``)
in its own GPU shape:

  - **dQ kernel** (reference ``:164-258``): a program per (q block, B·Hq)
    computes delta = row_sum(dO ⊙ O) once (``:209-211``), loops over the
    K/V blocks its rows see, rebuilds P = exp2(S·log2e − LSE·log2e) from the
    stored LSE (``:230-244``), forms dP = dO·Vᵀ and dS = P ⊙ (dP − delta)
    (``:247-250``), accumulates dQ in float32 (``:253``), and writes delta
    for the dK/dV kernel (``:258``) — the delta-reuse optimization
    (``Phase_5.md:529-624``).
  - **dK/dV kernel** (reference ``:291-386``): a program per (kv block,
    B·Hkv) loops over the q heads of its GQA group and, for each, over the
    q blocks that see it; it accumulates dV += Pᵀ·dO and dK += dSᵀ·Q
    (``:370,382``) and loads delta instead of recomputing it
    (``:375-376``). One program owns every q head sharing its kv head, so
    GQA needs no atomics.

The ordering dependency (dK/dV reads dQ's delta, reference
``My_FlashAttention_optimized.py:111-126``) is a plain data dependency
between the two pallas_calls. Both kernels share the forward's block-range
split (`kv_block_range` / `q_block_range`): only blocks on a mask edge pay
for the element mask.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from flashattn_tpu.ops.common import (
    LOG2E,
    MASK_VALUE,
    BlockSizes,
    dropout_keep_mask,
    pad_to_block,
    resolve_interpret,
)
from flashattn_tpu.ops.flash_fwd import (
    check_variants,
    default_alibi_slopes,
    kv_block_range,
    pad_head_dim,
    pad_segments,
    q_block_range,
    run_blocks,
    scalar_operands,
    visibility_mask,
)


def _unpack_scalars(refs, has_dynoff, dropout_rate, alibi):
    refs = list(refs)
    dynoff_ref = refs.pop(0) if has_dynoff else None
    seed_ref = refs.pop(0) if dropout_rate > 0.0 else None
    slope_ref = refs.pop(0) if alibi else None
    return dynoff_ref, seed_ref, slope_ref, refs


def _logits(s, softcap):
    """Log2-domain logits from the raw product; with soft-capping also the
    tanh value the gradient needs (d cap·tanh(x/cap)/dx = 1 - tanh²)."""
    if softcap > 0.0:
        t = jnp.tanh(s * (1.0 / softcap))
        return t * (softcap * LOG2E), t
    return s, None


def _dq_kernel(*refs, hq, block_q, block_kv, num_kv_blocks, s_k, causal,
               window, static_offset, has_dynoff, dropout_rate, alibi,
               segmented, softcap, scale):
    dynoff_ref, seed_ref, slope_ref, refs = _unpack_scalars(
        refs, has_dynoff, dropout_rate, alibi)
    q_ref, k_ref, v_ref, o_ref, do_ref, lse_ref = refs[:6]
    del refs[:6]
    segq_ref, segk_ref = (refs[:2] if segmented else (None, None))
    if segmented:
        del refs[:2]
    dq_ref, delta_ref = refs

    qi = pl.program_id(0)
    bh = pl.program_id(1)
    offset = dynoff_ref[...] if has_dynoff else static_offset
    q = q_ref[...]  # pre-scaled by scale·log2(e) (scale only w/ softcap)
    do = do_ref[...]
    delta = jnp.sum(do.astype(jnp.float32) * o_ref[...].astype(jnp.float32),
                    axis=1)
    delta_ref[...] = delta
    lse2 = lse_ref[...] * LOG2E  # padded rows carry +inf -> P = 0
    rows = qi * block_q + jnp.arange(block_q, dtype=jnp.int32)[:, None]
    segq = segq_ref[...][:, None] if segmented else None
    tail = s_k if s_k % block_kv else None

    def body(j, dq, masked):
        kv_slice = pl.ds(j * block_kv, block_kv)
        k = k_ref[kv_slice, :]
        v = v_ref[kv_slice, :]
        s, t_cap = _logits(pl.dot(q, k, trans_b=True), softcap)
        cols = j * block_kv + jnp.arange(block_kv, dtype=jnp.int32)[None, :]
        if alibi:
            s = s + (slope_ref[...] * LOG2E) * (
                cols - rows - offset).astype(jnp.float32)
        mask = None
        if masked:
            mask = visibility_mask(rows, cols, offset, causal=causal,
                                   window=window, s_k=tail)
            if segmented:
                seg = segq == segk_ref[kv_slice][None, :]
                mask = seg if mask is None else mask & seg
        if mask is not None:
            s = jnp.where(mask, s, MASK_VALUE)
        p = jnp.exp2(s - lse2[:, None])
        if mask is not None:
            # Rows with no visible key carry LSE = -inf: select, never scale.
            p = jnp.where(mask, p, 0.0)
        dp = pl.dot(do, v, trans_b=True)
        if dropout_rate > 0.0:
            # Regenerate the forward's keep-mask; dS = P ⊙ (M⊙dP/(1-r) − δ)
            # (δ = rowsum(dO⊙O) already carries the dropout through O).
            keep = dropout_keep_mask(seed_ref[...], bh, rows, cols,
                                     dropout_rate)
            dp = jnp.where(keep, dp * (1.0 / (1.0 - dropout_rate)), 0.0)
        ds = p * (dp - delta[:, None])
        if t_cap is not None:
            ds = ds * (1.0 - t_cap * t_cap)
        return dq + pl.dot(ds.astype(k.dtype), k)

    bounds = kv_block_range(
        qi, block_q=block_q, block_kv=block_kv, num_kv_blocks=num_kv_blocks,
        s_k=s_k, offset=offset, causal=causal, window=window,
        segmented=segmented)
    dq = run_blocks(bounds, body,
                    jnp.zeros((block_q, q_ref.shape[-1]), jnp.float32))
    dq_ref[...] = (dq * scale).astype(dq_ref.dtype)


def _dkv_kernel(*refs, hq, hkv, q_per_kv, block_q, block_kv, num_q_blocks,
                s_q_p, causal, window, static_offset, has_dynoff,
                dropout_rate, alibi, segmented, softcap, scale):
    dynoff_ref, seed_ref, slope_ref, refs = _unpack_scalars(
        refs, has_dynoff, dropout_rate, alibi)
    q_ref, do_ref, lse_ref, delta_ref, k_ref, v_ref = refs[:6]
    del refs[:6]
    segq_ref, segk_ref = (refs[:2] if segmented else (None, None))
    if segmented:
        del refs[:2]
    dk_ref, dv_ref = refs

    kj = pl.program_id(0)
    bhk = pl.program_id(1)
    batch = bhk // hkv
    offset = dynoff_ref[...] if has_dynoff else static_offset
    k = k_ref[...]  # pre-scaled by scale·log2(e) (scale only w/ softcap)
    v = v_ref[...]
    cols = kj * block_kv + jnp.arange(block_kv, dtype=jnp.int32)[None, :]
    segk = segk_ref[...][None, :] if segmented else None
    bounds = q_block_range(
        kj, block_q=block_q, block_kv=block_kv, num_q_blocks=num_q_blocks,
        offset=offset, causal=causal, window=window, segmented=segmented)

    def head_body(g, carry):
        h = (bhk % hkv) * q_per_kv + g  # q head within the batch row
        slope = slope_ref[h] if alibi else None

        def body(i, carry, masked):
            dk, dv = carry
            # q, dO and the row stats of all q_per_kv heads are stacked
            # along the row axis: head g's rows start at g * s_q_p.
            q_slice = pl.ds(g * s_q_p + i * block_q, block_q)
            q = q_ref[q_slice, :]
            do = do_ref[q_slice, :]
            lse2 = lse_ref[q_slice] * LOG2E  # padded rows carry +inf
            delta = delta_ref[q_slice]
            rows = i * block_q + jnp.arange(block_q, dtype=jnp.int32)[:, None]
            s, t_cap = _logits(pl.dot(q, k, trans_b=True), softcap)
            if alibi:
                s = s + (slope * LOG2E) * (
                    cols - rows - offset).astype(jnp.float32)
            mask = None
            if masked:
                mask = visibility_mask(rows, cols, offset, causal=causal,
                                       window=window, s_k=None)
                if segmented:
                    seg = (segq_ref[pl.ds(i * block_q, block_q)][:, None]
                           == segk)
                    mask = seg if mask is None else mask & seg
            if mask is not None:
                s = jnp.where(mask, s, MASK_VALUE)
            p = jnp.exp2(s - lse2[:, None])
            if mask is not None:
                p = jnp.where(mask, p, 0.0)
            dp = pl.dot(do, v, trans_b=True)
            p_v = p
            if dropout_rate > 0.0:
                # Same keep-mask as the forward: keyed on global (row, col)
                # and the true q head, whatever the tile sizes.
                keep = dropout_keep_mask(seed_ref[...], batch * hq + h, rows,
                                         cols, dropout_rate)
                inv = 1.0 / (1.0 - dropout_rate)
                p_v = jnp.where(keep, p * inv, 0.0)  # dV sees the dropped P
                dp = jnp.where(keep, dp * inv, 0.0)
            dv = dv + pl.dot(p_v.astype(do.dtype), do, trans_a=True)
            ds = p * (dp - delta[:, None])
            if t_cap is not None:
                ds = ds * (1.0 - t_cap * t_cap)
            dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True)
            return dk, dv

        return run_blocks(bounds, body, carry)

    d = k_ref.shape[-1]
    zeros = jnp.zeros((block_kv, d), jnp.float32)
    dk, dv = jax.lax.fori_loop(0, q_per_kv, head_body, (zeros, zeros))
    dk_ref[...] = (dk * scale).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


@functools.partial(
    jax.jit,
    static_argnames=("is_causal", "scale", "block_sizes", "interpret",
                     "debug", "dropout_rate", "window", "logit_softcap",
                     "alibi", "pos_offset"),
)
def flash_attention_backward(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    o: jnp.ndarray,
    do: jnp.ndarray,
    lse: jnp.ndarray,
    is_causal: bool = False,
    scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    interpret: bool | None = None,
    debug: bool = False,
    segment_ids: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    dropout_rate: float = 0.0,
    dropout_seed: jnp.ndarray | int | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    alibi_slopes: jnp.ndarray | None = None,  # (Hq,) f32; None = standard
    pos_offset: int | None = None,
    dyn_pos_offset: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Flash-attention backward (the reference ``flash_attention_backward``,
    ``My_FlashAttention_optimized.py:62-128``): the dQ kernel, then the
    dK/dV kernel reusing its delta.

    Every variant argument (segment_ids, dropout, window, softcap, ALiBi,
    pos_offset / dyn_pos_offset) must match the forward call that produced
    o/lse; see ``flash_attention_forward``.

    Returns (dQ [B,Hq,S_q,D], dK [B,Hkv,S_k,D], dV [B,Hkv,S_k,D]).
    """
    b, hq, s_q, d = q.shape
    _, hkv, s_k, _ = k.shape
    assert hq % hkv == 0
    check_variants(is_causal, window, alibi, logit_softcap, dropout_rate,
                   pos_offset, dyn_pos_offset)
    q_per_kv = hq // hkv
    if scale is None:
        scale = 1.0 / (d**0.5)
    interpret = resolve_interpret(interpret)
    if block_sizes is None:
        from flashattn_tpu.ops.autotune import lookup_block_sizes

        block_sizes = lookup_block_sizes(b, hq, hkv, s_q, s_k, d, is_causal,
                                         q.dtype)
    block_sizes = block_sizes.clamp(s_q, s_k)
    static_offset = (s_k - s_q) if pos_offset is None else int(pos_offset)
    segmented = segment_ids is not None
    if alibi and alibi_slopes is None:
        alibi_slopes = default_alibi_slopes(hq)
    variants = dict(
        causal=is_causal,
        window=window,
        static_offset=static_offset,
        has_dynoff=dyn_pos_offset is not None,
        dropout_rate=dropout_rate,
        alibi=alibi,
        segmented=segmented,
        softcap=float(logit_softcap or 0.0),
        scale=scale,
    )
    # With soft-capping only `scale` folds into the operand (tanh needs true
    # logits); the kernels apply ·log2(e) after the cap.
    pre = scale if logit_softcap else scale * LOG2E

    # ---- Kernel 1: dQ (+ delta for kernel 2) ----
    bq, bkv = block_sizes.block_q_dq, block_sizes.block_kv_dq
    q_p = pad_head_dim(pad_to_block((q * pre).astype(q.dtype), 2, bq))
    o_p = pad_head_dim(pad_to_block(o, 2, bq))
    do_p = pad_head_dim(pad_to_block(do, 2, bq))
    lse_p = pad_to_block(lse, 2, bq, value=jnp.inf)
    k_p = pad_head_dim(pad_to_block(k, 2, bkv))
    v_p = pad_head_dim(pad_to_block(v, 2, bkv))
    s_q_p, s_k_p, d_p = q_p.shape[2], k_p.shape[2], q_p.shape[3]
    compiler_params = plgpu.CompilerParams(
        num_warps=block_sizes.num_warps, num_stages=block_sizes.num_stages)

    def batch_of(i, bh):
        return bh // hq

    def head_of(i, bh):
        return bh % hq

    def q_map(i, bh):
        return (batch_of(i, bh), head_of(i, bh), i, 0)

    def stat_map(i, bh):
        return (batch_of(i, bh), head_of(i, bh), i)

    def kv_map(i, bh):
        return (batch_of(i, bh), head_of(i, bh) // q_per_kv, 0, 0)

    inputs, in_specs = scalar_operands(hq, dyn_pos_offset, dropout_rate,
                                       dropout_seed, alibi, alibi_slopes,
                                       head_of)
    inputs += [q_p, k_p, v_p, o_p, do_p, lse_p]
    in_specs += [
        pl.BlockSpec((None, None, bq, d_p), q_map),
        pl.BlockSpec((None, None, s_k_p, d_p), kv_map),
        pl.BlockSpec((None, None, s_k_p, d_p), kv_map),
        pl.BlockSpec((None, None, bq, d_p), q_map),
        pl.BlockSpec((None, None, bq, d_p), q_map),
        pl.BlockSpec((None, None, bq), stat_map),
    ]
    if segmented:
        inputs += pad_segments(segment_ids, b, s_q, s_k, s_q_p, s_k_p)
        in_specs += [
            pl.BlockSpec((None, bq), lambda i, bh: (batch_of(i, bh), i)),
            pl.BlockSpec((None, s_k_p), lambda i, bh: (batch_of(i, bh), 0)),
        ]
    dq, delta = pl.pallas_call(
        functools.partial(_dq_kernel, hq=hq, block_q=bq, block_kv=bkv,
                          num_kv_blocks=s_k_p // bkv, s_k=s_k, **variants),
        grid=(s_q_p // bq, b * hq),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((None, None, bq, d_p), q_map),
                   pl.BlockSpec((None, None, bq), stat_map)],
        out_shape=[jax.ShapeDtypeStruct((b, hq, s_q_p, d_p), q.dtype),
                   jax.ShapeDtypeStruct((b, hq, s_q_p), jnp.float32)],
        backend="triton",
        compiler_params=compiler_params,
        interpret=interpret,
        debug=debug,
        name="flash_bwd_dq",
    )(*inputs)
    dq = dq[:, :, :s_q, :d]

    # ---- Kernel 2: dK/dV, reusing kernel 1's delta ----
    bq2, bkv2 = block_sizes.block_q_dkv, block_sizes.block_kv_dkv
    s_q_p2 = pad_to_block(lse, 2, bq2).shape[2]
    # The q heads of one GQA group are contiguous, so [B, Hq, S, D] folds
    # to [B, Hkv, q_per_kv·S, D] for free: one program streams them all.
    q_p2 = pad_head_dim(pad_to_block(q, 2, bq2)).reshape(
        b, hkv, q_per_kv * s_q_p2, d_p)  # UNscaled (dK = dSᵀ·Q uses raw Q)
    do_p2 = pad_head_dim(pad_to_block(do, 2, bq2)).reshape(
        b, hkv, q_per_kv * s_q_p2, d_p)
    lse_p2 = pad_to_block(lse, 2, bq2, value=jnp.inf).reshape(
        b, hkv, q_per_kv * s_q_p2)
    delta_p2 = pad_to_block(delta[:, :, :s_q], 2, bq2).reshape(
        b, hkv, q_per_kv * s_q_p2)
    k_p2 = pad_head_dim(pad_to_block((k * pre).astype(k.dtype), 2, bkv2))
    v_p2 = pad_head_dim(pad_to_block(v, 2, bkv2))
    s_k_p2 = k_p2.shape[2]

    def kv_map2(j, bhk):
        return (bhk // hkv, bhk % hkv, j, 0)

    def group_map(j, bhk):
        return (bhk // hkv, bhk % hkv, 0, 0)

    def group_stat_map(j, bhk):
        return (bhk // hkv, bhk % hkv, 0)

    inputs2, in_specs2 = scalar_operands(hq, dyn_pos_offset, dropout_rate,
                                         dropout_seed, False, None, None)
    if alibi:
        # One program covers all q heads of its group: pass the whole table.
        inputs2.append(alibi_slopes.astype(jnp.float32))
        in_specs2.append(pl.BlockSpec((hq,), lambda j, bhk: (0,)))
    inputs2 += [q_p2, do_p2, lse_p2, delta_p2, k_p2, v_p2]
    in_specs2 += [
        pl.BlockSpec((None, None, q_per_kv * s_q_p2, d_p), group_map),
        pl.BlockSpec((None, None, q_per_kv * s_q_p2, d_p), group_map),
        pl.BlockSpec((None, None, q_per_kv * s_q_p2), group_stat_map),
        pl.BlockSpec((None, None, q_per_kv * s_q_p2), group_stat_map),
        pl.BlockSpec((None, None, bkv2, d_p), kv_map2),
        pl.BlockSpec((None, None, bkv2, d_p), kv_map2),
    ]
    if segmented:
        inputs2 += pad_segments(segment_ids, b, s_q, s_k, s_q_p2, s_k_p2)
        in_specs2 += [
            pl.BlockSpec((None, s_q_p2), lambda j, bhk: (bhk // hkv, 0)),
            pl.BlockSpec((None, bkv2), lambda j, bhk: (bhk // hkv, j)),
        ]
    dk, dv = pl.pallas_call(
        functools.partial(_dkv_kernel, hq=hq, hkv=hkv, q_per_kv=q_per_kv,
                          block_q=bq2, block_kv=bkv2,
                          num_q_blocks=s_q_p2 // bq2, s_q_p=s_q_p2,
                          **variants),
        grid=(s_k_p2 // bkv2, b * hkv),
        in_specs=in_specs2,
        out_specs=[pl.BlockSpec((None, None, bkv2, d_p), kv_map2),
                   pl.BlockSpec((None, None, bkv2, d_p), kv_map2)],
        out_shape=[jax.ShapeDtypeStruct((b, hkv, s_k_p2, d_p), k.dtype),
                   jax.ShapeDtypeStruct((b, hkv, s_k_p2, d_p), v.dtype)],
        backend="triton",
        compiler_params=compiler_params,
        interpret=interpret,
        debug=debug,
        name="flash_bwd_dkv",
    )(*inputs2)
    return dq, dk[:, :, :s_k, :d], dv[:, :, :s_k, :d]
