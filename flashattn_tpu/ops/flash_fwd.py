"""Flash-attention forward kernel (Pallas, Triton route).

Re-design of the reference forward kernel
(``code/_flash_attention_kernel_optimized.py:34-129``) in its own GPU shape:
the grid is (q blocks, B·Hq); each program keeps one Q tile resident and
loops over the K/V blocks its rows can see, carrying the online-softmax
running stats (m, l, acc) through the loop (update rules: reference
``:106-117``), in the exp2 domain (``:79,108-109``), with float32
accumulation and the P tile cast to the V dtype for the P·V product
(``:112-115``), and writes the LSE (``:126-129``).

The loop bounds come from `kv_block_range`: causal and sliding-window
pruning is a shorter loop, not masked programs (the reference's loop-bound
truncation, ``:82``), and only the blocks that straddle a mask edge pay for
the element mask — the interior runs a mask-free loop body.

Composable variants (each a static flag, zero cost when off): sliding
window, Gemma-style logit soft-capping, ALiBi (per-head slope table,
shardable with the heads), counter-based dropout, packed-sequence segment
masking (varlen), GQA/MQA (the K/V index map folds q head -> kv head), and a
global q/k alignment that is either static (`pos_offset`) or traced
(`dyn_pos_offset`, a scalar operand read inside the kernel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from flashattn_tpu.ops.common import (
    LN2,
    LOG2E,
    MASK_VALUE,
    BlockSizes,
    dropout_keep_mask,
    next_pow2,
    pad_to_block,
    resolve_interpret,
)


def default_alibi_slopes(num_heads: int) -> jnp.ndarray:
    """Standard ALiBi slope table: 2^(-8(h+1)/H) for h in [0, H)."""
    return jnp.exp2(-8.0 * (jnp.arange(num_heads, dtype=jnp.float32) + 1)
                    / num_heads)


# ---------------------------------------------------------------------------
# Block ranges. Shared by the forward, dQ and dK/dV kernels and exercised by
# tests/test_wavefront.py with plain ints; inside a kernel the block index
# and the offset may be traced int32 scalars.


def _fdiv(a, b: int):
    """floor(a / b) for a Python int or a traced int32 (b > 0 static)."""
    if isinstance(a, int):
        return a // b
    return jnp.where(a >= 0, lax.div(a, b), -lax.div(b - 1 - a, b))


def _cdiv(a, b: int):
    return -_fdiv(-a, b)


def _clip(x, lo, hi):
    if all(isinstance(t, int) for t in (x, lo, hi)):
        return max(lo, min(x, hi))
    return jnp.minimum(jnp.maximum(x, lo), hi)


def _split(lo, lo_full, hi_full, hi):
    """(lo, b, c, hi): blocks [lo, b) and [c, hi) need the element mask,
    [b, c) need none; the three ranges are disjoint and cover [lo, hi)."""
    b = _clip(lo_full, lo, hi)
    c = _clip(hi_full, b, hi)
    return lo, b, c, hi


def kv_block_range(qi, *, block_q: int, block_kv: int, num_kv_blocks: int,
                   s_k: int, offset, causal: bool, window: int | None,
                   segmented: bool = False):
    """K/V blocks that q block `qi` visits, split by whether they need the
    element mask: returns (lo, b, c, hi) as in `_split`.

    Row r sees column c iff c <= r + offset (causal), c >= r + offset -
    window + 1 (window) and c < s_k. A block is mask-free when every one of
    the q block's rows sees every one of its columns.
    """
    row0 = qi * block_q
    row1 = row0 + block_q - 1
    if causal:
        hi = _clip(_fdiv(row1 + offset, block_kv) + 1, 0, num_kv_blocks)
        hi_full = _fdiv(row0 + offset + 1, block_kv)
    else:
        hi = num_kv_blocks
        hi_full = num_kv_blocks
    if s_k % block_kv:
        hi_full = _clip(hi_full, 0, s_k // block_kv)
    if window is not None:
        lo = _clip(_fdiv(row0 + offset - (window - 1), block_kv), 0, hi)
        lo_full = _cdiv(row1 + offset - (window - 1), block_kv)
    else:
        lo = 0
        lo_full = 0
    if segmented:
        lo_full = hi
    return _split(lo, lo_full, hi_full, hi)


def q_block_range(kj, *, block_q: int, block_kv: int, num_q_blocks: int,
                  offset, causal: bool, window: int | None,
                  segmented: bool = False):
    """Q blocks that see any column of K/V block `kj`, split like
    `kv_block_range`. Padded q rows need no mask: the backward gives them
    LSE = +inf, so their P is exactly 0."""
    col0 = kj * block_kv
    col1 = col0 + block_kv - 1
    if causal:
        lo = _clip(_fdiv(col0 - offset, block_q), 0, num_q_blocks)
        lo_full = _cdiv(col1 - offset, block_q)
    else:
        lo = 0
        lo_full = 0
    if window is not None:
        hi = _clip(_fdiv(col1 + window - 1 - offset, block_q) + 1, lo,
                   num_q_blocks)
        hi_full = _fdiv(col0 + window - offset, block_q)
    else:
        hi = num_q_blocks
        hi_full = num_q_blocks
    if segmented:
        lo_full = hi
    return _split(lo, lo_full, hi_full, hi)


def visibility_mask(rows, cols, offset, *, causal: bool, window: int | None,
                    s_k: int | None):
    """Element mask of (rows (bq,1), cols (1,bkv)) global positions, or
    None when nothing is masked. `s_k` masks the ragged key tail."""
    mask = None

    def both(a, b):
        return b if a is None else a & b

    if causal:
        mask = both(mask, cols <= rows + offset)
    if window is not None:
        mask = both(mask, cols >= rows + offset - (window - 1))
    if s_k is not None:
        mask = both(mask, cols < s_k)
    return mask


def run_blocks(bounds, body, carry):
    """fori_loop `body(j, carry, masked)` over the (lo, b, c, hi) split."""
    lo, b, c, hi = bounds
    carry = lax.fori_loop(lo, b, functools.partial(body, masked=True), carry)
    carry = lax.fori_loop(b, c, functools.partial(body, masked=False), carry)
    return lax.fori_loop(c, hi, functools.partial(body, masked=True), carry)


# ---------------------------------------------------------------------------


def _fwd_kernel(*refs, hq, block_q, block_kv, num_kv_blocks, s_k, causal,
                window, static_offset, has_dynoff, dropout_rate, alibi,
                segmented, softcap, need_lse):
    refs = list(refs)
    dynoff_ref = refs.pop(0) if has_dynoff else None
    seed_ref = refs.pop(0) if dropout_rate > 0.0 else None
    slope_ref = refs.pop(0) if alibi else None
    q_ref, k_ref, v_ref = refs[:3]
    del refs[:3]
    segq_ref, segk_ref = (refs[:2] if segmented else (None, None))
    if segmented:
        del refs[:2]
    o_ref = refs[0]
    lse_ref = refs[1] if need_lse else None

    qi = pl.program_id(0)
    bh = pl.program_id(1)
    offset = dynoff_ref[...] if has_dynoff else static_offset
    q = q_ref[...]  # (bq, D), carries scale·log2(e) (scale only w/ softcap)
    rows = qi * block_q + jnp.arange(block_q, dtype=jnp.int32)[:, None]
    segq = segq_ref[...][:, None] if segmented else None
    tail = s_k if s_k % block_kv else None

    def body(j, carry, masked):
        acc, m, l = carry
        kv_slice = pl.ds(j * block_kv, block_kv)
        s = pl.dot(q, k_ref[kv_slice, :], trans_b=True)  # (bq, bkv) f32
        if softcap > 0.0:
            s = jnp.tanh(s * (1.0 / softcap)) * (softcap * LOG2E)
        cols = j * block_kv + jnp.arange(block_kv, dtype=jnp.int32)[None, :]
        if alibi:
            dist = (cols - rows - offset).astype(jnp.float32)
            s = s + (slope_ref[...] * LOG2E) * dist
        mask = None
        if masked:
            mask = visibility_mask(rows, cols, offset, causal=causal,
                                   window=window, s_k=tail)
            if segmented:
                seg = segq == segk_ref[kv_slice][None, :]
                mask = seg if mask is None else mask & seg
        if mask is not None:
            s = jnp.where(mask, s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        if mask is not None:
            # A row with no visible key in this block would get
            # p = exp2(MASK - MASK) = 1; zero it exactly.
            p = jnp.where(mask, p, 0.0)
        l = alpha * l + jnp.sum(p, axis=1)
        if dropout_rate > 0.0:
            # Dropout on the unnormalized P feeding the PV product only: l
            # keeps the clean normalizer, so LSE and the backward's P
            # rebuild are dropout-free (Phase_6.md:54-114).
            keep = dropout_keep_mask(seed_ref[...], bh, rows, cols,
                                     dropout_rate)
            p = jnp.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
        v = v_ref[kv_slice, :]
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l

    d = q_ref.shape[-1]
    carry = (jnp.zeros((block_q, d), jnp.float32),
             jnp.full((block_q,), MASK_VALUE, jnp.float32),
             jnp.zeros((block_q,), jnp.float32))
    bounds = kv_block_range(
        qi, block_q=block_q, block_kv=block_kv, num_kv_blocks=num_kv_blocks,
        s_k=s_k, offset=offset, causal=causal, window=window,
        segmented=segmented)
    acc, m, l = run_blocks(bounds, body, carry)
    empty = l == 0.0  # rows with no visible key: O = 0, LSE = -inf
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = (acc / l_safe[:, None]).astype(o_ref.dtype)
    if need_lse:
        lse_ref[...] = jnp.where(empty, -jnp.inf,
                                 (m + jnp.log2(l_safe)) * LN2)


def pad_head_dim(x: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad D to a power of two >= 16 (Triton tiles; zeros change no
    dot product)."""
    d = x.shape[-1]
    d_p = max(16, next_pow2(d))
    if d_p == d:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, d_p - d)])


def scalar_operands(hq, dyn_pos_offset, dropout_rate, dropout_seed, alibi,
                    alibi_slopes, head_of):
    """(arrays, BlockSpecs) for the per-call scalars read in the kernels:
    the traced offset, the dropout seed, and the ALiBi slope of the
    program's q head (`head_of` maps grid indices to it)."""
    arrays, specs = [], []
    if dyn_pos_offset is not None:
        arrays.append(jnp.asarray(dyn_pos_offset, jnp.int32).reshape(1))
        specs.append(pl.BlockSpec((None,), lambda *_: (0,)))
    if dropout_rate > 0.0:
        assert dropout_seed is not None, "dropout needs dropout_seed"
        arrays.append(jnp.asarray(dropout_seed, jnp.int32).reshape(1))
        specs.append(pl.BlockSpec((None,), lambda *_: (0,)))
    if alibi:
        if alibi_slopes is None:
            alibi_slopes = default_alibi_slopes(hq)
        assert alibi_slopes.shape == (hq,), (alibi_slopes.shape, hq)
        arrays.append(alibi_slopes.astype(jnp.float32))
        specs.append(pl.BlockSpec((None,), lambda *g: (head_of(*g),)))
    return arrays, specs


def pad_segments(segment_ids, b, s_q, s_k, s_q_p, s_k_p):
    """Pad q ids with -1 and k ids with -2: padding matches nothing."""
    seg_q, seg_k = segment_ids
    assert seg_q.shape == (b, s_q) and seg_k.shape == (b, s_k), (
        seg_q.shape, seg_k.shape, (b, s_q, s_k))
    segq = jnp.pad(seg_q.astype(jnp.int32), ((0, 0), (0, s_q_p - s_q)),
                   constant_values=-1)
    segk = jnp.pad(seg_k.astype(jnp.int32), ((0, 0), (0, s_k_p - s_k)),
                   constant_values=-2)
    return segq, segk


def check_variants(is_causal, window, alibi, logit_softcap, dropout_rate,
                   pos_offset, dyn_pos_offset):
    assert not (alibi and logit_softcap), "alibi + softcap: pick one"
    assert 0.0 <= dropout_rate < 1.0, dropout_rate
    assert pos_offset is None or dyn_pos_offset is None, (
        "pos_offset and dyn_pos_offset are mutually exclusive")
    assert window is None or window >= 1, window
    assert window is None or is_causal or dyn_pos_offset is not None, (
        "window requires is_causal (or a traced dyn_pos_offset whose caller "
        "guarantees causal visibility)")


@functools.partial(
    jax.jit,
    static_argnames=("is_causal", "scale", "block_sizes", "interpret",
                     "debug", "dropout_rate", "window", "logit_softcap",
                     "alibi", "pos_offset", "need_lse"),
)
def flash_attention_forward(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
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
    need_lse: bool = True,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fused flash-attention forward (the reference launcher,
    ``My_FlashAttention_optimized.py:14-60``): O in the input dtype, LSE in
    float32.

    Args:
      q: [B, Hq, S_q, D]; k, v: [B, Hkv, S_k, D] with Hkv | Hq (GQA).
      segment_ids: optional (seg_q [B, S_q], seg_k [B, S_k]) int32 packed-
        sequence ids for varlen/cu_seqlens batching (reference deferred
        design ``Phase_6.md:118-178``); attention restricted to equal ids.
      pos_offset: global q/k alignment override — the global position of
        q row r is ``r + pos_offset`` relative to k column coordinates, so
        causal visibility is ``col <= row + pos_offset``, the window's left
        edge is ``col >= row + pos_offset - window + 1``, and the ALiBi
        distance is ``col - row - pos_offset``. Defaults to ``s_k - s_q``
        (bottom-right alignment). Ring/context parallelism passes the
        per-hop shard offset here so every position-dependent feature stays
        globally exact on sharded calls.
      dyn_pos_offset: the same alignment as a TRACED int32 scalar, for shard
        offsets that depend on the device under shard_map (zigzag ring
        hops). Mutually exclusive with pos_offset. Loop bounds follow it, so
        it may be combined with is_causal and window.
      need_lse: False (inference, the custom_vjp primal) drops the LSE
        output; None is returned in its place.

    Returns:
      (O [B, Hq, S_q, D] in q.dtype, LSE [B, Hq, S_q] fp32, natural log;
       rows with no visible keys get O = 0, LSE = -inf).
    """
    b, hq, s_q, d = q.shape
    _, hkv, s_k, dk = k.shape
    assert v.shape == k.shape, (v.shape, k.shape)
    assert dk == d, "q/k head_dim mismatch"
    assert hq % hkv == 0, f"Hq={hq} must be a multiple of Hkv={hkv}"
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
    bq, bkv = block_sizes.block_q, block_sizes.block_kv

    # Q carries scale·log2(e) so S = Q̃·Kᵀ lands in the log2 domain; with
    # soft-capping the tanh needs true logits, so only `scale` folds and the
    # kernel applies ·log2(e) after the cap.
    pre = scale if logit_softcap else scale * LOG2E
    q_p = pad_head_dim(pad_to_block((q * pre).astype(q.dtype), 2, bq))
    k_p = pad_head_dim(pad_to_block(k, 2, bkv))
    v_p = pad_head_dim(pad_to_block(v, 2, bkv))
    s_q_p, s_k_p, d_p = q_p.shape[2], k_p.shape[2], q_p.shape[3]

    def batch_of(i, bh):
        return bh // hq

    def head_of(i, bh):
        return bh % hq

    inputs, in_specs = scalar_operands(hq, dyn_pos_offset, dropout_rate,
                                       dropout_seed, alibi, alibi_slopes,
                                       head_of)
    inputs += [q_p, k_p, v_p]
    in_specs += [
        pl.BlockSpec((None, None, bq, d_p),
                     lambda i, bh: (batch_of(i, bh), head_of(i, bh), i, 0)),
        pl.BlockSpec((None, None, s_k_p, d_p),
                     lambda i, bh: (batch_of(i, bh),
                                    head_of(i, bh) // q_per_kv, 0, 0)),
        pl.BlockSpec((None, None, s_k_p, d_p),
                     lambda i, bh: (batch_of(i, bh),
                                    head_of(i, bh) // q_per_kv, 0, 0)),
    ]
    segmented = segment_ids is not None
    if segmented:
        inputs += pad_segments(segment_ids, b, s_q, s_k, s_q_p, s_k_p)
        in_specs += [
            pl.BlockSpec((None, bq), lambda i, bh: (batch_of(i, bh), i)),
            pl.BlockSpec((None, s_k_p), lambda i, bh: (batch_of(i, bh), 0)),
        ]
    out_shape = [jax.ShapeDtypeStruct((b, hq, s_q_p, d_p), q.dtype)]
    out_specs = [pl.BlockSpec(
        (None, None, bq, d_p),
        lambda i, bh: (batch_of(i, bh), head_of(i, bh), i, 0))]
    if need_lse:
        out_shape.append(jax.ShapeDtypeStruct((b, hq, s_q_p), jnp.float32))
        out_specs.append(pl.BlockSpec(
            (None, None, bq),
            lambda i, bh: (batch_of(i, bh), head_of(i, bh), i)))

    kernel = functools.partial(
        _fwd_kernel,
        hq=hq,
        block_q=bq,
        block_kv=bkv,
        num_kv_blocks=s_k_p // bkv,
        s_k=s_k,
        causal=is_causal,
        window=window,
        static_offset=(s_k - s_q) if pos_offset is None else int(pos_offset),
        has_dynoff=dyn_pos_offset is not None,
        dropout_rate=dropout_rate,
        alibi=alibi,
        segmented=segmented,
        softcap=float(logit_softcap or 0.0),
        need_lse=need_lse,
    )
    outs = pl.pallas_call(
        kernel,
        grid=(s_q_p // bq, b * hq),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=block_sizes.num_warps,
            num_stages=block_sizes.num_stages),
        interpret=interpret,
        debug=debug,
        name="flash_fwd",
    )(*inputs)
    o = outs[0][:, :, :s_q, :d]
    lse = outs[1][:, :, :s_q] if need_lse else None
    return o, lse
