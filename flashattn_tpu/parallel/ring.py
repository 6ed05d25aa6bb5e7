"""Ring flash attention — context parallelism over a mesh axis.

Sequence parallelism (SURVEY.md §2.3 T10, §5 "long-context").
The reference has no distributed code; what it DOES provide is the math
that makes this possible: the online-softmax (m, l, acc) update rule is
associative (reference ``Phase_0.md:123-188``, kernel
``_flash_attention_kernel_optimized.py:106-117``), so partial attention
results computed against disjoint key shards merge exactly with the same
correction algebra the kernel applies per tile. Ring attention is that
merge applied across devices instead of across kernel tiles.

Design (inside ``shard_map``; every array is the per-device shard):

  forward:  each device holds Q_i, K_i, V_i  ([B, H, S/n, D], contiguous
            partition). For n ring steps, the device attends its Q shard to
            the K/V shard it currently holds, merges (o, lse) partials into
            running (m, l, acc) stats, and rotates K/V one hop along the
            axis with ``lax.ppermute`` — the permute for step t+1 is issued
            BEFORE step t's compute so XLA can overlap the transfer with
            the kernel.
  causal:   at step t the device holds the shard originating from
            ``src = (idx - t) mod n``. step 0 is the diagonal (local causal
            kernel — statically known); step t>0 is either fully visible
            (src < idx, i.e. t <= idx) or fully masked (skip). The
            visible/skip choice is a runtime ``lax.cond`` on the device
            index — the cross-chip analogue of the reference's
            full-visible / partial / skip block taxonomy
            (``Phase_3.md:273-322``).
  backward: custom_vjp. dQ accumulates locally (every step contributes to
            the resident Q shard); dK/dV accumulators TRAVEL with the K/V
            shards so each contribution is computed where the (Q_i, K_src)
            pair is resident; after the loop one final hop returns them to
            their owners (n hops = identity). The per-step primitive is the
            two-kernel recompute backward called with the GLOBAL O/dO/LSE:
            P rebuilt as exp(S - LSE_global) is exactly the global softmax
            restricted to this shard's columns, and delta = rowsum(dO ⊙ O)
            is the global delta, so per-shard dQ/dK/dV partials are exact
            partial sums of the true gradients (math: ``Phase_4.md:97-158``).

Two causal layouts:
  - ``contiguous`` (default): device i holds global rows [i·S/n, (i+1)·S/n).
    Simple, but causally imbalanced — device 0 skips n-1 of n steps while
    device n-1 works every step.
  - ``zigzag`` (``zigzag_ring_flash_attention``): the sequence is split into
    2n chunks and device i holds chunks (i, 2n-1-i). At every ring step each
    device runs exactly TWO equal-size chunk attentions — (q_hi, k_lo) is
    always fully visible, and exactly one of (q_lo, k_lo)/(q_hi, k_hi) fires
    (the other is fully masked) — so causal work is perfectly balanced.
    Inputs must be in zigzag layout; ``zigzag_shard``/``zigzag_unshard``
    convert a global [.., S, ..] array to/from it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward

NEG_INF = float("-inf")


def _merge_partial(m, l, acc, o_p, lse_p):
    """Fold a normalized partial (o_p, lse_p) into running (m, l, acc).

    Same correction algebra as the kernel's inner loop (reference
    ``:106-117``), in natural-log units, -inf-safe (fully-masked partials
    carry lse_p = -inf and must be no-ops).
    """
    m_new = jnp.maximum(m, lse_p)
    m_safe = jnp.where(jnp.isneginf(m_new), 0.0, m_new)
    gamma = jnp.where(jnp.isneginf(m), 0.0, jnp.exp(m - m_safe))
    w_p = jnp.where(jnp.isneginf(lse_p), 0.0, jnp.exp(lse_p - m_safe))
    acc_new = acc * gamma[..., None] + o_p.astype(jnp.float32) * w_p[..., None]
    l_new = l * gamma + w_p
    return m_new, l_new, acc_new


def _ring_perm(n: int):
    return [(i, (i + 1) % n) for i in range(n)]


def _rotate(xs, axis_name: str, n: int, anchor=None):
    """Rotate xs one hop along the ring.

    `anchor` (any array from the PREVIOUS hop's compute, e.g. the running
    max) orders the permute-start AFTER that compute. Without it the hops'
    permutes form a pure chain (hop t+1's input is hop t's output) with no
    dependency on any kernel, and XLA's latency-hiding scheduler hoists the
    WHOLE chain to the top of the program, with no kernel in flight under
    the permutes. The anchoring must be a REAL data dependency:
    ``lax.optimization_barrier`` survives lowering but XLA's
    OptimizationBarrierExpander deletes it before the scheduling pass runs.
    (Whether the GPU scheduler overlaps NCCL permutes with the kernels
    under this anchor has not been measured.) So
    one element of each floating x takes a numerically-zero perturbation
    ``min(|anchor[0]|, 0)`` that the compiler cannot fold (it would need
    range analysis; -inf anchors map to 0 through |.|->min, and NaN
    anchors — where min would PROPAGATE the NaN into the permuted tile —
    are explicitly zeroed with an isnan select).
    The patch is a rank-preserving single-element dynamic_update_slice —
    compute reads the ORIGINAL refs and takes no new dependency, so the
    scheduler's only legal window for hop t+1's wire is under kernel t+1."""
    perm = _ring_perm(n)
    if anchor is not None:
        a0 = anchor.reshape(-1)[:1]  # (1,) from the previous hop's stats
        eps = jnp.where(jnp.isnan(a0), 0.0, jnp.minimum(jnp.abs(a0), 0.0))
        tied = []
        for x in xs:
            if jnp.issubdtype(x.dtype, jnp.floating):
                idx = (jnp.int32(0),) * x.ndim
                patch = (lax.dynamic_slice(x, idx, (1,) * x.ndim)
                         + eps.astype(x.dtype).reshape((1,) * x.ndim))
                x = lax.dynamic_update_slice(x, patch, idx)
            tied.append(x)
        xs = tied
    return [lax.ppermute(x, axis_name, perm) for x in xs]


def _fold_seed(seed, idx, step: int):
    """Per-(device, ring-step) dropout seed: decorrelates the counter-based
    mask across shards/hops while staying identical between the forward and
    backward call at the same (idx, step) — the fwd/bwd-consistency property
    the reference's Philox design needs (``Phase_6.md:54-114``), lifted to
    the ring."""
    return seed * jnp.int32(1000003) + idx * jnp.int32(7919) + jnp.int32(step)


def _ring_steps(n: int, is_causal: bool, window, s_local: int) -> int:
    """Number of ring hops that can contribute ANY visible (q, k) pair.

    A sliding window prunes whole hops statically: at hop t >= 1 the K shard
    is (t-1)·L+1 .. (t+1)·L-1 positions in the past, so it is visible iff
    (t-1)·L + 1 <= window - 1. The same pruning the kernels do per block
    (flash_fwd.kv_block_range), applied per ring hop.
    """
    if not (is_causal and window is not None):
        return n
    if window < 2:
        return 1
    return min(n, (window - 2) // s_local + 2)


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10, 11, 12, 13, 14)
)
def _ring_core(q, k, v, dropout_seed, alibi_slopes, segment_ids,
               axis_name, is_causal, scale, block_sizes, interpret,
               window, logit_softcap, alibi, dropout_rate):
    o, _ = _ring_forward(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                         axis_name, is_causal, scale, block_sizes, interpret,
                         window, logit_softcap, alibi, dropout_rate)
    return o


def ring_flash_attention(
    q,
    k,
    v,
    axis_name: str,
    is_causal: bool = False,
    scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    interpret: bool | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    alibi_slopes=None,
    segment_ids=None,
):
    """Context-parallel flash attention; call INSIDE shard_map.

    Args:
      q: [B, Hq, S/n, D] local query shard (sequence contiguously
         partitioned over `axis_name`); k, v: [B, Hkv, S/n, D] local shards.
      axis_name: mesh axis carrying the sequence shards.
      is_causal: global causal mask (chunk-aligned across the ring).
      window / logit_softcap / alibi / dropout: the same attention variants
        as the dense kernels, globally exact across shards — every hop calls
        the kernel with ``pos_offset = t·L`` (the static global q/k shard
        alignment), so the causal mask, the window's left edge, and the
        ALiBi distance all use true global positions. A window additionally
        prunes whole hops statically (the ring stops rotating once every
        remaining shard is entirely left of the window). window and alibi
        require is_causal (non-causal hop offsets are device-dependent).
      dropout_seed: int32 scalar (traced ok); folded per (device, hop).
      alibi_slopes: (Hq_local,) f32 table — REQUIRED under head sharding
        (shard the global table with the heads).
      segment_ids: (seg_q [B, S/n], seg_k [B, S/n]) local packed-sequence id
        shards; seg_k travels with its K/V shard around the ring.

    Returns:
      O [B, Hq, S/n, D] local output shard in q.dtype.
    """
    if alibi and alibi_slopes is None:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        alibi_slopes = default_alibi_slopes(q.shape[1])
    if alibi_slopes is not None:
        alibi_slopes = jax.lax.stop_gradient(alibi_slopes)
    if dropout_rate > 0.0:
        assert dropout_seed is not None, "dropout needs dropout_seed"
        dropout_seed = jnp.asarray(dropout_seed, jnp.int32)
    if segment_ids is not None:
        # Same padding canonicalization as flash_attention_varlen: q-side
        # pads -> -1, k-side pads -> -2, so padding never matches anything
        # (raw ids would let pad rows attend to pad keys).
        seg_q, seg_k = segment_ids
        segment_ids = (
            jnp.where(seg_q < 0, -1, seg_q).astype(jnp.int32),
            jnp.where(seg_k < 0, -2, seg_k).astype(jnp.int32),
        )
    return _ring_core(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                      axis_name, is_causal, scale, block_sizes, interpret,
                      window, logit_softcap, alibi, dropout_rate)


def _check_ring_features(is_causal, window, alibi):
    assert window is None or is_causal, "ring window requires is_causal"
    assert not alibi or is_causal, (
        "ring alibi requires is_causal (non-causal hop offsets are "
        "device-dependent; use zigzag/Ulysses or open an issue)")


def _ring_forward(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                  axis_name, is_causal, scale, block_sizes, interpret,
                  window, logit_softcap, alibi, dropout_rate):
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    b, hq, s_local, d = q.shape
    _check_ring_features(is_causal, window, alibi)

    if scale is None:
        scale = 1.0 / (d**0.5)
    seg_q = segment_ids[0] if segment_ids is not None else None

    def local_attn(k_in, v_in, causal, step, seg_k_in):
        return flash_attention_forward(
            q, k_in, v_in, is_causal=causal, scale=scale,
            block_sizes=block_sizes, interpret=interpret,
            window=window if causal else None,
            logit_softcap=logit_softcap, alibi=alibi,
            alibi_slopes=alibi_slopes,
            dropout_rate=dropout_rate,
            dropout_seed=(_fold_seed(dropout_seed, idx, step)
                          if dropout_rate > 0.0 else None),
            segment_ids=((seg_q, seg_k_in) if segment_ids is not None
                         else None),
            pos_offset=step * s_local if causal else None,
        )

    m = jnp.full((b, hq, s_local), NEG_INF, jnp.float32)
    l = jnp.zeros((b, hq, s_local), jnp.float32)
    acc = jnp.zeros((b, hq, s_local, d), jnp.float32)

    steps = _ring_steps(n, is_causal, window, s_local)
    k_cur, v_cur = k, v
    segk_cur = segment_ids[1] if segment_ids is not None else None
    for step in range(steps):
        if step < steps - 1:
            # Issue the next hop's permute before this step's compute so XLA
            # can overlap the transfer with the kernel; anchor on the
            # previous hop's PRE-merge kernel output (lse_p, not the merged
            # stats) so the permute chain cannot be hoisted wholesale ahead
            # of all compute (see _rotate) yet does not wait for the merge
            # fusion either.
            nxt = _rotate([x for x in (k_cur, v_cur, segk_cur)
                           if x is not None], axis_name, n,
                          anchor=lse_p if step > 0 else None)
        if not is_causal or step == 0:
            o_p, lse_p = local_attn(k_cur, v_cur, is_causal, step, segk_cur)
        else:
            # Visible iff the shard we hold originated upstream of us
            # (src = idx - step  =>  visible iff step <= idx). The local
            # call carries pos_offset = step·L: with a window it masks /
            # prunes the stale left edge exactly; without one it is the
            # fully-visible rectangle.
            def _visible(kv):
                return local_attn(kv[0], kv[1], True, step, kv[2])

            def _skip(kv):
                return (
                    jnp.zeros((b, hq, s_local, d), q.dtype),
                    jnp.full((b, hq, s_local), NEG_INF, jnp.float32),
                )

            o_p, lse_p = lax.cond(step <= idx, _visible, _skip,
                                  (k_cur, v_cur, segk_cur))
        m, l, acc = _merge_partial(m, l, acc, o_p, lse_p)
        if step < steps - 1:
            if segk_cur is not None:
                k_cur, v_cur, segk_cur = nxt
            else:
                k_cur, v_cur = nxt

    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).astype(q.dtype)
    lse = jnp.where(l == 0.0, NEG_INF, m + jnp.log(l_safe))
    return o, lse


def _ring_fwd(q, k, v, dropout_seed, alibi_slopes, segment_ids,
              axis_name, is_causal, scale, block_sizes, interpret,
              window, logit_softcap, alibi, dropout_rate):
    o, lse = _ring_forward(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                           axis_name, is_causal, scale, block_sizes,
                           interpret, window, logit_softcap, alibi,
                           dropout_rate)
    return o, (q, k, v, dropout_seed, alibi_slopes, segment_ids, o, lse)


def _ring_bwd(axis_name, is_causal, scale, block_sizes, interpret,
              window, logit_softcap, alibi, dropout_rate, residuals, do):
    q, k, v, dropout_seed, alibi_slopes, segment_ids, o, lse = residuals
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    b, hq, s_local, d = q.shape
    hkv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    seg_q = segment_ids[0] if segment_ids is not None else None

    def local_bwd(k_in, v_in, causal, step, seg_k_in):
        return flash_attention_backward(
            q, k_in, v_in, o, do, lse, is_causal=causal, scale=scale,
            block_sizes=block_sizes, interpret=interpret,
            window=window if causal else None,
            logit_softcap=logit_softcap, alibi=alibi,
            alibi_slopes=alibi_slopes,
            dropout_rate=dropout_rate,
            dropout_seed=(_fold_seed(dropout_seed, idx, step)
                          if dropout_rate > 0.0 else None),
            segment_ids=((seg_q, seg_k_in) if segment_ids is not None
                         else None),
            pos_offset=step * s_local if causal else None,
        )

    steps = _ring_steps(n, is_causal, window, s_local)
    dq_acc = jnp.zeros((b, hq, s_local, d), jnp.float32)
    dk_cur = jnp.zeros((b, hkv, s_local, d), jnp.float32)
    dv_cur = jnp.zeros((b, hkv, s_local, d), jnp.float32)
    k_cur, v_cur = k, v
    segk_cur = segment_ids[1] if segment_ids is not None else None

    for step in range(steps):
        if step < steps - 1:
            nxt = _rotate([x for x in (k_cur, v_cur, segk_cur)
                           if x is not None], axis_name, n,
                          anchor=dq_acc if step > 0 else None)
        if not is_causal or step == 0:
            dq_p, dk_p, dv_p = local_bwd(k_cur, v_cur, is_causal, step,
                                         segk_cur)
        else:
            def _visible(kv):
                return local_bwd(kv[0], kv[1], True, step, kv[2])

            def _skip(kv):
                return (
                    jnp.zeros((b, hq, s_local, d), q.dtype),
                    jnp.zeros((b, hkv, s_local, d), k.dtype),
                    jnp.zeros((b, hkv, s_local, d), v.dtype),
                )

            dq_p, dk_p, dv_p = lax.cond(step <= idx, _visible, _skip,
                                        (k_cur, v_cur, segk_cur))
        dq_acc = dq_acc + dq_p.astype(jnp.float32)
        dk_cur = dk_cur + dk_p.astype(jnp.float32)
        dv_cur = dv_cur + dv_p.astype(jnp.float32)
        # dK/dV accumulators travel WITH their K/V shard; the K/V rotation
        # below plus the final return permute complete the full cycle that
        # brings each accumulator home to the shard's owner.
        if step < steps - 1:
            if segk_cur is not None:
                k_cur, v_cur, segk_cur = nxt
            else:
                k_cur, v_cur = nxt
            dk_cur, dv_cur = _rotate([dk_cur, dv_cur], axis_name, n)

    # After (steps - 1) in-loop hops the accumulators are (steps - 1) hops
    # from home; one permute with the complementary shift returns them
    # (shift 1 when the ring ran full length — the classic final hop).
    shift = (n - (steps - 1)) % n or n
    perm = [(i, (i + shift) % n) for i in range(n)]
    dk_cur, dv_cur = (lax.ppermute(x, axis_name, perm)
                      for x in (dk_cur, dv_cur))
    zeros = None
    if segment_ids is not None:
        zeros = tuple(np.zeros(s.shape, dtype=jax.dtypes.float0)
                      for s in segment_ids)
    return (
        dq_acc.astype(q.dtype),
        dk_cur.astype(k.dtype),
        dv_cur.astype(v.dtype),
        (None if dropout_seed is None
         else np.zeros(jnp.shape(dropout_seed), dtype=jax.dtypes.float0)),
        None if alibi_slopes is None else jnp.zeros_like(alibi_slopes),
        zeros,
    )


_ring_core.defvjp(_ring_fwd, _ring_bwd)


# ---------------- zigzag (load-balanced causal) layout ----------------


def zigzag_permutation(s: int, n: int, inverse: bool = False):
    """Row permutation taking natural order -> zigzag-shardable order.

    The sequence is cut into 2n chunks; the permuted order concatenates
    (chunk_i, chunk_{2n-1-i}) for i in 0..n-1, so a plain contiguous
    shard_map split hands device i exactly its zigzag pair.
    """
    import numpy as np

    assert s % (2 * n) == 0, (s, n)
    c = s // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * n - 1 - i) * c, (2 * n - i) * c))
    perm = np.asarray(order, dtype=np.int32)
    if inverse:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(s, dtype=np.int32)
        return inv
    return perm


def zigzag_shard(x, n: int, axis: int = 2):
    """Reorder `axis` (global view) into zigzag order for an n-way ring."""
    return jnp.take(x, jnp.asarray(zigzag_permutation(x.shape[axis], n)),
                    axis=axis)


def zigzag_unshard(x, n: int, axis: int = 2):
    """Inverse of zigzag_shard."""
    return jnp.take(
        x, jnp.asarray(zigzag_permutation(x.shape[axis], n, inverse=True)),
        axis=axis)


def _halves(x):
    c = x.shape[2] // 2
    return x[:, :, :c], x[:, :, c:]


def _place(o_p, lse_p, half: str):
    """Embed a C-row partial into the 2C-row local frame; the untouched half
    carries lse = -inf so the (m, l, acc) merge ignores it exactly."""
    b, h, c, d = o_p.shape
    zo = jnp.zeros_like(o_p)
    zl = jnp.full(lse_p.shape, NEG_INF, lse_p.dtype)
    if half == "lo":
        return (jnp.concatenate([o_p, zo], axis=2),
                jnp.concatenate([lse_p, zl], axis=2))
    return (jnp.concatenate([zo, o_p], axis=2),
            jnp.concatenate([zl, lse_p], axis=2))


@functools.partial(
    jax.custom_vjp, nondiff_argnums=(6, 7, 8, 9, 10, 11, 12, 13)
)
def _zz_core(q, k, v, dropout_seed, alibi_slopes, segment_ids,
             axis_name, scale, block_sizes, interpret,
             window, logit_softcap, alibi, dropout_rate):
    o, _ = _zz_forward(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                       axis_name, scale, block_sizes, interpret,
                       window, logit_softcap, alibi, dropout_rate)
    return o


def zigzag_ring_flash_attention(
    q,
    k,
    v,
    axis_name: str,
    scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    interpret: bool | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    alibi_slopes=None,
    segment_ids=None,
):
    """Load-balanced CAUSAL ring attention; call INSIDE shard_map with
    zigzag-layout shards (see zigzag_shard). Non-causal needs no balancing —
    use ring_flash_attention for it.

    Variants: softcap / dropout / segments are position-free and pass
    straight through (per-sub-call seed folding keeps dropout fwd/bwd
    consistent and decorrelated). window / ALiBi need global positions;
    zigzag chunk offsets are DEVICE-dependent, so the always-visible
    (q_hi, k_lo) pair threads a TRACED alignment into the kernels
    (``dyn_pos_offset`` — scalar-prefetched, masks/biases computed in-kernel)
    while the diagonal pairs use static per-hop offsets like the contiguous
    ring. segment_ids must be in zigzag layout (zigzag_shard the global ids
    exactly like the tokens).
    """
    if alibi and alibi_slopes is None:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        alibi_slopes = default_alibi_slopes(q.shape[1])
    if alibi_slopes is not None:
        alibi_slopes = jax.lax.stop_gradient(alibi_slopes)
    if dropout_rate > 0.0:
        assert dropout_seed is not None, "dropout needs dropout_seed"
        dropout_seed = jnp.asarray(dropout_seed, jnp.int32)
    if segment_ids is not None:
        seg_q, seg_k = segment_ids
        segment_ids = (
            jnp.where(seg_q < 0, -1, seg_q).astype(jnp.int32),
            jnp.where(seg_k < 0, -2, seg_k).astype(jnp.int32),
        )
    return _zz_core(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                    axis_name, scale, block_sizes, interpret,
                    window, logit_softcap, alibi, dropout_rate)


def _zz_attn_args(window, logit_softcap, alibi, alibi_slopes, dropout_rate,
                  dropout_seed, idx, step, subid):
    """Common variant kwargs for one zigzag sub-call; subid (0=hi-lo, 1=lo-lo,
    2=hi-hi) decorrelates the dropout mask between the sub-calls of a hop."""
    kw = dict(logit_softcap=logit_softcap, alibi=alibi,
              alibi_slopes=alibi_slopes, dropout_rate=dropout_rate,
              window=window)
    if dropout_rate > 0.0:
        kw["dropout_seed"] = (_fold_seed(dropout_seed, idx, step)
                              + jnp.int32(subid) * jnp.int32(424243))
    return kw


def _zz_forward(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                axis_name, scale, block_sizes, interpret,
                window, logit_softcap, alibi, dropout_rate):
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    b, hq, s_local, d = q.shape
    assert s_local % 2 == 0
    c = s_local // 2
    if scale is None:
        scale = 1.0 / (d**0.5)
    segmented = segment_ids is not None
    sq_lo = sq_hi = None
    if segmented:
        sq_lo, sq_hi = segment_ids[0][:, :c], segment_ids[0][:, c:]

    def attn(qc, kc, vc, causal, step, subid, sq, sk,
             pos_off=None, dyn_off=None):
        kw = _zz_attn_args(window, logit_softcap, alibi, alibi_slopes,
                           dropout_rate, dropout_seed, idx, step, subid)
        return flash_attention_forward(
            qc, kc, vc, is_causal=causal, scale=scale,
            block_sizes=block_sizes, interpret=interpret,
            segment_ids=((sq, sk) if segmented else None),
            pos_offset=pos_off, dyn_pos_offset=dyn_off, **kw)

    q_lo, q_hi = _halves(q)
    m = jnp.full((b, hq, s_local), NEG_INF, jnp.float32)
    l = jnp.zeros((b, hq, s_local), jnp.float32)
    acc = jnp.zeros((b, hq, s_local, d), jnp.float32)

    k_cur, v_cur = k, v
    segk_cur = segment_ids[1] if segmented else None
    for step in range(n):
        if step < n - 1:
            nxt = _rotate([x for x in (k_cur, v_cur, segk_cur)
                           if x is not None], axis_name, n,
                          anchor=m if step > 0 else None)
        k_lo, k_hi = _halves(k_cur)
        v_lo, v_hi = _halves(v_cur)
        sk_lo = segk_cur[:, :c] if segmented else None
        sk_hi = segk_cur[:, c:] if segmented else None
        # Always-visible pair: q_hi (chunk 2n-1-idx) vs k_lo (chunk < n).
        # Its global alignment (2n-1-idx - src)·C is device-dependent —
        # traced into the kernel when a position feature needs it.
        if window is not None or alibi:
            src = jnp.mod(idx - step, n)
            dyn = ((2 * n - 1) - idx - src) * c
            o_p, lse_p = attn(q_hi, k_lo, v_lo, False, step, 0, sq_hi, sk_lo,
                              dyn_off=dyn)
        else:
            o_p, lse_p = attn(q_hi, k_lo, v_lo, False, step, 0, sq_hi, sk_lo)
        m, l, acc = _merge_partial(m, l, acc, *_place(o_p, lse_p, "hi"))
        if step == 0:
            for qc, kc, vc, half, subid, sq, sk in (
                    (q_lo, k_lo, v_lo, "lo", 1, sq_lo, sk_lo),
                    (q_hi, k_hi, v_hi, "hi", 2, sq_hi, sk_hi)):
                o_p, lse_p = attn(qc, kc, vc, True, step, subid, sq, sk)
                m, l, acc = _merge_partial(m, l, acc,
                                           *_place(o_p, lse_p, half))
        else:
            # Exactly one of the two remaining pairs is fully visible:
            # (q_lo, k_lo) iff step <= idx (static alignment step·C), else
            # (q_hi, k_hi) (static alignment (n-step)·C). Equal work either
            # way — the load-balancing property. The static offsets keep
            # window pruning/masking and ALiBi exact per branch.
            def _lo(kv):
                (kl, vl, skl), _ = kv
                return _place(*attn(q_lo, kl, vl, True, step, 1, sq_lo, skl,
                                    pos_off=step * c), "lo")

            def _hi(kv):
                _, (kh, vh, skh) = kv
                return _place(*attn(q_hi, kh, vh, True, step, 2, sq_hi, skh,
                                    pos_off=(n - step) * c), "hi")

            o_f, lse_f = lax.cond(step <= idx, _lo, _hi,
                                  ((k_lo, v_lo, sk_lo), (k_hi, v_hi, sk_hi)))
            m, l, acc = _merge_partial(m, l, acc, o_f, lse_f)
        if step < n - 1:
            if segmented:
                k_cur, v_cur, segk_cur = nxt
            else:
                k_cur, v_cur = nxt

    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = (acc / l_safe[..., None]).astype(q.dtype)
    lse = jnp.where(l == 0.0, NEG_INF, m + jnp.log(l_safe))
    return o, lse


def _zz_fwd(q, k, v, dropout_seed, alibi_slopes, segment_ids,
            axis_name, scale, block_sizes, interpret,
            window, logit_softcap, alibi, dropout_rate):
    o, lse = _zz_forward(q, k, v, dropout_seed, alibi_slopes, segment_ids,
                         axis_name, scale, block_sizes, interpret,
                         window, logit_softcap, alibi, dropout_rate)
    return o, (q, k, v, dropout_seed, alibi_slopes, segment_ids, o, lse)


def _zz_bwd(axis_name, scale, block_sizes, interpret,
            window, logit_softcap, alibi, dropout_rate, residuals, do):
    q, k, v, dropout_seed, alibi_slopes, segment_ids, o, lse = residuals
    n = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    b, hq, s_local, d = q.shape
    hkv = k.shape[1]
    c = s_local // 2
    if scale is None:
        scale = 1.0 / (d**0.5)
    segmented = segment_ids is not None
    sq_lo = sq_hi = None
    if segmented:
        sq_lo, sq_hi = segment_ids[0][:, :c], segment_ids[0][:, c:]

    q_lo, q_hi = _halves(q)
    o_lo, o_hi = _halves(o)
    do_lo, do_hi = _halves(do)
    lse_lo, lse_hi = lse[:, :, :c], lse[:, :, c:]

    def bwd(qc, oc, doc, lsec, kc, vc, causal, step, subid, sq, sk,
            pos_off=None, dyn_off=None):
        kw = _zz_attn_args(window, logit_softcap, alibi, alibi_slopes,
                           dropout_rate, dropout_seed, idx, step, subid)
        return flash_attention_backward(
            qc, kc, vc, oc, doc, lsec, is_causal=causal, scale=scale,
            block_sizes=block_sizes, interpret=interpret,
            segment_ids=((sq, sk) if segmented else None),
            pos_offset=pos_off, dyn_pos_offset=dyn_off, **kw)

    def cat(lo_x, hi_x):
        return jnp.concatenate([lo_x, hi_x], axis=2)

    def dkv(dk_p, dv_p):
        return jnp.concatenate([dk_p, dv_p], -1).astype(jnp.float32)

    zero2 = jnp.zeros((b, hkv, c, 2 * d), jnp.float32)
    dq_lo = jnp.zeros((b, hq, c, d), jnp.float32)
    dq_hi = jnp.zeros((b, hq, c, d), jnp.float32)
    dkv_cur = jnp.zeros((b, hkv, s_local, 2 * d), jnp.float32)  # [dK | dV]
    k_cur, v_cur = k, v
    segk_cur = segment_ids[1] if segmented else None

    for step in range(n):
        if step < n - 1:
            nxt = _rotate([x for x in (k_cur, v_cur, segk_cur)
                           if x is not None], axis_name, n,
                          anchor=dq_hi if step > 0 else None)
        k_lo, k_hi = _halves(k_cur)
        v_lo, v_hi = _halves(v_cur)
        sk_lo = segk_cur[:, :c] if segmented else None
        sk_hi = segk_cur[:, c:] if segmented else None

        if window is not None or alibi:
            src = jnp.mod(idx - step, n)
            dyn = ((2 * n - 1) - idx - src) * c
            dq_p, dk_p, dv_p = bwd(q_hi, o_hi, do_hi, lse_hi, k_lo, v_lo,
                                   False, step, 0, sq_hi, sk_lo, dyn_off=dyn)
        else:
            dq_p, dk_p, dv_p = bwd(q_hi, o_hi, do_hi, lse_hi, k_lo, v_lo,
                                   False, step, 0, sq_hi, sk_lo)
        dq_hi = dq_hi + dq_p.astype(jnp.float32)
        dkv_cur = dkv_cur + cat(dkv(dk_p, dv_p), zero2)

        if step == 0:
            dq_p, dk_p, dv_p = bwd(q_lo, o_lo, do_lo, lse_lo, k_lo, v_lo,
                                   True, step, 1, sq_lo, sk_lo)
            dq_lo = dq_lo + dq_p.astype(jnp.float32)
            dkv_cur = dkv_cur + cat(dkv(dk_p, dv_p), zero2)
            dq_p, dk_p, dv_p = bwd(q_hi, o_hi, do_hi, lse_hi, k_hi, v_hi,
                                   True, step, 2, sq_hi, sk_hi)
            dq_hi = dq_hi + dq_p.astype(jnp.float32)
            dkv_cur = dkv_cur + cat(zero2, dkv(dk_p, dv_p))
        else:
            def _lo(kv):
                (kl, vl, skl), _ = kv
                dq_p, dk_p, dv_p = bwd(q_lo, o_lo, do_lo, lse_lo, kl, vl,
                                       True, step, 1, sq_lo, skl,
                                       pos_off=step * c)
                return (
                    jnp.concatenate(
                        [dq_p.astype(jnp.float32),
                         jnp.zeros((b, hq, c, d), jnp.float32)], axis=2),
                    cat(dkv(dk_p, dv_p), zero2),
                )

            def _hi(kv):
                _, (kh, vh, skh) = kv
                dq_p, dk_p, dv_p = bwd(q_hi, o_hi, do_hi, lse_hi, kh, vh,
                                       True, step, 2, sq_hi, skh,
                                       pos_off=(n - step) * c)
                return (
                    jnp.concatenate(
                        [jnp.zeros((b, hq, c, d), jnp.float32),
                         dq_p.astype(jnp.float32)], axis=2),
                    cat(zero2, dkv(dk_p, dv_p)),
                )

            dq_f, dkv_f = lax.cond(step <= idx, _lo, _hi,
                                   ((k_lo, v_lo, sk_lo), (k_hi, v_hi, sk_hi)))
            dq_lo = dq_lo + dq_f[:, :, :c]
            dq_hi = dq_hi + dq_f[:, :, c:]
            dkv_cur = dkv_cur + dkv_f

        if step < n - 1:
            if segmented:
                k_cur, v_cur, segk_cur = nxt
            else:
                k_cur, v_cur = nxt
            (dkv_cur,) = _rotate([dkv_cur], axis_name, n)

    (dkv_cur,) = _rotate([dkv_cur], axis_name, n)
    dq = jnp.concatenate([dq_lo, dq_hi], axis=2).astype(q.dtype)
    dk = dkv_cur[..., :d].astype(k.dtype)
    dv = dkv_cur[..., d:].astype(v.dtype)
    zeros = None
    if segmented:
        zeros = tuple(np.zeros(s.shape, dtype=jax.dtypes.float0)
                      for s in segment_ids)
    return (
        dq, dk, dv,
        (None if dropout_seed is None
         else np.zeros(jnp.shape(dropout_seed), dtype=jax.dtypes.float0)),
        None if alibi_slopes is None else jnp.zeros_like(alibi_slopes),
        zeros,
    )


_zz_core.defvjp(_zz_fwd, _zz_bwd)
