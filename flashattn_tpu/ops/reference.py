"""Pure-jnp reference (oracle) attention.

Counterpart of the reference's naive attention + LSE oracle:
  - ``naive_attention``  (reference ``code/Performance_Comparison.py:130-144``)
  - LSE oracle via logsumexp (reference ``Phase_3.md:699-755``)

Everything else in the framework is numerics-gated against these functions,
mirroring the reference's oracle-alignment test discipline (SURVEY.md §4).
All math is done in float32 regardless of input dtype, so the oracle is a
stable high-precision reference for bf16 kernel outputs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# On the GPU a float32 product runs in TF32 (about three decimal digits)
# unless asked otherwise; the oracle asks.
_HIGHEST = jax.lax.Precision.HIGHEST


def reference_attention_with_lse(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    is_causal: bool = False,
    scale: float | None = None,
    segment_ids: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unfused attention oracle returning (O, LSE).

    Args:
      q: [B, Hq, S_q, D]
      k: [B, Hkv, S_k, D]   (Hkv must divide Hq — GQA/MQA broadcast)
      v: [B, Hkv, S_k, D]
      is_causal: apply causal mask aligned to the *end* of the key sequence
        (standard convention: query i attends keys j with j <= i + S_k - S_q).
      scale: softmax scale; defaults to 1/sqrt(D) as in the reference
        (``My_FlashAttention_optimized.py:54``).
      segment_ids: optional (seg_q [B, S_q], seg_k [B, S_k]) int32 packed-
        sequence ids; attention is restricted to seg_q[i] == seg_k[j]
        (varlen oracle, reference design ``Phase_6.md:118-178``).

    Returns:
      O:   [B, Hq, S_q, D] in q.dtype
      LSE: [B, Hq, S_q]    float32, natural-log units: logsumexp(S*scale)
    """
    b, hq, s_q, d = q.shape
    _, hkv, s_k, _ = k.shape
    if scale is None:
        scale = 1.0 / (d**0.5)

    out_dtype = q.dtype
    qf = q.astype(jnp.float32)
    kf = k.astype(jnp.float32)
    vf = v.astype(jnp.float32)
    if hkv != hq:
        assert hq % hkv == 0, f"Hq={hq} not divisible by Hkv={hkv}"
        rep = hq // hkv
        kf = jnp.repeat(kf, rep, axis=1)
        vf = jnp.repeat(vf, rep, axis=1)

    s = jnp.einsum("bhqd,bhkd->bhqk", qf, kf, precision=_HIGHEST) * scale
    if logit_softcap:
        s = logit_softcap * jnp.tanh(s / logit_softcap)
    if alibi:
        slopes = 2.0 ** (-8.0 * (jnp.arange(hq) + 1) / hq)  # [Hq]
        dist = (jnp.arange(s_k)[None, :] - jnp.arange(s_q)[:, None]
                - (s_k - s_q)).astype(jnp.float32)
        s = s + slopes[:, None, None] * dist[None]
    mask = None
    if is_causal:
        qi = jnp.arange(s_q)[:, None]
        kj = jnp.arange(s_k)[None, :]
        mask = kj <= qi + (s_k - s_q)
        if window is not None:
            mask = mask & (kj >= qi + (s_k - s_q) - window + 1)
    if segment_ids is not None:
        seg_q, seg_k = segment_ids
        seg_mask = (seg_q[:, :, None] == seg_k[:, None, :])[:, None]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        s = jnp.where(mask, s, -jnp.inf)

    m = jnp.max(s, axis=-1, keepdims=True)
    # Rows with zero visible keys (causal cross-attention with S_q > S_k) are
    # mathematically undefined; convention: O = 0, LSE = -inf.
    m_safe = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.exp(s - m_safe)
    l = jnp.sum(p, axis=-1, keepdims=True)
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o = jnp.einsum("bhqk,bhkd->bhqd", p / l_safe, vf, precision=_HIGHEST)
    lse = (m_safe + jnp.log(l))[..., 0]
    return o.astype(out_dtype), lse


def reference_attention(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    is_causal: bool = False,
    scale: float | None = None,
    segment_ids: tuple[jnp.ndarray, jnp.ndarray] | None = None,
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
) -> jnp.ndarray:
    """Unfused attention oracle (O only) — differentiable, used as the
    gradient oracle in alignment tests (reference's SDPA role,
    ``My_FlashAttention_optimized.py:172-212``)."""
    return reference_attention_with_lse(q, k, v, is_causal, scale,
                                        segment_ids, window, logit_softcap,
                                        alibi)[0]
