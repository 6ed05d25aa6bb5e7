"""Llama-style decoder built on the Pallas flash-attention kernels.

Design (SURVEY.md §2.3 T12 — the reference has no model layer):
  - pure-functional pytree params (no framework Module state), so the whole
    model jits/shards with pjit + NamedSharding and grads are plain jax.grad
  - attention runs the fused Pallas kernel; under a mesh it is wrapped in a
    shard_map island (batch over 'data', heads over 'model') while every
    matmul is left to GSPMD to partition from the param shardings
  - RoPE, RMSNorm, SwiGLU as fused-friendly jnp (XLA fuses elementwise into
    the surrounding matmuls)
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from flashattn_tpu.models.config import ModelConfig
from flashattn_tpu.ops.attention import flash_attention
from flashattn_tpu.ops.quant_matmul import (
    QuantizedLinear,
    quant_matmul,
    quantize_weights,
)

Params = dict[str, Any]

# Projection leaves eligible for weight-only quantization (T8): everything
# except embeddings (gather, not matmul) and norms.
_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def proj(x: jnp.ndarray, w, out_dtype=None) -> jnp.ndarray:
    """x @ w for plain arrays OR weight-only-quantized projections (the
    int8/int4 weights convert inside the product, so they cross memory
    at 1 or 1/2 byte — decode projections are weight-bandwidth-bound)."""
    if isinstance(w, QuantizedLinear):
        flat = x.reshape(-1, x.shape[-1])
        y = quant_matmul(flat, w, out_dtype=out_dtype)
        return y.reshape(*x.shape[:-1], w.out_features)
    return jnp.dot(x, w, preferred_element_type=out_dtype)


def qkv_proj(xn, layer, cfg, which: str):
    """Attention projection with the optional Qwen2-style additive bias."""
    y = proj(xn, layer["w" + which])
    if cfg.attn_bias:
        y = y + layer["b" + which]
    return y


def quantize_params(params: Params, bits: int = 8) -> Params:
    """Weight-only quantization of all projection matrices (embeddings and
    norms stay in the compute dtype). Works on any param pytree from
    init_params or convert.params_from_hf."""
    out = dict(params)
    if "lm_head" in params:
        out["lm_head"] = quantize_weights(params["lm_head"], bits)
    out["layers"] = [
        {k: (quantize_weights(v, bits) if k in _QUANT_KEYS else v)
         for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


# ---------------- init ----------------


def init_params(cfg: ModelConfig, key: jax.Array) -> Params:
    """Initialize a parameter pytree (truncated-normal-ish scaled init)."""
    h, hd = cfg.hidden_size, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads

    def dense(key, shape, scale):
        return (jax.random.normal(key, shape, jnp.float32) * scale).astype(cfg.dtype)

    keys = jax.random.split(key, 3 + cfg.num_layers)
    params: Params = {
        "embed": dense(keys[0], (cfg.vocab_size, h), h**-0.5),
        "final_norm": jnp.full((h,), 1.0 - cfg.norm_offset, cfg.dtype),
        "layers": [],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(keys[1], (h, cfg.vocab_size), h**-0.5)
    for i in range(cfg.num_layers):
        lk = jax.random.split(keys[3 + i], 7)
        layer = {
            "attn_norm": jnp.full((h,), 1.0 - cfg.norm_offset, cfg.dtype),
            "wq": dense(lk[0], (h, nq * hd), h**-0.5),
            "wk": dense(lk[1], (h, nkv * hd), h**-0.5),
            "wv": dense(lk[2], (h, nkv * hd), h**-0.5),
            "wo": dense(lk[3], (nq * hd, h), (nq * hd) ** -0.5),
            "mlp_norm": jnp.full((h,), 1.0 - cfg.norm_offset, cfg.dtype),
        }
        if cfg.attn_bias:
            layer.update(bq=jnp.zeros((nq * hd,), cfg.dtype),
                         bk=jnp.zeros((nkv * hd,), cfg.dtype),
                         bv=jnp.zeros((nkv * hd,), cfg.dtype))
        # Identity norm = (offset + w) == 1, so init w = 1 - offset.
        norm_one = jnp.full((h,), 1.0 - cfg.norm_offset, cfg.dtype)
        if cfg.use_post_norms:
            layer.update(post_attn_norm=norm_one, post_mlp_norm=norm_one)
        if cfg.qk_norm:
            hd_one = jnp.full((hd,), 1.0 - cfg.norm_offset, cfg.dtype)
            layer.update(q_norm=hd_one, k_norm=hd_one)
        if cfg.num_experts:
            from flashattn_tpu.parallel.moe import init_moe_params

            layer["moe"] = init_moe_params(
                lk[4], h, cfg.intermediate_size, cfg.num_experts,
                dtype=cfg.dtype)
            if cfg.moe_shared_intermediate:
                fs = cfg.moe_shared_intermediate
                sk = jax.random.split(lk[5], 4)
                layer["moe"]["shared"] = {
                    "w_gate": dense(sk[0], (h, fs), h**-0.5),
                    "w_up": dense(sk[1], (h, fs), h**-0.5),
                    "w_down": dense(sk[2], (fs, h), fs**-0.5),
                }
                layer["moe"]["shared_gate"] = dense(sk[3], (h, 1), h**-0.5)
        else:
            layer.update(
                w_gate=dense(lk[4], (h, cfg.intermediate_size), h**-0.5),
                w_up=dense(lk[5], (h, cfg.intermediate_size), h**-0.5),
                w_down=dense(
                    lk[6], (cfg.intermediate_size, h),
                    cfg.intermediate_size**-0.5),
            )
        params["layers"].append(layer)
    return params


def param_shardings(cfg: ModelConfig) -> Params:
    """PartitionSpecs for Megatron-style TP over the 'model' mesh axis:
    column-parallel QKV/gate/up, row-parallel O/down (GSPMD inserts the
    reduce-scatter/all-reduce), replicated norms, vocab-sharded embeddings."""
    layer = {
        "attn_norm": P(),
        "wq": P(None, "model"),
        "wk": P(None, "model"),
        "wv": P(None, "model"),
        "wo": P("model", None),
        "mlp_norm": P(),
    }
    if cfg.attn_bias:
        layer.update(bq=P("model"), bk=P("model"), bv=P("model"))
    if cfg.use_post_norms:
        layer.update(post_attn_norm=P(), post_mlp_norm=P())
    if cfg.qk_norm:
        layer.update(q_norm=P(), k_norm=P())
    if cfg.num_experts:
        # Experts shard over 'ep' at rest (matches the shard_map island).
        layer["moe"] = {
            "router": P(),
            "w_gate": P("ep"), "w_up": P("ep"), "w_down": P("ep"),
        }
        if cfg.moe_shared_intermediate:
            layer["moe"]["shared"] = {
                "w_gate": P(), "w_up": P(), "w_down": P()}
            layer["moe"]["shared_gate"] = P()
    else:
        layer.update(w_gate=P(None, "model"), w_up=P(None, "model"),
                     w_down=P("model", None))
    shardings: Params = {
        "embed": P("model", None),
        "final_norm": P(),
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        shardings["lm_head"] = P(None, "model")
    return shardings


# ---------------- building blocks ----------------


def rms_norm(x: jnp.ndarray, w: jnp.ndarray, eps: float,
             offset: float = 0.0) -> jnp.ndarray:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    normed = xf * jax.lax.rsqrt(var + eps)
    if offset:
        # Gemma convention: multiply by (offset + w) IN f32, then cast
        # (transformers Gemma2RMSNorm does the product in float).
        return ((offset + w.astype(jnp.float32)) * normed).astype(x.dtype)
    return normed.astype(x.dtype) * w


def layer_window(cfg: ModelConfig, layer_idx: int) -> int | None:
    """Per-layer sliding window: Gemma-2-style 'alternate' puts the window
    on even layers and full attention on odd ones (HF layer_types)."""
    if cfg.window_pattern is None:
        return cfg.attn_window
    assert cfg.window_pattern == "alternate", cfg.window_pattern
    return cfg.attn_window if layer_idx % 2 == 0 else None


def apply_qk_norm(q, k, layer, cfg):
    """Qwen3-style per-head RMSNorm over head_dim, pre-RoPE. q/k are
    [B, S, H, D] (pre-transpose) or [B, H, S, D] — last dim is D either way.
    """
    if not cfg.qk_norm:
        return q, k
    return (rms_norm(q, layer["q_norm"], cfg.norm_eps, cfg.norm_offset),
            rms_norm(k, layer["k_norm"], cfg.norm_eps, cfg.norm_offset))


def embed_tokens(params, tokens, cfg):
    x = jnp.take(params["embed"], tokens, axis=0)
    if cfg.scale_embeddings:
        # HF casts the sqrt(hidden) normalizer to the activation dtype
        # BEFORE multiplying — match it for bit-level parity.
        x = x * jnp.asarray(cfg.hidden_size**0.5, x.dtype)
    return x


def lm_logits(x, params, cfg):
    """Final norm -> head -> optional Gemma-style final logit soft-cap."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps, cfg.norm_offset)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = proj(x, head, out_dtype=jnp.float32)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = jnp.tanh(logits / cap) * cap
    return logits


def rope_tables(cfg: ModelConfig, positions: jnp.ndarray):
    """positions [.., S] -> (cos, sin) [.., S, head_dim/2] f32."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (-jnp.arange(0, half, dtype=jnp.float32) / half)
    if cfg.rope_longrope is not None:
        # Phi-3 longrope: per-dim inverse factors, the long set once the
        # call's max position passes the original context (matches
        # transformers' per-call switch — with a KV cache both stacks
        # rotate K at insert time with the then-active set).
        short_f, long_f, orig_max, attn_factor = cfg.rope_longrope
        short = freqs / jnp.asarray(short_f, jnp.float32)
        long = freqs / jnp.asarray(long_f, jnp.float32)
        freqs = jnp.where(jnp.max(positions) + 1 > orig_max, long, short)
        angles = positions[..., None].astype(jnp.float32) * freqs
        return (jnp.cos(angles) * attn_factor, jnp.sin(angles) * attn_factor)
    if cfg.rope_scaling is not None:
        # Llama-3.1 frequency remap: long wavelengths (past the original
        # training context / low_freq_factor) stretch by `factor`, short
        # ones stay, the band in between interpolates smoothly (matches
        # transformers' _compute_llama3_parameters).
        factor, low_f, high_f, orig_max = cfg.rope_scaling
        wavelen = 2.0 * jnp.pi / freqs
        smooth = (orig_max / wavelen - low_f) / (high_f - low_f)
        smooth = jnp.clip(smooth, 0.0, 1.0)
        freqs = (1.0 - smooth) * freqs / factor + smooth * freqs
    angles = positions[..., None].astype(jnp.float32) * freqs
    return jnp.cos(angles), jnp.sin(angles)


def apply_rope(x: jnp.ndarray, cos: jnp.ndarray, sin: jnp.ndarray) -> jnp.ndarray:
    """x [B, H, S, D]; cos/sin [B, S, D/2] or [S, D/2]. Rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos_b = cos[None, None]
        sin_b = sin[None, None]
    else:
        cos_b = cos[:, None]
        sin_b = sin[:, None]
    x1f, x2f = x1.astype(jnp.float32), x2.astype(jnp.float32)
    out = jnp.concatenate(
        [x1f * cos_b - x2f * sin_b, x2f * cos_b + x1f * sin_b], axis=-1
    )
    return out.astype(x.dtype)


def _attention(q, k, v, mesh, block_sizes=None, segment_ids=None,
               window=None, logit_softcap=None, alibi=False, scale=None):
    """Fused attention; shard_map island under a mesh: batch over 'data',
    heads over 'model', and — when the mesh carries an 'sp' axis — sequence
    over 'sp' with ring-attention K/V rotation (context parallelism, the
    pallas kernel itself is mesh-oblivious). segment_ids [B, S] enables
    packed-document training (within-segment causal attention, T7).

    Every variant composes with every mesh: window / softcap / ALiBi /
    segments ride the ring via static per-hop pos_offsets (parallel/ring.py)
    and shard over heads via the slope-table input; packed segments shard
    over batch and sequence like the tokens they label.
    """
    if mesh is None:
        if segment_ids is not None:
            from flashattn_tpu.ops.varlen import flash_attention_varlen

            return flash_attention_varlen(
                q, k, v, segment_ids=segment_ids, is_causal=True,
                block_sizes=block_sizes, window=window, scale=scale,
                logit_softcap=logit_softcap, alibi=alibi)
        return flash_attention(q, k, v, is_causal=True, scale=scale,
                               block_sizes=block_sizes, window=window,
                               logit_softcap=logit_softcap, alibi=alibi)
    da = "data" if "data" in mesh.axis_names else None
    ma = "model" if "model" in mesh.axis_names else None
    use_sp = "sp" in mesh.axis_names and mesh.shape["sp"] > 1
    # Slopes are a per-head table: build it GLOBALLY and shard it with the
    # heads, so each shard's kernel indexes its local slice — head-sharding-
    # correct by construction (the in-kernel head grid index is shard-local).
    slopes = None
    if alibi:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        slopes = default_alibi_slopes(q.shape[1])
    if use_sp:
        from flashattn_tpu.parallel.ring import ring_flash_attention

        inner = functools.partial(
            ring_flash_attention, axis_name="sp", is_causal=True,
            block_sizes=block_sizes, window=window, scale=scale,
            logit_softcap=logit_softcap, alibi=alibi,
        )
        spec = P(da, ma, "sp", None)
        sspec = P(da, "sp")
    else:
        inner = functools.partial(
            flash_attention, is_causal=True, block_sizes=block_sizes,
            window=window, logit_softcap=logit_softcap, alibi=alibi,
            scale=scale,
        )
        spec = P(da, ma, None, None)
        sspec = P(da, None)

    if segment_ids is not None and use_sp:
        seg = segment_ids.astype(jnp.int32)
        fn = (lambda q, k, v, sq, sk, sl=None: inner(
            q, k, v, segment_ids=(sq, sk), alibi_slopes=sl))
    elif segment_ids is not None:
        from flashattn_tpu.ops.varlen import flash_attention_varlen

        seg = segment_ids.astype(jnp.int32)
        fn = (lambda q, k, v, sq, sk, sl=None: flash_attention_varlen(
            q, k, v, segment_ids=(sq, sk), is_causal=True, scale=scale,
            block_sizes=block_sizes, window=window,
            logit_softcap=logit_softcap, alibi=alibi, alibi_slopes=sl))
    else:
        seg = None
        fn = (lambda q, k, v, sl=None: inner(q, k, v, alibi_slopes=sl))

    in_specs = [spec, spec, spec]
    args = [q, k, v]
    if seg is not None:
        in_specs += [sspec, sspec]
        args += [seg, seg]
    if slopes is not None:
        in_specs += [P(ma)]
        args += [slopes]
        wrapped = fn
    else:
        wrapped = lambda *a: fn(*a)
    return jax.shard_map(
        wrapped, mesh=mesh, in_specs=tuple(in_specs), out_specs=spec,
        check_vma=False,
    )(*args)


# ---------------- forward ----------------


def forward(
    params: Params,
    tokens: jnp.ndarray,  # [B, S] int32
    cfg: ModelConfig,
    mesh=None,
    block_sizes=None,
    segment_ids: jnp.ndarray | None = None,  # [B, S] packed-document ids
    remat: bool = False,
) -> jnp.ndarray:
    """Training/prefill forward -> logits [B, S, vocab] (f32).

    With segment_ids, rows are packed documents: attention stays within a
    segment (varlen kernels) and RoPE positions restart at each boundary.
    remat=True wraps each layer in jax.checkpoint (rematerialization):
    activations per layer shrink to the block boundary, trading one extra
    forward pass for O(layers) memory — what lets long-context 1B+
    training fit one device. remat="dots" keeps matmul outputs
    (dots_with_no_batch_dims_saveable): the backward skips recomputing the
    projections/MLP and only the cheap elementwise work replays — faster
    when the saved activations still fit device memory."""
    b, s = tokens.shape
    x = embed_tokens(params, tokens, cfg)  # [B, S, H]
    if segment_ids is not None:
        # Per-document positions: index since the segment's first token.
        pos = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        change = jnp.concatenate(
            [jnp.ones((b, 1), bool),
             segment_ids[:, 1:] != segment_ids[:, :-1]], axis=1)
        starts = jax.lax.cummax(jnp.where(change, pos, 0), axis=1)
        positions = pos - starts  # [B, S]
    else:
        positions = jnp.arange(s)
    cos, sin = rope_tables(cfg, positions)

    def layer_fn(x, layer, window):
        a = _attn_block(layer, x, cos, sin, cfg, mesh, block_sizes,
                        segment_ids, window=window, _default_window=False)
        if cfg.use_post_norms:
            a = rms_norm(a, layer["post_attn_norm"], cfg.norm_eps,
                         cfg.norm_offset)
        x = x + a
        m = _mlp_block(layer, x, cfg, mesh)
        if cfg.use_post_norms:
            m = rms_norm(m, layer["post_mlp_norm"], cfg.norm_eps,
                         cfg.norm_offset)
        return x + m

    if remat:
        # remat="dots": save matmul outputs (backward replays only cheap
        # elementwise work). remat="attn": selective activation
        # checkpointing — save ONLY the flash-attention residuals
        # (Q,K,V,O,LSE, tagged "flash_resid" in ops/attention.py), so the
        # backward skips re-running the attention kernel but recomputes
        # projections/MLP/norms; ~146 MB/layer at 1B B=8 S=2048 vs
        # "dots"' ~700 MB (sizes from the shapes).
        policy = (jax.checkpoint_policies.dots_with_no_batch_dims_saveable
                  if remat == "dots" else
                  jax.checkpoint_policies.save_only_these_names(
                      "flash_resid")
                  if remat == "attn" else None)
        layer_fn = jax.checkpoint(layer_fn, policy=policy,
                                  static_argnums=(2,))
    for i, layer in enumerate(params["layers"]):
        x = layer_fn(x, layer, layer_window(cfg, i))

    return lm_logits(x, params, cfg)


def _attn_block(layer, x, cos, sin, cfg, mesh, block_sizes,
                segment_ids=None, window=None, _default_window=True):
    b, s, h = x.shape
    if _default_window:
        window = cfg.attn_window
    xn = rms_norm(x, layer["attn_norm"], cfg.norm_eps, cfg.norm_offset)
    q = qkv_proj(xn, layer, cfg, "q").reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = qkv_proj(xn, layer, cfg, "k").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = qkv_proj(xn, layer, cfg, "v").reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_qk_norm(q, k, layer, cfg)
    # [B, H, S, D] layout for the kernel
    q = q.transpose(0, 2, 1, 3)
    k = k.transpose(0, 2, 1, 3)
    v = v.transpose(0, 2, 1, 3)
    if not cfg.use_alibi:  # ALiBi models carry position in the bias, not RoPE
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = _attention(q, k, v, mesh, block_sizes, segment_ids,
                   window, cfg.logit_softcap,
                   cfg.use_alibi, cfg.attn_scale)  # [B, H, S, D]
    o = o.transpose(0, 2, 1, 3).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return proj(o, layer["wo"])


def _mlp_block(layer, x, cfg, mesh=None):
    xn = rms_norm(x, layer["mlp_norm"], cfg.norm_eps, cfg.norm_offset)
    if "moe" in layer:  # Mixture-of-Experts FFN (cfg.num_experts > 0)
        from flashattn_tpu.parallel.moe import (
            moe_ffn, moe_ffn_a2a, moe_ffn_dense_reference)

        flat = xn.reshape(-1, xn.shape[-1])
        # The routed experts go through the (possibly sharded) dispatchers;
        # a Qwen2-MoE/DeepSeek-style shared expert is dense/replicated math
        # handled below, outside the shard_map island.
        moe_p = {k: layer["moe"][k]
                 for k in ("router", "w_gate", "w_up", "w_down")}
        if mesh is not None and "ep" in mesh.axis_names and (
                mesh.shape["ep"] > 1):
            specs = {"router": P(), "w_gate": P("ep"), "w_up": P("ep"),
                     "w_down": P("ep")}
            if cfg.moe_dispatch == "a2a" and (
                    flat.shape[0] % mesh.shape["ep"] == 0):
                # Tokens shard over ep; per-device FLOPs ∝ cf·k, not E.
                out = jax.shard_map(
                    functools.partial(
                        moe_ffn_a2a, axis_name="ep",
                        top_k=cfg.top_k_experts,
                        capacity_factor=cfg.moe_capacity_factor,
                        activation=cfg.mlp_activation,
                        norm_topk=cfg.moe_norm_topk),
                    mesh=mesh, in_specs=(P("ep"), specs), out_specs=P("ep"),
                    check_vma=False,
                )(flat, moe_p)
            else:
                out = jax.shard_map(
                    functools.partial(moe_ffn, axis_name="ep",
                                      top_k=cfg.top_k_experts,
                                      activation=cfg.mlp_activation,
                                      norm_topk=cfg.moe_norm_topk),
                    mesh=mesh, in_specs=(P(), specs), out_specs=P(),
                    check_vma=False,
                )(flat, moe_p)
        else:
            out = moe_ffn_dense_reference(flat, moe_p,
                                          top_k=cfg.top_k_experts,
                                          activation=cfg.mlp_activation,
                                          norm_topk=cfg.moe_norm_topk)
        if "shared" in layer["moe"]:
            # Always-on shared expert, scaled by a learned sigmoid gate
            # (Qwen2-MoE convention: final = routed + sig(gate(x))*shared(x)).
            sh = layer["moe"]["shared"]
            gf = jnp.dot(flat, sh["w_gate"]).astype(jnp.float32)
            actv = (jax.nn.gelu(gf, approximate=True)
                    if cfg.mlp_activation == "gelu_tanh"
                    else jax.nn.silu(gf))
            shared_y = jnp.dot(actv.astype(flat.dtype) * jnp.dot(
                flat, sh["w_up"]), sh["w_down"]).astype(jnp.float32)
            coef = jax.nn.sigmoid(jnp.dot(
                flat.astype(jnp.float32),
                layer["moe"]["shared_gate"].astype(jnp.float32)))  # [T, 1]
            out = (out.astype(jnp.float32) + coef * shared_y).astype(x.dtype)
        return out.reshape(xn.shape)
    gate = proj(xn, layer["w_gate"])
    up = proj(xn, layer["w_up"])
    gf = gate.astype(jnp.float32)
    act = (jax.nn.gelu(gf, approximate=True)
           if cfg.mlp_activation == "gelu_tanh" else jax.nn.silu(gf))
    return proj(act.astype(x.dtype) * up, layer["w_down"])


# ---------------- training ----------------


def loss_fn(params, tokens, cfg, mesh=None, block_sizes=None,
            segment_ids=None, remat=False) -> jnp.ndarray:
    """Next-token cross-entropy over tokens[:, :-1] -> tokens[:, 1:].

    With segment_ids (packed documents), predictions across document
    boundaries and padding (ids < 0) are masked out of the mean."""
    seg_in = segment_ids[:, :-1] if segment_ids is not None else None
    logits = forward(params, tokens[:, :-1], cfg, mesh, block_sizes, seg_in,
                     remat=remat)
    targets = tokens[:, 1:]
    logz = jax.scipy.special.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    nll = logz - gold
    if segment_ids is None:
        return jnp.mean(nll)
    valid = (segment_ids[:, :-1] == segment_ids[:, 1:]) & (
        segment_ids[:, :-1] >= 0)
    denom = jnp.maximum(jnp.sum(valid), 1)
    return jnp.sum(jnp.where(valid, nll, 0.0)) / denom


def sgd_train_step(params, tokens, cfg, lr=1e-3, mesh=None,
                   block_sizes=None, remat=False):
    """Minimal full training step (loss + grads + SGD update) used by the
    multi-chip dryrun; real runs plug optax in via train.py."""
    loss, grads = jax.value_and_grad(loss_fn)(
        params, tokens, cfg, mesh, block_sizes, None, remat)
    new_params = jax.tree_util.tree_map(
        lambda p, g: (p - lr * g.astype(jnp.float32).astype(p.dtype))
        if jnp.issubdtype(p.dtype, jnp.floating) else p,
        params, grads,
    )
    return loss, new_params


# ---------------- pipeline parallelism (GPipe over a 'pp' mesh axis) ----


def pipeline_forward(
    params: Params,
    tokens: jnp.ndarray,  # [B, S] int32, B divisible by num_microbatches
    cfg: ModelConfig,
    mesh,
    num_microbatches: int,
    pp_axis: str = "pp",
    block_sizes=None,
    remat: bool = False,
) -> jnp.ndarray:
    """Training forward with the LAYER STACK pipelined over `pp_axis`
    (SURVEY.md T10; parallel/pipeline.py). Embedding and head are cheap and
    run replicated outside the pipeline; each stage applies
    num_layers / n_pp transformer layers. Returns logits [B, S, vocab].

    Params must be the STAGE-STACKED tree from `stack_pipeline_params`
    (leaves carry a leading pp axis, shard with P('pp', ...))."""
    from flashattn_tpu.parallel.pipeline import pipeline_apply, unstack_stage_params

    b, s = tokens.shape
    assert b % num_microbatches == 0, (b, num_microbatches)
    assert cfg.window_pattern is None, (
        "per-layer window patterns need global layer indices; the pipeline "
        "stage_fn only sees stage-local ones — not wired")
    mb = b // num_microbatches
    x = embed_tokens(params, tokens, cfg)  # [B, S, H]
    cos, sin = rope_tables(cfg, jnp.arange(s))

    def stage_fn(stage_layers, x_mb):
        # stage_layers: stacked [K, ...] leaves for this stage's K layers.
        n_local = jax.tree_util.tree_leaves(stage_layers)[0].shape[0]
        for i in range(n_local):
            layer = jax.tree_util.tree_map(lambda l: l[i], stage_layers)
            a = _attn_block(layer, x_mb, cos, sin, cfg, None, block_sizes)
            if cfg.use_post_norms:
                a = rms_norm(a, layer["post_attn_norm"], cfg.norm_eps,
                             cfg.norm_offset)
            x_mb = x_mb + a
            m = _mlp_block(layer, x_mb, cfg)
            if cfg.use_post_norms:
                m = rms_norm(m, layer["post_mlp_norm"], cfg.norm_eps,
                             cfg.norm_offset)
            x_mb = x_mb + m
        return x_mb

    def body(stage_stacked, x_mbs):
        stage = unstack_stage_params(stage_stacked)
        return pipeline_apply(stage_fn, stage, x_mbs, pp_axis, remat=remat)

    from jax.sharding import PartitionSpec as P

    x_mbs = x.reshape(num_microbatches, mb, s, -1)
    data_axis = "data" if "data" in mesh.axis_names else None
    x_spec = P(None, data_axis, None, None)
    stage_spec = jax.tree_util.tree_map(
        lambda _: P(pp_axis), params["stages"])
    y = jax.shard_map(
        body, mesh=mesh,
        in_specs=(stage_spec, x_spec), out_specs=x_spec,
        check_vma=False,
    )(params["stages"], x_mbs)
    x = y.reshape(b, s, -1)
    return lm_logits(x, params, cfg)


def stack_pipeline_params(params: Params, n_stages: int) -> Params:
    """Regroup a plain param tree for the pipeline: cfg.num_layers layers
    split into n_stages equal stages, each stage's layers stacked on a
    leading per-stage axis, stages stacked on a leading 'pp' axis
    ('stages' leaves: [n_stages, layers_per_stage, ...])."""
    from flashattn_tpu.parallel.pipeline import stack_stage_params

    layers = params["layers"]
    assert len(layers) % n_stages == 0, (len(layers), n_stages)
    k = len(layers) // n_stages
    stages = []
    for st in range(n_stages):
        group = layers[st * k:(st + 1) * k]
        stages.append(jax.tree_util.tree_map(
            lambda *ls: jnp.stack(ls), *group))
    out = {kk: v for kk, v in params.items() if kk != "layers"}
    out["stages"] = stack_stage_params(stages)
    return out


def pipeline_loss_fn(params, tokens, cfg, mesh, num_microbatches,
                     block_sizes=None, remat=False):
    logits = pipeline_forward(params, tokens[:, :-1], cfg, mesh,
                              num_microbatches, block_sizes=block_sizes,
                              remat=remat)
    targets = tokens[:, 1:]
    logz = jax.scipy.special.logsumexp(logits, axis=-1)
    gold = jnp.take_along_axis(logits, targets[..., None], axis=-1)[..., 0]
    return jnp.mean(logz - gold)
