"""Model configs for the Llama-style decoder stack (SURVEY.md §2.3 T12).

The reference has no model layer; these configs host the kernels end-to-end
for training and decode benchmarks (BASELINE.json configs 4-5: Llama-style
1B single-chip decode, 8B multi-host decode)."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: int = 64
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: jnp.dtype = jnp.bfloat16
    tie_embeddings: bool = False
    max_seq_len: int = 4096
    # Sliding-window attention (Mistral-style); None = full causal.
    attn_window: int | None = None
    # Mixture-of-Experts FFN (Mixtral-style); 0 = dense MLP.
    num_experts: int = 0
    top_k_experts: int = 2
    # Expert-parallel dispatch: "a2a" = GShard all_to_all capacity dispatch
    # (per-device FLOPs ∝ cf·k instead of E; over-capacity tokens dropped),
    # "dense" = masked-dense (exact, E/k more compute). parallel/moe.py.
    moe_dispatch: str = "a2a"
    moe_capacity_factor: float = 2.0
    # Renormalize the top-k router gates (Mixtral convention). Qwen3-MoE
    # checkpoints with norm_topk_prob=False keep full-softmax probabilities.
    moe_norm_topk: bool = True
    # Qwen2-MoE/DeepSeek-style always-on shared expert (0 = none): a dense
    # SwiGLU of this intermediate size added to the routed output, scaled by
    # a learned sigmoid gate.
    moe_shared_intermediate: int = 0
    # Gemma-style attention logit soft-capping; None = off.
    logit_softcap: float | None = None
    # ALiBi position bias (BLOOM/MPT-style) — disables RoPE when True.
    use_alibi: bool = False
    # StreamingLLM attention sinks: first N tokens stay visible alongside
    # the sliding window. DECODE-ONLY (requires attn_window; training uses
    # the plain window — sinks are an inference-time stabilizer).
    attn_sink: int = 0
    # Qwen2-style additive biases on the q/k/v projections.
    attn_bias: bool = False
    # Gemma-2-style architecture knobs (all default to Llama conventions):
    # per-layer window pattern: None = attn_window on every layer;
    # "alternate" = even layers sliding, odd layers full (HF layer_types).
    window_pattern: str | None = None
    # cap*tanh(logits/cap) on the FINAL lm-head logits.
    final_logit_softcap: float | None = None
    mlp_activation: str = "silu"  # or "gelu_tanh" (Gemma GeGLU)
    # Sandwich norms: extra RMSNorm on each block's OUTPUT before the
    # residual add (post_attention / post_feedforward layernorms).
    use_post_norms: bool = False
    scale_embeddings: bool = False  # x *= sqrt(hidden) after embedding
    # Softmax scale override (Gemma-2 query_pre_attn_scalar**-0.5);
    # None = 1/sqrt(head_dim).
    attn_scale: float | None = None
    # RMSNorm multiplies (norm_offset + w): Gemma stores zero-centered
    # weights (offset 1.0), Llama stores the weight directly (offset 0).
    norm_offset: float = 0.0
    # Qwen3-style per-head RMSNorm on q and k (over head_dim, pre-RoPE).
    qk_norm: bool = False
    # Llama-3.1-style RoPE frequency scaling:
    # (factor, low_freq_factor, high_freq_factor, original_max_position).
    # None = plain RoPE. Wavelengths above original/low stretch by `factor`,
    # below original/high stay put, in between interpolate smoothly.
    rope_scaling: tuple[float, float, float, int] | None = None
    # Phi-3-style longrope scaling:
    # (short_factors tuple[D/2], long_factors tuple[D/2],
    #  original_max_position, attention_factor). Per-call the factor set is
    # chosen by max position (long once past the original context) — the
    # same insert-time switching transformers applies with a KV cache —
    # and cos/sin are scaled by attention_factor.
    rope_longrope: tuple | None = None

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


# TinyLlama-1.1B-like geometry (BASELINE config 4: "Llama-style 1B").
LLAMA_1B = ModelConfig()

# ~150M draft model for speculative decoding against LLAMA_1B (same
# vocab/tokenizer family, ~7x fewer FLOPs/token): the draft:target cost
# ratio that makes Leviathan speculation pay on-device is measured by
# benchmarks/speculate_bench.py.
LLAMA_150M = ModelConfig(
    hidden_size=1024,
    intermediate_size=2816,
    num_layers=8,
    num_heads=16,
    num_kv_heads=4,
    head_dim=64,
)

# Mistral-7B geometry: GQA + 4096-token sliding-window attention.
MISTRAL_7B = ModelConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=10000.0,
    max_seq_len=8192,
    attn_window=4096,
)

# Llama-3-8B geometry (BASELINE config 5: 8B decode).
LLAMA_8B = ModelConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=500000.0,
    max_seq_len=8192,
)

# Llama-3.1-8B: same geometry, llama3 RoPE scaling unlocks 128k context.
LLAMA31_8B = dataclasses.replace(
    LLAMA_8B,
    rope_scaling=(8.0, 1.0, 4.0, 8192),
    max_seq_len=131072,
)

# Gemma-2-9B geometry: alternating 4096-token local / global attention,
# sandwich norms, GeGLU, attn+final soft-caps, scaled tied embeddings.
GEMMA2_9B = ModelConfig(
    vocab_size=256128,
    hidden_size=3584,
    intermediate_size=14336,
    num_layers=42,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    rope_theta=10000.0,
    norm_eps=1e-6,
    max_seq_len=8192,
    tie_embeddings=True,
    attn_window=4096,
    window_pattern="alternate",
    logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="gelu_tanh",
    use_post_norms=True,
    scale_embeddings=True,
    attn_scale=256**-0.5,  # query_pre_attn_scalar = head_dim
    norm_offset=1.0,
)

# Qwen3-8B geometry: per-head q/k RMSNorm, explicit head_dim.
QWEN3_8B = ModelConfig(
    vocab_size=151936,
    hidden_size=4096,
    intermediate_size=12288,
    num_layers=36,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    max_seq_len=32768,
    qk_norm=True,
)

# Tiny config for tests / dryruns (heads divisible by small mesh axes).
TINY = ModelConfig(
    vocab_size=512,
    hidden_size=256,
    intermediate_size=512,
    num_layers=2,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    max_seq_len=512,
)


# Tiny Mixtral-style MoE config for tests / dryruns.
TINY_MOE = ModelConfig(
    vocab_size=256,
    hidden_size=128,
    intermediate_size=256,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    max_seq_len=256,
    num_experts=4,
    top_k_experts=2,
    # Generous capacity so the a2a dispatch is drop-free at test sizes and
    # matches the dense oracle exactly.
    moe_capacity_factor=8.0,
)
