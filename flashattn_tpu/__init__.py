"""flashattn_tpu — a flash-attention framework in JAX for NVIDIA GPUs.

A from-scratch JAX/Pallas re-design of the capability surface of
``Pearbiossom-M/FlashAttention-from-Scratch-with-Triton``: fused
flash-attention forward with online softmax + LSE, two-kernel recompute
backward with delta reuse (Pallas kernels through Triton), autograd
(custom_vjp) integration, numerical verification, and a TFLOPS benchmark
harness — extended with decode over quantized and paged KV caches,
weight-only quantized matmuls, variable-length batching, a Llama-style model
layer, and mesh parallelism (TP / ring / Ulysses / pipeline / experts).

Public API mirrors the reference's single entry point
(``code/My_FlashAttention_optimized.py:169-170``):

    >>> from flashattn_tpu import flash_attention
    >>> O = flash_attention(Q, K, V, is_causal=True)   # differentiable
"""

from flashattn_tpu.ops.attention import (
    flash_attention,
    flash_attention_forward,
    flash_attention_backward,
)
from flashattn_tpu.ops.decode import decode_attention, decode_attention_chunk
from flashattn_tpu.ops.kvcache import KVCache, init_cache, update_cache
from flashattn_tpu.ops.paged import (
    PagedKVCache,
    PageAllocator,
    append_paged,
    init_paged_cache,
    paged_decode_attention,
    paged_decode_attention_chunk,
    pages_to_dense,
    set_block_table,
    write_pages,
    write_slot_paged,
)
from flashattn_tpu.ops.flash_fwd import default_alibi_slopes
from flashattn_tpu.ops.quant_matmul import quant_matmul, quantize_weights
from flashattn_tpu.ops.reference import reference_attention, reference_attention_with_lse
from flashattn_tpu.ops.varlen import (
    flash_attention_varlen,
    segment_ids_from_cu_seqlens,
)
from flashattn_tpu.utils.verify import verify_results

__version__ = "0.1.0"

__all__ = [
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_backward",
    "flash_attention_varlen",
    "segment_ids_from_cu_seqlens",
    "decode_attention",
    "decode_attention_chunk",
    "KVCache",
    "init_cache",
    "update_cache",
    "PagedKVCache",
    "PageAllocator",
    "init_paged_cache",
    "append_paged",
    "set_block_table",
    "paged_decode_attention",
    "paged_decode_attention_chunk",
    "pages_to_dense",
    "write_pages",
    "write_slot_paged",
    "default_alibi_slopes",
    "quant_matmul",
    "quantize_weights",
    "reference_attention",
    "reference_attention_with_lse",
    "verify_results",
]
