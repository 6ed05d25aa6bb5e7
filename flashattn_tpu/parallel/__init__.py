"""Mesh parallelism for the flash-attention kernels (SURVEY.md §2.3 T9/T10).

The reference is single-GPU with no distributed code of any kind (SURVEY.md
§0); everything here is scale-out built on jax.sharding meshes and XLA
collectives (NCCL on GPUs):

  - ``ring_flash_attention`` — context/sequence parallelism: K/V shards
    rotate around the mesh axis via ``lax.ppermute`` while each device's
    Q shard accumulates online-softmax partials; the cross-device merge is
    the same associative (m, l, acc) correction algebra as the kernel's
    inner loop (reference ``Phase_0.md:123-188``).
  - ``ulysses_flash_attention`` — alternative SP mode: ``lax.all_to_all``
    re-shards sequence->heads so each device runs full-sequence attention
    on a head slice, then re-shards back.
  - ``make_mesh`` / ``sharded_ring_attention`` — mesh + shard_map helpers.
"""

from flashattn_tpu.parallel.mesh import make_mesh, sharded_ring_attention
from flashattn_tpu.parallel.ring import (
    ring_flash_attention,
    zigzag_ring_flash_attention,
    zigzag_shard,
    zigzag_unshard,
)
from flashattn_tpu.parallel.moe import (
    init_moe_params,
    moe_ffn,
    moe_ffn_dense_reference,
)
from flashattn_tpu.parallel.pipeline import (
    pipeline_apply,
    stack_stage_params,
)
from flashattn_tpu.parallel.ulysses import ulysses_flash_attention

__all__ = [
    "ring_flash_attention",
    "zigzag_ring_flash_attention",
    "zigzag_shard",
    "zigzag_unshard",
    "ulysses_flash_attention",
    "pipeline_apply",
    "stack_stage_params",
    "init_moe_params",
    "moe_ffn",
    "moe_ffn_dense_reference",
    "make_mesh",
    "sharded_ring_attention",
]
