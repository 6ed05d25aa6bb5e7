"""Mesh construction + shard_map conveniences for the parallel attention ops.

The reference has no mesh/comms layer (SURVEY.md §5); these helpers are the
entry points: build a named `jax.sharding.Mesh` over the local
devices and wrap the ring/Ulysses collectives in shard_map with the
canonical (data, model, sp) PartitionSpecs.
"""

from __future__ import annotations

import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.parallel.ring import (
    ring_flash_attention,
    zigzag_ring_flash_attention,
    zigzag_shard,
    zigzag_unshard,
)
from flashattn_tpu.parallel.ulysses import ulysses_flash_attention


def make_mesh(axes: Mapping[str, int], devices=None) -> Mesh:
    """Build a Mesh from {axis_name: size}; sizes must multiply to the
    device count used. Axis order = dict order (put host-crossing axes
    first on multi-host so inner axes stay on one host's NVLink)."""
    if devices is None:
        devices = jax.devices()
    n = int(np.prod(list(axes.values())))
    assert len(devices) >= n, f"need {n} devices, have {len(devices)}"
    grid = np.array(devices[:n]).reshape(tuple(axes.values()))
    return Mesh(grid, tuple(axes.keys()))


def sharded_ring_attention(
    q,
    k,
    v,
    mesh: Mesh,
    is_causal: bool = False,
    scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    interpret: bool | None = None,
    *,
    seq_axis: str = "sp",
    batch_axis: str | None = "data",
    head_axis: str | None = "model",
    mode: str = "ring",
    window: int | None = None,
    logit_softcap: float | None = None,
    alibi: bool = False,
    dropout_rate: float = 0.0,
    dropout_seed=None,
    segment_ids=None,
):
    """Global-view [B, H, S, D] attention sharded over `mesh`.

    Batch over `batch_axis`, heads over `head_axis`, sequence over
    `seq_axis` with ring (default), zigzag (load-balanced causal ring), or
    Ulysses collectives inside a shard_map island. Axes absent from the
    mesh are ignored. Zigzag mode handles the layout permutation here
    (global view — tokens AND segment ids), so callers always pass natural
    sequence order. Attention variants (window / softcap / ALiBi / dropout /
    packed segments) ride all modes; the ALiBi slope table is built globally
    and sharded with the heads.
    """
    assert seq_axis in mesh.axis_names, (seq_axis, mesh.axis_names)
    n_sp = mesh.shape[seq_axis]
    slopes = None
    if alibi:
        from flashattn_tpu.ops.flash_fwd import default_alibi_slopes

        slopes = default_alibi_slopes(q.shape[1])
    variant_kw = dict(window=window, logit_softcap=logit_softcap,
                      alibi=alibi, dropout_rate=dropout_rate,
                      dropout_seed=dropout_seed)
    if mode == "zigzag":
        assert is_causal, "zigzag layout only matters for causal attention"
        inner = functools.partial(
            zigzag_ring_flash_attention, axis_name=seq_axis, scale=scale,
            block_sizes=block_sizes, interpret=interpret, **variant_kw,
        )
    elif mode == "ulysses":
        inner = functools.partial(
            ulysses_flash_attention, axis_name=seq_axis, is_causal=is_causal,
            scale=scale, block_sizes=block_sizes, interpret=interpret,
            **variant_kw,
        )
    else:
        inner = functools.partial(
            ring_flash_attention, axis_name=seq_axis, is_causal=is_causal,
            scale=scale, block_sizes=block_sizes, interpret=interpret,
            **variant_kw,
        )
    ba = batch_axis if batch_axis in mesh.axis_names else None
    ha = head_axis if head_axis in mesh.axis_names else None
    spec = P(ba, ha, seq_axis, None)
    in_specs = [spec, spec, spec]
    args = [q, k, v]
    call = inner
    if segment_ids is not None:
        seg = segment_ids.astype(jnp.int32)
        if mode == "zigzag":
            seg = zigzag_shard(seg, n_sp, axis=1)
        sspec = P(ba, seq_axis)
        in_specs += [sspec, sspec]
        args += [seg, seg]
        if slopes is not None:
            in_specs += [P(ha)]
            args += [slopes]
            call = (lambda q, k, v, sq, sk, sl: inner(
                q, k, v, segment_ids=(sq, sk), alibi_slopes=sl))
        else:
            call = (lambda q, k, v, sq, sk: inner(
                q, k, v, segment_ids=(sq, sk)))
    elif slopes is not None:
        in_specs += [P(ha)]
        args += [slopes]
        call = lambda q, k, v, sl: inner(q, k, v, alibi_slopes=sl)
    fn = jax.shard_map(
        call, mesh=mesh, in_specs=tuple(in_specs), out_specs=spec,
        check_vma=False,
    )
    if mode == "zigzag":
        args[0], args[1], args[2] = (zigzag_shard(x, n_sp)
                                     for x in (q, k, v))
        return zigzag_unshard(fn(*args), n_sp)
    return fn(*args)
