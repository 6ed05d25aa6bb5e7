"""Shared helpers for the Pallas attention kernels."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

# Large-negative logit used for masking instead of -inf so that
# (masked - m) subtraction never produces NaN.
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def interpret_default() -> bool:
    """Whether Pallas kernels run in the interpreter on this backend.

    The CPU backend (the test suite) interprets; the GPU backend compiles
    every kernel through Triton. Any other backend is an error: there is no
    silent fallback to the interpreter on an accelerator.
    """
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise RuntimeError(
        f"flashattn_tpu kernels run on 'gpu' (compiled) or 'cpu' "
        f"(interpreted); got backend {backend!r}")


def resolve_interpret(interpret: bool | None) -> bool:
    """`interpret` as a launcher received it -> the mode to run in."""
    if interpret is None:
        return interpret_default()
    if interpret and jax.default_backend() != "cpu":
        raise ValueError("interpret=True is only supported on the CPU backend")
    return interpret


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes and launch parameters of the Triton attention kernels —
    the reference's autotune config space (BLOCK_M/BLOCK_N, num_warps,
    num_stages at _flash_attention_kernel_optimized.py:18-32). Every block
    is a power of two >= 16 (Triton tiles; `pl.dot` operands need 16)."""

    # Defaults: the autotune winners on an H100 at the LLAMA_1B attention
    # shape (D=64) and the bench shape (D=128); PERF.md, "Kernel choices".
    block_q: int = 128
    block_kv: int = 128
    # Backward tiles, tuned separately (Phase_5.md:160-162): dQ streams K/V
    # blocks past one q tile, dK/dV streams q blocks past one kv tile.
    block_q_dq: int = 64
    block_kv_dq: int = 128
    block_q_dkv: int = 64
    block_kv_dkv: int = 64
    num_warps: int = 4
    # 3 stages won the D=128 sweep but, at 128x128 tiles, needs more than
    # the 227 KB of shared memory a block may use once dropout is on; 2 is
    # safe for every variant, and autotune tries 3 per shape.
    num_stages: int = 2

    def clamp(self, s_q: int, s_k: int) -> "BlockSizes":
        """Shrink tiles to the problem size (kept powers of two >= 16)."""

        def fit(b: int, s: int) -> int:
            return max(16, min(next_pow2(b), next_pow2(s)))

        return dataclasses.replace(
            self,
            block_q=fit(self.block_q, s_q),
            block_kv=fit(self.block_kv, s_k),
            block_q_dq=fit(self.block_q_dq, s_q),
            block_kv_dq=fit(self.block_kv_dq, s_k),
            block_q_dkv=fit(self.block_q_dkv, s_q),
            block_kv_dkv=fit(self.block_kv_dkv, s_k),
        )


def dropout_keep_mask(seed, bh, row_ids, col_ids, rate: float):
    """Counter-based dropout keep-mask, shared by fwd and both bwd kernels.

    Realization of the reference's deferred Philox design
    (``Phase_6.md:54-114``): the mask is a pure function of
    (seed, batch·head, GLOBAL row, GLOBAL col), so forward and backward
    regenerate bit-identical masks without storing them — and because the
    hash keys on global coordinates (not block indices), the backward may
    even use different tile sizes than the forward.

    Args:
      seed: int32 scalar (traced).
      bh: int32 scalar — flattened batch*H + q-head index.
      row_ids: (bq, 1) int32 global query positions.
      col_ids: (1, bkv) int32 global key positions.
      rate: static drop probability in [0, 1).

    Returns:
      (bq, bkv) bool — True = keep.
    """
    u32 = jnp.uint32
    x = row_ids.astype(u32) * np.uint32(0x9E3779B1)
    y = col_ids.astype(u32) * np.uint32(0x85EBCA77)
    h = x ^ y
    h = h ^ (seed.astype(u32) + bh.astype(u32) * np.uint32(0x27D4EB2F))
    # xxhash-style avalanche: two multiply-xorshift rounds.
    h = h ^ (h >> 15)
    h = h * np.uint32(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * np.uint32(0x297A2D39)
    h = h ^ (h >> 15)
    threshold = np.uint32(int(rate * 4294967296.0))
    return h >= threshold


def pad_to_block(x: jnp.ndarray, axis: int, block: int,
                 value=0) -> jnp.ndarray:
    """Pad `axis` of x up to a multiple of `block` with `value`."""
    size = x.shape[axis]
    pad = round_up(size, block) - size
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, constant_values=value)
