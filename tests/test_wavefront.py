"""Property tests for the kernels' block ranges (pure index math — no
kernels).

`kv_block_range` (forward and dQ: which K/V blocks a q block loops over)
and `q_block_range` (dK/dV: which q blocks see a K/V block) ARE the kernels'
causal/window pruning, and their split into masked and mask-free blocks
decides where the element mask may be skipped. These tests reconstruct the
implied (row, col) visibility and compare it against a brute-force mask over
many geometries — causal offsets (positive and negative), ragged tails,
sliding windows — with Python ints and with traced int32 scalars (the
kernels evaluate the same helpers on `pl.program_id` and on a traced
offset).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashattn_tpu.ops.flash_fwd import kv_block_range, q_block_range


def brute_mask(s_q, s_k, causal_offset, window):
    r = np.arange(s_q)[:, None]
    c = np.arange(s_k)[None, :]
    m = np.ones((s_q, s_k), bool)
    if causal_offset is not None:
        m &= c <= r + causal_offset
        if window is not None:
            m &= c >= r + causal_offset - window + 1
    return m


GEOMETRIES = [
    # (s_q, s_k, bq, bkv, causal_offset, window)
    (16, 16, 4, 4, 0, None),
    (16, 16, 4, 4, None, None),
    (12, 20, 4, 4, 8, None),       # s_q != s_k, bottom-right
    (20, 12, 4, 4, -8, None),      # negative offset: empty top rows
    (16, 16, 4, 4, 0, 6),          # window
    (24, 24, 4, 8, 0, 9),          # mixed blocks + window
    (18, 18, 4, 4, 0, None),       # ragged tail (s % b != 0)
    (18, 14, 4, 4, -4, 5),         # ragged + negative offset + window
    (16, 32, 8, 4, 16, 4),         # tiny window far right
]


def _ranges(fn, idx, traced, **kw):
    """Evaluate a range helper with Python ints, or under jit with the
    block index and offset traced (as in the kernels)."""
    if not traced:
        return tuple(int(x) for x in fn(idx, **kw))
    offset = kw.pop("offset")
    out = jax.jit(lambda i, off: jnp.stack(
        [jnp.asarray(x) for x in fn(i, offset=off, **kw)]))(
            jnp.int32(idx), jnp.int32(offset))
    return tuple(int(x) for x in np.asarray(out))


def _fwd_visibility(s_q, s_k, bq, bkv, off, window, traced):
    """(visible, masked-block marks) implied by kv_block_range."""
    nq, nk = math.ceil(s_q / bq), math.ceil(s_k / bkv)
    vis = np.zeros((nq * bq, nk * bkv), bool)
    free = np.zeros_like(vis)  # cells of blocks the kernel runs mask-free
    want = brute_mask(nq * bq, nk * bkv, off, window)
    want[:, s_k:] = False
    for qi in range(nq):
        lo, b, c, hi = _ranges(
            kv_block_range, qi, traced, block_q=bq, block_kv=bkv,
            num_kv_blocks=nk, s_k=s_k, offset=0 if off is None else off,
            causal=off is not None, window=window)
        assert 0 <= lo <= b <= c <= hi <= nk, (qi, lo, b, c, hi)
        rows = slice(qi * bq, (qi + 1) * bq)
        for kj in range(lo, hi):
            cols = slice(kj * bkv, (kj + 1) * bkv)
            if b <= kj < c:
                free[rows, cols] = True
                vis[rows, cols] = True
            else:
                vis[rows, cols] = want[rows, cols]
    return vis, free, want


@pytest.mark.parametrize("s_q,s_k,bq,bkv,off,window", GEOMETRIES)
def test_wavefront_matches_brute_force(s_q, s_k, bq, bkv, off, window):
    """Forward / dQ: the visited blocks with their masks reproduce the
    brute-force visibility exactly (no missed block, nothing extra)."""
    vis, _, want = _fwd_visibility(s_q, s_k, bq, bkv, off, window, False)
    np.testing.assert_array_equal(vis[:s_q, :s_k], want[:s_q, :s_k])


@pytest.mark.parametrize("s_q,s_k,bq,bkv,off,window", GEOMETRIES)
def test_wavefront_row_flags(s_q, s_k, bq, bkv, off, window):
    """Mask classes: every block the kernels run mask-free is fully
    visible for every row of its q block (padded rows included, since the
    kernel computes them too), and the traced evaluation agrees."""
    vis, free, want = _fwd_visibility(s_q, s_k, bq, bkv, off, window, True)
    assert want[free].all()
    np.testing.assert_array_equal(vis[:s_q, :s_k], want[:s_q, :s_k])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("s_q,s_k,bq,bkv,off,window", GEOMETRIES)
def test_dkv_wavefront_matches_brute_force(s_q, s_k, bq, bkv, off, window,
                                           traced):
    """dK/dV: the q blocks visiting each K/V block, with their masks, must
    imply the forward's visibility on the real rows/cols; mask-free (kv,
    q) block pairs must be fully visible on every real row."""
    nq, nk = math.ceil(s_q / bq), math.ceil(s_k / bkv)
    want = brute_mask(nq * bq, nk * bkv, off, window)
    got = np.zeros_like(want)
    for kj in range(nk):
        lo, b, c, hi = _ranges(
            q_block_range, kj, traced, block_q=bq, block_kv=bkv,
            num_q_blocks=nq, offset=0 if off is None else off,
            causal=off is not None, window=window)
        assert 0 <= lo <= b <= c <= hi <= nq, (kj, lo, b, c, hi)
        cols = slice(kj * bkv, (kj + 1) * bkv)
        for qi in range(lo, hi):
            rows = slice(qi * bq, (qi + 1) * bq)
            if b <= qi < c:
                assert want[rows, cols].all(), (kj, qi)
                got[rows, cols] = True
            else:
                got[rows, cols] = want[rows, cols]
    np.testing.assert_array_equal(got[:s_q, :s_k], want[:s_q, :s_k])


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("off", [-20, -3, 0, 7, 40])
def test_traced_offset_matches_static(off, window):
    """The traced offset (zigzag ring hops) gives the same ranges as the
    static one, including offsets that leave whole blocks empty."""
    for qi in range(5):
        kw = dict(block_q=4, block_kv=8, num_kv_blocks=3, s_k=20, offset=off,
                  causal=True, window=window)
        assert (_ranges(kv_block_range, qi, False, **dict(kw))
                == _ranges(kv_block_range, qi, True, **dict(kw)))
