"""jax.profiler tracing helper (SURVEY.md §5 tracing subsystem)."""

import jax
import jax.numpy as jnp

from flashattn_tpu import flash_attention
from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.utils.profiling import profile_fn


def test_profile_fn_writes_trace(tmp_path):
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    q, k, v = (jax.random.normal(kk, (1, 2, 256, 64)) for kk in keys)
    bs = BlockSizes(block_q=64, block_kv=64)
    log_dir = profile_fn(
        lambda q, k, v: flash_attention(q, k, v, is_causal=True,
                                        block_sizes=bs),
        q, k, v, log_dir=str(tmp_path / "trace"))
    assert log_dir


def test_peak_table_rejects_unknown_device():
    """A roofline against a guessed peak is a wrong number: a device kind
    missing from the table raises instead of falling back."""
    import pytest

    from flashattn_tpu.utils.roofline import PEAKS, detect_chip

    assert jax.devices()[0].device_kind not in PEAKS  # the CPU backend
    with pytest.raises(ValueError, match="no published peaks"):
        detect_chip()


def test_roofline_bound_and_causal_halving():
    from flashattn_tpu.utils.roofline import (
        H100_SXM, attention_bwd_roofline, attention_fwd_roofline)

    full = attention_fwd_roofline(4, 8, 8, 16384, 16384, 128, False,
                                  chip=H100_SXM)
    causal = attention_fwd_roofline(4, 8, 8, 16384, 16384, 128, True,
                                    chip=H100_SXM)
    assert causal.flops == full.flops / 2
    assert full.bound == "compute"  # long-S attention is above the ridge
    assert abs(full.compute_seconds - full.flops / 989e12) < 1e-12
    bwd = attention_bwd_roofline(4, 8, 8, 16384, 16384, 128, True,
                                 chip=H100_SXM)
    assert bwd.flops == 2.5 * causal.flops
    # Decode-like shape (one query row): far below the ridge.
    dec = attention_fwd_roofline(8, 32, 4, 1, 32768, 64, False,
                                 chip=H100_SXM)
    assert dec.bound == "memory"
