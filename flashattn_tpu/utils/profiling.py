"""Tracing / profiling helpers (SURVEY.md §5: the reference has only
print-based wall-clock timing; here jax.profiler traces plus the analytic
roofline in utils/roofline.py). Traces default to `<repo>/.traces`."""

from __future__ import annotations

import contextlib
import glob
import os

import jax

from flashattn_tpu.utils.compile_cache import REPO_ROOT

_TRACE_DIR = str(REPO_ROOT / ".traces")


@contextlib.contextmanager
def trace(log_dir: str = _TRACE_DIR):
    """Capture a jax.profiler trace (TensorBoard/XProf format) around a block.

    >>> with trace("/tmp/t"):
    ...     flash_attention(q, k, v).block_until_ready()
    View with: tensorboard --logdir /tmp/t   (or xprof)
    """
    with jax.profiler.trace(log_dir):
        yield log_dir


def profile_fn(fn, *args, log_dir: str = _TRACE_DIR,
               iters: int = 3) -> str:
    """Run fn under the profiler (after one warmup) and return the trace dir."""
    out = fn(*args)
    jax.block_until_ready(out)
    with trace(log_dir):
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
    produced = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                         recursive=True)
    assert produced, f"no trace written under {log_dir}"
    return log_dir
