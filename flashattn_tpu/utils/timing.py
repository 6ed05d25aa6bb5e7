"""Benchmark timing + FLOPs model.

Port of the reference harness discipline (``code/Performance_Comparison.py``):
  - steady-state timing with warmup (``:111-128``): host wall clock around
    work that ends in jax.block_until_ready — same rationale as the
    reference's CUDA events: exclude cold-start compile, measure device
    time not dispatch (``Phase_5.md:40-69``)
  - FLOPs model from the flash-attn repo: 4·B·H·S_q·S_k·D, halved if causal;
    bwd = 2.5×, fwd+bwd = 3.5× (``:98-107``)
  - bwd measured as fwd_bwd − fwd (``:92-95``)
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def _sync(out) -> None:
    """Wait until every output of the last dispatched call is computed."""
    jax.block_until_ready(out)


def median_seconds(fn: Callable, *args, warmup: int = 2,
                   reps: int = 10) -> float:
    """Median host seconds per call, each call timed alone and ended by
    block_until_ready, after `warmup` calls (the first compiles)."""
    import statistics

    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure(
    fn: Callable, *args, warmup: int = 3, n1: int = 5, n2: int = 20,
    # kept for call-site compat; repeat overrides n2 when larger
    repeat: int | None = None,
) -> float:
    """Steady-state seconds per call via two-point slope timing.

    Times n1 and n2 back-to-back dispatches, each bracket ending in
    block_until_ready, and returns (T2 - T1)/(n2 - n1). The slope cancels
    the fixed dispatch + sync overhead, which a single timed loop would
    smear over every iteration. Same rationale as the reference's
    CUDA-event timing — measure device time, not host/launch overhead
    (Phase_5.md:40-69).
    """
    if repeat is not None:
        n2 = max(n2, repeat)
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)

    def bracket(n: int) -> float:
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn(*args)
        _sync(out)
        return time.perf_counter() - t0

    # Auto-scale iteration counts so the bracket delta dwarfs host jitter:
    # target >= 0.5 s of pure kernel time in the long bracket.
    est = bracket(n1) / n1
    target = 0.5
    scale_n = max(1, int(target / max(est * (n2 - n1), 1e-9)))
    n1, n2 = n1 * scale_n, n2 * scale_n
    # Take the median of three slopes and retry once if all are degenerate
    # (a host stall in the short bracket can make a slope non-positive).
    for _ in range(2):
        slopes = sorted(
            (bracket(n2) - bracket(n1)) / (n2 - n1) for _ in range(3)
        )
        if slopes[1] > 0:
            return slopes[1]
    return max(slopes[1], 1e-9)


def measure_looped(
    fn: Callable, *args, iters: int = 200, warmup: int = 1,
    repeats: int = 1,
) -> float:
    """Seconds per call for SMALL kernels (< ~1 ms device time).

    Kernels cheaper than the per-dispatch host cost are rate-limited by the
    host in a dispatch loop. This wraps fn in an on-device lax.scan (a data
    dependency on the previous iteration's output defeats loop-invariant
    hoisting) and times ONE dispatch of `iters` chained executions — the
    chain is compiled once even with repeats > 1 (min taken: host stalls
    only ADD time). The reading is ``real + F/iters`` (F = fixed
    dispatch + sync cost): good for RANKING with a uniform bias; use
    measure_looped_slope for absolute numbers.
    """
    first, rest = args[0], args[1:]
    run = _make_chain(fn, iters)
    out = run(first, rest)
    for _ in range(max(0, warmup - 1)):
        out = run(first, rest)
    _sync(out)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = run(first, rest)
        _sync(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def measure_looped_slope(
    fn: Callable, *args, est: float | None = None, repeats: int = 3,
) -> float:
    """Fixed-overhead-cancelling device time: slope between two on-device
    chain lengths.

    A single measure_looped() reading is ``real + F/iters`` where F is the
    fixed dispatch + sync cost. Timing chains of n1 and n2 iterations and
    taking ``(T2 - T1)/(n2 - n1)`` cancels F exactly — the same two-point
    trick as measure(), applied to scan chains (which, unlike back-to-back
    dispatches, can never be host-rate-bound).

    (n1, n2) come from a small FIXED set picked by a crude estimate — scan
    lengths are trace-static, so every distinct length costs an XLA
    compile; two shared lengths per regime keep that bounded.
    """
    if est is None:
        est = measure(fn, *args, warmup=1, n1=2, n2=5)
    # Pairs sized so the slope window holds >= ~0.3 s of pure kernel time.
    if est < 1e-3:
        n1, n2 = 800, 2400
    elif est < 8e-3:
        n1, n2 = 100, 300
    else:
        n1, n2 = 20, 60
    first, rest = args[0], args[1:]
    # One jitted chain per length (compiled once — a fresh wrapper per
    # timing run would recompile).
    run1, run2 = _make_chain(fn, n1), _make_chain(fn, n2)
    _sync(run1(first, rest))
    _sync(run2(first, rest))

    def timed(run):
        t0 = time.perf_counter()
        _sync(run(first, rest))
        return time.perf_counter() - t0

    # Slope of MINS, not median of slopes: host stalls only ever ADD time,
    # so take each chain length's best-of-N — the cleanest observation of a
    # monotone-noise quantity — and slope those. (A min over SLOPES would
    # be wrong: a stalled T1 deflates its slope.)
    t1 = min(timed(run1) for _ in range(repeats))
    t2 = min(timed(run2) for _ in range(repeats))
    if t2 - t1 <= 0.05 * t1:
        # Degenerate slope (t2 barely above t1): a stall polluted every t1
        # rep. One more round of reps, then fall back to the long chain's
        # biased-but-sane reading rather than returning ~0.
        t1 = min(t1, *(timed(run1) for _ in range(repeats)))
        t2 = min(t2, *(timed(run2) for _ in range(repeats)))
        if t2 - t1 <= 0.05 * t1:
            return t2 / n2
    return (t2 - t1) / (n2 - n1)


def _make_chain(fn: Callable, iters: int):
    """Jitted `iters`-long on-device chain of fn (measure_looped's scan:
    a data dependency on the previous iteration's output defeats
    loop-invariant hoisting; only the first arg rides the carry)."""
    import jax.numpy as jnp

    @jax.jit
    def run(first, rest):
        def body(carry, _):
            out = fn(carry, *rest)
            # Fold EVERY output leaf into the dependency, not just the
            # first: with only one leaf used, XLA dead-code-eliminates
            # whole sibling computations (e.g. the dK/dV kernel of a
            # backward) out of the timed program.
            dep = jnp.float32(0)
            for leaf in jax.tree_util.tree_leaves(out):
                dep += (leaf.reshape(-1)[0] * 1e-30).astype(jnp.float32)
            return (carry.astype(jnp.float32) + dep).astype(carry.dtype), None

        carry, _ = jax.lax.scan(body, first, None, length=iters)
        return carry

    return run


def measure_auto(
    fn: Callable, *args, warmup: int = 3, repeat: int | None = None,
) -> float:
    """Robust device seconds per call: measure() for a crude estimate, then
    the fixed-overhead-cancelling chain slope (measure_looped_slope)."""
    est = measure(fn, *args, warmup=warmup, repeat=repeat)
    return measure_looped_slope(fn, *args, est=est)


def attention_flops(
    b: int,
    h: int,
    s_q: int,
    s_k: int,
    d: int,
    mode: str = "fwd",
    is_causal: bool = False,
) -> float:
    """Reference FLOPs convention (Performance_Comparison.py:98-107)."""
    base = 4.0 * b * h * s_q * s_k * d
    if is_causal:
        base /= 2.0
    factor = {"fwd": 1.0, "bwd": 2.5, "fwd_bwd": 3.5}[mode]
    return base * factor


def tflops(flops: float, seconds: float) -> float:
    return flops / seconds / 1e12
