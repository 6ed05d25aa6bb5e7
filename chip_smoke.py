"""End-to-end check that the system's main path runs compiled on one GPU.

    python chip_smoke.py              # phases 1-4 on one GPU
    python chip_smoke.py --chips 4    # phase 5 only: the sharded train step
    python chip_smoke.py --rehearse   # the same phases on the CPU, tiny sizes

Phases (each prints its comparisons beside their tolerances and fails the
run if one misses; nothing is caught):

  1. attention kernels — Triton flash fwd+bwd at the benchmark shape and at
     the model shape against the float32 oracle, every variant once, and
     the kernels timed beside the plain-XLA and cuDNN versions;
  2. decode — dense bf16/int8/fp8 and paged caches against the dequantized
     oracle, paged == dense, timed beside the library's Triton kernels; the
     weight-only quantized matmul beside the bf16 product;
  3. train — LLAMA_1B at full width (depth cut) takes three optimizer steps
     and one packed-document step; step-1 loss against a float32 oracle
     forward;
  4. serve — InferenceServer answers requests four ways (dense, paged,
     paged int8 KV, shared prefix); every logprob against the float32
     oracle teacher-forced on the same tokens;
  5. (--chips 4 only) the train step on a (data 1, model 2, sp 2) mesh
     against the same step on one device.

The last line of standard output is one JSON object with "ok" and the device
as JAX reports it. Without a GPU (and without --rehearse) the script exits
non-zero before printing any result. Every timing on the GPU is the slope
between two lengths of an on-device chain of calls, timed on the host
around block_until_ready after warm-up (`timed`).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from unittest import mock

# Tolerances. Kernel gates are the repo's own (verify_results: allclose and
# cosine > 0.999): bf16 outputs vs the float32 oracle atol 2e-2, bf16
# gradients rtol 2e-2 / atol 5e-2. Decode vs the dequantized oracle: the
# P·V product takes P in bf16, so the bf16 output gate. Model-level gates
# compare a bf16 model against a float32 one (bf16 weights, activations and
# residual stream): the loss within 3e-2 absolute (random-init loss is
# ~ln(32000) = 10.4) and per-token logprobs within 0.1 (bf16 KV) / 0.15
# (int8 KV adds per-token quantization, ~0.4% per element).
O_TOL = dict(atol=2e-2, rtol=2e-2)
GRAD_TOL = dict(atol=5e-2, rtol=2e-2)
LOSS_TOL = 3e-2
LOGPROB_TOL = {None: 0.1, "int8": 0.15}
MESH_LOSS_TOL = 1e-2  # sharded vs one-device step: same bf16 math, other
MESH_GNORM_RTOL = 2e-2  # summation order (TP all-reduce, ring merges)


@dataclasses.dataclass(frozen=True)
class Sizes:
    bench: tuple  # (B, H, S, D), causal
    oracle_bh: tuple  # (B, H) the f32 oracle covers at the bench shape
    model_attn: tuple  # (B, Hq, Hkv, S, D)
    variant_s: int
    decode_b: int
    decode_s: tuple
    page: int
    train_b: int
    train_s: int
    layers: int
    serve_len: int
    serve_prompt: tuple  # (min, max) prompt tokens
    serve_new: int
    serve_prefix: int
    oracle_len: int  # padded length of the teacher-forced oracle batch
    qmm_m: tuple


FULL = Sizes(bench=(4, 8, 16384, 128), oracle_bh=(1, 8),
             model_attn=(4, 32, 4, 2048, 64), variant_s=4096, decode_b=8,
             decode_s=(2048, 32768), page=256, train_b=4, train_s=2048,
             layers=4, serve_len=2048, serve_prompt=(200, 400), serve_new=16,
             serve_prefix=512, oracle_len=1024, qmm_m=(8, 2048))
TINY = Sizes(bench=(1, 2, 256, 64), oracle_bh=(1, 1),
             model_attn=(1, 4, 2, 128, 32), variant_s=128, decode_b=2,
             decode_s=(128, 256), page=32, train_b=2, train_s=64, layers=2,
             serve_len=256, serve_prompt=(20, 40), serve_new=4,
             serve_prefix=64, oracle_len=128, qmm_m=(8, 64))


def log(*parts):
    print(*parts, flush=True)


class Phase:
    """Prints a phase's wall seconds; any exception propagates."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: done in "
                f"{time.perf_counter() - self.t0:.1f} s")
        return False


def check(label, ref, out, tol):
    from flashattn_tpu.utils.verify import verify_results

    r = verify_results(ref, out, **tol)
    log(f"  {label}: max|err|={r.max_abs_err:.3e} cos={r.cosine:.6f} "
        f"(tol atol={tol['atol']} rtol={tol['rtol']}, cos>0.999) "
        f"{'PASS' if r.passed else 'FAIL'}")
    if not r.passed:
        raise AssertionError(f"{label}: {r}")


def check_abs(label, err, tol):
    ok = err <= tol
    log(f"  {label}: {err:.3e} (tol {tol}) {'PASS' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: {err} > {tol}")


def compiled(fn, *args, label):
    """jit + compile once, printing compile seconds and memory analysis."""
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    ma = exe.memory_analysis()
    mem = ""
    if ma is not None:
        mem = (f" args={ma.argument_size_in_bytes / 2**30:.2f} GiB "
               f"out={ma.output_size_in_bytes / 2**30:.2f} GiB "
               f"temp={ma.temp_size_in_bytes / 2**30:.2f} GiB")
    log(f"  compile {label}: {time.perf_counter() - t0:.1f} s;{mem}")
    return exe


def timed(label, fn, *args, reps=10, chain=True):
    """Seconds per call on the GPU: the slope between two lengths of an
    on-device chain of calls, each timed on the host around
    block_until_ready (utils.timing.measure_looped_slope) — a single timed
    call would add the host's dispatch and sync cost, which is most of a
    sub-millisecond call. The median of single calls (after warm-up) gives
    the chain lengths, and is what a CPU rehearsal reports; chain=False
    keeps it for whole steps (tens of ms, first argument not an array)."""
    import jax

    from flashattn_tpu.utils.timing import (measure_looped_slope,
                                            median_seconds)

    t = median_seconds(fn, *args, warmup=2, reps=reps)
    if jax.devices()[0].platform == "gpu":
        if chain:
            t = measure_looped_slope(fn, *args, est=t)
        how = "chain slope" if chain else "median of single calls"
        log(f"  time {label}: {t * 1e3:.4f} ms ({how})")
    else:
        log(f"  time {label}: {t * 1e3:.4f} ms "
            "[CPU rehearsal: median of single calls, not a device time]")
    return t


def yardstick(label, run):
    """Time a library's kernel (cuDNN, the installed JAX's Pallas ops) as a
    yardstick. A library build that refuses the shape is reported, not
    fatal: it is not part of this repository's path."""
    try:
        run()
    except Exception as e:  # noqa: BLE001 — any refusal is reported
        log(f"  time {label}: unavailable ({type(e).__name__}: "
            f"{str(e)[:160]})")


def rand(key, shape, dtype):
    import jax

    return jax.random.normal(key, shape, dtype)


# --------------------------------------------------------------------------
# Phase 1: attention kernels


def dropout_oracle(q, k, v, rate, seed):
    """f32 causal attention with the kernels' counter-hash keep mask."""
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.ops.common import dropout_keep_mask

    b, h, s, d = q.shape
    hi = jax.lax.Precision.HIGHEST
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    sc = jnp.einsum("bhqd,bhkd->bhqk", qf, kf, precision=hi) / d**0.5
    r = jnp.arange(s)[:, None]
    c = jnp.arange(s)[None, :]
    p = jax.nn.softmax(jnp.where(c <= r, sc, -jnp.inf), axis=-1)
    bh = jnp.arange(b * h, dtype=jnp.int32).reshape(b, h, 1, 1)
    keep = dropout_keep_mask(jnp.int32(seed), bh, r.astype(jnp.int32),
                             c.astype(jnp.int32), rate)
    p = jnp.where(keep, p / (1.0 - rate), 0.0)
    return jnp.einsum("bhqk,bhkd->bhqd", p, vf, precision=hi)


def offset_oracle(q, k, v, offset):
    """f32 attention where row r sees cols <= r + offset."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    qf, kf, vf = (x.astype(jnp.float32) for x in (q, k, v))
    sc = jnp.einsum("bhqd,bhkd->bhqk", qf, kf,
                    precision=hi) / q.shape[-1]**0.5
    r = jnp.arange(q.shape[2])[:, None]
    c = jnp.arange(k.shape[2])[None, :]
    p = jax.nn.softmax(jnp.where(c <= r + offset, sc, -jnp.inf), axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p, vf, precision=hi)


def fwd_bwd_vs_oracle(label, q, k, v, do, ours, oracle, oracle_slice=None):
    """Compile ours' fwd+grads, compare O and dQ/dK/dV with the oracle's
    (on a (batch, head) slice of the inputs when the oracle is cut)."""
    import jax
    import jax.numpy as jnp

    def fwd_bwd(fn):
        def run(q, k, v, do):
            o, vjp = jax.vjp(fn, q, k, v)
            return (o,) + vjp(do.astype(o.dtype))
        return run

    exe = compiled(fwd_bwd(ours), q, k, v, do, label=f"{label} fwd+bwd")
    outs = exe(q, k, v, do)
    if oracle_slice is not None:
        bs, hs = oracle_slice
        q, k, v, do = (x[:bs, :hs] for x in (q, k, v, do))
        outs = tuple(x[:bs, :hs] for x in outs)
    refs = jax.jit(fwd_bwd(lambda q, k, v: oracle(q, k, v)))(
        q.astype(jnp.float32), k.astype(jnp.float32), v.astype(jnp.float32),
        do.astype(jnp.float32))
    check(f"{label} O", refs[0], outs[0], O_TOL)
    for name, r, o in zip(("dQ", "dK", "dV"), refs[1:], outs[1:]):
        check(f"{label} {name}", r, o, GRAD_TOL)


def bthd(x):
    return x.transpose(0, 2, 1, 3)


def time_attention(label, q, k, v, do, rehearse):
    """Triton kernels vs XLA's plain version vs cuDNN, fwd and fwd+bwd."""
    import jax

    from flashattn_tpu import flash_attention

    def dpa(impl):
        def f(q, k, v):
            return bthd(jax.nn.dot_product_attention(
                bthd(q), bthd(k), bthd(v), is_causal=True,
                implementation=impl))
        return f

    def fwd_bwd(fn):
        def run(q, k, v, do):
            o, vjp = jax.vjp(fn, q, k, v)
            return vjp(do)
        return jax.jit(run)

    fa = lambda q, k, v: flash_attention(q, k, v, is_causal=True)
    timed(f"{label} triton fwd", jax.jit(fa), q, k, v)
    timed(f"{label} triton fwd+bwd", fwd_bwd(fa), q, k, v, do)
    timed(f"{label} xla fwd", jax.jit(dpa("xla")), q, k, v)
    timed(f"{label} xla fwd+bwd", fwd_bwd(dpa("xla")), q, k, v, do)
    if rehearse:
        return
    yardstick(f"{label} cudnn fwd",
              lambda: timed(f"{label} cudnn fwd", jax.jit(dpa("cudnn")),
                            q, k, v))
    yardstick(f"{label} cudnn fwd+bwd",
              lambda: timed(f"{label} cudnn fwd+bwd", fwd_bwd(dpa("cudnn")),
                            q, k, v, do))


def phase_attention(sz, rehearse):
    import jax
    import jax.numpy as jnp

    from flashattn_tpu import flash_attention
    from flashattn_tpu.ops.reference import reference_attention

    ks = jax.random.split(jax.random.PRNGKey(0), 16)
    bf = jnp.bfloat16

    # Benchmark shape: the f32 oracle's S x S scores limit it to a slice.
    b, h, s, d = sz.bench
    q, k, v, do = (rand(ks[i], (b, h, s, d), bf) for i in range(4))
    ob, oh = sz.oracle_bh
    log(f"  bench shape B={b} H={h} S={s} D={d} causal bf16; oracle on "
        f"B={ob} H={oh} of it (f32 scores {ob * oh * s * s * 4 / 2**30:.1f} "
        f"GiB per tensor)")
    causal = lambda q, k, v: flash_attention(q, k, v, is_causal=True)
    ref_causal = lambda q, k, v: reference_attention(q, k, v, is_causal=True)
    fwd_bwd_vs_oracle("bench", q, k, v, do, causal, ref_causal,
                      oracle_slice=(ob, oh))
    timed(f"bench B={b} triton fwd+bwd",
          jax.jit(lambda q, k, v, do: jax.vjp(causal, q, k, v)[1](do)),
          q, k, v, do)
    # The plain-XLA and cuDNN comparison at B=1: XLA's plain version holds
    # the S x S scores (its B=4 run was not attempted).
    q1, k1, v1, do1 = (x[:1] for x in (q, k, v, do))
    time_attention(f"bench B=1 H={h} S={s}", q1, k1, v1, do1, rehearse)
    del q, k, v, do, q1, k1, v1, do1

    # Model shape (LLAMA_1B attention: GQA 32/4, D=64).
    b, hq, hkv, s, d = sz.model_attn
    q, do = (rand(ks[4 + i], (b, hq, s, d), bf) for i in range(2))
    k, v = (rand(ks[6 + i], (b, hkv, s, d), bf) for i in range(2))
    log(f"  model shape B={b} Hq={hq} Hkv={hkv} S={s} D={d} causal bf16")
    fwd_bwd_vs_oracle("model", q, k, v, do, causal, ref_causal)
    time_attention(f"model B={b} S={s}", q, k, v, do, rehearse)

    # Every variant once.
    s = sz.variant_s
    hq, hkv, d = 8, 8, 128 if not rehearse else 64
    q, do = (rand(ks[8 + i], (1, hq, s, d), bf) for i in range(2))
    k, v = (rand(ks[10 + i], (1, hkv, s, d), bf) for i in range(2))
    seg = jnp.asarray(
        jax.random.randint(ks[12], (1, s), 0, 4).sort(axis=-1), jnp.int32)
    win = s // 4
    log(f"  variants at B=1 H={hq} S={s} D={d} bf16")

    def both(**kw):
        return (lambda q, k, v: flash_attention(q, k, v, is_causal=True,
                                                **kw),
                lambda q, k, v: reference_attention(q, k, v, is_causal=True,
                                                    **kw))

    from flashattn_tpu.ops.varlen import flash_attention_varlen

    variants = {
        "window": both(window=win),
        "softcap": both(logit_softcap=30.0),
        "alibi": both(alibi=True),
        "segments": (
            lambda q, k, v: flash_attention_varlen(
                q, k, v, segment_ids=seg, is_causal=True),
            lambda q, k, v: reference_attention(
                q, k, v, is_causal=True, segment_ids=(seg, seg))),
        "dropout": (
            lambda q, k, v: flash_attention(q, k, v, is_causal=True,
                                            dropout_rate=0.1,
                                            dropout_seed=5),
            lambda q, k, v: dropout_oracle(q, k, v, 0.1, 5)),
    }
    for name, (ours, ref) in variants.items():
        fwd_bwd_vs_oracle(name, q, k, v, do, ours, ref)

    kg, vg = k[:, :2], v[:, :2]
    fwd_bwd_vs_oracle("gqa 8/2", q, kg, vg, do, causal, ref_causal)

    # Alignment overrides (ring/zigzag hops): half the queries against all
    # keys, row r seeing cols <= r + off.
    from flashattn_tpu.ops.flash_fwd import flash_attention_forward

    off = s // 4
    qh = q[:, :, : s // 2]
    o_static, _ = jax.jit(lambda q, k, v: flash_attention_forward(
        q, k, v, is_causal=True, pos_offset=off))(qh, k, v)
    o_dyn, _ = jax.jit(lambda q, k, v, o: flash_attention_forward(
        q, k, v, is_causal=True, dyn_pos_offset=o))(qh, k, v, jnp.int32(off))
    o_ref = offset_oracle(qh, k, v, off)
    check("pos_offset O", o_ref, o_static, O_TOL)
    check("dyn_pos_offset O", o_ref, o_dyn, O_TOL)


# --------------------------------------------------------------------------
# Phase 2: decode and the quantized matmul


def phase_decode(sz, rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu.models.config import LLAMA_1B
    from flashattn_tpu.ops.decode import decode_attention
    from flashattn_tpu.ops.kvcache import dequantize, init_cache, update_cache
    from flashattn_tpu.ops.paged import (init_paged_cache,
                                         paged_decode_attention, write_pages)

    hq, hkv, d = ((LLAMA_1B.num_heads, LLAMA_1B.num_kv_heads,
                   LLAMA_1B.head_dim) if not rehearse else (8, 2, 32))
    b = sz.decode_b
    ks = jax.random.split(jax.random.PRNGKey(1), 8)
    for s in sz.decode_s:
        kn = rand(ks[0], (b, hkv, s, d), jnp.bfloat16)
        vn = rand(ks[1], (b, hkv, s, d), jnp.bfloat16)
        q = rand(ks[2], (b, hq, d), jnp.bfloat16)
        lens = jnp.asarray(np.linspace(s // 2, s, b).astype(np.int32))
        log(f"  decode B={b} Hq={hq} Hkv={hkv} D={d} S={s} (ragged lengths "
            f"{int(lens[0])}..{int(lens[-1])})")
        for quant in (None, "int8", "fp8"):
            name = quant or "bf16"
            cache = update_cache(init_cache(b, hkv, s, d, quant=quant),
                                 kn, vn, assume_fits=True)
            cache = dataclasses.replace(cache, length=lens)
            dec = jax.jit(decode_attention)
            o = dec(q, cache)
            kd = dequantize(cache.k, cache.k_scale)
            vd = dequantize(cache.v, cache.v_scale)
            # The oracle: full attention over each row's live prefix.
            mask_len = lens[:, None, None, None]
            pos = jnp.arange(s)[None, None, None, :]
            ref = jax.jit(lambda q, k, v: jnp.einsum(
                "bhqk,bhkd->bhqd",
                jax.nn.softmax(jnp.where(
                    pos < mask_len,
                    jnp.einsum("bhqd,bhkd->bhqk", q, k,
                               precision=jax.lax.Precision.HIGHEST) / d**0.5,
                    -jnp.inf), axis=-1), v,
                precision=jax.lax.Precision.HIGHEST))(
                q.reshape(b, hkv, hq // hkv, d).astype(jnp.float32),
                kd.astype(jnp.float32), vd.astype(jnp.float32))
            check(f"decode {name} S={s}", ref.reshape(b, hq, d), o, O_TOL)
            timed(f"decode {name} S={s} plain-xla", dec, q, cache)

            # Paged: the same tokens in scrambled pages must decode to the
            # same bits as the dense cache.
            page = sz.page
            per_seq = s // page
            perm = np.random.default_rng(0).permutation(b * per_seq)
            table = jnp.asarray(perm.reshape(b, per_seq), jnp.int32)
            paged = init_paged_cache(b, hkv, b * per_seq, page, d, per_seq,
                                     quant=quant)
            for bi in range(b):
                one = jax.tree_util.tree_map(lambda x: x[bi:bi + 1], cache)
                paged = write_pages(paged, one, table[bi])
            paged = dataclasses.replace(paged, block_table=table,
                                        length=lens)
            pdec = jax.jit(paged_decode_attention)
            o_p = pdec(q, paged)
            same = bool(jnp.array_equal(o_p, o))
            log(f"  paged {name} S={s} == dense: {same}")
            if not same:
                raise AssertionError(f"paged {name} S={s} differs from dense")
            timed(f"paged decode {name} S={s} page={page} plain-xla", pdec,
                  q, paged)
            if quant is None and not rehearse:
                time_library_decode(s, page, q, kn, vn, lens, table, paged)
        del kn, vn

    phase_quant_matmul(sz, rehearse)


def time_library_decode(s, page, q, kn, vn, lens, table, paged):
    """The installed JAX's Triton decode kernels, as yardsticks. They are
    library kernels, not this repository's."""
    import jax

    from jax.experimental.pallas.ops.gpu import decode_attention as lib_dec
    from jax.experimental.pallas.ops.gpu import paged_attention as lib_paged

    k_bshd, v_bshd = kn.transpose(0, 2, 1, 3), vn.transpose(0, 2, 1, 3)
    gqa = jax.jit(lambda q, k, v, n: lib_dec.gqa(q, k, v, kv_seq_len=n))
    label = f"decode bf16 S={s} library triton gqa"
    yardstick(label, lambda: timed(label, gqa, q, k_bshd, v_bshd, lens))
    k_pages = paged.k_pages.transpose(1, 0, 2, 3)  # [Hkv, P, page, D]
    v_pages = paged.v_pages.transpose(1, 0, 2, 3)
    per_seq = table.shape[1]
    splits = min(16, per_seq)  # must divide the pages of a sequence
    # At most 512 keys per compute block: 8 pages of 256 overflow the
    # block's shared memory.
    pa = jax.jit(lambda q, kp, vp, t, n: lib_paged.paged_attention(
        q, kp, vp, t, n, k_splits=splits,
        pages_per_compute_block=max(1, min(512 // page, per_seq // splits))))
    label = f"paged decode bf16 S={s} page={page} library triton"
    yardstick(label, lambda: timed(label, pa, q, k_pages, v_pages, table,
                                   lens))


def phase_quant_matmul(sz, rehearse):
    import jax
    import jax.numpy as jnp

    from flashattn_tpu.models.config import LLAMA_1B
    from flashattn_tpu.ops.quant_matmul import (dequantize_weights,
                                                quant_matmul,
                                                quantize_weights)

    k_dim, n_dim = ((LLAMA_1B.hidden_size, LLAMA_1B.intermediate_size)
                    if not rehearse else (128, 256))
    w = rand(jax.random.PRNGKey(2), (k_dim, n_dim), jnp.float32) * 0.02
    w_bf = w.astype(jnp.bfloat16)
    for m in sz.qmm_m:
        x = rand(jax.random.PRNGKey(3), (m, k_dim), jnp.bfloat16)
        timed(f"matmul M={m} K={k_dim} N={n_dim} bf16 dot",
              jax.jit(jnp.dot), x, w_bf)
        for bits in (8, 4):
            qw = quantize_weights(w, bits=bits)
            qmm = jax.jit(quant_matmul)
            y = qmm(x, qw)
            ref = jnp.dot(x.astype(jnp.float32), dequantize_weights(qw),
                          precision=jax.lax.Precision.HIGHEST)
            check(f"quant_matmul int{bits} M={m}", ref, y, O_TOL)
            timed(f"matmul M={m} int{bits} weights plain-xla", qmm, x, qw)
        if not rehearse:
            time_library_mixed_matmul(m, x, quantize_weights(w, bits=8))


def time_library_mixed_matmul(m, x, qw):
    """The installed JAX's Hopper mixed-type (int8 x bf16) Mosaic GPU
    matmul, a library kernel, where it accepts the shape: it takes the int8
    operand on the left, so it computes yᵀ = wᵀ·xᵀ."""
    import jax
    import jax.numpy as jnp

    label = f"matmul M={m} int8 weights library mosaic-gpu mixed"

    def run():
        from jax.experimental.pallas.ops.gpu import (
            hopper_mixed_type_matmul_mgpu as lib)

        cfg = lib.TuningConfig(tile_m=128, tile_n=128, tile_k=64,
                               max_concurrent_steps=4)
        fn = jax.jit(lambda a, b: lib.mixed_matmul_kernel(
            a, b, out_dtype=jnp.bfloat16, config=cfg))
        # [N, K] int8 and [K, M], transposed outside the timing.
        timed(label, fn, qw.w.T, x.T)

    yardstick(label, run)


# --------------------------------------------------------------------------
# Model oracles: the same model in float32 with the plain reference
# attention at HIGHEST matmul precision.


@contextmanager
def oracle_model():
    import jax

    from flashattn_tpu.models import llama
    from flashattn_tpu.ops import varlen
    from flashattn_tpu.ops.reference import reference_attention

    def attn(q, k, v, is_causal=False, scale=None, block_sizes=None,
             window=None, logit_softcap=None, alibi=False):
        return reference_attention(q, k, v, is_causal=is_causal, scale=scale,
                                   window=window, logit_softcap=logit_softcap,
                                   alibi=alibi)

    def attn_varlen(q, k, v, segment_ids=None, is_causal=False, scale=None,
                    block_sizes=None, window=None, logit_softcap=None,
                    alibi=False, alibi_slopes=None):
        seg = (segment_ids if isinstance(segment_ids, tuple)
               else (segment_ids, segment_ids))
        return reference_attention(q, k, v, is_causal=is_causal, scale=scale,
                                   segment_ids=seg, window=window,
                                   logit_softcap=logit_softcap, alibi=alibi)

    with mock.patch.object(llama, "flash_attention", attn), \
            mock.patch.object(varlen, "flash_attention_varlen", attn_varlen), \
            jax.default_matmul_precision("highest"):
        yield


def f32_model(params, cfg):
    import jax
    import jax.numpy as jnp

    p32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, params)
    return p32, dataclasses.replace(cfg, dtype=jnp.float32)


def model_config(sz, rehearse):
    from flashattn_tpu.models.config import LLAMA_1B

    if rehearse:
        return dataclasses.replace(
            LLAMA_1B, vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=sz.layers, num_heads=4, num_kv_heads=2, head_dim=16)
    return dataclasses.replace(LLAMA_1B, num_layers=sz.layers)


# --------------------------------------------------------------------------
# Phase 3: train


def phase_train(sz, rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu.models import data, llama, train

    cfg = model_config(sz, rehearse)
    log(f"  LLAMA_1B width (hidden={cfg.hidden_size} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} head_dim={cfg.head_dim} ffn="
        f"{cfg.intermediate_size} vocab={cfg.vocab_size}), depth cut "
        f"22 -> {cfg.num_layers} layers; B={sz.train_b} S={sz.train_s}")
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tc = train.TrainConfig(learning_rate=1e-3, warmup_steps=0,
                           total_steps=100)
    state = train.init_train_state(params, tc)
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (sz.train_b, sz.train_s + 1), 0,
                                cfg.vocab_size, jnp.int32)

    step = compiled(functools.partial(train.train_step, cfg=cfg, tc=tc),
                    state, tokens, label="train_step")
    losses = []
    for i in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, tokens)
        loss = float(metrics["loss"])
        losses.append(loss)
        log(f"  step {i + 1}: loss={loss:.5f} grad_norm="
            f"{float(metrics['grad_norm']):.4f} "
            f"({(time.perf_counter() - t0) * 1e3:.1f} ms incl. sync)")
    if not all(np.isfinite(losses)) or not losses[2] < losses[0]:
        raise AssertionError(f"losses not finite and falling: {losses}")
    timed("train_step (steady)", step, state, tokens, reps=5, chain=False)

    p32, cfg32 = f32_model(params, cfg)
    with oracle_model():
        ref_loss = float(jax.jit(
            lambda p, t: llama.loss_fn(p, t, cfg32))(p32, tokens))
    check_abs("step-1 loss vs f32 oracle |diff|", abs(losses[0] - ref_loss),
              LOSS_TOL)

    # One packed-document step: documents of random lengths packed into
    # rows with segment ids (models/data.py).
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(sz.train_s // 8, sz.train_s // 2, 64)]
    rows = list(data.pack_documents(docs, sz.train_s + 1))[:sz.train_b]
    ptoks = jnp.asarray(np.stack([r[0] for r in rows]))
    psegs = jnp.asarray(np.stack([r[1] for r in rows]))
    pstep = compiled(lambda st, t, sg: train.train_step(
        st, t, cfg, tc, segment_ids=sg), state, ptoks, psegs,
        label="packed train_step")
    state, metrics = pstep(state, ptoks, psegs)
    ploss = float(metrics["loss"])
    log(f"  packed step: loss={ploss:.5f} "
        f"({int(jnp.max(psegs)) + 1} segment ids over {len(rows)} rows)")
    if not np.isfinite(ploss):
        raise AssertionError(f"packed loss not finite: {ploss}")


# --------------------------------------------------------------------------
# Phase 4: serve


def phase_serve(sz, rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from flashattn_tpu.models import llama
    from flashattn_tpu.models.serve import InferenceServer, Request

    cfg = model_config(sz, rehearse)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    p32, cfg32 = f32_model(params, cfg)
    rng = np.random.default_rng(1)
    n_req = 8
    prefix = rng.integers(0, cfg.vocab_size, sz.serve_prefix).tolist()
    # Traced (on first call) and run inside oracle_model().
    ref_fwd = jax.jit(lambda p, t: jax.nn.log_softmax(
        llama.forward(p, t, cfg32), axis=-1))

    def requests(with_prefix, pid):
        reqs = []
        for uid in range(n_req):
            n = int(rng.integers(*sz.serve_prompt))
            own = rng.integers(0, cfg.vocab_size, n).tolist()
            reqs.append(Request(uid=uid, prompt=(prefix + own) if with_prefix
                                else own, max_new_tokens=sz.serve_new,
                                prefix_id=pid))
        return reqs

    base_reqs = requests(False, None)
    outs = {}
    modes = [("dense bf16", dict(), False),
             ("paged bf16", dict(paged=True), False),
             ("paged int8 KV", dict(paged=True, quant="int8"), False),
             ("paged bf16 shared prefix", dict(paged=True), True)]
    for name, kw, with_prefix in modes:
        if kw.get("paged"):
            kw = dict(kw, page_size=sz.page)
        srv = InferenceServer(params, cfg, max_slots=4,
                              max_len=sz.serve_len, return_logprobs=True,
                              **kw)
        reqs = base_reqs
        if with_prefix:
            pid = srv.register_prefix(prefix)
            reqs = requests(True, pid)
        t0 = time.perf_counter()
        for r in reqs:
            srv.submit(r)
        done = srv.run()
        n_tok = sum(len(v) for v in done.values())
        log(f"  {name}: {len(done)} requests, {n_tok} tokens in "
            f"{time.perf_counter() - t0:.2f} s (compiles included)")
        # Teacher-forced oracle over prompt + answer, one padded batch.
        seqs = [r.prompt + done[r.uid] for r in reqs]
        assert max(len(x) for x in seqs) <= sz.oracle_len
        batch = np.zeros((len(seqs), sz.oracle_len), np.int32)
        for i, x in enumerate(seqs):
            batch[i, :len(x)] = x
        with oracle_model():
            ref_lp = np.asarray(ref_fwd(p32, jnp.asarray(batch)))
        err = 0.0
        for i, r in enumerate(reqs):
            plen, out = len(r.prompt), done[r.uid]
            want = ref_lp[i, plen - 1 + np.arange(len(out)), out]
            got = np.asarray(srv.finished_logprobs[r.uid])
            err = max(err, float(np.max(np.abs(got - want))))
        check_abs(f"{name} logprobs vs f32 oracle max|diff|", err,
                  LOGPROB_TOL[kw.get("quant")])
        outs[name] = done
    same = outs["dense bf16"] == outs["paged bf16"]
    log(f"  dense bf16 tokens == paged bf16 tokens: {same}")
    if not same:
        raise AssertionError("dense and paged bf16 servers disagree")


# --------------------------------------------------------------------------
# Phase 5: four chips


def phase_mesh(sz, rehearse):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from flashattn_tpu.models import llama, train

    cfg = model_config(sz, rehearse)
    devs = jax.devices()
    assert len(devs) >= 4, f"--chips 4 needs 4 devices, found {len(devs)}"
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tc = train.TrainConfig(learning_rate=1e-3, warmup_steps=0,
                           total_steps=100)
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (sz.train_b, sz.train_s + 1), 0,
                                cfg.vocab_size, jnp.int32)
    log(f"  LLAMA_1B width, depth {cfg.num_layers}, B={sz.train_b} "
        f"S={sz.train_s}; mesh (data 1, model 2, sp 2) vs one device")

    one = jax.device_put((train.init_train_state(params, tc), tokens),
                         devs[0])
    step1 = compiled(functools.partial(train.train_step, cfg=cfg, tc=tc),
                     *one, label="train_step 1 device")
    _, m1 = step1(*one)

    mesh = Mesh(np.array(devs[:4]).reshape(1, 2, 2), ("data", "model", "sp"))
    shard = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), llama.param_shardings(cfg),
        is_leaf=lambda x: isinstance(x, P))
    params_s = jax.device_put(params, shard)
    state_s = train.init_train_state(params_s, tc)
    tokens_s = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
    step4 = compiled(functools.partial(train.train_step, cfg=cfg, tc=tc,
                                       mesh=mesh),
                     state_s, tokens_s, label="train_step 4-device mesh")
    _, m4 = step4(state_s, tokens_s)
    l1, l4 = float(m1["loss"]), float(m4["loss"])
    g1, g4 = float(m1["grad_norm"]), float(m4["grad_norm"])
    log(f"  1 device: loss={l1:.5f} grad_norm={g1:.4f}; mesh: "
        f"loss={l4:.5f} grad_norm={g4:.4f}")
    check_abs("mesh vs 1-device loss |diff|", abs(l1 - l4), MESH_LOSS_TOL)
    check_abs("mesh vs 1-device grad_norm rel diff", abs(g1 - g4) / g1,
              MESH_GNORM_RTOL)
    timed("train_step 1 device", step1, *one, reps=5, chain=False)
    timed("train_step 4-device mesh", step4, state_s, tokens_s, reps=5,
          chain=False)


# --------------------------------------------------------------------------


def card_line(rehearse):
    if rehearse:
        return "nvidia-smi: none (CPU rehearsal)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return "card: " + "; ".join(x.strip() for x in out.splitlines()
                                if x.strip())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU run at tiny sizes (kernels interpreted); "
                         "checks control flow only, measures nothing")
    args = ap.parse_args(argv)

    if args.rehearse:
        import os

        os.environ.setdefault(
            "XLA_FLAGS", "--xla_force_host_platform_device_count=4")
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax

    from flashattn_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU; JAX found platform "
              f"{dev.platform!r}", file=sys.stderr)
        return 2
    log(f"compile cache: {enable_compile_cache()}")
    log(card_line(args.rehearse))
    log(f"jax {jax.__version__}; devices: {len(jax.devices())} x "
        f"{dev.device_kind} ({dev.platform})")
    sz = TINY if args.rehearse else FULL
    t0 = time.perf_counter()
    if args.chips == 4:
        with Phase("phase 5: train step on 4 devices"):
            phase_mesh(sz, args.rehearse)
        count = 4
    else:
        with Phase("phase 1: attention kernels"):
            phase_attention(sz, args.rehearse)
        with Phase("phase 2: decode and quantized matmul"):
            phase_decode(sz, args.rehearse)
        with Phase("phase 3: train"):
            phase_train(sz, args.rehearse)
        with Phase("phase 4: serve"):
            phase_serve(sz, args.rehearse)
        count = len(jax.devices())
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
