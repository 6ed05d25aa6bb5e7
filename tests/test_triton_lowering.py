"""The attention kernels lower to Triton IR for the GPU.

Interpret mode (the rest of the suite) checks the kernels' arithmetic; it
does not check that every primitive they use has a Triton lowering rule.
Exporting for the 'cuda' platform runs that lowering on the CPU: the
kernel bodies become Triton IR inside `__gpu$xla.gpu.triton` custom calls.
What it cannot show is what the Triton compiler then says about the card
(shared memory, registers): that is `chip_smoke.py`'s first phase.
"""

import jax
import jax.numpy as jnp
import pytest
from jax import export

from flashattn_tpu.ops.common import BlockSizes
from flashattn_tpu.ops.flash_bwd import flash_attention_backward
from flashattn_tpu.ops.flash_fwd import flash_attention_forward

TRITON = "__gpu$xla.gpu.triton"


def lower_for_cuda(fn, *args) -> str:
    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(TRITON)],
    )(*args)
    return exp.mlir_module()


CASES = {
    "causal_d128": dict(hq=8, hkv=8, s=512, d=128),
    "gqa_d64": dict(hq=8, hkv=2, s=512, d=64),
    "noncausal_ragged": dict(causal=False, s=300),
    "window": dict(window=100),
    "softcap": dict(logit_softcap=30.0),
    "alibi_12_heads": dict(hq=12, hkv=4, alibi=True),
    "dropout": dict(dropout_rate=0.1, dropout_seed=3),
    "pos_offset": dict(pos_offset=128),
    "dyn_pos_offset": dict(causal=False, window=600,
                           dyn_pos_offset=jnp.int32(512)),
    "segments": dict(b=2, s=384, segments=True),
    "odd_head_dim": dict(d=80, s=256),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fwd_and_bwd_lower_to_triton(case):
    kw = dict(CASES[case])
    b, hq, hkv = kw.pop("b", 1), kw.pop("hq", 4), kw.pop("hkv", 4)
    s, d = kw.pop("s", 512), kw.pop("d", 64)
    causal = kw.pop("causal", True)
    if kw.pop("segments", False):
        seg = (jnp.arange(s) // 100)[None].repeat(b, 0).astype(jnp.int32)
        kw["segment_ids"] = (seg, seg)
    q = jnp.zeros((b, hq, s, d), jnp.bfloat16)
    k = jnp.zeros((b, hkv, s, d), jnp.bfloat16)
    lse = jnp.zeros((b, hq, s), jnp.float32)
    bs = BlockSizes()
    fwd = lower_for_cuda(
        lambda q, k, v: flash_attention_forward(
            q, k, v, is_causal=causal, block_sizes=bs, interpret=False,
            **kw), q, k, k)
    bwd = lower_for_cuda(
        lambda q, k, v, o, do, lse: flash_attention_backward(
            q, k, v, o, do, lse, is_causal=causal, block_sizes=bs,
            interpret=False, **kw), q, k, k, q, q, lse)
    assert fwd.count(TRITON) == 1 and 'name = "flash_fwd"' in fwd
    assert bwd.count(TRITON) == 2
    assert 'name = "flash_bwd_dq"' in bwd and 'name = "flash_bwd_dkv"' in bwd
