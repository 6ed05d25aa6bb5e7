"""Single-device training-step benchmark: tokens/s and model FLOPs/s for
the Llama-style stack (BASELINE config 4 scale). Uses the SGD step, so the
number isolates the model's forward+backward from the optimizer. MFU is
against the published peak of the device's kind (GPU only); every row names
its device.

  python benchmarks/train_bench.py --model 1b --batch 4 --seq 2048
  python benchmarks/train_bench.py --model tiny --batch 2 --seq 128 --sweep
"""

from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from flashattn_tpu.models import llama  # noqa: E402
from flashattn_tpu.models.config import LLAMA_1B, TINY  # noqa: E402
from flashattn_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flashattn_tpu.utils.roofline import device_fields, gpu_chip  # noqa: E402
from flashattn_tpu.utils.timing import measure  # noqa: E402


def model_flops_per_token(cfg, seq: int) -> float:
    """6·N matmul FLOPs per token + attention term (fwd+bwd, standard
    approximation: 6 = 2 fwd + 4 bwd passes over the weights)."""
    n_params = (
        cfg.vocab_size * cfg.hidden_size * (1 if cfg.tie_embeddings else 2)
        + cfg.num_layers * (
            cfg.hidden_size * (cfg.num_heads + 2 * cfg.num_kv_heads)
            * cfg.head_dim
            + cfg.num_heads * cfg.head_dim * cfg.hidden_size
            + 3 * cfg.hidden_size * cfg.intermediate_size
        )
    )
    attn = cfg.num_layers * 12 * cfg.num_heads * cfg.head_dim * seq / 2
    return 6.0 * n_params + attn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="1b", choices=["1b", "tiny"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--sweep", action="store_true",
                    help="measure remat in {none,dots,full}, one JSON row "
                         "each; a row that runs out of memory is nulled "
                         "with a note")
    ap.add_argument("--remat", default="dots",
                    choices=["none", "dots", "attn", "full"],
                    help="remat policy of a single run")
    args = ap.parse_args()

    enable_compile_cache()
    cfg = LLAMA_1B if args.model == "1b" else TINY
    chip = gpu_chip()
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1),
                                (args.batch, args.seq + 1), 0,
                                cfg.vocab_size, jnp.int32)
    remat_map = {"none": False, "dots": "dots", "attn": "attn", "full": True}

    def make_step(remat):
        @jax.jit
        def step(params, tokens):
            return llama.sgd_train_step(params, tokens, cfg,
                                        remat=remat_map[remat])
        return step

    toks = args.batch * args.seq
    flops = model_flops_per_token(cfg, args.seq) * toks

    def row(remat, sec, note=None):
        rec = {
            "bench": "train_step", "model": args.model, "B": args.batch,
            "S": args.seq, "remat": remat,
            "ms_per_step": round(sec * 1e3, 1) if sec else None,
            "tokens_per_s": round(toks / sec, 1) if sec else None,
            "model_tflops": round(flops / sec / 1e12, 1) if sec else None,
            "mfu": (round(flops / sec / (chip.bf16_tflops * 1e12), 3)
                    if sec and chip is not None else None),
            **device_fields(),
        }
        if note:
            rec["note"] = note
        print(json.dumps(rec), flush=True)
        return rec

    for remat in (("none", "dots", "full") if args.sweep else (args.remat,)):
        try:
            sec = measure(make_step(remat), params, tokens, warmup=3, n1=2,
                          n2=6)
        except jax.errors.JaxRuntimeError as e:  # out of device memory
            row(remat, None, f"{type(e).__name__}: {e}"[:200])
            continue
        row(remat, sec)


if __name__ == "__main__":
    main()
