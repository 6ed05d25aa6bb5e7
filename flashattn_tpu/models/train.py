"""Training loop + checkpoint/resume for the Llama-style decoder.

The reference has no training loop or checkpointing (SURVEY.md §5:
``ctx.save_for_backward`` is activation stashing, not checkpointing); this is
the training subsystem: optax AdamW with cosine schedule + grad clipping,
a jittable/pjit-able functional train step over the flash-attention model,
and Orbax for durable checkpoint/resume (async-capable, pytree-structured —
the standard JAX checkpoint layer).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Any, Iterator

import jax
import jax.numpy as jnp
import optax

from flashattn_tpu.models import llama
from flashattn_tpu.models.config import ModelConfig

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0


def make_optimizer(tc: TrainConfig) -> optax.GradientTransformation:
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=tc.learning_rate,
        warmup_steps=tc.warmup_steps,
        decay_steps=tc.total_steps,
        end_value=tc.learning_rate * 0.1,
    )
    return optax.chain(
        optax.clip_by_global_norm(tc.grad_clip),
        optax.adamw(schedule, b1=tc.b1, b2=tc.b2,
                    weight_decay=tc.weight_decay),
    )


def init_train_state(params: Params, tc: TrainConfig) -> dict:
    """State pytree: jit/shard/checkpoint as one unit."""
    return {
        "params": params,
        "opt_state": make_optimizer(tc).init(params),
        "step": jnp.zeros((), jnp.int32),
    }


@functools.partial(jax.jit, static_argnames=("cfg", "tc", "mesh"))
def train_step(
    state: dict,
    tokens: jnp.ndarray,  # [B, S+1] int32
    cfg: ModelConfig,
    tc: TrainConfig,
    mesh=None,
    segment_ids: jnp.ndarray | None = None,  # [B, S+1] packed-document ids
) -> tuple[dict, dict]:
    """One optimizer step -> (new_state, metrics). Sharding comes from the
    state/tokens placements (GSPMD); the attention island reads `mesh`."""
    loss, grads = jax.value_and_grad(llama.loss_fn)(
        state["params"], tokens, cfg, mesh, None, segment_ids
    )
    updates, new_opt = make_optimizer(tc).update(
        grads, state["opt_state"], state["params"]
    )
    new_params = optax.apply_updates(state["params"], updates)
    gnorm = optax.global_norm(grads)
    return (
        {"params": new_params, "opt_state": new_opt,
         "step": state["step"] + 1},
        {"loss": loss, "grad_norm": gnorm},
    )


# ---------------- checkpoint / resume (Orbax) ----------------


def _manager(ckpt_dir: str | Path, max_to_keep: int = 3):
    import orbax.checkpoint as ocp

    return ocp.CheckpointManager(
        Path(ckpt_dir).absolute(),
        options=ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep, create=True
        ),
    )


def save_checkpoint(ckpt_dir: str | Path, state: dict,
                    max_to_keep: int = 3) -> int:
    """Durably save the full train state; returns the step saved."""
    import orbax.checkpoint as ocp

    step = int(state["step"])
    mgr = _manager(ckpt_dir, max_to_keep)
    mgr.save(step, args=ocp.args.StandardSave(state))
    mgr.wait_until_finished()
    mgr.close()
    return step


def restore_checkpoint(ckpt_dir: str | Path, state_like: dict,
                       step: int | None = None) -> dict:
    """Restore into the structure/shardings of `state_like` (pass a state
    built with init_train_state — device placement is preserved)."""
    import orbax.checkpoint as ocp

    mgr = _manager(ckpt_dir)
    step = mgr.latest_step() if step is None else step
    assert step is not None, f"no checkpoint found in {ckpt_dir}"
    restored = mgr.restore(
        step, args=ocp.args.StandardRestore(state_like)
    )
    mgr.close()
    return restored


# ---------------- driver loop ----------------


def train(
    params: Params,
    data: Iterator[jnp.ndarray],
    cfg: ModelConfig,
    tc: TrainConfig,
    steps: int,
    mesh=None,
    ckpt_dir: str | Path | None = None,
    ckpt_every: int = 1000,
    log_every: int = 50,
) -> tuple[dict, list[dict]]:
    """Minimal synchronous training driver (resumes from ckpt_dir if it has
    a checkpoint). Returns (final_state, metric history)."""
    state = init_train_state(params, tc)
    if ckpt_dir is not None:
        import orbax.checkpoint as ocp  # noqa: F401

        mgr = _manager(ckpt_dir)
        latest = mgr.latest_step()
        mgr.close()
        if latest is not None:
            state = restore_checkpoint(ckpt_dir, state)
    history = []
    for _ in range(steps):
        batch = next(data)
        # Batches are either a [B, S+1] token array or a dict with packed
        # segment ids (models/data.PackedDataset emits the latter).
        if isinstance(batch, dict):
            tokens = jnp.asarray(batch["tokens"])
            segs = batch.get("segment_ids")
            segs = jnp.asarray(segs) if segs is not None else None
        else:
            tokens, segs = batch, None
        state, metrics = train_step(state, tokens, cfg, tc, mesh,
                                    segment_ids=segs)
        step = int(state["step"])
        if step % log_every == 0 or step == 1:
            history.append({"step": step,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"])})
        if ckpt_dir is not None and step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state)
    if ckpt_dir is not None:
        save_checkpoint(ckpt_dir, state)
    return state, history
