"""Failure detection + elastic recovery for training (SURVEY.md §5 — the
reference has nothing here; its only failure story is documented OOM
behavior, ``Phase_1.md:166-171``).

Failure model (what actually goes wrong on multi-device jobs):

- **Numeric blowup** — a bad batch / lr spike drives the loss non-finite.
  Detected synchronously per step; recovery = restore the last checkpoint
  and SKIP the offending batch (replaying it would fail identically).
- **Runtime faults** — XLA/PJRT raises (device lost, interconnect error,
  preemption). Same restore-and-continue path; bounded retries so a truly
  dead chip fails fast instead of thrashing.
- **Hangs / slowdowns** — a deadlocked collective never returns, so no
  in-process code runs after it; true hang recovery REQUIRES process-level
  supervision (restart the job; Orbax resume picks up the checkpoint —
  ``models/train.py`` restores automatically). What CAN be detected
  in-process: persistent step-time degradation (`StepTimer`) and dead peers
  before committing to a long program (`probe_collectives`, a tiny timed
  psum on a side thread — the thread stays parked on a hung collective
  while the caller moves on to fail fast).

``resilient_train`` packages the loop: checkpoint every N steps, detect,
restore, skip, and record every recovery event for observability.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from pathlib import Path
from typing import Callable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

logger = logging.getLogger(__name__)


class TrainingFailure(RuntimeError):
    """A detected training fault. kind: 'nonfinite' | 'timeout' | 'runtime'."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"[{kind}] {message}")
        self.kind = kind


def check_finite(metrics: dict, step: int) -> None:
    """Raise TrainingFailure('nonfinite') if any scalar metric is non-finite.

    Costs one host sync per checked step — call it at the logging cadence,
    not necessarily every step, if that sync shows up in the profile.
    """
    for name, val in metrics.items():
        v = float(val)
        if not np.isfinite(v):
            raise TrainingFailure(
                "nonfinite", f"{name}={v} at step {step}")


class StepTimer:
    """Detects persistent step-time degradation (in-process hang detection
    is impossible past a blocked collective — see module docstring).

    Flags a failure when `patience` consecutive steps each exceed
    `factor` x the calibrated baseline (median of the first `calibrate`
    steps). One-off stragglers (checkpoint writes, recompiles) don't trip it.
    """

    def __init__(self, factor: float = 10.0, calibrate: int = 5,
                 patience: int = 3):
        self.factor = factor
        self.calibrate = calibrate
        self.patience = patience
        self._samples: list[float] = []
        self._slow = 0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        assert self._t0 is not None, "stop() without start()"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if len(self._samples) < self.calibrate:
            self._samples.append(dt)
            return dt
        baseline = float(np.median(self._samples))
        if dt > self.factor * baseline:
            self._slow += 1
            if self._slow >= self.patience:
                raise TrainingFailure(
                    "timeout",
                    f"{self._slow} consecutive steps > {self.factor:.0f}x "
                    f"baseline ({dt:.3f}s vs {baseline:.3f}s) at step {step}")
        else:
            self._slow = 0
        return dt


def probe_collectives(mesh, timeout_s: float = 60.0) -> bool:
    """Fail-fast health probe: one tiny all-device psum with a deadline.

    Run before committing to a long compiled program (startup, resume): a
    dead/partitioned peer hangs the collective, and THIS thread — not the
    training loop — is the one that parks on it. Returns False on timeout
    or error.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    result: dict = {}

    def _probe():
        try:
            x = jax.device_put(
                jnp.arange(mesh.devices.size, dtype=jnp.float32).reshape(
                    mesh.devices.shape),
                NamedSharding(mesh, P(*mesh.axis_names)))
            total = jax.jit(
                jnp.sum, out_shardings=NamedSharding(mesh, P()))(x)
            result["ok"] = bool(np.isfinite(float(total)))
        except Exception as e:  # noqa: BLE001 — any fault = unhealthy
            logger.warning("collective probe failed: %s", e)
            result["ok"] = False

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        logger.error("collective probe hung > %.1fs (dead peer?)", timeout_s)
        return False
    return result.get("ok", False)


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    kind: str
    message: str
    restored_step: int


def resilient_train(
    state: dict,
    data: Iterator[jnp.ndarray],
    step_fn: Callable[[dict, jnp.ndarray], tuple[dict, dict]],
    steps: int,
    ckpt_dir: str | Path,
    ckpt_every: int = 100,
    max_recoveries: int = 3,
    step_timer: StepTimer | None = None,
    check_every: int = 1,
) -> tuple[dict, list[RecoveryEvent]]:
    """Checkpointed training loop with detect-restore-skip recovery.

    On TrainingFailure (non-finite metrics, step-time blowup) or an XLA
    runtime error, the loop restores the latest checkpoint and CONTINUES
    with the NEXT batch — the failing batch is consumed and skipped
    (replaying a NaN batch fails identically; event recorded). After
    `max_recoveries` restores the failure is re-raised: persistent faults
    need operator/a scheduler attention, not thrash.

    Process death (preemption, hard hang + external supervisor restart) is
    covered by the same checkpoints: re-running resumes from the latest
    step automatically (``models.train.restore_checkpoint``).
    """
    from flashattn_tpu.models.train import restore_checkpoint, save_checkpoint

    ckpt_dir = Path(ckpt_dir)
    events: list[RecoveryEvent] = []
    # Baseline checkpoint so step-0 failures have something to restore.
    save_checkpoint(ckpt_dir, state)
    target = int(state["step"]) + steps
    while int(state["step"]) < target:
        batch = next(data)
        try:
            if step_timer is not None:
                step_timer.start()
            new_state, metrics = step_fn(state, batch)
            step = int(new_state["step"])
            if step % check_every == 0:
                # check_finite syncs the host on the step's metrics — raise
                # check_every if the sync shows in the profile (a
                # blowup is then detected within check_every steps, still
                # before the next checkpoint when check_every <= ckpt_every).
                check_finite(metrics, step)
            if step_timer is not None:
                step_timer.stop(step)
        except (TrainingFailure, jax.errors.JaxRuntimeError) as e:
            kind = e.kind if isinstance(e, TrainingFailure) else "runtime"
            if len(events) >= max_recoveries:
                raise
            restored = restore_checkpoint(ckpt_dir, state)
            events.append(RecoveryEvent(
                step=int(state["step"]), kind=kind, message=str(e),
                restored_step=int(restored["step"])))
            logger.warning(
                "recovered from %s at step %s -> restored step %s "
                "(skipping the failing batch)",
                kind, int(state["step"]), int(restored["step"]))
            state = restored
            continue
        state = new_state
        if step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state)
    save_checkpoint(ckpt_dir, state)
    return state, events
