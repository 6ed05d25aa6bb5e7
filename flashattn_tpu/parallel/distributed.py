"""Multi-host runtime initialization + cluster mesh construction (SURVEY.md
T9).

The reference has no distributed backend at all (SURVEY.md §5); here it is
not a comms library but the JAX runtime itself: ``jax.distributed.initialize``
wires the hosts, GSPMD + shard_map emit the collectives (XLA hands them to
NCCL), and the MESH LAYOUT decides which axis stays on one host's NVLink
(every card of the host reaches every other at the same rate) and which
crosses the network between hosts (slower).

Rules encoded here (How-to-Scale-Your-Model recipe):
  - Axes that carry heavy collectives (tensor/sequence parallel: all-gather,
    reduce-scatter, ppermute rings) stay INSIDE one host's device block.
  - Axes with rare/light collectives (data parallel: one psum of grads per
    step) cross hosts — put them OUTERMOST so each host's devices stay
    contiguous in the inner axes.
"""

from __future__ import annotations

import logging
import os

import jax
import numpy as np
from jax.sharding import Mesh

logger = logging.getLogger(__name__)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Wire up the multi-host JAX runtime (idempotent; no-op single-host).

    Under a cluster manager JAX can detect the three arguments; elsewhere
    pass them (or set JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID). Without either, the run stays single-process.
    """
    explicit = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    # NOTE: jax.process_count() would force XLA backend init, which must not
    # happen before jax.distributed.initialize — probe the runtime state.
    if jax.distributed.is_initialized():
        return  # already initialized
    if explicit is None and num_processes is None:
        try:
            jax.distributed.initialize()  # cluster autodetection
        except Exception as e:
            # Autodetection fails on single-process runs — that is the
            # normal local path, but say so: a REAL cluster misconfiguration
            # (firewalled coordinator) lands here too, and a silent
            # fallback would train single-host at 1/N throughput.
            logger.info(
                "jax.distributed.initialize() autodetection unavailable "
                "(%s: %s) — continuing single-process. If this IS a "
                "multi-host run, pass coordinator_address/num_processes/"
                "process_id or set JAX_COORDINATOR_ADDRESS.",
                type(e).__name__, e)
        return
    jax.distributed.initialize(
        coordinator_address=explicit,
        num_processes=num_processes
        or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=process_id or int(os.environ.get("JAX_PROCESS_ID", "0")),
    )


def pod_mesh(
    data: int | None = None,
    model: int = 1,
    sp: int = 1,
    devices=None,
) -> Mesh:
    """Build a (data, model, sp) mesh with host-boundary-safe axis placement.

    `data` defaults to whatever is left after model*sp. Device order from
    jax.devices() is host-major, so making `data` the OUTERMOST mesh axis
    puts the host boundary (the network between hosts) on the data axis,
    while model/sp — which run all-gathers and ppermute rings every layer —
    stay on one host's NVLink. Asserts model*sp fits within one process's
    devices for exactly that reason.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    inner = model * sp
    if data is None:
        assert n % inner == 0, (n, model, sp)
        data = n // inner
    assert data * inner == n, f"{data}*{model}*{sp} != {n} devices"
    per_proc = n // max(jax.process_count(), 1)
    assert inner <= per_proc or jax.process_count() == 1, (
        f"model*sp={inner} spans hosts (per-host devices={per_proc}); "
        "ring/TP collectives would cross hosts — reshape the mesh"
    )
    grid = np.array(devices).reshape(data, model, sp)
    return Mesh(grid, ("data", "model", "sp"))
