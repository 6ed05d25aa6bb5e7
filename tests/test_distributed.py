"""Tests for the multi-host runtime helpers (SURVEY.md T9) on the
8-virtual-device CPU backend."""

import jax
import numpy as np
import pytest

from flashattn_tpu.parallel.distributed import initialize_distributed, pod_mesh


def test_initialize_is_idempotent_single_host():
    initialize_distributed()
    initialize_distributed()
    assert jax.process_count() == 1


def test_pod_mesh_shapes():
    mesh = pod_mesh(model=2, sp=2)
    assert mesh.axis_names == ("data", "model", "sp")
    assert mesh.shape == {"data": 2, "model": 2, "sp": 2}
    # data must be the OUTERMOST axis (host-major device order -> the host
    # boundary falls on it).
    grid = np.array(mesh.devices)
    assert grid.shape == (2, 2, 2)


def test_pod_mesh_defaults_data():
    mesh = pod_mesh(model=4)
    assert mesh.shape == {"data": 2, "model": 4, "sp": 1}


def test_pod_mesh_rejects_bad_factorization():
    with pytest.raises(AssertionError):
        pod_mesh(data=3, model=3, sp=1)


def test_two_process_jax_distributed():
    """REAL multi-process runtime: coordinator + worker subprocesses wire up
    via jax.distributed.initialize (the exact multi-host pod path, on the
    CPU backend), form a global 4-device mesh, and run (a) a cross-process
    psum and (b) a ring-attention whose ppermute ring crosses the process
    boundary, checked against the local oracle."""
    import socket
    import subprocess
    import sys
    import os

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "_multiproc_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=root)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-3000:]}"
        assert "MULTIPROC_OK" in out, out[-3000:]


def test_initialize_distributed_logs_fallback(caplog):
    """The single-process autodetection fallback must be LOGGED, not
    swallowed (a real pod misconfiguration lands on the same path)."""
    import logging

    from flashattn_tpu.parallel.distributed import initialize_distributed

    with caplog.at_level(logging.INFO,
                         logger="flashattn_tpu.parallel.distributed"):
        initialize_distributed()
    # Already-initialized runtimes return before the try; only assert when
    # the fallback path actually ran.
    if jax.process_count() == 1 and caplog.records:
        assert any("single-process" in r.getMessage()
                   for r in caplog.records)
