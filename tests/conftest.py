"""Test configuration: run everything on the CPU backend with 8 virtual
devices so kernel logic (Pallas interpret mode) and multi-device sharding
(mesh over virtual devices) are testable without a GPU (SURVEY.md §4).
On-card checks are `chip_smoke.py` phases, not tests.

Must configure the platform before any JAX backend initialization; the
jax.config update wins over a JAX_PLATFORMS set in the environment.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _check_cpu_devices():
    assert jax.default_backend() == "cpu"
    assert jax.device_count() == 8, jax.devices()


# The full suite compiles thousands of unique-shape XLA CPU executables in
# one process; the accumulated JIT code mappings eventually segfault LLVM
# mid-compile (reproduced twice at the same test, vanishes for any subset
# of the suite). Dropping the compiled-executable references periodically
# keeps the process well under the mapping ceiling; per-file granularity
# keeps the recompile cost negligible (tests rarely share shapes across
# files anyway).
_last_file = [None]


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_file(request):
    fname = getattr(request.node, "fspath", None)
    if _last_file[0] is not None and fname != _last_file[0]:
        jax.clear_caches()
    _last_file[0] = fname
    yield


# Smoke tier: one or two fast tests per subsystem so `pytest -m smoke`
# gives a cross-cutting sanity pass in minutes on the CPU backend (the full
# suite runs ~35 min+ and cannot fit a short iteration loop). Curated here
# (substring match on nodeid) rather than scattered across 30 files.
_SMOKE = [
    "test_reference.py::test_lse_matches_logsumexp",
    "test_verify.py",
    "test_flash_fwd.py::test_fwd_matches_oracle[256-256-True]",
    "test_flash_fwd.py::test_fwd_matches_oracle[200-200-True]",
    "test_flash_fwd.py::test_fwd_gqa_mqa[4-2]",
    "test_flash_bwd.py::test_bwd_square[True]",
    "test_bwd_blocks.py::test_bwd_blocks_variants[gqa-kw0]",
    "test_decode.py::test_decode_matches_oracle_ragged[int8]",
    "test_varlen.py::test_varlen_forward_vs_unpacked[True]",
    "test_window.py::test_window_forward[300]",
    "test_softcap.py::test_softcap_forward[30.0-True]",
    "test_alibi.py::test_alibi_forward[True]",
    "test_dropout.py::test_dropout_keep_fraction",
    "test_sampling.py::test_temperature_zero_is_greedy",
    "test_quant_matmul.py::test_kernel_matches_dequant_oracle[8]",
    "test_serve.py::test_single_request_matches_generate",
    "test_model.py::test_forward_shapes",
    "test_paged.py::test_paged_matches_dense_single[int8]",
    "test_triton_lowering.py::test_fwd_and_bwd_lower_to_triton[gqa_d64]",
    "test_autotune.py::test_lookup_block_sizes_resolves_cache_then_defaults",
    "test_wavefront.py",
    "test_data.py::test_batches_deterministic_resume",
]


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(s in item.nodeid for s in _SMOKE):
            item.add_marker(pytest.mark.smoke)
