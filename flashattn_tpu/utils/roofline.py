"""Per-kernel roofline model: analytic memory bytes + FLOPs vs the device's
published peaks. Extends the reference's FLOPs model
(Performance_Comparison.py:98-107) with a bytes model the reference lacks.
"""

from __future__ import annotations

import dataclasses

import jax


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    bf16_tflops: float  # dense tensor-core peak, bf16 inputs
    int8_tops: float  # dense tensor-core peak, int8 inputs
    hbm_gbps: float  # device-memory bandwidth, GB/s
    hbm_gib: float


# NVIDIA H100 data sheet, SXM part, dense rates without sparsity, at the
# full 700 W power limit (a card set below it cannot hold these clocks).
H100_SXM = ChipSpec(name="H100 SXM", bf16_tflops=989.0, int8_tops=1979.0,
                    hbm_gbps=3350.0, hbm_gib=80.0)

# Keyed by jax.devices()[0].device_kind.
PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def detect_chip() -> ChipSpec:
    """The peak table entry of this device. An unknown device is an error:
    a roofline against some other device's peak would be a wrong number."""
    kind = jax.devices()[0].device_kind
    try:
        return PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {kind!r}; add it to "
            f"flashattn_tpu.utils.roofline.PEAKS with its source") from None


def device_fields() -> dict:
    """The device every printed result ran on (platform, kind, count)."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def gpu_chip() -> ChipSpec | None:
    """The peak table entry on a GPU; None elsewhere (a CPU rehearsal has
    no roofline — its times are not device times)."""
    return detect_chip() if jax.devices()[0].platform == "gpu" else None


@dataclasses.dataclass
class RooflineReport:
    flops: float
    hbm_bytes: float
    arithmetic_intensity: float  # flops/byte
    sol_seconds: float  # speed-of-light time
    compute_seconds: float
    memory_seconds: float
    bound: str  # "compute" | "memory"

    def achieved(self, seconds: float) -> dict:
        return {
            "tflops": self.flops / seconds / 1e12,
            "sol_fraction": self.sol_seconds / seconds,
            "bound": self.bound,
        }


def _report(flops, hbm, chip):
    compute_s = flops / (chip.bf16_tflops * 1e12)
    memory_s = hbm / (chip.hbm_gbps * 1e9)
    return RooflineReport(
        flops=flops,
        hbm_bytes=hbm,
        arithmetic_intensity=flops / hbm,
        sol_seconds=max(compute_s, memory_s),
        compute_seconds=compute_s,
        memory_seconds=memory_s,
        bound="compute" if compute_s >= memory_s else "memory",
    )


def attention_fwd_roofline(
    b: int, hq: int, hkv: int, s_q: int, s_k: int, d: int,
    is_causal: bool, dtype_bytes: int = 2, chip: ChipSpec | None = None,
) -> RooflineReport:
    """Speed-of-light of the forward: its FLOPs, and the bytes it cannot
    avoid — Q, K, V read once, O and the LSE written once. (K/V tiles that
    several q blocks re-read are served from L2 when the blocks of one head
    run together; the roofline takes the least traffic.)"""
    chip = chip or detect_chip()
    flops = 4.0 * b * hq * s_q * s_k * d * (0.5 if is_causal else 1.0)
    hbm = ((2 * b * hq * s_q + 2 * b * hkv * s_k) * d * dtype_bytes
           + b * hq * s_q * 4)
    return _report(flops, hbm, chip)


def attention_bwd_roofline(
    b: int, hq: int, hkv: int, s_q: int, s_k: int, d: int,
    is_causal: bool, dtype_bytes: int = 2, chip: ChipSpec | None = None,
) -> RooflineReport:
    """Speed-of-light of the dQ + dK/dV kernels: 5 matmuls over the
    S_q×S_k square (2.5× the forward's FLOPs); Q, O, dO, K, V and the row
    stats read once, dQ, dK, dV and delta written once."""
    chip = chip or detect_chip()
    flops = 2.5 * 4.0 * b * hq * s_q * s_k * d * (0.5 if is_causal else 1.0)
    hbm = ((4 * b * hq * s_q + 4 * b * hkv * s_k) * d * dtype_bytes
           + 3 * b * hq * s_q * 4)
    return _report(flops, hbm, chip)
