"""Device peak specs: the denominators of MFU and the roofline.

Port of `eventgrad_tpu/obs/devicespec.py`. One table owns (peak FLOP/s,
peak HBM bytes/s) per device kind: `utils.flops.chip_peak_flops` reads
its peaks from here, `obs.costmodel.roofline` divides its analytic
FLOP/byte counts by the same numbers, and `chip_smoke.py` takes its
kernel bounds from the same row, so the MFU, the roofline position and
the kernels' bounds can never disagree about what "peak" means.

`TPU_SPECS` is the JAX package's table, kept as data so that
`spec_for_kind` still reads records of TPU rounds. `GPU_SPECS` holds the
card the port runs on: the NVIDIA H100 SXM's published dense bf16
tensor-core rate and HBM3 bandwidth (NVIDIA data sheet, SXM part, 700 W)
— the same contract as the TPU rows, `peak_flops` being the dense bf16
matmul rate — plus the two other rates its kernels' bounds use: the
dense TF32 tensor-core rate and the float32 rate outside the tensor
cores. Every other device falls back to GENERIC_CPU, a NOMINAL spec
(`nominal=True`): a CPU "MFU" from it is a regression-tracking number,
never a hardware-utilization claim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak throughputs of one device (a single chip / a single core)."""

    name: str
    #: peak dense-matmul FLOP/s (bf16 on TPU and GPU; nominal f32 on
    #: generic-cpu)
    peak_flops: float
    #: peak main-memory bandwidth, bytes/s (HBM on TPU and GPU; DRAM on
    #: CPU)
    peak_hbm_bytes_per_s: float
    #: True = documented placeholder numbers for regression tracking,
    #: not a published hardware peak
    nominal: bool = False
    #: dense TF32 tensor-core FLOP/s (GPU rows only)
    peak_tf32_flops: Optional[float] = None
    #: float32 FLOP/s outside the tensor cores (GPU rows only)
    peak_f32_flops: Optional[float] = None

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte where the roofline's memory slope meets the compute
        ceiling: below it a kernel is bandwidth-bound, above compute-bound."""
        return self.peak_flops / self.peak_hbm_bytes_per_s


#: device-kind substring -> spec, most-specific first (the JAX package's
#: TPU rows, as data)
TPU_SPECS: Tuple[Tuple[str, DeviceSpec], ...] = (
    ("v5 lite", DeviceSpec("tpu-v5e", 197e12, 819e9)),
    ("v5litepod", DeviceSpec("tpu-v5e", 197e12, 819e9)),
    ("v5e", DeviceSpec("tpu-v5e", 197e12, 819e9)),
    ("v5p", DeviceSpec("tpu-v5p", 459e12, 2765e9)),
    ("v6 lite", DeviceSpec("tpu-v6e", 918e12, 1640e9)),
    ("v6e", DeviceSpec("tpu-v6e", 918e12, 1640e9)),
    ("v4", DeviceSpec("tpu-v4", 275e12, 1228e9)),
    ("v3", DeviceSpec("tpu-v3", 123e12, 900e9)),
    ("v2", DeviceSpec("tpu-v2", 46e12, 700e9)),
)

#: the card the port runs on: H100 SXM, NVIDIA data sheet (700 W part)
H100 = DeviceSpec("nvidia-h100-sxm", 989e12, 3.35e12,
                  peak_tf32_flops=495e12, peak_f32_flops=67e12)

#: device-name substring (lower case) -> spec, for CUDA devices
GPU_SPECS: Tuple[Tuple[str, DeviceSpec], ...] = (
    ("h100", H100),
)

#: the fallback: one nominal modern core (~50 f32 GFLOP/s, ~20 GB/s
#: effective stream bandwidth), the JAX package's placeholder numbers
GENERIC_CPU = DeviceSpec("generic-cpu", 5e10, 2e10, nominal=True)

#: the platform words a CUDA device's records carry
GPU_PLATFORMS = ("gpu", "cuda")


def spec_for_kind(platform: Optional[str], device_kind: Optional[str]) -> DeviceSpec:
    """Spec from the (platform, device kind) STRINGS a record carries, so
    a reader can assign peaks to runs made on hardware this process does
    not have: TPU kinds match `TPU_SPECS`, GPU names (platform "gpu" or
    "cuda", e.g. "NVIDIA H100 80GB HBM3") match `GPU_SPECS`; anything
    else gets GENERIC_CPU."""
    if not device_kind:
        return GENERIC_CPU
    kind = device_kind.lower()
    table = (TPU_SPECS if platform == "tpu"
             else GPU_SPECS if platform in GPU_PLATFORMS else ())
    for sub, spec in table:
        if sub in kind:
            return spec
    return GENERIC_CPU


def device_spec(device: Optional[Any] = None) -> DeviceSpec:
    """Spec of `device` (default: the current CUDA device when there is
    one, else the CPU). A CUDA device is looked up by
    `torch.cuda.get_device_name`; every other device, and an unknown
    card, gets GENERIC_CPU, recognizable by `.nominal`."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return GENERIC_CPU
    return spec_for_kind("cuda", torch.cuda.get_device_name(device))
