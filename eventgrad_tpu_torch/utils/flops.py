"""FLOPs accounting and MFU: the perf yardstick.

Port of `eventgrad_tpu/utils/flops.py`. MFU is the analytic FLOPs of the
step program divided by the measured step time and the chip's peak. The
JAX package takes the FLOPs from XLA's cost analysis of the compiled
step; the port has no compiler cost analysis to ask, so its FLOPs are
the cost model's (`obs.costmodel`): the ATen graph of the traced step,
counted op by op, the kernels' work from their closed forms.

`chip_peak_flops` knows the card's dense bf16 peak (the devicespec
table) and returns 0.0 on the CPU and on unknown kinds, so that `mfu()`
returns None there: an MFU against an unknown peak would be noise.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from eventgrad_tpu_torch.obs.devicespec import GPU_SPECS, TPU_SPECS

#: peak dense-matmul throughput (bf16 FLOP/s) by device-kind substring,
#: read from the one spec table (obs/devicespec.py), TPU rows first as in
#: the JAX package, then the card
PEAK_FLOPS_BY_KIND = tuple(
    (sub, spec.peak_flops) for sub, spec in TPU_SPECS + GPU_SPECS
)


def chip_peak_flops(device: Optional[Any] = None) -> float:
    """Peak bf16 FLOP/s of one card; 0.0 when unknown (the CPU, an
    unknown card), so `mfu()` stays None off the card. `device` defaults
    to the current CUDA device when there is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return 0.0
    kind = torch.cuda.get_device_name(device).lower()
    for sub, spec in GPU_SPECS:
        if sub in kind:
            return spec.peak_flops
    return 0.0


def compiled_flops(fn, *args) -> float:
    """Analytic FLOPs of one call `fn(*args)`: the cost model's
    `flops_total` of the traced call (`obs.costmodel.analyze_call`; the
    call runs once, on the arguments' device). The counterpart of the
    JAX function, which reads XLA's cost analysis; 0.0 if the call
    cannot be traced."""
    from eventgrad_tpu_torch.obs import costmodel

    try:
        return float(costmodel.analyze_call(fn, *args)["flops_total"])
    except Exception:
        return 0.0


def step_layout_kwargs(state) -> dict:
    """`make_train_step` kwargs matching the LAYOUT of `state`'s receive
    buffers: per-bucket tuples (`bucketed=K`), and carrier residency (the
    buffers' dtype names the wire). A step built for another layout
    cannot consume the state; one detector shared by `train_step_flops`
    and `obs.costmodel.analyze_step`. The port runs the flat arena only,
    so there is no `arena` key."""
    ev = getattr(state, "event", None)
    bufs = getattr(ev, "bufs", None) or ()
    if not bufs:
        return {}
    first = bufs[0]
    out = {}
    if isinstance(first, tuple):  # per-neighbour tuple of bucket buffers
        out["bucketed"] = len(first)
        first = first[0]
    wire = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(first.dtype)
    if wire is not None:
        out.update(carrier_resident=True, wire=wire)
    return out


def train_step_flops(model, topo, algo, event_cfg, x, y, per_rank: int,
                     state, **step_kwargs) -> float:
    """Analytic FLOPs of one full train step (all ranks) of the given
    algo/model at per-rank batch size: the MFU numerator. The cost
    model's `flops_total` of `analyze_step` at the same arguments (the
    step runs once)."""
    from eventgrad_tpu_torch.obs import costmodel

    return float(costmodel.analyze_step(
        model, topo, algo, event_cfg, x, y, per_rank, state,
        **step_kwargs)["flops_total"])


def mfu(flops_per_step: float, step_seconds: float,
        device: Optional[Any] = None) -> Optional[float]:
    """Model-FLOPs utilization of ONE device running `flops_per_step`
    every `step_seconds`. None when either input or the card's peak is
    unknown. The rank-stacked step runs every rank on the one card, so
    pass the TOTAL step FLOPs."""
    peak = chip_peak_flops(device)
    if not (peak and flops_per_step and step_seconds):
        return None
    return flops_per_step / (step_seconds * peak)
