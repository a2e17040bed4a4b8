"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version for a CPU tensor and, for a
CUDA tensor, launches its kernel (built from `csrc/` on first use) or
raises. `launch_counts()` / `reset_launch_counts()` read and clear the
per-wrapper counters of kernel launches."""

from __future__ import annotations

from typing import Dict


def _wrappers():
    from eventgrad_tpu_torch.ops import attention
    from eventgrad_tpu_torch.ops.arena_update import (
        fused_mix_commit, fused_mix_commit_carrier,
    )
    from eventgrad_tpu_torch.ops.event_engine import (
        masked_wire, masked_wire_int8,
    )
    from eventgrad_tpu_torch.ops.fused_update import fused_mix_sgd

    return {
        "masked_wire": masked_wire,
        "masked_wire_int8": masked_wire_int8,
        "fused_mix_commit": fused_mix_commit,
        "fused_mix_sgd": fused_mix_sgd,
        "fused_mix_commit_carrier": fused_mix_commit_carrier,
        "flash_fwd": attention.flash_fwd,
        "flash_dq": attention.flash_dq,
        "flash_dkv": attention.flash_dkv,
    }


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
