"""The device rule of the port's entry points.

`device=None` means the card: CUDA, and an error when CUDA is absent —
a run never drops to the CPU without being asked. The CPU is a device
the caller names (`device="cpu"`), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by "
                "default; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
