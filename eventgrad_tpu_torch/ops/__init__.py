"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper takes the plain version for a CPU tensor and, for a
CUDA tensor, launches its kernel (built from `csrc/` on first use) or
raises. `launch_counts()` / `reset_launch_counts()` read and clear the
per-wrapper counters of kernel launches (a gated launch counts in its
kernel, and again under `<kernel>_gated`; a gated launch of a pitched
(bucket) form also under `<kernel>_pitched_gated`; the flash wrappers
also count by form, `attention.form_counts()`, cleared with the
rest)."""

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


#: the kernels with a gated form (chaos and integrity on the fused tail),
#: whose gated launches count again under "<name>_gated"
GATED = ("fused_mix_commit", "fused_mix_sgd", "fused_mix_commit_carrier")
#: the kernels whose pitched (bucket) form also has a gated form (the
#: bucketed schedule under the fault clauses), counted again under
#: "<name>_pitched_gated"
PITCHED_GATED = ("fused_mix_commit", "fused_mix_commit_carrier")


def launch_counts() -> Dict[str, int]:
    """{kernel: launches}, {"<kernel>_gated": its gated launches} for
    the kernels of `GATED`, and {"<kernel>_pitched_gated": the gated
    launches of its pitched form} for those of `PITCHED_GATED`."""
    wr = _wrappers()
    out = {name: fn.launches for name, fn in wr.items()}
    out.update({f"{name}_gated": wr[name].gated_launches for name in GATED})
    out.update({f"{name}_pitched_gated": wr[name].pitched_gated_launches
                for name in PITCHED_GATED})
    return out


def reset_launch_counts() -> None:
    wr = _wrappers()
    for fn in wr.values():
        fn.launches = 0
        if hasattr(fn, "forms"):
            fn.forms = dict.fromkeys(fn.forms, 0)
    for name in GATED:
        wr[name].gated_launches = 0
    for name in PITCHED_GATED:
        wr[name].pitched_gated_launches = 0
