"""The kernel registry: how the rank dimension enters each kernel op.

Port of `eventgrad_tpu/analysis/kernels.py`. A kernel operator (an `eg::`
op, `torch.library.custom_op`) is opaque to the rank-flow analysis
(`analysis/rankflow.py`): it cannot see inside the CUDA kernel, nor the
plain version that stands for it on the CPU. Soundness needs an explicit
declaration: a kernel op may appear in the audited step only if it is
registered here, and rankflow checks every call site against the
declared layout:

  * `ARENA` — the kernel is elementwise over `[R, n]` arenas (kernels
    1-5, and the pitched forms of 1, 2, 3 and 5 over `[R, c]` buckets),
    and the gated forms' per-row operands (`[R]`, `[R, n_nb]`) are read
    at the row they describe: every rank-carrying tensor argument holds
    the rank, pure, at dimension 0, and every output (a mutated output
    argument too) carries it there;
  * `FOLDED` — the ranks are folded into the batch, rank-major (the
    flash kernels 6-8, called from the `vmap` rules of
    `ops/attention.py`, `_fold`): every rank-carrying argument holds the
    rank at dimension 0 as consecutive blocks of equal size, and every
    output carries the same blocks.

An unregistered kernel op is a violation, always, even on rank-free
arguments: a new kernel is reviewed and declared, not waved through.
Registering one is a reviewed claim: `reviewed` says why the kernel is
rank-pointwise in its declared layout (ROADMAP, "Registering a kernel").

The registry is also what the `kernel-registered` lint
(`analysis/lint.py`) checks the sources against: every `eg::` op defined
in the package and every `lib.eg_*` launch names an entry of its module,
and every entry still names a real op and launch (stale entries flag).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

#: the rank layouts a kernel op may declare
ARENA = "arena"
FOLDED = "folded"


@dataclasses.dataclass(frozen=True)
class KernelSig:
    """How one kernel op takes the rank dimension.

    `name` — the op's name in the `eg` namespace (`eg::<name>`).
    `module` — the port module defining the op, from the repo root.
    `entry` — the C entry point the op's CUDA implementation launches.
    `layout` — `ARENA` or `FOLDED` (module docstring).
    `reviewed` — one line: why the kernel is rank-pointwise there.
    `kernel` — the kernel whose launch counter the op's launches count
    in (`ops.launch_counts`): its own name, or for a pitched form the
    kernel it is a form of.
    """

    name: str
    module: str
    entry: str
    layout: str = ARENA
    reviewed: str = ""
    kernel: str = ""

    @property
    def qualname(self) -> str:
        return "eg::" + self.name

    @property
    def counter(self) -> str:
        return self.kernel or self.name


REGISTRY: Dict[str, KernelSig] = {}


def register(sig: KernelSig) -> KernelSig:
    if sig.name in REGISTRY:
        raise ValueError(f"kernel {sig.name!r} already registered")
    if sig.layout not in (ARENA, FOLDED):
        raise ValueError(f"kernel {sig.name!r}: unknown layout {sig.layout!r}")
    REGISTRY[sig.name] = sig
    return sig


_EVENTS = "eventgrad_tpu_torch/ops/event_engine.py"
_ARENA = "eventgrad_tpu_torch/ops/arena_update.py"
_ATTN = "eventgrad_tpu_torch/ops/attention.py"

for _sig in (
    KernelSig(
        "masked_wire", _EVENTS, "eg_masked_wire",
        reviewed="csrc/masked_wire.cu: out[i] = fire[i] > 0 ? flat[i] : 0 "
        "over the flat [R, n] index; no index crosses a row",
    ),
    KernelSig(
        "masked_wire_int8", _EVENTS, "eg_mask_quant",
        reviewed="csrc/mask_quant.cu: the masked select and the quantize "
        "against scale[i], element by element over [R, n]",
    ),
    KernelSig(
        "fused_mix_sgd", "eventgrad_tpu_torch/ops/fused_update.py",
        "eg_mix_sgd",
        reviewed="csrc/mix_sgd.cu: p' = (p + buf_sum) w - lr (m t + g), "
        "element i reads element i of each [R, n] input only; the gated "
        "form's w_rows[r] is read by row r's blocks only",
    ),
    KernelSig(
        "fused_mix_commit", _ARENA, "eg_mix_commit",
        reviewed="csrc/mix_commit.cu: per element, the commit select and "
        "the mix read element i of every neighbour's [R, n] buffers; the "
        "neighbours' rows arrive already rolled by the exchange; the gated "
        "form's w_rows, gate, poison, quar are read at row r only, by row "
        "r's blocks",
    ),
    KernelSig(
        "fused_mix_commit_carrier", _ARENA, "eg_mix_commit_carrier",
        reviewed="csrc/mix_commit_carrier.cu: kernel 1 on bf16/int8 "
        "carriers; the dequant multiplies element i by scale i; the gated "
        "form's w_rows and gate are read at row r only, by row r's "
        "blocks",
    ),
    # the pitched (bucket) forms of kernels 1, 2, 3 and 5: the arena
    # operands are whole [R, n] arenas read (and, for p', t', written) at
    # one bucket's columns, the bucket operands [R, c]; row r of every
    # operand is rank r's
    KernelSig(
        "masked_wire_bucket", _EVENTS, "eg_masked_wire_pitched",
        reviewed="csrc/masked_wire.cu pitched form: out[r, j] = fire[r, j] "
        "> 0 ? flat[r, off + j] : 0; row r reads row r of each operand",
        kernel="masked_wire",
    ),
    KernelSig(
        "masked_wire_int8_bucket", _EVENTS, "eg_mask_quant_pitched",
        reviewed="csrc/mask_quant.cu pitched form: the masked select and "
        "quantize of flat[r, off + j] against scale[r, j], row by row",
        kernel="masked_wire_int8",
    ),
    KernelSig(
        "fused_mix_commit_bucket", _ARENA, "eg_mix_commit_pitched",
        reviewed="csrc/mix_commit.cu pitched form: element (r, j) reads "
        "p/g/t[r, off + j] and each neighbour's [r, j], writes p'/t'[r, "
        "off + j] and the buffers' [r, j]; no index crosses a row; the "
        "gated form's w_rows, gate, poison, quar (the bucketed schedule "
        "under the fault clauses) are read at row r only, by row r's "
        "blocks",
        kernel="fused_mix_commit",
    ),
    KernelSig(
        "fused_mix_commit_carrier_bucket", _ARENA,
        "eg_mix_commit_carrier_pitched",
        reviewed="csrc/mix_commit_carrier.cu pitched form: the bucket "
        "form of kernel 5, row by row as fused_mix_commit_bucket; the "
        "gated form's w_rows and gate are read at row r only",
        kernel="fused_mix_commit_carrier",
    ),
    KernelSig(
        "flash_fwd", _ATTN, "eg_flash_fwd", FOLDED,
        reviewed="csrc/flash_fwd.cu (and its wgmma and whole forms, "
        "flash_fwd_wgmma.cu, flash_fwd_whole.cu): one block per (batch "
        "row, head, query tile); keys and values are read from the same "
        "batch row only (a TMA box spans one batch row), so ranks folded "
        "rank-major into the batch never meet",
    ),
    KernelSig(
        "flash_dq", _ATTN, "eg_flash_dq", FOLDED,
        reviewed="csrc/flash_dq.cu (and flash_dq_wgmma.cu, "
        "flash_dq_whole.cu): the same (batch row, head, tile) grid as the "
        "forward; every read stays in the block's batch row",
    ),
    KernelSig(
        "flash_dkv", _ATTN, "eg_flash_dkv", FOLDED,
        reviewed="csrc/flash_dkv.cu (and flash_dkv_wgmma.cu, "
        "flash_dkv_whole.cu): the same grid, sweeping the queries of the "
        "block's own batch row",
    ),
):
    register(_sig)


def base_name(op_name: str) -> str:
    """`eg::masked_wire` (or `eg::masked_wire.default`) -> `masked_wire`."""
    name = op_name.split("::", 1)[-1]
    return name.split(".", 1)[0]


def lookup(op_name: str) -> Optional[KernelSig]:
    """The signature of a traced `eg::` op, or None if undeclared."""
    return REGISTRY.get(base_name(op_name))


def registered_names() -> Tuple[str, ...]:
    return tuple(sorted(REGISTRY))
