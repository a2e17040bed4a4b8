"""Flat-arena event engine: the sender pass and the masked-wire builder.

Port of `eventgrad_tpu/ops/event_engine.py`: `event_propose_pack` (the
sender pass: trigger, then on the compact wire the capacity gate and the
pack), `masked_wire` and its plain version `masked_wire_reference`. The
gate and the pack are plain PyTorch, as in the JAX package, where they
are jnp outside any Pallas kernel. Without
scales `masked_wire` launches the CUDA kernel `csrc/masked_wire.cu`
(replacing the TPU kernel `_mask_kernel`); with scales it is
`masked_wire_int8`, the CUDA kernel `csrc/mask_quant.cu` (replacing
`_mask_quant_kernel`). Each is a dispatcher operator (`eg::masked_wire`,
`eg::masked_wire_int8`): the plain version is its CPU implementation and
the launch its CUDA one, so a traced step shows the kernel as one node.
Each wrapper counts its own launches. With `off=` each builds one bucket
of the bucketed schedule through its kernel's pitched form
(`eg::masked_wire_bucket`, `eg::masked_wire_int8_bucket`), reading the
bucket's columns of the parameter arena in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from eventgrad_tpu_torch.ops import build
from eventgrad_tpu_torch.parallel.arena import ArenaSpec
from eventgrad_tpu_torch.parallel.collectives import _compact_pack
from eventgrad_tpu_torch.parallel.events import (
    EventConfig, EventProposal, EventState, capacity_gate, propose,
)


def event_propose_pack(
    flat: torch.Tensor,
    state: EventState,
    pass_num: int,
    cfg: EventConfig,
    spec: ArenaSpec,
    capacity: Optional[int] = None,
    force_fire: Optional[torch.Tensor] = None,
    suppress_fire: Optional[torch.Tensor] = None,
) -> Tuple[EventProposal, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """The sender side of one event pass on the parameter arena: trigger
    -> suppress -> gate -> pack.

    `force_fire` (bool, broadcast to `[R, L]`) ORs into the trigger;
    `suppress_fire` then clears fire bits before the gate and the pack
    (it wins over force and over the silence bound), and the suppressed
    leaves, never committed, re-contend next pass. Returns (proposal,
    effective fire bits, packed wire buffer, per-position leaf ids). With
    `capacity=None` (dense/masked wires) the pack outputs are None; with
    a compact capacity the bits are the `capacity_gate`d subset
    (max_silence-overdue and forced leaves claim budget first) and
    `packed` holds the admitted leaves' elements (`_compact_pack`)."""
    prop = propose(flat, state, pass_num, cfg, spec, force_fire=force_fire)
    fire_vec = prop.fire_vec
    if suppress_fire is not None:
        fire_vec = fire_vec & ~torch.broadcast_to(suppress_fire,
                                                  fire_vec.shape)
    packed = leaf_id = None
    if capacity is not None:
        pri = None
        if cfg.max_silence > 0:
            pri = prop.iter_diff >= float(cfg.max_silence)
        if force_fire is not None:
            ff = torch.broadcast_to(force_fire, fire_vec.shape)
            pri = ff if pri is None else (pri | ff)
        fire_vec = capacity_gate(fire_vec, spec.sizes_tensor(flat.device),
                                 int(capacity), priority=pri)
        packed, leaf_id = _compact_pack(flat, fire_vec, spec, int(capacity))
    return prop, fire_vec, packed, leaf_id


def masked_wire_reference(
    flat: torch.Tensor,
    fire_exp: torch.Tensor,
    scale_exp: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of `masked_wire`: where(fire > 0, flat, 0),
    and with `scale_exp` clip(round_half_even(masked / scale), -127, 127)
    in f32 (the int8 cast happens at the ship site)."""
    zero = torch.zeros((), dtype=flat.dtype, device=flat.device)
    masked = torch.where(fire_exp > 0, flat, zero)
    if scale_exp is None:
        return masked
    return torch.clamp(torch.round(masked / scale_exp), -127, 127)


def _check_masked(op, flat, fire_exp, scale_exp=None):
    named = {"flat": flat, "fire_exp": fire_exp}
    if scale_exp is not None:
        named["scale_exp"] = scale_exp
    return build.check_inputs(op, **named)


@torch.library.custom_op("eg::masked_wire", mutates_args=(),
                         device_types="cpu")
def _masked_wire_op(flat: torch.Tensor, fire_exp: torch.Tensor) -> torch.Tensor:
    _check_masked("masked_wire", flat, fire_exp)
    return masked_wire_reference(flat, fire_exp)


@_masked_wire_op.register_kernel("cuda")
def _masked_wire_cuda(flat, fire_exp):
    device, n = _check_masked("masked_wire", flat, fire_exp)
    out = torch.empty_like(flat)
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "masked_wire", lib.eg_masked_wire,
            flat.data_ptr(), fire_exp.data_ptr(), out.data_ptr(), n,
            build.aligned(flat, fire_exp, out), build.stream_of(device),
        )
    masked_wire.launches += 1
    return out


@_masked_wire_op.register_fake
def _masked_wire_fake(flat, fire_exp):
    return torch.empty_like(flat)


@torch.library.custom_op("eg::masked_wire_int8", mutates_args=(),
                         device_types="cpu")
def _masked_wire_int8_op(flat: torch.Tensor, fire_exp: torch.Tensor,
                         scale_exp: torch.Tensor) -> torch.Tensor:
    _check_masked("masked_wire_int8", flat, fire_exp, scale_exp)
    return masked_wire_reference(flat, fire_exp, scale_exp)


@_masked_wire_int8_op.register_kernel("cuda")
def _masked_wire_int8_cuda(flat, fire_exp, scale_exp):
    device, n = _check_masked("masked_wire_int8", flat, fire_exp, scale_exp)
    out = torch.empty_like(flat)
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "masked_wire_int8", lib.eg_mask_quant,
            flat.data_ptr(), fire_exp.data_ptr(), scale_exp.data_ptr(),
            out.data_ptr(), n, build.aligned(flat, fire_exp, scale_exp, out),
            build.stream_of(device),
        )
    masked_wire_int8.launches += 1
    return out


@_masked_wire_int8_op.register_fake
def _masked_wire_int8_fake(flat, fire_exp, scale_exp):
    return torch.empty_like(flat)


def _check_masked_bucket(op, flat, fire_exp, off, scale_exp=None):
    bucket = {"fire_exp": fire_exp}
    if scale_exp is not None:
        bucket["scale_exp"] = scale_exp
    return build.check_bucket(op, {"flat": flat}, bucket, off)


def _bucket_view(flat: torch.Tensor, off: int, cols: int) -> torch.Tensor:
    """The bucket's columns `[off, off + cols)` of an `[R, n]` arena (a
    strided view once R > 1)."""
    return flat[:, off:off + cols]


@torch.library.custom_op("eg::masked_wire_bucket", mutates_args=(),
                         device_types="cpu")
def _masked_wire_bucket_op(flat: torch.Tensor, fire_exp: torch.Tensor,
                           off: int) -> torch.Tensor:
    _check_masked_bucket("masked_wire_bucket", flat, fire_exp, off)
    return masked_wire_reference(
        _bucket_view(flat, off, fire_exp.shape[1]), fire_exp)


@_masked_wire_bucket_op.register_kernel("cuda")
def _masked_wire_bucket_cuda(flat, fire_exp, off):
    device, rows, cols, ld = _check_masked_bucket("masked_wire_bucket", flat,
                                                  fire_exp, off)
    out = torch.empty_like(fire_exp)
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "masked_wire_bucket", lib.eg_masked_wire_pitched,
            flat.data_ptr(), fire_exp.data_ptr(), out.data_ptr(), rows, cols,
            ld, int(off), build.aligned(flat, fire_exp, out),
            build.stream_of(device),
        )
    masked_wire.launches += 1
    return out


@_masked_wire_bucket_op.register_fake
def _masked_wire_bucket_fake(flat, fire_exp, off):
    return torch.empty_like(fire_exp)


@torch.library.custom_op("eg::masked_wire_int8_bucket", mutates_args=(),
                         device_types="cpu")
def _masked_wire_int8_bucket_op(flat: torch.Tensor, fire_exp: torch.Tensor,
                                scale_exp: torch.Tensor,
                                off: int) -> torch.Tensor:
    _check_masked_bucket("masked_wire_int8_bucket", flat, fire_exp, off,
                         scale_exp)
    return masked_wire_reference(
        _bucket_view(flat, off, fire_exp.shape[1]), fire_exp, scale_exp)


@_masked_wire_int8_bucket_op.register_kernel("cuda")
def _masked_wire_int8_bucket_cuda(flat, fire_exp, scale_exp, off):
    device, rows, cols, ld = _check_masked_bucket(
        "masked_wire_int8_bucket", flat, fire_exp, off, scale_exp)
    out = torch.empty_like(fire_exp)
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "masked_wire_int8_bucket", lib.eg_mask_quant_pitched,
            flat.data_ptr(), fire_exp.data_ptr(), scale_exp.data_ptr(),
            out.data_ptr(), rows, cols, ld, int(off),
            build.aligned(flat, fire_exp, scale_exp, out),
            build.stream_of(device),
        )
    masked_wire_int8.launches += 1
    return out


@_masked_wire_int8_bucket_op.register_fake
def _masked_wire_int8_bucket_fake(flat, fire_exp, scale_exp, off):
    return torch.empty_like(fire_exp)


def masked_wire(
    flat: torch.Tensor,
    fire_exp: torch.Tensor,
    scale_exp: Optional[torch.Tensor] = None,
    off: Optional[int] = None,
) -> torch.Tensor:
    """Build the masked wire buffer in one pass: zero the non-fired
    positions (`fire_exp` = f32 per-position fire bits, fire_vec[seg]),
    quantizing against the f32 per-position `scale_exp` in the same pass
    when it is given (`masked_wire_int8`). The operator `eg::masked_wire`:
    on a CPU tensor `masked_wire_reference`, on a CUDA tensor a launch of
    `csrc/masked_wire.cu` (or an error).

    With `off` it is the pitched form over one bucket of the bucketed
    schedule (`eg::masked_wire_bucket`): `flat` is the whole `[R, n]`
    arena, read in place at the columns `[off, off + c)`, and `fire_exp`
    (and `scale_exp`) are the bucket's `[R, c]` arrays; the wire comes
    back `[R, c]`, bitwise the same columns of the contiguous form's."""
    if scale_exp is not None:
        return masked_wire_int8(flat, fire_exp, scale_exp, off)
    if off is not None:
        return _masked_wire_bucket_op(flat, fire_exp, int(off))
    return _masked_wire_op(flat, fire_exp)


def masked_wire_int8(
    flat: torch.Tensor,
    fire_exp: torch.Tensor,
    scale_exp: torch.Tensor,
    off: Optional[int] = None,
) -> torch.Tensor:
    """The int8 masked wire in one pass, as f32 values in [-127, 127]:
    clip(round_half_even(where(fire > 0, flat, 0) / scale), -127, 127).
    The operator `eg::masked_wire_int8`: on a CPU tensor
    `masked_wire_reference`, on a CUDA tensor a launch of
    `csrc/mask_quant.cu` (or an error). With `off`, the pitched form
    over one bucket (`eg::masked_wire_int8_bucket`, as `masked_wire`)."""
    if off is not None:
        return _masked_wire_int8_bucket_op(flat, fire_exp, scale_exp,
                                           int(off))
    return _masked_wire_int8_op(flat, fire_exp, scale_exp)


masked_wire.launches = 0
masked_wire_int8.launches = 0
