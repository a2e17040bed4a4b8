"""Fused buffer-commit + gossip-mix + momentum-SGD on the flat arena.

Port of `eventgrad_tpu/ops/arena_update.py`: `fused_mix_commit` — the
CUDA kernel `csrc/mix_commit.cu`, replacing the TPU kernel
`_commit_kernel` — and its plain version `mix_commit_reference`. Per
element and per neighbor:

    buf_new_i = where(keep_i > 0, candidate_i, stale_i)   # the commit
    mixed     = (p + sum(buf_mix_*)) * w                  # gossip mix
    trace     = momentum * trace + grad                   # sgd trace
    p_new     = mixed - lr * trace                        # optimizer step

`mix_stale=True` mixes the stale buffers while committing the new ones.

The carrier-resident variant `fused_mix_commit_carrier` — the CUDA
kernel `csrc/mix_commit_carrier.cu`, replacing the TPU kernel
`_carrier_commit_kernel` — and its plain version
`mix_commit_carrier_reference` read the receive buffers in the wire
carrier (bf16, or int8 with per-position f32 dequant scales): the select
runs on the carrier, the committed buffers come back in the carrier
dtype, and the mix reads `f32(val) * mix_scale` (int8) or `f32(val)`
(bf16).

Both take the gated form's optional per-row operands (chaos and
integrity on the fused tail; kernel 5 the first two only): `w_rows` (f32
`[R]`, the mix weight 1/(1 + n_alive) of each rank, replacing
`mix_weight`), `gate` (bool `[R, n_nb]`: a closed gate takes the edge
out of the mix, which then adds +0.0), `poison` (f32 `[R]`, NaN or 1:
the factor on the update and the new trace of a poisoned rank) and
`quar` (bool `[R]`, quarantine: p' = mixed, t' = t). In optax's order:

    mixed = (p + sum(where(gate_i, buf_mix_i, 0))) * w_rows
    trace = (momentum * trace + grad) * poison
    p_new = mixed - (lr * (momentum * trace + grad)) * poison
    quar:   p_new = mixed, trace = trace_old

With every gate open, `w_rows` = float32(mix_weight) and poison 1 the
gated form is bitwise the ungated one. On a CUDA tensor it launches the
kernel's pitched body over the whole `[R, n]` arena, one grid row per
rank (the `_pitched` entry at offset 0), and counts in the kernel's
launches and in its `gated_launches`.

Both take `off=` and `out=` for one bucket of the bucketed schedule:
the pitched forms (`eg::fused_mix_commit_bucket`,
`eg::fused_mix_commit_carrier_bucket`, the same kernels' `_pitched`
entry points) read the bucket's columns of the `[R, n]` arenas in place
and write p', t' into the same columns of the output arenas. They take
the same per-row operands (the bucketed schedule under the fault
clauses): a gated bucket launch counts in its kernel's launches, its
`gated_launches` and its `pitched_gated_launches`.

The scalars enter as float32 values, as JAX's weakly typed scalars do,
so the plain versions are bitwise the JAX ones and the kernels bitwise
the plain versions. Both are dispatcher operators (`eg::fused_mix_commit`,
`eg::fused_mix_commit_carrier`): the plain version is the CPU
implementation and the launch the CUDA one.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.ops import build

Tensors = Tuple[torch.Tensor, ...]


def _f32(x: float) -> float:
    return float(np.float32(x))


def mix_commit_reference(
    p: torch.Tensor,
    cands: Tensors,
    keeps: Tensors,
    lasts: Tensors,
    g: torch.Tensor,
    t: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    mix_stale: bool = False,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    poison: Optional[torch.Tensor] = None,
    quar: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """Plain PyTorch version of `fused_mix_commit`."""
    bufs = tuple(
        torch.where(k.to(torch.float32) > 0, c, l)
        for c, k, l in zip(cands, keeps, lasts)
    )
    acc = p
    for i in range(len(bufs)):
        acc = acc + _gated(lasts[i] if mix_stale else bufs[i], gate, i)
    mixed = acc * _weight(mix_weight, w_rows)
    trace = _f32(momentum) * t + g
    return _sgd_tail(mixed, trace, t, lr, poison, quar) + (bufs,)


def _gated(v: torch.Tensor, gate: Optional[torch.Tensor], i: int):
    """Neighbour i's mix term: `v`, or `where(gate_i, v, +0.0)`."""
    if gate is None:
        return v
    return torch.where(gate[:, i:i + 1], v, torch.zeros((), dtype=v.dtype,
                                                        device=v.device))


def _weight(mix_weight: float, w_rows: Optional[torch.Tensor]):
    return _f32(mix_weight) if w_rows is None else w_rows[:, None]


def _sgd_tail(mixed, trace, t, lr, poison, quar):
    """(p', t') of optax's tail on the mixed parameters: the update
    `lr * trace` and the new trace times the poison factor, and the
    quarantined rows' p' = mixed, t' = t."""
    upd = _f32(lr) * trace
    if poison is not None:
        upd = upd * poison[:, None]
        trace = trace * poison[:, None]
    p_new = mixed - upd
    if quar is not None:
        p_new = torch.where(quar[:, None], mixed, p_new)
        trace = torch.where(quar[:, None], t, trace)
    return p_new, trace


def _check_gates(op, p, nb, w_rows=None, gate=None, poison=None, quar=None):
    """Validate the gated form's per-row operands against the `[R, n]`
    arena `p`; returns True when any is given."""
    given = {k: v for k, v in (("w_rows", w_rows), ("gate", gate),
                                ("poison", poison), ("quar", quar))
             if v is not None}
    if not given:
        return False
    if p.dim() != 2:
        raise ValueError(f"{op}: the gated form takes [R, n] arenas, got "
                         f"{tuple(p.shape)}")
    rows = p.shape[0]
    want = {"w_rows": ((rows,), torch.float32),
            "gate": ((rows, nb), torch.bool),
            "poison": ((rows,), torch.float32),
            "quar": ((rows,), torch.bool)}
    for name, x in given.items():
        shape, dt = want[name]
        if tuple(x.shape) != shape or x.dtype != dt:
            raise ValueError(f"{op}: {name} must be {dt} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != p.device or not x.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous on "
                             f"{p.device}")
    return True


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _ptrs(ts: Tensors):
    return (ctypes.c_void_p * len(ts))(*(x.data_ptr() for x in ts))


def _check_lengths(op, cands, keeps, lasts) -> int:
    nb = len(cands)
    if len(keeps) != nb or len(lasts) != nb:
        raise ValueError(f"{op}: cands/keeps/lasts lengths differ")
    if not 1 <= nb <= 4:
        raise ValueError(f"{op}: 1..4 neighbors, got {nb}")
    return nb


def _check_commit(op, p, cands, keeps, lasts, g, t, mix_scales=None,
                  carrier=None):
    """Validate a commit's arguments; returns (device, n, named tensors)."""
    nb = _check_lengths(op, cands, keeps, lasts)
    named, dtypes = {"p": p, "g": g, "t": t}, {}
    for i in range(nb):
        named.update({f"cand{i}": cands[i], f"keep{i}": keeps[i],
                      f"last{i}": lasts[i]})
        if carrier is not None:
            dtypes.update({f"cand{i}": carrier, f"last{i}": carrier})
        if mix_scales:
            named[f"scale{i}"] = mix_scales[i]
    device, n = build.check_inputs(op, dtypes=dtypes, **named)
    return device, n, named


@torch.library.custom_op("eg::fused_mix_commit", mutates_args=(),
                         device_types="cpu")
def _fused_mix_commit_op(
    p: torch.Tensor, cands: List[torch.Tensor], keeps: List[torch.Tensor],
    lasts: List[torch.Tensor], g: torch.Tensor, t: torch.Tensor, lr: float,
    momentum: float, mix_weight: float, mix_stale: bool,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    poison: Optional[torch.Tensor] = None,
    quar: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    _check_commit("fused_mix_commit", p, cands, keeps, lasts, g, t)
    _check_gates("fused_mix_commit", p, len(cands), w_rows, gate, poison,
                 quar)
    p_new, t_new, bufs = mix_commit_reference(
        p, cands, keeps, lasts, g, t, lr, momentum, mix_weight, mix_stale,
        w_rows, gate, poison, quar)
    return p_new, t_new, list(bufs)


@_fused_mix_commit_op.register_kernel("cuda")
def _fused_mix_commit_cuda(p, cands, keeps, lasts, g, t, lr, momentum,
                           mix_weight, mix_stale, w_rows=None, gate=None,
                           poison=None, quar=None):
    device, n, named = _check_commit("fused_mix_commit", p, cands, keeps,
                                     lasts, g, t)
    gated = _check_gates("fused_mix_commit", p, len(cands), w_rows, gate,
                         poison, quar)
    nb = len(cands)
    p_out, t_out = torch.empty_like(p), torch.empty_like(p)
    bufs = [torch.empty_like(p) for _ in range(nb)]
    lib = build.library()
    with torch.cuda.device(device):
        if gated:
            # the pitched body over the whole arena: one grid row per rank
            rows, cols = p.shape
            build.launch(
                "fused_mix_commit", lib.eg_mix_commit_pitched,
                p.data_ptr(), g.data_ptr(), t.data_ptr(),
                _ptrs(cands), _ptrs(keeps), _ptrs(lasts),
                p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, rows,
                cols, cols, 0, _f32(lr), _f32(momentum), _f32(mix_weight),
                int(bool(mix_stale)), _ptr(w_rows), _ptr(gate), _ptr(poison),
                _ptr(quar), build.aligned(*named.values(), p_out, t_out,
                                          *bufs),
                build.stream_of(device),
            )
        else:
            build.launch(
                "fused_mix_commit", lib.eg_mix_commit,
                p.data_ptr(), g.data_ptr(), t.data_ptr(),
                _ptrs(cands), _ptrs(keeps), _ptrs(lasts),
                p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, n,
                _f32(lr), _f32(momentum), _f32(mix_weight),
                int(bool(mix_stale)),
                build.aligned(*named.values(), p_out, t_out, *bufs),
                build.stream_of(device),
            )
    fused_mix_commit.launches += 1
    fused_mix_commit.gated_launches += int(gated)
    return p_out, t_out, bufs


@_fused_mix_commit_op.register_fake
def _fused_mix_commit_fake(p, cands, keeps, lasts, g, t, lr, momentum,
                           mix_weight, mix_stale, w_rows=None, gate=None,
                           poison=None, quar=None):
    return (torch.empty_like(p), torch.empty_like(p),
            [torch.empty_like(p) for _ in cands])


def _check_commit_bucket(op, p, cands, keeps, lasts, g, t, off, p_out,
                         t_out, mix_scales=None, carrier=None):
    """Validate a pitched commit's arguments; returns (device, rows,
    cols, ld, named tensors)."""
    nb = _check_lengths(op, cands, keeps, lasts)
    arena = {"p": p, "g": g, "t": t, "p_out": p_out, "t_out": t_out}
    bucket, dtypes = {}, {}
    for i in range(nb):
        bucket.update({f"cand{i}": cands[i], f"keep{i}": keeps[i],
                       f"last{i}": lasts[i]})
        if carrier is not None:
            dtypes.update({f"cand{i}": carrier, f"last{i}": carrier})
        if mix_scales:
            bucket[f"scale{i}"] = mix_scales[i]
    device, rows, cols, ld = build.check_bucket(op, arena, bucket, off,
                                                dtypes=dtypes)
    return device, rows, cols, ld, {**arena, **bucket}


def _commit_into(p_out, t_out, off, p_new, t_new):
    """Write a bucket's p', t' into its columns of the output arenas."""
    cols = p_new.shape[-1]
    p_out[:, off:off + cols].copy_(p_new)
    t_out[:, off:off + cols].copy_(t_new)


@torch.library.custom_op("eg::fused_mix_commit_bucket",
                         mutates_args=("p_out", "t_out"), device_types="cpu")
def _fused_mix_commit_bucket_op(
    p: torch.Tensor, cands: List[torch.Tensor], keeps: List[torch.Tensor],
    lasts: List[torch.Tensor], g: torch.Tensor, t: torch.Tensor, lr: float,
    momentum: float, mix_weight: float, mix_stale: bool, off: int,
    p_out: torch.Tensor, t_out: torch.Tensor,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    poison: Optional[torch.Tensor] = None,
    quar: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    _check_commit_bucket("fused_mix_commit_bucket", p, cands, keeps, lasts,
                         g, t, off, p_out, t_out)
    _check_gates("fused_mix_commit_bucket", p, len(cands), w_rows, gate,
                 poison, quar)
    cols = cands[0].shape[1]
    view = lambda x: x[:, off:off + cols]
    p_new, t_new, bufs = mix_commit_reference(
        view(p), cands, keeps, lasts, view(g), view(t), lr, momentum,
        mix_weight, mix_stale, w_rows, gate, poison, quar)
    _commit_into(p_out, t_out, off, p_new, t_new)
    return list(bufs)


@_fused_mix_commit_bucket_op.register_kernel("cuda")
def _fused_mix_commit_bucket_cuda(p, cands, keeps, lasts, g, t, lr, momentum,
                                  mix_weight, mix_stale, off, p_out, t_out,
                                  w_rows=None, gate=None, poison=None,
                                  quar=None):
    device, rows, cols, ld, named = _check_commit_bucket(
        "fused_mix_commit_bucket", p, cands, keeps, lasts, g, t, off, p_out,
        t_out)
    gated = _check_gates("fused_mix_commit_bucket", p, len(cands), w_rows,
                         gate, poison, quar)
    nb = len(cands)
    bufs = [torch.empty_like(cands[0]) for _ in range(nb)]
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "fused_mix_commit_bucket", lib.eg_mix_commit_pitched,
            p.data_ptr(), g.data_ptr(), t.data_ptr(),
            _ptrs(cands), _ptrs(keeps), _ptrs(lasts),
            p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, rows, cols,
            ld, int(off), _f32(lr), _f32(momentum), _f32(mix_weight),
            int(bool(mix_stale)), _ptr(w_rows), _ptr(gate), _ptr(poison),
            _ptr(quar), build.aligned(*named.values(), *bufs),
            build.stream_of(device),
        )
    fused_mix_commit.launches += 1
    fused_mix_commit.gated_launches += int(gated)
    fused_mix_commit.pitched_gated_launches += int(gated)
    return bufs


@_fused_mix_commit_bucket_op.register_fake
def _fused_mix_commit_bucket_fake(p, cands, keeps, lasts, g, t, lr, momentum,
                                  mix_weight, mix_stale, off, p_out, t_out,
                                  w_rows=None, gate=None, poison=None,
                                  quar=None):
    return [torch.empty_like(c) for c in cands]


def fused_mix_commit(
    p: torch.Tensor,
    cands: Tensors,
    keeps: Tensors,
    lasts: Tensors,
    g: torch.Tensor,
    t: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    mix_stale: bool = False,
    off: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
    poison: Optional[torch.Tensor] = None,
    quar: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """Fused commit+mix+SGD over flat f32 arenas of one shape (`[R, n]`
    for all ranks in one launch). `cands`/`keeps`/`lasts` hold one entry
    per neighbor: received candidates, per-POSITION f32 keep bits and the
    stale buffers. Returns (p_new, trace_new, committed_bufs). The
    operator `eg::fused_mix_commit`: on CPU tensors `mix_commit_reference`,
    on CUDA tensors a launch of `csrc/mix_commit.cu` (or an error).

    With `off` it is the pitched form over one bucket of the bucketed
    schedule (`eg::fused_mix_commit_bucket`): `p`, `g`, `t` are the whole
    `[R, n]` arenas, read in place at the columns `[off, off + c)`, the
    per-neighbor tensors the bucket's `[R, c]` arrays, and p', t' are
    written into the same columns of `out = (p_out, t_out)`, `[R, n]`
    arenas, which come back in place of p_new, trace_new.

    `w_rows`, `gate`, `poison`, `quar` select the gated form (module
    docstring), on the whole arena or on a bucket (the bucketed schedule
    under the fault clauses: the per-row operands are the whole pass's,
    computed once before the bucket loop)."""
    gates = (w_rows, gate, poison, quar)
    if off is not None:
        p_out, t_out = out
        bufs = _fused_mix_commit_bucket_op(
            p, list(cands), list(keeps), list(lasts), g, t, float(lr),
            float(momentum), float(mix_weight), bool(mix_stale), int(off),
            p_out, t_out, *gates)
        return p_out, t_out, tuple(bufs)
    p_new, t_new, bufs = _fused_mix_commit_op(
        p, list(cands), list(keeps), list(lasts), g, t, float(lr),
        float(momentum), float(mix_weight), bool(mix_stale), *gates)
    return p_new, t_new, tuple(bufs)


fused_mix_commit.launches = 0
fused_mix_commit.gated_launches = 0
fused_mix_commit.pitched_gated_launches = 0


#: carrier dtype -> the kernel's carrier code
_CARRIERS = {torch.int8: 0, torch.bfloat16: 1}


def mix_commit_carrier_reference(
    p: torch.Tensor,
    cands: Tensors,
    keeps: Tensors,
    lasts: Tensors,
    g: torch.Tensor,
    t: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    mix_scales: Optional[Tensors] = None,
    mix_stale: bool = False,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """Plain PyTorch version of `fused_mix_commit_carrier`."""
    bufs = tuple(
        torch.where(k.to(torch.float32) > 0, c, l)
        for c, k, l in zip(cands, keeps, lasts)
    )
    acc = p
    for i in range(len(bufs)):
        val = (lasts[i] if mix_stale else bufs[i]).to(torch.float32)
        if mix_scales is not None:
            val = val * mix_scales[i]
        acc = acc + _gated(val, gate, i)
    mixed = acc * _weight(mix_weight, w_rows)
    trace = _f32(momentum) * t + g
    return mixed - _f32(lr) * trace, trace, bufs


def _check_carrier_common(op, cands, keeps, lasts, mix_scales):
    """The carrier dtype of a carrier commit's buffers, after the checks
    both forms share."""
    _check_lengths(op, cands, keeps, lasts)
    cdt = lasts[0].dtype
    if cdt not in _CARRIERS:
        raise TypeError(
            f"{op}: carriers must be int8 or bfloat16, got {cdt}"
        )
    if (cdt == torch.int8) != bool(mix_scales):
        raise ValueError(f"{op}: int8 carriers take mix_scales, bf16 "
                         "carriers none")
    if mix_scales and len(mix_scales) != len(cands):
        raise ValueError(f"{op}: mix_scales length differs")
    return cdt


def _check_carrier(p, cands, keeps, lasts, g, t, mix_scales):
    op = "fused_mix_commit_carrier"
    cdt = _check_carrier_common(op, cands, keeps, lasts, mix_scales)
    return _check_commit(op, p, cands, keeps, lasts, g, t, mix_scales,
                         carrier=cdt)


@torch.library.custom_op("eg::fused_mix_commit_carrier", mutates_args=(),
                         device_types="cpu")
def _fused_mix_commit_carrier_op(
    p: torch.Tensor, cands: List[torch.Tensor], keeps: List[torch.Tensor],
    lasts: List[torch.Tensor], g: torch.Tensor, t: torch.Tensor, lr: float,
    momentum: float, mix_weight: float, mix_scales: List[torch.Tensor],
    mix_stale: bool, w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    _check_carrier(p, cands, keeps, lasts, g, t, mix_scales)
    _check_gates("fused_mix_commit_carrier", p, len(cands), w_rows, gate)
    p_new, t_new, bufs = mix_commit_carrier_reference(
        p, cands, keeps, lasts, g, t, lr, momentum, mix_weight,
        mix_scales=mix_scales or None, mix_stale=mix_stale, w_rows=w_rows,
        gate=gate,
    )
    return p_new, t_new, list(bufs)


@_fused_mix_commit_carrier_op.register_kernel("cuda")
def _fused_mix_commit_carrier_cuda(p, cands, keeps, lasts, g, t, lr,
                                   momentum, mix_weight, mix_scales,
                                   mix_stale, w_rows=None, gate=None):
    device, n, named = _check_carrier(p, cands, keeps, lasts, g, t,
                                      mix_scales)
    gated = _check_gates("fused_mix_commit_carrier", p, len(cands), w_rows,
                         gate)
    nb = len(cands)
    p_out, t_out = torch.empty_like(p), torch.empty_like(p)
    bufs = [torch.empty_like(lasts[0]) for _ in range(nb)]
    lib = build.library()
    scales = _ptrs(mix_scales) if mix_scales else None
    with torch.cuda.device(device):
        if gated:
            # the pitched body over the whole arena: one grid row per rank
            rows, cols = p.shape
            build.launch(
                "fused_mix_commit_carrier",
                lib.eg_mix_commit_carrier_pitched,
                p.data_ptr(), g.data_ptr(), t.data_ptr(),
                _ptrs(cands), _ptrs(keeps), _ptrs(lasts), scales,
                p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, rows,
                cols, cols, 0, _f32(lr), _f32(momentum), _f32(mix_weight),
                int(bool(mix_stale)), _CARRIERS[lasts[0].dtype],
                _ptr(w_rows), _ptr(gate),
                build.aligned(*named.values(), p_out, t_out, *bufs),
                build.stream_of(device),
            )
        else:
            build.launch(
                "fused_mix_commit_carrier", lib.eg_mix_commit_carrier,
                p.data_ptr(), g.data_ptr(), t.data_ptr(),
                _ptrs(cands), _ptrs(keeps), _ptrs(lasts), scales,
                p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, n,
                _f32(lr), _f32(momentum), _f32(mix_weight),
                int(bool(mix_stale)), _CARRIERS[lasts[0].dtype],
                build.aligned(*named.values(), p_out, t_out, *bufs),
                build.stream_of(device),
            )
    fused_mix_commit_carrier.launches += 1
    fused_mix_commit_carrier.gated_launches += int(gated)
    return p_out, t_out, bufs


@_fused_mix_commit_carrier_op.register_fake
def _fused_mix_commit_carrier_fake(p, cands, keeps, lasts, g, t, lr,
                                   momentum, mix_weight, mix_scales,
                                   mix_stale, w_rows=None, gate=None):
    return (torch.empty_like(p), torch.empty_like(p),
            [torch.empty_like(x) for x in lasts])


def _check_carrier_bucket(p, cands, keeps, lasts, g, t, off, p_out, t_out,
                          mix_scales):
    op = "fused_mix_commit_carrier_bucket"
    cdt = _check_carrier_common(op, cands, keeps, lasts, mix_scales)
    return _check_commit_bucket(op, p, cands, keeps, lasts, g, t, off, p_out,
                                t_out, mix_scales, carrier=cdt)


@torch.library.custom_op("eg::fused_mix_commit_carrier_bucket",
                         mutates_args=("p_out", "t_out"), device_types="cpu")
def _fused_mix_commit_carrier_bucket_op(
    p: torch.Tensor, cands: List[torch.Tensor], keeps: List[torch.Tensor],
    lasts: List[torch.Tensor], g: torch.Tensor, t: torch.Tensor, lr: float,
    momentum: float, mix_weight: float, mix_scales: List[torch.Tensor],
    mix_stale: bool, off: int, p_out: torch.Tensor, t_out: torch.Tensor,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> List[torch.Tensor]:
    _check_carrier_bucket(p, cands, keeps, lasts, g, t, off, p_out, t_out,
                          mix_scales)
    _check_gates("fused_mix_commit_carrier_bucket", p, len(cands), w_rows,
                 gate)
    cols = cands[0].shape[1]
    view = lambda x: x[:, off:off + cols]
    p_new, t_new, bufs = mix_commit_carrier_reference(
        view(p), cands, keeps, lasts, view(g), view(t), lr, momentum,
        mix_weight, mix_scales=mix_scales or None, mix_stale=mix_stale,
        w_rows=w_rows, gate=gate,
    )
    _commit_into(p_out, t_out, off, p_new, t_new)
    return list(bufs)


@_fused_mix_commit_carrier_bucket_op.register_kernel("cuda")
def _fused_mix_commit_carrier_bucket_cuda(p, cands, keeps, lasts, g, t, lr,
                                          momentum, mix_weight, mix_scales,
                                          mix_stale, off, p_out, t_out,
                                          w_rows=None, gate=None):
    device, rows, cols, ld, named = _check_carrier_bucket(
        p, cands, keeps, lasts, g, t, off, p_out, t_out, mix_scales)
    gated = _check_gates("fused_mix_commit_carrier_bucket", p, len(cands),
                         w_rows, gate)
    nb = len(cands)
    bufs = [torch.empty_like(lasts[0]) for _ in range(nb)]
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "fused_mix_commit_carrier_bucket",
            lib.eg_mix_commit_carrier_pitched,
            p.data_ptr(), g.data_ptr(), t.data_ptr(),
            _ptrs(cands), _ptrs(keeps), _ptrs(lasts),
            _ptrs(mix_scales) if mix_scales else None,
            p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, rows, cols,
            ld, int(off), _f32(lr), _f32(momentum), _f32(mix_weight),
            int(bool(mix_stale)), _CARRIERS[lasts[0].dtype], _ptr(w_rows),
            _ptr(gate), build.aligned(*named.values(), *bufs),
            build.stream_of(device),
        )
    fused_mix_commit_carrier.launches += 1
    fused_mix_commit_carrier.gated_launches += int(gated)
    fused_mix_commit_carrier.pitched_gated_launches += int(gated)
    return bufs


@_fused_mix_commit_carrier_bucket_op.register_fake
def _fused_mix_commit_carrier_bucket_fake(p, cands, keeps, lasts, g, t, lr,
                                          momentum, mix_weight, mix_scales,
                                          mix_stale, off, p_out, t_out,
                                          w_rows=None, gate=None):
    return [torch.empty_like(x) for x in lasts]


def fused_mix_commit_carrier(
    p: torch.Tensor,
    cands: Tensors,
    keeps: Tensors,
    lasts: Tensors,
    g: torch.Tensor,
    t: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    mix_scales: Optional[Tensors] = None,
    mix_stale: bool = False,
    off: Optional[int] = None,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    w_rows: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """Fused commit+mix+SGD whose buffer reads stay in the carrier.
    `cands`/`lasts` are per-neighbor carriers of one dtype — int8, with
    `mix_scales` the per-position f32 dequant scales of the values the
    mix reads (the committed scales, or the stale buffers' with
    `mix_stale`), or bf16 with `mix_scales=None`. `keeps` are f32
    per-position keep bits; `p`, `g`, `t` f32 arenas of the same shape.
    Returns (p_new, trace_new, committed carrier buffers). The operator
    `eg::fused_mix_commit_carrier`: on CPU tensors
    `mix_commit_carrier_reference`, on CUDA tensors a launch of
    `csrc/mix_commit_carrier.cu` (or an error). With `off` and `out`, the
    pitched form over one bucket (`eg::fused_mix_commit_carrier_bucket`,
    as `fused_mix_commit`). `w_rows` and `gate` select the gated form
    (module docstring), on the whole arena or on a bucket."""
    if off is not None:
        p_out, t_out = out
        bufs = _fused_mix_commit_carrier_bucket_op(
            p, list(cands), list(keeps), list(lasts), g, t, float(lr),
            float(momentum), float(mix_weight),
            [] if mix_scales is None else list(mix_scales), bool(mix_stale),
            int(off), p_out, t_out, w_rows, gate)
        return p_out, t_out, tuple(bufs)
    p_new, t_new, bufs = _fused_mix_commit_carrier_op(
        p, list(cands), list(keeps), list(lasts), g, t, float(lr),
        float(momentum), float(mix_weight),
        [] if mix_scales is None else list(mix_scales), bool(mix_stale),
        w_rows, gate)
    return p_new, t_new, tuple(bufs)


fused_mix_commit_carrier.launches = 0
fused_mix_commit_carrier.gated_launches = 0
fused_mix_commit_carrier.pitched_gated_launches = 0
