"""Carry weights between the JAX package's flax dicts and the port.

`params_from_jax` maps flax's nested dict of numpy arrays (`params` and
`batch_stats` collections) to the port's flat dicts of torch tensors
keyed by dotted flax paths; `params_to_jax` maps them back. Convolution
kernels go HWIO <-> OIHW and dense kernels `(in, out)` <-> `(out, in)`;
every other leaf keeps its shape. With `stacked=True` every array
carries a leading rank dimension that is left in place.

The dicts come out in flax leaf order (`parallel/arena.flax_order`),
the order of the arena segments and of the `[L]` event-state vectors.
The sharded transformers' trees carry the same way, rank by rank from a
JAX stacked state (`stacked=True`): the tensor-parallel `tp_kernel`s
are dense kernels (transposed), the pipeline stages' `tp_l{i}_*` leaves
and the experts' `[e_local, d, hidden]` `tp_wi` / `tp_wo` keep the JAX
layout (their models compute `x @ w`).

`arena_from_jax` maps a JAX `[..., n]` arena (flax layout inside each
leaf) to the port's, `event_state_from_jax` and `sparse_state_from_jax`
carry the JAX package's rank-stacked `EventState` (receive buffers,
monolithic or per bucket, f32 or carrier; dequant scales; the
bounded-async queue slots, edge clocks and late commits; the trigger
vectors and counters) and `SparseState` (shadow, replicas, payload
queues) into the port's. Every array is numpy (a host copy of the JAX
state); values are copied bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.parallel.arena import (
    ArenaSpec, flax_axes, flax_order, flax_positions,
)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def _kernel_perm(name: str, ndim: int, lead: int, to_torch: bool):
    """Axis permutation of a leaf between the flax and torch layouts
    (None when the layouts agree; `arena.flax_axes` is the rule)."""
    axes = flax_axes(name, ndim - lead)
    if axes is None:
        return None
    if to_torch:
        axes = tuple(int(i) for i in np.argsort(axes))
    return tuple(range(lead)) + tuple(lead + p for p in axes)


def params_from_jax(
    params_np: Mapping[str, Any],
    batch_stats_np: Optional[Mapping[str, Any]] = None,
    *,
    stacked: bool = False,
    device=None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """flax `params` / `batch_stats` nested dicts -> the port's (params,
    batch_stats) dicts of float32 torch tensors in torch layout."""
    lead = 1 if stacked else 0
    params = {}
    flat = _flatten(params_np)
    for name in flax_order(flat):
        a = np.array(flat[name], np.float32)  # a writable copy
        perm = _kernel_perm(name, a.ndim, lead, to_torch=True)
        if perm is not None:
            a = a.transpose(perm)
        params[name] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    stats_flat = _flatten(batch_stats_np or {})
    stats = {
        name: torch.from_numpy(
            np.array(stats_flat[name], np.float32)
        ).to(device)
        for name in flax_order(stats_flat)
    }
    return params, stats


def params_to_jax(
    params: Mapping[str, torch.Tensor],
    batch_stats: Optional[Mapping[str, torch.Tensor]] = None,
    *,
    stacked: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's (params, batch_stats) dicts -> flax nested dicts of
    numpy arrays in flax layout."""
    lead = 1 if stacked else 0
    flat = {}
    for name, t in params.items():
        a = t.detach().to("cpu", torch.float32).numpy()
        perm = _kernel_perm(name, a.ndim, lead, to_torch=False)
        flat[name] = np.ascontiguousarray(a.transpose(perm) if perm else a)
    stats = {
        name: t.detach().to("cpu", torch.float32).numpy()
        for name, t in (batch_stats or {}).items()
    }
    return _nest(flat), _nest(stats)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def arena_from_jax(a, spec: ArenaSpec, bucket=None, device=None
                   ) -> torch.Tensor:
    """A JAX `[..., n]` arena (flax layout inside each leaf; any dtype)
    in the port's layout. With `bucket` (an `arena.BucketSpec`), a JAX
    bucket array `[..., n_b]` in the port's layout of that bucket."""
    src = _tensor(a)
    pos = flax_positions(spec)
    if bucket is not None:
        pos = pos[bucket.start:bucket.start + bucket.size] - bucket.start
    out = torch.empty_like(src)
    out[..., pos] = src
    return out.to(device)


def _buf_from_jax(b, spec: ArenaSpec, device):
    """One neighbour's buffer: an arena, or the per-bucket tuple."""
    if isinstance(b, (tuple, list)):
        bks = spec.buckets(len(b))
        return tuple(arena_from_jax(x, spec, bks[i], device)
                     for i, x in enumerate(b))
    return arena_from_jax(b, spec, device=device)


def _vec_from_jax(v, device):
    """Per-leaf vectors (`[R, L]`, or the per-bucket tuple) as tensors."""
    if isinstance(v, (tuple, list)):
        return tuple(_tensor(x).to(device) for x in v)
    return _tensor(v).to(device)


def event_state_from_jax(ev, spec: ArenaSpec, device=None):
    """The port's `EventState` holding a rank-stacked JAX `EventState`'s
    values (numpy arrays): the trigger vectors and counters, the receive
    buffers and scales in their layout, and the delivery queues (each
    slot's candidate in the buffers' layout, eff bits, sent and late
    stamps, int8 scales) with the edge clocks and late commits."""
    from eventgrad_tpu_torch.parallel.events import EventState

    pending = None
    if ev.pending is not None:
        pending = tuple(
            tuple(
                (_buf_from_jax(slot[0], spec, device),
                 _vec_from_jax(slot[1], device),
                 _tensor(slot[2]).to(device), _tensor(slot[3]).to(device))
                + ((_vec_from_jax(slot[4], device),) if len(slot) > 4
                   else ())
                for slot in edge)
            for edge in ev.pending)
    opt = lambda v: None if v is None else _tensor(v).to(device)
    return EventState(
        thres=_tensor(ev.thres).to(device),
        last_sent_norm=_tensor(ev.last_sent_norm).to(device),
        last_sent_iter=_tensor(ev.last_sent_iter).to(device),
        slopes=_tensor(ev.slopes).to(device),
        bufs=tuple(_buf_from_jax(b, spec, device) for b in ev.bufs),
        num_events=_tensor(ev.num_events).to(device),
        num_deferred=_tensor(ev.num_deferred).to(device),
        buf_scales=None if ev.buf_scales is None else tuple(
            _vec_from_jax(sc, device) for sc in ev.buf_scales),
        pending=pending,
        edge_clock=opt(ev.edge_clock),
        late_commits=opt(ev.late_commits),
    )


def sparse_state_from_jax(sp, spec: ArenaSpec, device=None):
    """The port's `SparseState` holding a rank-stacked JAX `SparseState`:
    the shadow and replicas as `[R, n]` arenas, and each payload-queue
    slot's per-leaf `(vals, idxs, fire)` concatenated in leaf order into
    `([R, K] f32, [R, K] int32, [R, L] bool)`."""
    from eventgrad_tpu_torch.parallel.sparsify import SparseState

    def arena(tree):
        tp, _ = params_from_jax(tree, stacked=True)
        return spec.ravel(tp).to(device)

    def lanes(tree, axis=-1):
        leaves = [np.asarray(v) for _, v in sorted(
            _flatten(tree).items(), key=lambda kv: tuple(kv[0].split(".")))]
        if leaves[0].ndim == 1:  # per-leaf scalars: the fire bits
            return _tensor(np.stack(leaves, axis=-1)).to(device)
        return _tensor(np.concatenate(leaves, axis=axis)).to(device)

    pending = None
    if sp.pending is not None:
        pending = tuple(
            tuple((lanes(v), lanes(i), lanes(f)) for v, i, f in edge)
            for edge in sp.pending)
    return SparseState(prev_sent=arena(sp.prev_sent),
                       replicas=tuple(arena(r) for r in sp.replicas),
                       pending=pending)


def telemetry_from_jax(tel, device=None):
    """The port's `TelemetryState` holding a rank-stacked JAX
    `TelemetryState`'s values (numpy arrays), the message ledger
    included: field for field, the same dtypes (the None fields stay
    None)."""
    import dataclasses

    from eventgrad_tpu_torch.obs.device import TelemetryState
    from eventgrad_tpu_torch.obs.ledger import MessageLedger

    opt = lambda v: None if v is None else _tensor(v).to(device)
    led = tel.ledger
    if led is not None:
        led = MessageLedger(counts=opt(led.counts), queue=opt(led.queue),
                            late_queue=opt(led.late_queue))
    return TelemetryState(**{
        f.name: opt(getattr(tel, f.name))
        for f in dataclasses.fields(TelemetryState) if f.name != "ledger"
    }, ledger=led)
