"""Gossip exchanges over the rank-stacked dimension, f32 wire.

Port of `eventgrad_tpu/parallel/collectives.py`, the subset the flagship
arena path runs: `recv_from`, `_wire_concat`, `neighbor_vals_flat`,
`masked_neighbor_vals_flat`, `commit_bufs_flat` and the wire byte
accounting. The bf16/int8 wires, the compact wire, the integrity riders
and carrier-resident buffers are not ported yet and raise
`NotImplementedError`.

Each `[R, ...]` argument holds every rank of the topology; a ppermute of
the JAX package is a `torch.roll` of the rank dimension.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from eventgrad_tpu_torch.parallel import arena
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Topology

#: wire bytes per payload element (the reference's f32 MPI wire is the
#: 4-byte baseline; accounting and wire-real numbers share the constants)
WIRE_VAL_BYTES = {None: 4.0}


def _require_f32_wire(wire) -> None:
    if wire is not None:
        raise NotImplementedError(
            f"wire={wire!r} is not ported yet; only the f32 wire (None)"
        )


def recv_from(x: torch.Tensor, topo: Topology, nb: NeighborSpec) -> torch.Tensor:
    """Each rank receives the slice held by the rank `nb.offset` away along
    `nb.axis` (offset -1 == "from my left neighbor"): out[r] = x[r + offset],
    i.e. a roll of the rank dimension by -offset."""
    ax = topo.axes.index(nb.axis)
    grid = x.reshape(tuple(topo.shape) + tuple(x.shape[1:]))
    return torch.roll(grid, shifts=-nb.offset, dims=ax).reshape(x.shape)


def _wire_concat(pieces, dtype=torch.float32) -> torch.Tensor:
    """The arena wire build: one concatenation of `[R, z]` per-leaf
    pieces along the flat dimension, any masking already in the pieces."""
    if len(pieces) == 1:
        return pieces[0].to(dtype)
    return torch.cat([p.to(dtype) for p in pieces], dim=-1)


def neighbor_vals_flat(
    payload: torch.Tensor, topo: Topology, spec: "arena.ArenaSpec", wire=None,
) -> Tuple[torch.Tensor, ...]:
    """D-PSGD exchange on the arena: each neighbor's whole `[R, n]`
    parameter arena, one flat buffer per neighbor."""
    _require_f32_wire(wire)
    return tuple(recv_from(payload, topo, nb) for nb in topo.neighbors)


def masked_neighbor_vals_flat(
    payload: torch.Tensor,
    fire_vec: torch.Tensor,
    topo: Topology,
    spec: "arena.ArenaSpec",
    wire=None,
    wire_builder=None,
    checksum: bool = False,
    finite: bool = False,
    corrupt=None,
    carrier: bool = False,
):
    """Event-triggered masked exchange on the arena.

    `payload` is the `[R, n]` parameter arena and `fire_vec` the `[R, L]`
    fire bits. The wire zeroes every non-fired leaf; `wire_builder` — a
    callable (flat, fire_exp, scale_exp|None) -> f32 wire, the masked-wire
    kernel `ops.event_engine.masked_wire` — builds it in one pass over
    the arena, else the mask is fused into a per-leaf concatenation.
    Returns (candidate `[R, n]` values, effective `[R, L]` fire bits, raw
    `[R, L]` sender bits) per neighbor; the caller commits
    `where(eff, candidate, stale)`. Without chaos the effective bits are
    the sender's."""
    if checksum or finite or corrupt is not None:
        raise NotImplementedError("the integrity riders are not ported yet")
    if carrier:
        raise NotImplementedError("carrier-resident exchange is not ported yet")
    _require_f32_wire(wire)
    if wire_builder is not None:
        fire_exp = fire_vec.to(torch.float32)[:, spec.seg_expand(payload.device)]
        wire_buf = wire_builder(payload, fire_exp, None)
    else:
        zero = torch.zeros((), dtype=payload.dtype, device=payload.device)
        wire_buf = _wire_concat([
            torch.where(fire_vec[:, k : k + 1], v, zero)
            for k, v in enumerate(spec.leaf_views(payload))
        ], payload.dtype)
    cands = tuple(recv_from(wire_buf, topo, nb) for nb in topo.neighbors)
    raws = tuple(recv_from(fire_vec, topo, nb) for nb in topo.neighbors)
    return cands, raws, raws


def commit_bufs_flat(
    cands: Tuple[torch.Tensor, ...],
    effs: Tuple[torch.Tensor, ...],
    lasts: Tuple[torch.Tensor, ...],
    spec: "arena.ArenaSpec",
) -> Tuple[torch.Tensor, ...]:
    """new_buf_i = where(eff_i per position, candidate_i, stale_i): the
    receive-buffer commit, one wide select per neighbor."""
    seg = spec.seg_expand(lasts[0].device if lasts else None)
    return tuple(
        torch.where(e[:, seg], c, l) for c, e, l in zip(cands, effs, lasts)
    )


def wire_real_bytes_per_neighbor(
    n_params: int,
    n_leaves: int,
    wire=None,
    compact_capacity: "Optional[int]" = None,
    fire_bits: bool = False,
) -> float:
    """Bytes ONE neighbor exchange actually moves: `n_params` value lanes
    regardless of fire bits (the masked wire is dense), plus the
    `[n_leaves]` bool fire vector on the event path."""
    _require_f32_wire(wire)
    if compact_capacity is not None:
        raise NotImplementedError("the compact wire is not ported yet")
    b = WIRE_VAL_BYTES[wire] * float(n_params)
    if fire_bits:
        b += 1.0 * n_leaves
    return b
