"""Gossip exchanges over the rank-stacked dimension: the f32, bf16 and
int8 wires, masked or compact.

Port of `eventgrad_tpu/parallel/collectives.py`, the subset the port's
steps run: `allreduce_mean`, `recv_from`, the grid collectives the
hybrid meshes' models and step run along one named axis (`axis_sum`
for `lax.psum`, `axis_mean` for `lax.pmean`, `axis_all_to_all` for
`lax.all_to_all`, `axis_index` for `lax.axis_index`; a shift along one
axis is `recv_from`), `_wire_concat`, the wire codecs
(`_wire_out`, `_contract_safe`, `_leaf_absmax`, `_masked_scales`,
`_int8_encode_flat`), `neighbor_vals_flat`, `masked_neighbor_vals_flat`
and `compact_neighbor_vals_flat` (both with the carrier-resident
contract), the compact wire's `_compact_pack`, `compact_capacity_floor`
and `choose_capacity`, `commit_bufs_flat`, `commit_carrier_scales`,
`dequant_carrier_bufs` and the wire byte accounting; and the bucketed
schedule's family: `bucketed_capacity_floor`, `split_capacity`,
`bucketed_wire_real_bytes_per_neighbor`, `masked_neighbor_vals_bucket`,
`compact_neighbor_vals_bucket`, and `mix_carrier_flat_into_tree` (the
carrier mix the step's fused tail computes inside kernel 5; here the
plain per-leaf twin). The masked and compact arena exchanges take the
chaos delivery bits and the integrity riders (`wire_checksum`,
`_verify_wire`, the in-transit corruption); `mix_weighted` is the gated
mix over a data-dependent subset of edges, whose per-row weights the
gated forms of kernels 1, 4 and 5 take (`mix_weights`). The tree-path
`compact_neighbor_vals` and `mix_flat_into_tree` are absent, since the
port runs the arena and the fused tail kernels only.

Each `[R, ...]` argument holds every rank of the topology; a ppermute of
the JAX package is a `torch.roll` of the rank dimension. On a topology
lifted onto a device mesh (`topo.mesh`, `parallel/spmd.py`) each holds
this process's rows, and `recv_from`, `allreduce_mean` and the grid
collectives route through the mesh, so every caller here (the masked
and compact wires, the int8 scales, the checksums, the bucketed and
bounded-async queues) runs the lift unchanged. The int8 codec
is bitwise the JAX one: per-leaf absmax scales divided by 127 in IEEE
float32, truncated to 17 significand bits, then
`clip(round_half_even(x / s))`.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.parallel import arena, spmd
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Topology

#: wire modes: None = f32; "bf16" = bfloat16 transfer (2 B/elem);
#: "int8" = per-leaf absmax-scaled int8 transfer (1 B/elem + one f32
#: scale per leaf). Local state stays f32.
WIRE_MODES = (None, "bf16", "int8")

#: wire bytes per payload element (the reference's f32 MPI wire is the
#: 4-byte baseline; accounting and wire-real numbers share the constants)
WIRE_VAL_BYTES = {None: 4.0, "bf16": 2.0, "int8": 1.0}


def check_wire(wire) -> None:
    if wire not in WIRE_MODES:
        raise ValueError(f"wire must be one of {WIRE_MODES}")


def fold(grid: torch.Tensor, ax: int) -> torch.Tensor:
    """The sum over dimension `ax` of a grid, member by member in axis
    order (((x0 + x1) + x2) + ...), the dimension kept at size 1: the
    order the device mesh's chain reduction keeps across processes
    (`spmd.Mesh.fold`), so the lift computes the simulator's bits."""
    acc = grid.select(ax, 0)
    for i in range(1, grid.shape[ax]):
        acc = acc + grid.select(ax, i)
    return acc.unsqueeze(ax)


class _AxisSum(torch.autograd.Function):
    """The group sum along a grid axis, broadcast back to every member
    (`fold`); its transpose is the same sum of the cotangents, the JAX
    package's transpose of `psum`."""

    @staticmethod
    def forward(x, topo, ax):
        grid = _grid(x, topo)
        if grid.shape[ax] == 1:
            return x.clone()
        return fold(grid, ax).expand(grid.shape).reshape(x.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.topo, ctx.ax = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _AxisSum.apply(g.contiguous(), ctx.topo, ctx.ax), None, None


def allreduce_mean(x: torch.Tensor, topo: Topology, axes=None) -> torch.Tensor:
    """Mean over every rank of the topology (or over the grid axes named
    in `axes`): each rank's slice of the `[R, ...]` result holds its
    group's mean, taken axis by axis in the topology's axis order as the
    JAX package's chain of `pmean`s takes it (each a `fold` divided by
    the axis size). On a mesh each axis's sum is the mesh's chain
    reduction (`spmd.fold`), in the same order."""
    for name in topo.axes:
        if axes is None or name in axes:
            x = axis_sum(x, topo, name) / topo.axis_size(name)
    return x


def _grid(x: torch.Tensor, topo: Topology) -> torch.Tensor:
    """The `[R, ...]` stack viewed as the topology's grid `[*shape, ...]`
    (row-major: the rank dimension split across consecutive
    dimensions)."""
    return x.reshape(tuple(topo.shape) + tuple(x.shape[1:]))


def axis_sum(x: torch.Tensor, topo: Topology, axis: str) -> torch.Tensor:
    """`lax.psum(x, axis)` on the stack: every rank receives the sum of
    its group along grid axis `axis`, summed member by member in axis
    order (`fold`). Under autograd the cotangent that reaches a rank's
    input is the sum of its group's cotangents, the JAX package's
    transpose of `psum`. On a mesh: the chain reduction (`spmd.fold`)."""
    ax = topo.axes.index(axis)
    if topo.mesh is not None:
        return spmd.fold(x, topo, ax)
    return _AxisSum.apply(x, topo, ax)


def axis_mean(x: torch.Tensor, topo: Topology, axis: str) -> torch.Tensor:
    """`lax.pmean(x, axis)` on the stack: the group mean along grid axis
    `axis`, broadcast back to every member."""
    return allreduce_mean(x, topo, axes=(axis,))


def axis_index(topo: Topology, axis: str, device=None) -> torch.Tensor:
    """`lax.axis_index(axis)` of every rank: `[R]` int64, each rank's
    coordinate along grid axis `axis` (on a mesh, of the rows this
    process holds)."""
    ax = topo.axes.index(axis)
    grid = torch.arange(topo.shape[ax], device=device).reshape(
        (1,) * ax + (topo.shape[ax],) + (1,) * (len(topo.shape) - ax - 1))
    return topo.local_rows(grid.expand(tuple(topo.shape)).reshape(
        topo.n_ranks))


def axis_all_to_all(x: torch.Tensor, topo: Topology, axis: str) -> torch.Tensor:
    """`lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=True)`
    on the stack, where each rank's `x[r]` leads with one chunk per
    member of its group along `axis` (`[R, n, ...]`, n the axis size):
    member a's chunk s goes to member s, which holds it at position a —
    the exchange of the grid dimension with the chunk dimension."""
    ax = topo.axes.index(axis)
    n = topo.shape[ax]
    if x.dim() < 2 or x.shape[1] != n:
        raise ValueError(
            f"all_to_all along {axis!r} needs [R, {n}, ...] chunks, got "
            f"{tuple(x.shape)}")
    if topo.mesh is not None:
        return spmd.swap(x, topo, ax)
    grid = _grid(x, topo)
    return grid.transpose(ax, len(topo.shape)).reshape(x.shape)


def recv_from(x: torch.Tensor, topo: Topology, nb: NeighborSpec) -> torch.Tensor:
    """Each rank receives the slice held by the rank `nb.offset` away along
    `nb.axis` (offset -1 == "from my left neighbor"): out[r] = x[r + offset],
    i.e. a roll of the rank dimension by -offset. On a mesh, the rows
    whose source another process holds arrive from it by
    point-to-point (`spmd.hop`)."""
    if topo.mesh is not None:
        return spmd.hop(x, topo, nb)
    ax = topo.axes.index(nb.axis)
    grid = x.reshape(tuple(topo.shape) + tuple(x.shape[1:]))
    return torch.roll(grid, shifts=-nb.offset, dims=ax).reshape(x.shape)


def _wire_concat(pieces, dtype=torch.float32) -> torch.Tensor:
    """The arena wire build: one concatenation of `[R, z]` per-leaf
    pieces along the flat dimension, any masking already in the pieces."""
    if len(pieces) == 1:
        return pieces[0].to(dtype)
    return torch.cat([p.to(dtype) for p in pieces], dim=-1)


def _wire_out(x: torch.Tensor, wire) -> torch.Tensor:
    """Downcast a floating wire payload for transfer (bf16 mode; int8 has
    its own codec below)."""
    if wire == "bf16" and x.is_floating_point() and x.dtype != torch.bfloat16:
        return x.to(torch.bfloat16)
    return x


def _contract_safe(scale: torch.Tensor) -> torch.Tensor:
    """Truncate an f32 quantization scale to 17 significand bits (clear
    the low 7 stored mantissa bits), so every dequantized product `q * s`
    with |q| <= 127 is exact in f32 and the receive path gives the same
    bits whether or not a compiler fuses the multiply into an add."""
    bits = scale.to(torch.float32).contiguous().view(torch.int32)
    return (bits & ~0x7F).view(torch.float32)


def _int8_scales(absmax_vec: torch.Tensor) -> torch.Tensor:
    """Per-leaf int8 wire scales: contract_safe(max(absmax, 1e-30) / 127),
    divided in IEEE float32 on any device (the divisor is a device
    tensor: a host scalar divisor becomes a reciprocal multiply on
    CUDA)."""
    div = torch.full((), 127.0, dtype=torch.float32, device=absmax_vec.device)
    return _contract_safe(torch.clamp_min(absmax_vec, 1e-30) / div)


def _leaf_absmax(flat: torch.Tensor, spec: "arena.ArenaSpec") -> torch.Tensor:
    """`[..., L]` per-leaf absmax of an `[..., n]` arena: one multi-tensor
    reduction over the per-rank leaf views (max is exact, so any order
    gives the JAX bits). The contiguous arena is rank-major, so one split
    of its flat view makes every (rank, leaf) view."""
    lead = tuple(flat.shape[:-1])
    rows = flat.numel() // flat.shape[-1]
    views = flat.contiguous().reshape(-1).split(list(spec.sizes) * rows)
    maxes = torch._foreach_norm(views, float("inf"))
    return torch.stack(maxes).reshape(lead + (spec.n_leaves,))


def _masked_scales(absmax_vec: torch.Tensor, fire_vec: torch.Tensor) -> torch.Tensor:
    """Per-leaf int8 wire scales with non-fired leaves bottomed out —
    `_int8_scales` of the zero-masked arena's absmax."""
    zero = torch.zeros((), dtype=torch.float32, device=absmax_vec.device)
    return _int8_scales(torch.where(fire_vec, absmax_vec, zero))


def _int8_encode_flat(masked_flat: torch.Tensor, scale_vec: torch.Tensor,
                      seg: torch.Tensor) -> torch.Tensor:
    """Quantize an `[..., n]` (masked) arena against `[..., L]` per-leaf
    scales: clip(round_half_even(x / scale[seg]), -127, 127) as int8.
    `seg` is the `[n]` leaf of each position, or per row (`[R, n]`, the
    compact pack's `leaf_id`)."""
    if seg.dim() == 1:
        scale = scale_vec[..., seg]
    else:
        scale = torch.gather(scale_vec, -1, seg)
    return torch.clamp(torch.round(masked_flat / scale), -127, 127).to(
        torch.int8)


# ---------------------------------------------------------------------------
# wire integrity: per-neighbour payload checksums (chaos/integrity.py)


def wire_checksum(buf: torch.Tensor) -> torch.Tensor:
    """int32 `[R]` checksum of each row's exact wire bits: the storage
    words (f32 and bf16 as int32 and int16, int8 as is), sign-extended
    to int32 and summed with int32 wraparound (summed in int64, then
    cast back), so any single flipped bit changes it and any reduction
    order gives the JAX package's value."""
    if buf.is_floating_point():
        int_dt = {32: torch.int32, 16: torch.int16}[torch.finfo(buf.dtype).bits]
        buf = buf.contiguous().view(int_dt)
    return torch.sum(buf, dim=-1, dtype=torch.int64).to(torch.int32)


def _verify_wire(got_buf, got_csum, decoded, checksum: bool,
                 finite: bool) -> torch.Tensor:
    """bool `[R]` per-neighbour wire verdict: the received buffer's
    checksum matches the sender's, and (with `finite`) the decoded
    payload is finite."""
    ok = torch.ones(got_buf.shape[:1], dtype=torch.bool,
                    device=got_buf.device)
    if checksum:
        ok = ok & (wire_checksum(got_buf) == got_csum)
    if finite:
        ok = ok & torch.isfinite(decoded).all(dim=-1)
    return ok


def mix_weights(gate: torch.Tensor) -> torch.Tensor:
    """f32 `[R]` mix weight per rank over the gated edges (`gate` bool
    `[R, n_nb]`): 1 / (1 + n_alive), an IEEE float32 quotient on any
    device. With every gate on it equals float32(topo.mix_weight)."""
    n_alive = torch.sum(gate.to(torch.float32), dim=-1)
    return torch.ones_like(n_alive) / (1.0 + n_alive)


def mix_weighted(params: torch.Tensor, bufs: Tuple[torch.Tensor, ...],
                 gate: torch.Tensor) -> torch.Tensor:
    """Gossip averaging over a data-dependent subset of edges:
    p <- (p + sum(where(gate_i, buf_i, 0))) / (1 + sum(gate_i)), per rank
    (`gate` bool `[R, n_nb]`, the freeze mask and D-PSGD's delivered
    bits). A gated-off edge adds +0.0, as the JAX function's where
    does. With every gate on this is the uniform mix, bitwise."""
    zero = torch.zeros((), dtype=params.dtype, device=params.device)
    acc = params
    for i, b in enumerate(bufs):
        acc = acc + torch.where(gate[:, i:i + 1], b, zero)
    return acc * mix_weights(gate)[:, None]


def neighbor_vals_flat(
    payload: torch.Tensor, topo: Topology, spec: "arena.ArenaSpec", wire=None,
) -> Tuple[torch.Tensor, ...]:
    """D-PSGD exchange on the arena: each neighbor's whole `[R, n]`
    parameter arena, one flat buffer per neighbor, already decoded to
    f32."""
    check_wire(wire)
    if wire == "int8":
        seg = spec.seg_expand(payload.device)
        scale_vec = _int8_scales(_leaf_absmax(payload, spec))
        q = _int8_encode_flat(payload, scale_vec, seg)

        def one(nb):
            got_q, got_s = recv_from(q, topo, nb), recv_from(scale_vec, topo, nb)
            return got_q.to(torch.float32) * got_s[:, seg]
    else:
        wire_buf = _wire_out(payload, wire)

        def one(nb):
            return recv_from(wire_buf, topo, nb).to(payload.dtype)

    return tuple(one(nb) for nb in topo.neighbors)


def masked_neighbor_vals_flat(
    payload: torch.Tensor,
    fire_vec: torch.Tensor,
    topo: Topology,
    spec: "arena.ArenaSpec",
    wire=None,
    deliver=None,
    wire_builder=None,
    checksum: bool = False,
    finite: bool = False,
    corrupt=None,
    carrier: bool = False,
):
    """Event-triggered masked exchange on the arena.

    `payload` is the `[R, n]` parameter arena and `fire_vec` the `[R, L]`
    fire bits. The wire zeroes every non-fired leaf (and, for int8,
    quantizes against per-leaf scales that bottom out on non-fired
    leaves); `wire_builder` — a callable (flat, fire_exp, scale_exp|None)
    -> f32 wire, the masked-wire kernels `ops.event_engine.masked_wire` —
    builds it in one pass over the arena, else plain tensor ops build the
    same bits. Returns (candidate `[R, n]` values, effective `[R, L]` fire
    bits, raw `[R, L]` sender bits) per neighbor; the caller commits
    `where(eff, candidate, stale)`. Without chaos the effective bits are
    the sender's; `deliver` (bool `[R, n_nb]`, `chaos.inject`) clears a
    dropped edge's effective bits, so a drop is bitwise an event that
    did not fire, while the raw bits stay what was on the wire.

    Integrity: `checksum` ships an int32 `wire_checksum` of each row's
    wire buffer beside it (a one-element lane per rank) and verifies it
    on receipt; `finite` also rejects a decoded payload carrying
    NaN/Inf; `corrupt` is an `(edge_index, received_buffer) -> buffer`
    transform modelling in-transit corruption
    (`chaos.inject.flip_one_bit`), applied before the verification. A
    failed check clears the edge's effective bits like an undelivered
    message. With any of the three set, a fourth value comes back: the
    per-edge verdicts, bool `[R, n_nb]`.

    `carrier=True` (bf16/int8 wires, no integrity riders) returns the
    candidates still in the wire dtype plus a fourth value: the
    per-neighbor received `[R, L]` dequant scales (int8; None for bf16)
    — the carrier-resident contract, where the dequant multiply happens
    in the commit/mix reads."""
    integrity = checksum or finite or corrupt is not None
    if carrier:
        if integrity:
            raise ValueError(
                "carrier-resident exchange does not compose with the "
                "integrity riders (their verdicts read dequantized "
                "values) — use carrier=False"
            )
        if wire not in ("bf16", "int8"):
            raise ValueError(
                f"carrier-resident exchange needs a bf16/int8 wire; "
                f"got {wire!r}"
            )
    check_wire(wire)
    seg = spec.seg_expand(payload.device)
    fire_f32 = fire_vec.to(torch.float32)
    scale_vec = None
    if wire == "int8":
        scale_vec = _masked_scales(_leaf_absmax(payload, spec), fire_vec)
        if wire_builder is not None:
            q = wire_builder(payload, fire_f32[:, seg], scale_vec[:, seg])
            wire_buf = q.to(torch.int8)
        else:
            zero = torch.zeros((), dtype=payload.dtype, device=payload.device)
            wire_buf = _int8_encode_flat(
                torch.where(fire_vec[:, seg], payload, zero), scale_vec, seg
            )
    else:
        if wire_builder is not None:
            masked = wire_builder(payload, fire_f32[:, seg], None)
        else:
            zero = torch.zeros((), dtype=payload.dtype, device=payload.device)
            masked = _wire_concat([
                torch.where(fire_vec[:, k : k + 1], v, zero)
                for k, v in enumerate(spec.leaf_views(payload))
            ], payload.dtype)
        wire_buf = _wire_out(masked, wire)
    csum = wire_checksum(wire_buf) if checksum else None

    cands, effs, raws, oks, scls = [], [], [], [], []
    for i, nb in enumerate(topo.neighbors):
        got = recv_from(wire_buf, topo, nb)
        got_s = None if scale_vec is None else recv_from(scale_vec, topo, nb)
        if corrupt is not None:
            got = corrupt(i, got)
        cand = got
        if not carrier:
            cand = got.to(payload.dtype)
            if got_s is not None:
                cand = cand * got_s[:, seg]
        raw = recv_from(fire_vec, topo, nb)
        eff = raw
        if integrity:
            ok = _verify_wire(
                got, recv_from(csum, topo, nb) if checksum else None, cand,
                checksum, finite)
            eff = eff & ok[:, None]
            oks.append(ok)
        if deliver is not None:
            eff = eff & deliver[:, i:i + 1]
        cands.append(cand)
        effs.append(eff)
        raws.append(raw)
        scls.append(got_s)
    if carrier:
        return tuple(cands), tuple(effs), tuple(raws), (
            tuple(scls) if wire == "int8" else None
        )
    if integrity:
        return tuple(cands), tuple(effs), tuple(raws), torch.stack(oks, -1)
    return tuple(cands), tuple(effs), tuple(raws)


# ---------------------------------------------------------------------------
# the compact static-capacity wire: only fired leaves' elements travel


def compact_capacity_floor(sizes) -> int:
    """Smallest legal compact capacity: the largest leaf must fit whole
    (a leaf bigger than the buffer could never ship and would starve)."""
    return max(int(s) for s in sizes)


def choose_capacity(
    n_params: int,
    max_fired_elems: float,
    floor: int,
    headroom: float = 1.25,
    granularity: int = 8192,
) -> int:
    """Static compact-buffer capacity from an observed post-warmup fired
    peak: `headroom` over the peak, rounded up to `granularity` elements
    so nearby observations give the same capacity, clamped to
    `[floor, n_params]`. An underestimate is safe: the overflow defers,
    bounded by max_silence."""
    want = int(math.ceil(float(max_fired_elems) * float(headroom)))
    c = max(int(floor), want, 1)
    c = ((c + granularity - 1) // granularity) * granularity
    return int(min(int(n_params), c))


@functools.lru_cache(maxsize=16)
def _compact_constants(spec: "arena.ArenaSpec", device: torch.device):
    """(int32 `[L]` leaf sizes, int64 `[L]` leaf starts, int64 `[n]`
    position of each arena element within its leaf) on one device,
    built once: read only."""
    sizes_t = spec.sizes_tensor(device)
    starts_t = torch.tensor(spec.starts, dtype=torch.int64, device=device)
    seg = spec.seg_expand(device)
    pos_in_leaf = torch.arange(spec.n_total, device=device) - starts_t[seg]
    return sizes_t, starts_t, pos_in_leaf


def _fired_offsets(fire_vec: torch.Tensor, sizes_t: torch.Tensor):
    """(exclusive, inclusive) int32 `[R, L]` cumsums of the fired leaves'
    sizes in leaf order: where each fired leaf starts and ends in the
    packed buffer."""
    fired = torch.where(fire_vec, sizes_t, torch.zeros_like(sizes_t))
    ends = torch.cumsum(fired, dim=-1, dtype=torch.int32)
    return ends - fired, ends


def _compact_pack(
    flat: torch.Tensor,
    fire_vec: torch.Tensor,
    spec: "arena.ArenaSpec",
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather each rank's fired leaves' elements, in leaf order, into a
    `[R, capacity]` wire buffer. Every packed position finds its source
    leaf with one searchsorted over the fired ends; positions past the
    fired total hold zero. The caller guarantees (`events.capacity_gate`)
    that the fired total fits. Returns (packed `[R, capacity]`, leaf_id
    `[R, capacity]` int64: each position's source leaf, clamped to L-1,
    which the int8 codec reads for the per-position scale)."""
    dev = flat.device
    sizes_t, starts_t, _ = _compact_constants(spec, dev)
    offsets, ends = _fired_offsets(fire_vec, sizes_t)
    j = torch.arange(capacity, dtype=torch.int32, device=dev).expand(
        flat.shape[0], capacity).contiguous()
    leaf_id = torch.searchsorted(ends, j, right=True).clamp_max_(
        spec.n_leaves - 1)
    # source = starts[leaf] + (j - offsets[leaf])
    src = torch.gather(starts_t - offsets, -1, leaf_id).add_(j)
    vals = torch.gather(flat, -1, src.clamp_(0, spec.n_total - 1))
    packed = torch.where(j < ends[:, -1:], vals, torch.zeros_like(vals))
    return packed, leaf_id


def compact_neighbor_vals_flat(
    payload: torch.Tensor,
    fire_vec: torch.Tensor,
    packed: torch.Tensor,
    leaf_id: torch.Tensor,
    topo: Topology,
    capacity: int,
    spec: "arena.ArenaSpec",
    wire=None,
    deliver=None,
    checksum: bool = False,
    finite: bool = False,
    corrupt=None,
    carrier: bool = False,
):
    """Budgeted compact exchange on the arena.

    `packed` / `leaf_id` come from `ops.event_engine.event_propose_pack`
    with a capacity, whose gated `fire_vec` this must be. Each neighbor
    ships `(packed [R, capacity], fire_vec [R, L])`, plus the `[R, L]`
    scales on the int8 wire (`_masked_scales` of the gated bits; the
    pack quantizes with the masked wire's codec, per packed position's
    source leaf). The receiver recomputes the packed offsets from the
    received fire bits and gathers position i of leaf k from
    `packed[offsets[k] + (i - starts[k])]`, clipped into the buffer, so
    the candidates are `[R, n]` like the masked exchange's: a non-fired
    leaf's positions hold clipped garbage that the commit's `where(eff,
    candidate, stale)` discards. Returns (candidates, effective bits,
    raw sender bits) per neighbor, and with `carrier=True` (bf16/int8)
    the candidates in the wire dtype plus the per-neighbor received
    `[R, L]` int8 scales (None for bf16). `deliver`, `checksum`,
    `finite` and `corrupt` are the masked exchange's (the checksum covers
    the packed buffer; the finite check reads the packed float values,
    or the received scales on the int8 wire, as the JAX function's)."""
    if carrier:
        if checksum or finite or corrupt is not None:
            raise ValueError(
                "carrier-resident exchange does not compose with the "
                "integrity riders (their verdicts read dequantized "
                "values) — use carrier=False"
            )
        if wire not in ("bf16", "int8"):
            raise ValueError(
                f"carrier-resident exchange needs a bf16/int8 wire; "
                f"got {wire!r}"
            )
    integrity = checksum or finite or corrupt is not None
    check_wire(wire)
    capacity = int(capacity)
    if capacity < spec.floor:
        raise ValueError(
            f"compact capacity {capacity} is below the largest leaf "
            f"({spec.floor} elements): that leaf could never ship and "
            "would starve"
        )
    dev = payload.device
    scale_vec = None
    if wire == "int8":
        scale_vec = _masked_scales(_leaf_absmax(payload, spec), fire_vec)
        wire_packed = _int8_encode_flat(packed, scale_vec, leaf_id)
    else:
        wire_packed = _wire_out(packed, wire)
    csum = wire_checksum(wire_packed) if checksum else None
    seg = spec.seg_expand(dev)
    sizes_t, _, pos_in_leaf = _compact_constants(spec, dev)
    cands, effs, raws, oks, scls = [], [], [], [], []
    for i, nb in enumerate(topo.neighbors):
        got_packed = recv_from(wire_packed, topo, nb)
        got_vec = recv_from(fire_vec, topo, nb)
        got_s = None if scale_vec is None else recv_from(scale_vec, topo, nb)
        if corrupt is not None:
            got_packed = corrupt(i, got_packed)
        eff = got_vec
        if integrity:
            dec = (got_packed.to(torch.float32)
                   if got_packed.is_floating_point() else got_s)
            ok = _verify_wire(
                got_packed, recv_from(csum, topo, nb) if checksum else None,
                dec, checksum, finite)
            eff = eff & ok[:, None]
            oks.append(ok)
        if deliver is not None:
            eff = eff & deliver[:, i:i + 1]
        # the offsets ride implicitly: recomputed from the fire bits
        got_offsets, _ = _fired_offsets(got_vec, sizes_t)
        src = got_offsets.long()[:, seg].add_(pos_in_leaf).clamp_(
            0, capacity - 1)
        val = torch.gather(got_packed, -1, src)
        # free the [R, n] int64 index before the next neighbour builds its
        # own: one lives at a time
        del src
        if not carrier:
            val = val.to(payload.dtype)
            if got_s is not None:
                val = val * got_s[:, seg]
        cands.append(val)
        effs.append(eff)
        raws.append(got_vec)
        scls.append(got_s)
    if carrier:
        return tuple(cands), tuple(effs), tuple(raws), (
            tuple(scls) if wire == "int8" else None
        )
    if integrity:
        return tuple(cands), tuple(effs), tuple(raws), torch.stack(oks, -1)
    return tuple(cands), tuple(effs), tuple(raws)


def commit_bufs_flat(
    cands: Tuple[torch.Tensor, ...],
    effs: Tuple[torch.Tensor, ...],
    lasts: Tuple[torch.Tensor, ...],
    spec: "arena.ArenaSpec",
) -> Tuple[torch.Tensor, ...]:
    """new_buf_i = where(eff_i per position, candidate_i, stale_i): the
    receive-buffer commit, one wide select per neighbor (any dtype, so
    carriers commit through it too)."""
    seg = spec.seg_expand(lasts[0].device if lasts else None)
    return tuple(
        torch.where(e[:, seg], c, l) for c, e, l in zip(cands, effs, lasts)
    )


def commit_carrier_scales(
    cand_scales: Tuple[torch.Tensor, ...],
    effs: Tuple[torch.Tensor, ...],
    last_scales: Tuple[torch.Tensor, ...],
) -> Tuple[torch.Tensor, ...]:
    """Per-neighbor `[R, L]` scale commit riding the carrier buffer
    commit: a fired leaf adopts the scale its candidate crossed the wire
    with, a stale leaf keeps the scale of its resident carrier."""
    return tuple(
        torch.where(e, sc, sl)
        for sc, e, sl in zip(cand_scales, effs, last_scales)
    )


def dequant_carrier_bufs(
    bufs: Tuple[torch.Tensor, ...],
    scales: "Optional[Tuple[torch.Tensor, ...]]",
    spec: "arena.ArenaSpec",
) -> Tuple[torch.Tensor, ...]:
    """The f32 view of carrier-resident `[..., n]` receive buffers —
    exactly what the f32-resident layout would have stored (the test
    shim; the hot path never materializes it). A bucketed buffer (a
    tuple of per-bucket carriers, with per-bucket scales) dequantizes
    bucket by bucket and comes back as the same tuple."""
    out = []
    for i, buf in enumerate(bufs):
        if isinstance(buf, tuple):
            ks = len(buf)
            out.append(tuple(
                _dequant(buf[b], None if scales is None else scales[i][b],
                         spec.buckets(ks)[b].seg_expand(buf[b].device))
                for b in range(ks)))
        else:
            out.append(_dequant(
                buf, None if scales is None else scales[i],
                spec.seg_expand(buf.device)))
    return tuple(out)


def _dequant(buf, scale, seg):
    val = buf.to(torch.float32)
    return val if scale is None else val * scale[..., seg]


def wire_real_bytes_per_neighbor(
    n_params: int,
    n_leaves: int,
    wire=None,
    compact_capacity: "Optional[int]" = None,
    fire_bits: bool = False,
) -> float:
    """Bytes ONE neighbor exchange actually moves: `n_params` value lanes
    regardless of fire bits on the dense and masked wires,
    `compact_capacity` lanes on the compact wire, plus the `[n_leaves]`
    bool fire vector on the event path and the `[n_leaves]` f32 scale
    vector the int8 wire always ships."""
    check_wire(wire)
    elems = n_params if compact_capacity is None else int(compact_capacity)
    b = WIRE_VAL_BYTES[wire] * float(elems)
    if fire_bits:
        b += 1.0 * n_leaves
    if wire == "int8":
        b += 4.0 * n_leaves
    return b


def fired_wire_bytes_per_neighbor(
    fired_elems: float, fired_leaves: float, wire=None,
) -> float:
    """Bytes of useful (fired) payload one neighbor exchange carries: the
    compact wire's capacity-utilization numerator, beside the static
    capacity `wire_real_bytes_per_neighbor` counts. The accounting's
    constants: WIRE_VAL_BYTES per element, one f32 scale per fired leaf
    on the int8 wire."""
    b = WIRE_VAL_BYTES[wire] * float(fired_elems)
    if wire == "int8":
        b += 4.0 * float(fired_leaves)
    return b


# ---------------------------------------------------------------------------
# the bucketed schedule: one leaf-aligned bucket of the arena per call
# (`arena.BucketSpec`), the wire semantics of the flat functions above.
# Each bucket's lanes are bitwise the bucket's columns of the monolithic
# wire (per-leaf int8 scales do not depend on the bucket), so the K-bucket
# schedule reproduces the monolithic step exactly.


def bucketed_capacity_floor(buckets) -> int:
    """Smallest legal total compact capacity under a bucketed schedule:
    every bucket must ship its own largest leaf whole, so the floor is
    the sum of the per-bucket floors."""
    return int(sum(b.floor for b in buckets))


def split_capacity(capacity: int, buckets) -> Tuple[int, ...]:
    """Split a total compact capacity into per-bucket static budgets:
    element-proportional shares, each at least its bucket's floor, that
    sum exactly to `capacity` (largest remainder first, ties to the lower
    index), so the bucketed wire moves the monolithic wire's total value
    lanes. Raises below `bucketed_capacity_floor`."""
    capacity = int(capacity)
    floors = [int(b.floor) for b in buckets]
    if sum(floors) > capacity:
        raise ValueError(
            f"compact capacity {capacity} is below the bucketed floor "
            f"{sum(floors)} (sum of per-bucket largest leaves): some "
            "bucket's largest leaf could never ship and would starve — "
            "raise the capacity or lower the bucket count"
        )
    total = sum(int(b.size) for b in buckets)
    raw = [capacity * int(b.size) / total for b in buckets]
    caps = [max(f, int(r)) for f, r in zip(floors, raw)]
    rem = capacity - sum(caps)
    order = sorted(range(len(caps)),
                   key=lambda i: (-(raw[i] - int(raw[i])), i))
    j = 0
    while rem != 0:
        i = order[j % len(order)]
        if rem > 0:
            caps[i] += 1
            rem -= 1
        elif caps[i] > floors[i]:
            caps[i] -= 1
            rem += 1
        j += 1
    return tuple(caps)


def bucketed_wire_real_bytes_per_neighbor(
    buckets, wire=None, caps: "Optional[Tuple[int, ...]]" = None,
) -> Tuple[float, ...]:
    """Per-bucket wire truth of the bucketed schedule: bucket b ships its
    value lanes (`caps[b]` on the compact wire, its element count
    otherwise) plus its own fire-bit vector (and int8 scale vector). The
    sum over buckets equals the monolithic number exactly."""
    return tuple(
        wire_real_bytes_per_neighbor(
            int(b.size), b.n_leaves, wire,
            compact_capacity=None if caps is None else int(caps[i]),
            fire_bits=True,
        )
        for i, b in enumerate(buckets)
    )


def _carrier_check(carrier: bool, wire) -> None:
    if carrier and wire not in ("bf16", "int8"):
        raise ValueError(
            f"carrier-resident exchange needs a bf16/int8 wire; got {wire!r}"
        )


def masked_neighbor_vals_bucket(
    payload: torch.Tensor,
    fire_vec: torch.Tensor,
    topo: Topology,
    bucket: "arena.BucketSpec",
    wire=None,
    scale_vec: "Optional[torch.Tensor]" = None,
    wire_builder=None,
    carrier: bool = False,
    deliver=None,
):
    """One bucket of the event-triggered masked exchange.

    `payload` is the whole `[R, n]` parameter arena (the bucket's columns
    `[start, start + size)` are read in place), `fire_vec` the
    bucket-local `[R, L_b]` fire bits, `scale_vec` the bucket's `[R, L_b]`
    columns of the per-leaf int8 scales (required for int8).
    `wire_builder` — a callable (flat, fire_exp, scale_exp|None, off) ->
    f32 wire, the pitched forms of the masked-wire kernels — builds the
    bucket's wire in one pass; else plain tensor ops build the same bits.
    Returns the flat exchange's (candidates, effective bits, raw bits),
    every array bucket-sized, and with `carrier=True` the candidates in
    the wire dtype plus the per-neighbor received `[R, L_b]` scales
    (int8; None for bf16). `deliver` (bool `[R, n_nb]`, the pass's chaos
    delivery bits) clears a dropped edge's effective bits in every
    bucket alike: a drop drops the whole message."""
    _carrier_check(carrier, wire)
    check_wire(wire)
    dev = payload.device
    seg = bucket.seg_expand(dev)
    fire_exp = fire_vec.to(torch.float32)[:, seg]
    view = payload[:, bucket.start:bucket.start + bucket.size]
    if wire == "int8":
        scale_exp = scale_vec[:, seg]
        if wire_builder is not None:
            q = wire_builder(payload, fire_exp, scale_exp, bucket.start)
            wire_buf = q.to(torch.int8)
        else:
            zero = torch.zeros((), dtype=payload.dtype, device=dev)
            wire_buf = torch.clamp(torch.round(
                torch.where(fire_exp > 0, view, zero) / scale_exp),
                -127, 127).to(torch.int8)
    else:
        if wire_builder is not None:
            masked = wire_builder(payload, fire_exp, None, bucket.start)
        else:
            zero = torch.zeros((), dtype=payload.dtype, device=dev)
            masked = torch.where(fire_exp > 0, view, zero)
        wire_buf = _wire_out(masked, wire)
    cands, raws, scls = [], [], []
    for nb in topo.neighbors:
        got = recv_from(wire_buf, topo, nb)
        got_s = None if scale_vec is None else recv_from(scale_vec, topo, nb)
        if not carrier:
            got = got.to(payload.dtype)
            if got_s is not None:
                got = got * got_s[:, seg]
        cands.append(got)
        raws.append(recv_from(fire_vec, topo, nb))
        scls.append(got_s)
    return _bucket_result(cands, raws, scls, wire, carrier, deliver)


def _bucket_result(cands, raws, scls, wire, carrier, deliver):
    """A bucket exchange's triple (carrier: plus the received scales),
    the effective bits the raw ones cleared on undelivered edges."""
    effs = tuple(raws) if deliver is None else tuple(
        raw & deliver[:, i:i + 1] for i, raw in enumerate(raws))
    if carrier:
        return tuple(cands), effs, tuple(raws), (
            tuple(scls) if wire == "int8" else None
        )
    return tuple(cands), effs, tuple(raws)


def compact_neighbor_vals_bucket(
    packed: torch.Tensor,
    leaf_id: torch.Tensor,
    fire_vec: torch.Tensor,
    topo: Topology,
    bucket: "arena.BucketSpec",
    capacity: int,
    dtype=torch.float32,
    wire=None,
    scale_vec: "Optional[torch.Tensor]" = None,
    carrier: bool = False,
    deliver=None,
):
    """One bucket of the budgeted compact exchange.

    `packed` / `leaf_id` come from `_compact_pack` over the bucket's
    columns with its bucket-local `capacity` (one share of
    `split_capacity`); `fire_vec` is the bucket-local capacity-gated
    `[R, L_b]` bits, `scale_vec` the bucket's `[R, L_b]` int8 scales. The
    offsets stay implicit: the receiver recomputes them from the bucket's
    fire bits, so deferral re-contends within the bucket. Returns the
    flat exchange's triple (carrier: plus the received scales), every
    array bucket-sized; `deliver` as `masked_neighbor_vals_bucket`."""
    _carrier_check(carrier, wire)
    check_wire(wire)
    capacity = int(capacity)
    if capacity < bucket.floor:
        raise ValueError(
            f"bucket {bucket.index}: compact capacity {capacity} is "
            f"below its largest leaf ({bucket.floor} elements) — use "
            "split_capacity, which enforces per-bucket floors"
        )
    dev = packed.device
    if wire == "int8":
        wire_packed = _int8_encode_flat(packed, scale_vec, leaf_id)
    else:
        wire_packed = _wire_out(packed, wire)
    seg = bucket.seg_expand(dev)
    sizes_t, _, pos_in_leaf = _compact_constants(
        bucket_spec_of(bucket), dev)
    cands, raws, scls = [], [], []
    for nb in topo.neighbors:
        got_packed = recv_from(wire_packed, topo, nb)
        got_vec = recv_from(fire_vec, topo, nb)
        got_s = None if scale_vec is None else recv_from(scale_vec, topo, nb)
        got_offsets, _ = _fired_offsets(got_vec, sizes_t)
        src = got_offsets.long()[:, seg].add_(pos_in_leaf).clamp_(
            0, capacity - 1)
        val = torch.gather(got_packed, -1, src)
        del src
        if not carrier:
            val = val.to(dtype)
            if got_s is not None:
                val = val * got_s[:, seg]
        cands.append(val)
        raws.append(got_vec)
        scls.append(got_s)
    return _bucket_result(cands, raws, scls, wire, carrier, deliver)


def bucket_spec_of(bucket: "arena.BucketSpec") -> "arena.ArenaSpec":
    """A bucket's leaf layout as an ArenaSpec (sizes and bucket-local
    starts; the names are placeholders): the compact constants' key."""
    return _bucket_layout(bucket.sizes, bucket.starts_rel, bucket.size)


@functools.lru_cache(maxsize=64)
def _bucket_layout(sizes, starts, total) -> "arena.ArenaSpec":
    return arena.ArenaSpec(
        names=tuple(f"leaf{i}" for i in range(len(sizes))),
        shapes=tuple((z,) for z in sizes), sizes=sizes, starts=starts,
        n_total=total,
    )


def mix_carrier_flat_into_tree(
    params: Dict[str, torch.Tensor],
    bufs: Tuple[torch.Tensor, ...],
    scales: "Optional[Tuple[torch.Tensor, ...]]",
    spec: "arena.ArenaSpec",
    topo: Topology,
) -> Dict[str, torch.Tensor]:
    """The gossip mix of per-leaf parameters (a dict of `[R, *shape]`
    leaves in flax order, torch layout) with carrier-resident flat `[R,
    n]` buffers: per leaf `(p + dq(buf_0) + dq(buf_1) + ...) * w`, each
    buffer slice upcast and, for int8, multiplied by the leaf's scalar
    scale. Elementwise the dequantized slice equals what the f32-resident
    buffer stored, so the mix is bitwise the f32-resident mix (the plain
    twin of the mix kernel 5 runs in the step)."""
    w = float(np.float32(topo.mix_weight))
    out = {}
    for k, (name, shape, start, size) in enumerate(zip(
            spec.names, spec.shapes, spec.starts, spec.sizes)):
        p = params[name]
        acc = p
        for i, buf in enumerate(bufs):
            piece = buf[:, start:start + size].to(p.dtype)
            if scales is not None:
                piece = piece * scales[i][:, k:k + 1].to(p.dtype)
            acc = acc + piece.reshape(p.shape)
        out[name] = acc * w
    return out
