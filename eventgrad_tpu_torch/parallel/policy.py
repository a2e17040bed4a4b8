"""Trigger policies: which leaves an event step proposes to send, and
what ships.

Port of `eventgrad_tpu/parallel/policy.py`: the partition geometry of
the partitioned policies (`partition_masks`, `partition_table`,
`validate_partitions`, `max_partition_elems`, `ownership_vec`), the
top-k payload helpers `topk_payload` and `scatter_into`, and the four
policies `NormDelta`, `TopK`, `Micro` and `Hybrid`, all driving the same
norm-delta trigger state machine through `events.propose` /
`events.commit`. Of the JAX package's `WireSpec` the port's guards read
`algos` (the train-step branches a policy drives), `gossip_wires`,
`compact_needs_capacity` and `partitioned`, which each policy keeps as
class attributes.

`micro` and `hybrid` (after MiCRO, arXiv:2310.00967): the arena is cut
into `n_ranks` element-balanced leaf-aligned partitions
(`ArenaSpec.buckets`), and rank r owns partition `(r + pass_num) mod K`
each pass, so ownership is implicit and the wire needs no index lanes.
From the trigger's warmup on, micro ships exactly its owned partition
(force = owned, suppress = not owned) and hybrid ships the fired leaves
of it (suppress = not owned); both ride the compact wire at a capacity
of at least the largest partition. The warmup passes full-fire as
norm_delta's do: the JAX package measured that suppressing them
collapses training (its `Micro` docstring).

The top-k helpers work on the flat arena (`parallel/arena.py`): values
and indices of every leaf concatenated in leaf order into `[R, K]`
tensors, K = sum of the per-leaf k. The indices are the JAX package's:
positions in the leaf flattened in flax's layout (HWIO convolutions,
`(in, out)` dense kernels), so they select the same elements as the JAX
package's and `arena.flax_positions` maps them to the arena. Ties break
as `lax.top_k` breaks them, lower index first, by a stable descending
sort: at a sender's first exchange |p - prev_sent| is all zeros, and on
the int8 wire the chosen values set the per-leaf scale.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from eventgrad_tpu_torch.parallel import events
from eventgrad_tpu_torch.parallel.arena import ArenaSpec, flax_positions
from eventgrad_tpu_torch.parallel.topology import Topology


def partition_masks(
    spec: ArenaSpec, n_parts: int
) -> Tuple[Tuple[bool, ...], ...]:
    """Static `[K][L]` leaf masks of the partitions: the leaf-aligned
    element-balanced buckets `spec.buckets(n_parts)`, K clamped to the
    leaf count."""
    return tuple(
        tuple(b.lo <= leaf < b.hi for leaf in range(spec.n_leaves))
        for b in spec.buckets(int(n_parts))
    )


def partition_table(spec: ArenaSpec, n_parts: int) -> Tuple[Dict[str, int], ...]:
    """Each partition's leaf and element range."""
    return tuple(
        {"index": b.index, "lo": b.lo, "hi": b.hi,
         "start": b.start, "size": b.size}
        for b in spec.buckets(int(n_parts))
    )


def validate_partitions(spec: ArenaSpec, n_parts: int) -> Dict[str, Any]:
    """The partition geometry's invariants, checked on the masks
    themselves: disjoint (no leaf in two partitions), exact_cover (every
    leaf in one), balanced (the largest partition at most
    ceil(n_total / K) plus the largest leaf)."""
    masks = partition_masks(spec, n_parts)
    k = len(masks)
    claims = [sum(m[leaf] for m in masks) for leaf in range(spec.n_leaves)]
    disjoint = all(c <= 1 for c in claims)
    exact_cover = all(c == 1 for c in claims)
    sizes = [sum(sz for sz, on in zip(spec.sizes, m) if on) for m in masks]
    bound = -(-spec.n_total // max(1, k)) + max(spec.sizes)
    balanced = bool(sizes) and max(sizes) <= bound
    return {
        "n_partitions": k,
        "sizes": sizes,
        "max_partition_elems": max(sizes) if sizes else 0,
        "disjoint": bool(disjoint),
        "exact_cover": bool(exact_cover),
        "balanced": bool(balanced),
        "ok": bool(disjoint and exact_cover and balanced),
    }


def max_partition_elems(spec: ArenaSpec, n_parts: int) -> int:
    """The compact capacity floor of a partitioned policy: the largest
    partition must ship whole."""
    return max(b.size for b in spec.buckets(int(n_parts)))


@functools.lru_cache(maxsize=16)
def _ownership_constants(spec: ArenaSpec, n_ranks: int, device):
    """(`[K, L]` bool partition masks, `[R]` int64 rank indices) on one
    device, built once: read only."""
    masks = torch.tensor(partition_masks(spec, n_ranks), dtype=torch.bool,
                         device=device)
    return masks, torch.arange(n_ranks, device=device)


def ownership_vec(
    spec: ArenaSpec, topo: Topology, pass_num: int, device=None,
) -> torch.Tensor:
    """`[R, L]` bool: the leaves of the partition each rank owns this
    pass, `(r + pass_num) mod K` over K = n_ranks partitions (clamped to
    the leaf count). The rank r is the row of the rank-stacked layout,
    the row-major ravel of the topology coordinates, as the JAX package
    numbers ranks (on a mesh, the rows this process holds)."""
    masks, ranks = _ownership_constants(spec, topo.n_ranks,
                                        torch.device(device or "cpu"))
    return masks[(topo.local_rows(ranks) + int(pass_num)) % masks.shape[0]]


@functools.lru_cache(maxsize=16)
def topk_layout(spec: ArenaSpec, ks: Tuple[int, ...]) -> ArenaSpec:
    """The `[R, K]` payload's layout: one segment of k_i lanes per leaf,
    in leaf order (the segment map and per-leaf reductions of the
    arena's own spec then serve the payload)."""
    return ArenaSpec(
        names=spec.names, shapes=tuple((k,) for k in ks), sizes=tuple(ks),
        starts=tuple(sum(ks[:i]) for i in range(len(ks))), n_total=sum(ks),
    )


def topk_payload(
    flat: torch.Tensor, prev_sent: torch.Tensor, ks: Tuple[int, ...],
    spec: ArenaSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per leaf, the `ks[i]` largest |p - prev_sent| entries of the
    `[R, n]` arenas: (values `[R, K]` f32, the CURRENT parameter there;
    indices `[R, K]` int32, flax-layout positions in the leaf). The
    selection is `lax.top_k`'s, ties to the lower index."""
    perm = flax_positions(spec, flat.device)
    flat_f = flat[:, perm]
    diff_f = torch.abs(flat_f - prev_sent[:, perm])
    idxs = []
    for start, size, k in zip(spec.starts, spec.sizes, ks):
        _, order = torch.sort(diff_f[:, start:start + size], dim=-1,
                              descending=True, stable=True)
        idxs.append(order[:, :k])
    idx = torch.cat(idxs, dim=-1)
    starts = _k_starts(spec, ks, flat.device)
    vals = torch.gather(flat_f, 1, idx + starts)
    return vals, idx.to(torch.int32)


@functools.lru_cache(maxsize=16)
def _k_starts(spec: ArenaSpec, ks: Tuple[int, ...], device) -> torch.Tensor:
    """`[K]` int64: the arena start of the leaf each payload lane
    belongs to (cached per device: read only)."""
    lay = topk_layout(spec, ks)
    return torch.tensor(spec.starts, dtype=torch.int64)[
        lay.seg_expand()].to(device)


def scatter_into(
    full: torch.Tensor, vals: torch.Tensor, idxs: torch.Tensor,
    gate: torch.Tensor, ks: Tuple[int, ...], spec: ArenaSpec,
    lanes: Optional[Tuple[int, int]] = None,
    leaves: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Write the `[R, K]` `vals` at the leaf positions `idxs` (flax
    layout) of the `[R, n]` arena `full`, for the leaves whose `[R, L]`
    `gate` bit is set; every other leaf keeps its values. The receiver's
    replica update and the sender's prev_sent update (gate = fire).
    `lanes=(k0, k1)` and `leaves=(l0, l1)` scatter one bucket's share:
    `vals`/`idxs` are then the payload lanes `[k0, k1)` and `gate` the
    bits of leaves `[l0, l1)`."""
    dev = full.device
    lay = topk_layout(spec, ks)
    starts, kseg = _k_starts(spec, ks, dev), lay.seg_expand(dev)
    if lanes is not None:
        # one bucket: its lanes, and its leaves' gate bits re-based
        starts, kseg = starts[lanes[0]:lanes[1]], kseg[lanes[0]:lanes[1]]
        kseg = kseg - leaves[0]
    pos = flax_positions(spec, dev)[idxs.to(torch.int64) + starts]
    v = torch.where(gate[:, kseg], vals, torch.gather(full, 1, pos))
    return torch.scatter(full, 1, pos, v)


class NormDelta:
    """The EventGraD norm-delta trigger on the masked or compact event
    exchange; its proposal is `ops.event_engine.event_propose_pack`."""

    name = "norm_delta"
    #: the train-step branches the policy drives
    algos = ("eventgrad",)
    #: the gossip wires its payload can ride
    gossip_wires = ("masked", "compact")
    #: "compact" needs a static element budget (False: the wire is
    #: statically sized without one, and compact is a no-op alias)
    compact_needs_capacity = True
    #: the payload is restricted to the rotating owned partition
    partitioned = False

    def commit(self, state, prop, fire_vec, cfg, n_neighbors):
        return events.commit(state, prop, fire_vec, cfg, n_neighbors)

    def masks(self, spec, topo, pass_num, cfg, device=None):
        """(force_fire, suppress_fire) for this pass, each None or `[R, L]`
        bool; suppression wins over force (`event_propose_pack`)."""
        return None, None


class TopK(NormDelta):
    """sp_eventgrad's magnitude top-k selection, driven by the shared
    norm-delta trigger state. Its wire is physically sparse and
    statically sized: k values and k int32 indices per leaf, so
    "compact" is a capacity-free no-op alias of it."""

    name = "topk"
    algos = ("sp_eventgrad",)
    compact_needs_capacity = False


class Micro(NormDelta):
    """Partitioned sends, rotated for gossip: each rank ships exactly
    its owned partition (force = owned, suppress = not owned), the
    suppression from the trigger's warmup on."""

    name = "micro"
    partitioned = True

    def masks(self, spec, topo, pass_num, cfg, device=None):
        owned = ownership_vec(spec, topo, pass_num, device)
        return owned, (~owned if pass_num >= cfg.warmup_passes else None)


class Hybrid(NormDelta):
    """The norm-delta gate on micro's payload: a leaf ships when the
    trigger fires and it lies in the owned partition (suppression from
    the warmup on). Suppressed leaves are not committed, so their
    thresholds keep decaying until their partition rotates back in."""

    name = "hybrid"
    partitioned = True

    def masks(self, spec, topo, pass_num, cfg, device=None):
        if pass_num < cfg.warmup_passes:
            return None, None
        return None, ~ownership_vec(spec, topo, pass_num, device)


POLICIES: Dict[str, NormDelta] = {
    p.name: p for p in (NormDelta(), TopK(), Micro(), Hybrid())
}

#: the policy an algo runs when none is named
DEFAULT_FOR_ALGO: Dict[str, str] = {
    "eventgrad": "norm_delta",
    "sp_eventgrad": "topk",
}


def check_compact(pol: Optional[NormDelta], algo: str) -> None:
    """Raise unless the resolved policy `pol` (None: an algo without an
    event trigger) declares the compact wire."""
    if pol is None or "compact" not in pol.gossip_wires:
        raise ValueError(
            "gossip_wire='compact' rides the statically-sized wire of an "
            "event trigger policy (algos: eventgrad, sp_eventgrad); "
            f"algo={algo!r} with policy {pol.name if pol else 'none'!r} "
            "declares no compact wire (parallel/policy.py)"
        )


def resolve(name: Optional[str], algo: str) -> NormDelta:
    """The policy instance `algo` runs: the registered `name`, or the
    algo's default when None. Raises ValueError for unknown names, algos
    without an event trigger and policy/algo mismatches, in the JAX
    registry's words (the single guard `train` and `cli.py` both call)."""
    if name is None:
        default = DEFAULT_FOR_ALGO.get(algo)
        if default is None:
            raise ValueError(
                f"--algo {algo} has no event trigger; trigger policies "
                f"apply to {sorted(DEFAULT_FOR_ALGO)}"
            )
        return POLICIES[default]
    pol = POLICIES.get(name)
    if pol is None:
        raise ValueError(
            f"unknown trigger policy {name!r}; registered: "
            f"{sorted(POLICIES)} (parallel/policy.py)"
        )
    if algo not in pol.algos:
        raise ValueError(
            f"trigger policy {name!r} drives "
            f"{'/'.join(pol.algos)}, not --algo {algo}"
        )
    return pol
