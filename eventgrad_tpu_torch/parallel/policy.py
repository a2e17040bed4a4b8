"""Trigger policies: which leaves an event step proposes to send, and
what ships.

Port of `eventgrad_tpu/parallel/policy.py`: the top-k payload helpers
`topk_payload` and `scatter_into`, and the `NormDelta` and `TopK`
policies, both driving the same norm-delta trigger state machine through
the `events.propose` / `events.commit` functions. Of the JAX package's
`WireSpec` these two need only `algos`, the train-step branches a policy
drives, which each keeps as a class attribute. The partitioned policies
`micro` and `hybrid` ride the compact static-capacity wire and wait
with it (ROADMAP queue 1, item 4); they raise.

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
from typing import Dict, Optional, Tuple

import torch

from eventgrad_tpu_torch.parallel import events
from eventgrad_tpu_torch.parallel.arena import ArenaSpec, flax_positions


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
) -> torch.Tensor:
    """Write the `[R, K]` `vals` at the leaf positions `idxs` (flax
    layout) of the `[R, n]` arena `full`, for the leaves whose `[R, L]`
    `gate` bit is set; every other leaf keeps its values. The receiver's
    replica update and the sender's prev_sent update (gate = fire)."""
    dev = full.device
    lay = topk_layout(spec, ks)
    pos = flax_positions(spec, dev)[idxs.to(torch.int64) + _k_starts(spec, ks, dev)]
    v = torch.where(gate[:, lay.seg_expand(dev)], vals, torch.gather(full, 1, pos))
    return torch.scatter(full, 1, pos, v)


class NormDelta:
    """The EventGraD norm-delta trigger on the masked event exchange; its
    proposal is `ops.event_engine.event_propose_pack`."""

    name = "norm_delta"
    algos = ("eventgrad",)

    def commit(self, state, prop, fire_vec, cfg, n_neighbors):
        return events.commit(state, prop, fire_vec, cfg, n_neighbors)


class TopK(NormDelta):
    """sp_eventgrad's magnitude top-k selection, driven by the shared
    norm-delta trigger state. Its wire is physically sparse and
    statically sized: k values and k int32 indices per leaf."""

    name = "topk"
    algos = ("sp_eventgrad",)


POLICIES: Dict[str, NormDelta] = {p.name: p for p in (NormDelta(), TopK())}

#: registered in the JAX package, not ported yet
UNPORTED = ("micro", "hybrid")

#: the policy an algo runs when none is named
DEFAULT_FOR_ALGO: Dict[str, str] = {
    "eventgrad": "norm_delta",
    "sp_eventgrad": "topk",
}


def resolve(name: Optional[str], algo: str) -> NormDelta:
    """The policy instance `algo` runs: the registered `name`, or the
    algo's default when None. Raises ValueError for unknown names, algos
    without an event trigger and policy/algo mismatches, and
    NotImplementedError for policies not ported yet."""
    if name is None:
        default = DEFAULT_FOR_ALGO.get(algo)
        if default is None:
            raise ValueError(
                f"algo {algo!r} has no event trigger; trigger policies "
                f"apply to {sorted(DEFAULT_FOR_ALGO)}"
            )
        return POLICIES[default]
    if name in UNPORTED:
        raise NotImplementedError(
            f"trigger policy {name!r} rides the compact wire, which is "
            "not ported yet (ROADMAP queue 1, item 4); ported: "
            f"{sorted(POLICIES)}"
        )
    pol = POLICIES.get(name)
    if pol is None:
        raise ValueError(
            f"unknown trigger policy {name!r}; registered: "
            f"{sorted(POLICIES) + list(UNPORTED)}"
        )
    if algo not in pol.algos:
        raise ValueError(
            f"trigger policy {name!r} drives "
            f"{'/'.join(pol.algos)}, not algo {algo!r}"
        )
    return pol
