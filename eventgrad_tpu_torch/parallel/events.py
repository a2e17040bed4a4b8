"""EventGraD: per-parameter event-triggered communication state machine.

Port of `eventgrad_tpu/parallel/events.py` (`EventConfig`, `EventState`
with f32 or carrier-resident arena buffers and no delivery queue, `propose`,
`propose_from_norms`, `commit`, the compact wire's `capacity_gate`; the
bounded-async queues wait).

  * event condition:  fire_i <- |‖p_i‖₂ − last_sent_norm_i| >= thres_i
                                OR pass_num < warmup_passes
                                OR iter_diff_i >= max_silence (if > 0)
  * threshold decay BEFORE the check (adaptive: thres *= horizon;
    constant mode: thres = constant)
  * on fire (adaptive): the slope history shifts in value_diff/iter_diff
    and thres becomes the history mean; last_sent_norm/iter update
  * num_events += n_neighbors per fired parameter

The state is a set of `[..., L]` vectors over the leaf axis (leaf order of
`parallel/arena.py`); every op is elementwise over leading dimensions, so
the same functions serve one rank (`[L]`) and the rank-stacked `[R, L]`
state, with the same float32 arithmetic in the same order as the JAX
package — bitwise on equal norms.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.parallel import arena as arena_lib
from eventgrad_tpu_torch.parallel.topology import Topology


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Static event-trigger configuration (see the JAX EventConfig).

    adaptive=True  -> thres decays by `horizon` each pass and resets to the
                      mean send slope on fire.
    adaptive=False -> thres is the fixed `constant` every pass.
    max_silence > 0 fires a parameter that has been silent that many
    passes regardless of its norm drift (0 disables).
    """

    adaptive: bool = True
    horizon: float = 0.95
    constant: float = 0.0
    warmup_passes: int = 30
    history: int = 2
    max_silence: int = 0


def _f32(x: float) -> float:
    """A Python scalar rounded to float32 — the value a weakly typed
    scalar takes in JAX's float32 arithmetic."""
    return float(np.float32(x))


@dataclasses.dataclass
class EventState:
    """Sender-side per-parameter state + per-neighbor receive buffers.

    thres / last_sent_norm / last_sent_iter: f32 `[..., L]`.
    slopes: f32 `[..., L, history]`.
    bufs:   one `[R, n]` arena per topology neighbor (the RMA window
            halves), zero-initialized like the reference: f32, or the
            wire carrier (bf16/int8) under carrier residency.
    num_events / num_deferred: int32 `[...]` cumulative counters.
    buf_scales: per-neighbor f32 `[R, L]` dequant scales of int8-resident
            buffers; None for f32/bf16 residency.
    """

    thres: torch.Tensor
    last_sent_norm: torch.Tensor
    last_sent_iter: torch.Tensor
    slopes: torch.Tensor
    bufs: Tuple[torch.Tensor, ...]
    num_events: torch.Tensor
    num_deferred: torch.Tensor
    buf_scales: Optional[Tuple[torch.Tensor, ...]] = None

    def replace(self, **kw) -> "EventState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(
        cls, spec: "arena_lib.ArenaSpec", topo: Topology, cfg: EventConfig,
        *, resident_wire=None, device=None, with_bufs: bool = True,
    ) -> "EventState":
        """Rank-stacked zero state over `topo.n_ranks` ranks with flat
        arena receive buffers. `resident_wire` ("bf16" | "int8") stores
        them carrier-resident: in the wire dtype, plus the per-leaf int8
        dequant scales in `buf_scales`. `with_bufs=False` leaves them out
        (sp_eventgrad keeps its replicas in a `SparseState`)."""
        r, n = topo.n_ranks, spec.n_leaves
        bufs, buf_scales = arena_lib.alloc_event_bufs(
            spec, topo.n_neighbors if with_bufs else 0, r,
            wire=resident_wire, device=device,
        )
        zeros = lambda: torch.zeros((r, n), dtype=torch.float32, device=device)
        return cls(
            thres=zeros(),
            last_sent_norm=zeros(),
            last_sent_iter=zeros(),
            slopes=torch.zeros((r, n, cfg.history), dtype=torch.float32,
                               device=device),
            bufs=bufs,
            num_events=torch.zeros((r,), dtype=torch.int32, device=device),
            num_deferred=torch.zeros((r,), dtype=torch.int32, device=device),
            buf_scales=buf_scales,
        )


@dataclasses.dataclass
class EventProposal:
    """Sender decision for one pass, before any wire-budget gating:
    everything `commit` needs once the effective fire bits are known."""

    fire_vec: torch.Tensor    # bool [..., L] — the un-gated decision
    curr_norm: torch.Tensor   # f32 [..., L]
    new_slopes: torch.Tensor  # f32 [..., L, history]
    thres: torch.Tensor       # f32 [..., L] post-decay, pre-fire threshold
    iter_diff: torch.Tensor   # f32 [..., L] passes since last send
    pass_f: torch.Tensor      # f32 [] — this pass, as float
    value_diff: torch.Tensor  # f32 [..., L] |‖p‖₂ − last_sent_norm|


def leaf_norms(flat: torch.Tensor, spec: "arena_lib.ArenaSpec") -> torch.Tensor:
    """Per-leaf L2 norms of an `[..., n]` arena, stacked to `[..., L]`.
    The reduction order is torch's, so a norm may differ from the JAX
    package's in the last bit (the one legitimate source of trigger
    disagreement on equal parameters)."""
    return torch.stack(
        [torch.linalg.vector_norm(v, dim=-1) for v in spec.leaf_views(flat)],
        dim=-1,
    ).to(torch.float32)


def propose(
    flat: torch.Tensor,
    state: EventState,
    pass_num: int,
    cfg: EventConfig,
    spec: "arena_lib.ArenaSpec",
    force_fire: Optional[torch.Tensor] = None,
) -> EventProposal:
    """One pass of the sender trigger for every parameter at once, on the
    parameter arena `flat`. `pass_num` is 1-based and already incremented
    for this pass. `force_fire` (bool, broadcast to `[..., L]`) ORs into
    the decision: a forced fire updates the state and counters like any
    fire (the micro policy's owned partition)."""
    return propose_from_norms(leaf_norms(flat, spec), state, pass_num, cfg,
                              force_fire=force_fire)


def propose_from_norms(
    curr_norm: torch.Tensor,
    state: EventState,
    pass_num: int,
    cfg: EventConfig,
    force_fire: Optional[torch.Tensor] = None,
) -> EventProposal:
    """`propose` with the `[..., L]` parameter norms precomputed."""
    pass_f = torch.tensor(float(pass_num), dtype=torch.float32,
                          device=curr_norm.device)
    value_diff = torch.abs(curr_norm - state.last_sent_norm)
    iter_diff = pass_f - state.last_sent_iter

    # threshold decay/assignment happens before the check
    if cfg.adaptive:
        thres = state.thres * _f32(cfg.horizon)
    else:
        thres = torch.full_like(state.thres, _f32(cfg.constant))

    fire_vec = value_diff >= thres
    if int(pass_num) < cfg.warmup_passes:
        fire_vec = torch.ones_like(fire_vec)
    if cfg.max_silence > 0:  # bounded staleness (beyond-reference)
        fire_vec = fire_vec | (iter_diff >= float(cfg.max_silence))
    if force_fire is not None:
        fire_vec = fire_vec | force_fire

    # slope ring buffer: drop oldest, append value_diff/iter_diff
    new_slopes = torch.cat(
        [state.slopes[..., 1:], (value_diff / iter_diff)[..., None]], dim=-1
    )
    return EventProposal(
        fire_vec=fire_vec,
        curr_norm=curr_norm,
        new_slopes=new_slopes,
        thres=thres,
        iter_diff=iter_diff,
        pass_f=pass_f,
        value_diff=value_diff,
    )


def commit(
    state: EventState,
    prop: EventProposal,
    fire_vec: torch.Tensor,
    cfg: EventConfig,
    n_neighbors: int,
) -> EventState:
    """Apply one pass's state update for the leaves that actually fired.
    `fire_vec` is the effective decision; proposed-but-not-committed
    leaves count into `num_deferred` and keep their state."""
    slope_avg = torch.mean(prop.new_slopes, dim=-1)
    thres_on_fire = slope_avg if cfg.adaptive else prop.thres
    deferred = torch.sum(prop.fire_vec & ~fire_vec, dim=-1, dtype=torch.int32)
    fired = torch.sum(fire_vec, dim=-1, dtype=torch.int32)
    return state.replace(
        thres=torch.where(fire_vec, thres_on_fire, prop.thres),
        last_sent_norm=torch.where(fire_vec, prop.curr_norm,
                                   state.last_sent_norm),
        last_sent_iter=torch.where(fire_vec, prop.pass_f,
                                   state.last_sent_iter),
        slopes=torch.where(fire_vec[..., None], prop.new_slopes, state.slopes),
        num_events=state.num_events + int(n_neighbors) * fired,
        num_deferred=state.num_deferred + deferred,
    )


def capacity_gate(
    fire_vec: torch.Tensor,
    sizes,
    capacity: int,
    priority: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Admit fired leaves into a static wire budget of `capacity`
    elements; defer the overflow.

    Greedy prefix admission over the cumulative fired sizes of each
    `[..., L]` row, in a stable priority order: fired leaves flagged in
    `priority` (overdue per max_silence, forced) claim budget first, then
    the rest, each group in leaf order. A mid-list overflow also defers
    later leaves that would still fit: the offsets must be a pure
    function of the admitted bits, which the receiver recomputes.
    Returns the effective fire bits, a subset of `fire_vec`; the caller
    commits the event state with them, so a deferred leaf re-contends
    next pass. `sizes` is the `[L]` leaf sizes (a tensor or a
    sequence)."""
    sizes_t = torch.as_tensor(sizes, dtype=torch.int32,
                              device=fire_vec.device)
    zero = torch.zeros((), dtype=torch.int32, device=fire_vec.device)
    if priority is None:
        ends = torch.cumsum(torch.where(fire_vec, sizes_t, zero), dim=-1,
                            dtype=torch.int32)
        return fire_vec & (ends <= capacity)
    pri = torch.broadcast_to(priority, fire_vec.shape)
    # a stable argsort of the not-priority bit: priority-fired leaves
    # first, then the rest, each in leaf order
    order = torch.argsort((~(pri & fire_vec)).to(torch.int32), dim=-1,
                          stable=True)
    fire_p = torch.gather(fire_vec, -1, order)
    ends_p = torch.cumsum(torch.where(fire_p, sizes_t[order], zero), dim=-1,
                          dtype=torch.int32)
    keep_p = fire_p & (ends_p <= capacity)
    return torch.zeros_like(fire_vec).scatter(-1, order, keep_p)
