"""EventGraD: per-parameter event-triggered communication state machine.

Port of `eventgrad_tpu/parallel/events.py` (`EventConfig`, `EventState`
with f32 or carrier-resident arena buffers, monolithic or per bucket, and
the bounded-async delivery queues; `propose`, `propose_from_norms`,
`commit`, the compact wire's `capacity_gate`, the queue engine
`async_delivery_plan`, `async_bucket_commit`, `async_delivery_commit`;
and bench.py's op-point helpers `resolve_bench_trigger`,
`MNIST_FULLSCALE_OP_POINT` and `resolve_bench_trigger_mnist`, as they
are).

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
from typing import Any, Optional, Sequence, Tuple

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


def resolve_bench_trigger(environ) -> tuple:
    """(horizon, max_silence) of the benchmark op-point from the
    EG_BENCH_HORIZON / EG_BENCH_MAX_SILENCE knobs (default 1.05 and 50).
    A request with the silence guard off drops the horizon to the
    neutral 1.0 unless one was pinned: 1.05 without the guard is the
    combination that collapses seeds."""
    horizon = float(environ.get("EG_BENCH_HORIZON", "1.05"))
    max_silence = int(environ.get("EG_BENCH_MAX_SILENCE", "50"))
    if max_silence == 0 and "EG_BENCH_HORIZON" not in environ:
        horizon = 1.0
    return horizon, max_silence


#: the full-scale MNIST op-point (n_train, epochs, batch per rank): 1168
#: passes of CNN-2 at batch 64, lr 0.05, the sequential sampler
MNIST_FULLSCALE_OP_POINT = (8192, 73, 64)


def resolve_bench_trigger_mnist(environ, max_silence: int) -> float:
    """The MNIST leg's horizon, by the same rule: 1.05 with the silence
    guard, the neutral 1.0 without it, unless EG_BENCH_HORIZON_MNIST
    pins one."""
    return float(environ.get(
        "EG_BENCH_HORIZON_MNIST", "1.05" if max_silence > 0 else "1.0"
    ))


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
            wire carrier (bf16/int8) under carrier residency; under the
            bucketed schedule a tuple of `[R, n_b]` buffers per neighbor.
    num_events / num_deferred: int32 `[...]` cumulative counters.
    buf_scales: per-neighbor f32 `[R, L]` dequant scales of int8-resident
            buffers (per-bucket `[R, L_b]` tuples when bucketed); None
            for f32/bf16 residency.
    pending: the bounded-async delivery queues (staleness D >= 2; None
            otherwise): per neighbor, D slots of (candidate, eff bits,
            sent pass int32 `[R]`, late count int32 `[R]`[, scales]),
            slot r holding the in-flight message that commits r + 1
            passes from now (`arena.alloc_event_queue`).
    edge_clock: int32 `[R, n_neighbors]` — the send pass of the newest
            delivered message committed on each edge (0 = none yet);
            `pass - edge_clock` is the per-edge staleness gauge.
    late_commits: int32 `[R]` cumulative commits that arrived >= 2
            passes after their send.
    """

    thres: torch.Tensor
    last_sent_norm: torch.Tensor
    last_sent_iter: torch.Tensor
    slopes: torch.Tensor
    bufs: Tuple[torch.Tensor, ...]
    num_events: torch.Tensor
    num_deferred: torch.Tensor
    buf_scales: Optional[Tuple[Any, ...]] = None
    pending: Optional[Tuple[Any, ...]] = None
    edge_clock: Optional[torch.Tensor] = None
    late_commits: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "EventState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(
        cls, spec: "arena_lib.ArenaSpec", topo: Topology, cfg: EventConfig,
        *, resident_wire=None, device=None, with_bufs: bool = True,
        buckets: int = 1, staleness: int = 0,
    ) -> "EventState":
        """Rank-stacked zero state over `topo.n_ranks` ranks with flat
        arena receive buffers. `resident_wire` ("bf16" | "int8") stores
        them carrier-resident: in the wire dtype, plus the per-leaf int8
        dequant scales in `buf_scales`. `with_bufs=False` leaves them out
        (sp_eventgrad keeps its replicas in a `SparseState`).
        `buckets=K` (K >= 2) holds the buffers per bucket, the layout of
        the bucketed schedule; `staleness=D` (D >= 2) adds the D-deep
        delivery queues in the buffers' layout, the per-edge clocks and
        the late-commit counter."""
        r, n = topo.n_ranks, spec.n_leaves
        k = int(buckets) if buckets else 1
        bufs, buf_scales = arena_lib.alloc_event_bufs(
            spec, topo.n_neighbors if with_bufs else 0, r,
            wire=resident_wire, device=device, buckets=k,
        )
        pending = edge_clock = late_commits = None
        if with_bufs and int(staleness) >= 2:
            pending = arena_lib.alloc_event_queue(
                spec, topo.n_neighbors, r, int(staleness),
                wire=resident_wire, device=device, buckets=k,
            )
            edge_clock = torch.zeros((r, topo.n_neighbors),
                                     dtype=torch.int32, device=device)
            late_commits = torch.zeros((r,), dtype=torch.int32,
                                       device=device)
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
            pending=pending,
            edge_clock=edge_clock,
            late_commits=late_commits,
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


# ---------------------------------------------------------------------------
# the bounded-async delivery engine (staleness = D >= 2)


def async_delivery_plan(
    state: EventState,
    delivered: Optional[torch.Tensor],
    lag_vec: torch.Tensor,
    pass_num: int,
    bound: int,
):
    """The scalar half of one bounded-async pass, shared by every bucket
    of the buffer layout: the arrival clocks from slot 0's sent stamps,
    the late-commit drain, and the shift and merge of the per-slot (sent,
    late) stamps. `delivered` is bool `[R, n_nb]` (None: all delivered),
    `lag_vec` the int32 `[R, n_nb]` effective lags
    (`chaos.inject.lag_vector`).

    Returns `(here, sent_slots, late_slots, new_clock, late_now)`:
    `here[i][r]` the bool `[R]` enqueue mask of edge i's slot r (this
    pass's message lands where its lag says), `sent_slots` /
    `late_slots` the per-edge per-slot int32 `[R]` stamps after the shift
    and merge, `new_clock` the advanced `[R, n_nb]` clock, `late_now` the
    `[R]` late commits drained this pass (slot 0's counts)."""
    D = int(bound)
    pending = state.pending
    n_nb = len(pending)
    dev = state.edge_clock.device
    pass_t = torch.full((), int(pass_num), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if delivered is None:
        delivered = torch.ones(lag_vec.shape, dtype=torch.bool, device=dev)
    sent_new = torch.where(delivered, pass_t, zero)
    # a delivered message enqueued at lag >= 2 will commit late; the
    # count rides its slot, so merged arrivals still count every one
    late_new = (delivered & (lag_vec >= 2)).to(torch.int32)
    here_all, sent_all, late_all, clock_out = [], [], [], []
    late = torch.zeros(lag_vec.shape[:1], dtype=torch.int32, device=dev)
    for i in range(n_nb):
        slots = pending[i]
        s0, l0 = slots[0][2], slots[0][3]
        clk = state.edge_clock[:, i]
        clock_out.append(torch.where(s0 > 0, torch.maximum(clk, s0), clk))
        late = late + l0
        d = lag_vec[:, i]
        hs, ss_out, ls_out = [], [], []
        for r in range(D):
            if r + 1 < D:
                ss, sl = slots[r + 1][2], slots[r + 1][3]
            else:
                ss = sl = torch.zeros_like(s0)
            h = (d - 1) == r
            hs.append(h)
            ss_out.append(torch.where(h, torch.maximum(ss, sent_new[:, i]),
                                      ss))
            ls_out.append(torch.where(h, sl + late_new[:, i], sl))
        here_all.append(tuple(hs))
        sent_all.append(tuple(ss_out))
        late_all.append(tuple(ls_out))
    clock = (torch.stack(clock_out, dim=-1) if n_nb
             else state.edge_clock)
    return here_all, sent_all, late_all, clock, late


def _rows(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-rank `[R]` mask shaped to broadcast over `like`'s `[R, ...]`."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def async_bucket_commit(
    slots,
    here: Sequence[torch.Tensor],
    cand: torch.Tensor,
    eff: torch.Tensor,
    seg: torch.Tensor,
    bucket: Optional[int] = None,
    cand_scale: Optional[torch.Tensor] = None,
    last_scale: Optional[torch.Tensor] = None,
):
    """The array half of one edge's bounded-async update over one bucket
    of the buffer layout (`bucket=None`: the monolithic buffer): the
    arrival (slot 0's candidate and eff bits), the queue shift, and this
    pass's shipped (cand, eff[, scale]) merged in at the slots `here`
    flags (`async_delivery_plan`) — later-sent wins, elementwise.

    Returns `(arrival, new_cands, new_effs, new_scales, buf_scale)`:
    `arrival = (c0, e0)`, which the commit lands in the receive buffer as
    `where(e0[seg], c0, last)` — the select every synchronous path uses,
    run by the step's tail kernel (kernels 1 and 5: candidates c0, keeps
    e0[seg], lasts the buffers) or by `async_delivery_commit`'s plain
    select; the D per-slot candidates, eff bits (and int8 scales) after
    the shift and merge; and the post-arrival dequant scales
    `where(e0, scale0, last_scale)` (None without an int8 carrier)."""
    D = len(slots)

    def pick(slot, idx):
        v = slot[idx]
        return v if bucket is None else v[bucket]

    c0, e0 = pick(slots[0], 0), pick(slots[0], 1)
    scaled = last_scale is not None
    buf_scale = None
    if scaled:
        buf_scale = torch.where(e0, pick(slots[0], 4), last_scale)
    eff_exp = eff[:, seg]
    new_cands, new_effs, new_scales = [], [], []
    for r in range(D):
        if r + 1 < D:
            sc, se = pick(slots[r + 1], 0), pick(slots[r + 1], 1)
            ssc = pick(slots[r + 1], 4) if scaled else None
        else:
            sc, se = torch.zeros_like(c0), torch.zeros_like(e0)
            ssc = torch.zeros_like(last_scale) if scaled else None
        h = here[r]
        new_cands.append(torch.where(_rows(h, cand) & eff_exp, cand, sc))
        new_effs.append(torch.where(_rows(h, se), se | eff, se))
        if scaled:
            new_scales.append(torch.where(_rows(h, eff) & eff, cand_scale,
                                          ssc))
    return ((c0, e0), tuple(new_cands), tuple(new_effs),
            tuple(new_scales) if scaled else None, buf_scale)


def async_delivery_commit(
    state: EventState,
    cands: Tuple[torch.Tensor, ...],
    effs: Tuple[torch.Tensor, ...],
    delivered: Optional[torch.Tensor],
    lag_vec: torch.Tensor,
    pass_num: int,
    spec: "arena_lib.ArenaSpec",
    bound: int,
    cand_scales=None,
):
    """One pass of the bounded-async delivery engine on the monolithic
    buffers, every step plain: the JAX function's contract.

      1. ARRIVALS: slot 0 commits into the receive buffer through the
         `where(eff, cand, stale)` select of every other path, so a late
         delivery is bitwise a fire deferred to its arrival pass; the
         edge clock advances to the committed send pass, and lag >= 2
         commits count into `late_commits`;
      2. SHIFT: every slot's remaining delay drops by one;
      3. ENQUEUE: this pass's (candidate, eff) enters slot lag - 1; two
         messages landing on one pass merge later-sent-wins.

    Returns (new_state, the post-arrival buffers — what this pass mixes
    —, the edge staleness int32 `[R, n_nb]`, the late commits of this
    pass `[R]`). The train step runs the same plan and bucket commits
    with the arrival select inside its tail kernel."""
    D = int(bound)
    seg = spec.seg_expand(state.edge_clock.device)
    scaled = state.buf_scales is not None
    if scaled and cand_scales is None:
        raise ValueError(
            "async_delivery_commit on an int8-carrier state needs the "
            "exchange's cand_scales (the per-slot dequant scales ride "
            "the queue)"
        )
    here, sent_slots, late_slots, clock, late = async_delivery_plan(
        state, delivered, lag_vec, pass_num, bound)
    new_bufs, new_pending, new_bscales = [], [], []
    for i in range(len(cands)):
        (c0, e0), ncs, nes, nss, bscale = async_bucket_commit(
            state.pending[i], here[i], cands[i], effs[i], seg,
            cand_scale=cand_scales[i] if scaled else None,
            last_scale=state.buf_scales[i] if scaled else None,
        )
        new_bufs.append(torch.where(e0[:, seg], c0, state.bufs[i]))
        new_pending.append(tuple(
            (ncs[r], nes[r], sent_slots[i][r], late_slots[i][r])
            + ((nss[r],) if scaled else ())
            for r in range(D)))
        if scaled:
            new_bscales.append(bscale)
    pass_t = torch.full((), int(pass_num), dtype=torch.int32,
                        device=clock.device)
    new_state = state.replace(
        bufs=tuple(new_bufs), pending=tuple(new_pending), edge_clock=clock,
        late_commits=state.late_commits + late,
        buf_scales=tuple(new_bscales) if scaled else state.buf_scales,
    )
    return new_state, tuple(new_bufs), pass_t - clock, late
