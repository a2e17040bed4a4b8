"""Message-lifecycle ledger: per-edge disposition accounting + auditor.

Port of `eventgrad_tpu/obs/ledger.py` on the rank-stacked layout: every
tensor carries the leading `[R]` rank dimension the JAX package's vmap
adds.

EventGraD's value claim is an accounting claim ("~70% of messages saved
at no accuracy cost"), and the counters that tell each message's fate
come from five subsystems: capacity deferrals, chaos drops, integrity
wire rejections, bounded-async late commits, quarantine suppression.
This module is the one place message counters move. `MessageLedger`
rides inside `TelemetryState` (cumulative int32 per-edge counters, one
row per `schema.LEDGER_COUNTER_ROWS` entry) and every message-affecting
path of the step feeds one call to `ledger_update` per pass with its raw
observables (proposal bits, suppress mask, fire bits, the raw wire
census, the deliver / integrity verdicts, the lags), so the balance laws
hold by construction:

    proposed = suppressed + deferred + fired          (per rank, edge)
    fired    = delivered + dropped + rejected + in_flight
                                           (per edge, summed over ranks)
    sender.fired(e) = receiver.(delivered + dropped + rejected +
                     in_flight)(e)                    (per rank, edge)

`audit_window` re-checks those laws on the host with INTEGER equality,
per edge per flush window; `utils/ledger_audit.py` proves the auditor
catches the seeded leaks (`EG_LEDGER_LEAK`).

Message unit: one leaf-fire per edge (matching `EventState.num_events`
= fires x neighbors). Sender-side rows broadcast the same count to all
edges; receiver-side rows attribute the neighbor's raw wire bits to
exactly one of delivered / dropped / rejected / in-flight.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

from eventgrad_tpu_torch.obs.schema import LEDGER_COUNTER_ROWS

#: row index of each cumulative disposition counter in MessageLedger.counts
ROW = {name: i for i, name in enumerate(LEDGER_COUNTER_ROWS)}

#: the seeded leak oracles (`utils/ledger_audit.py`): read when the step
#: is built (`make_train_step`, the port's counterpart of the JAX trace
#: time), so a leaky step exists only where one was asked for. The two
#: leaks are the two classic counter bugs the auditor must catch: a
#: message fate nobody counts, and one counted twice.
LEAK_ENV = "EG_LEDGER_LEAK"
LEAKS = ("uncounted_drop", "double_reject")


def leak() -> str:
    """The armed seeded leak ("" for none); an unknown value raises."""
    v = os.environ.get(LEAK_ENV, "")
    if v and v not in LEAKS:
        raise ValueError(f"{LEAK_ENV}={v!r}: known leaks are {LEAKS}")
    return v


@dataclasses.dataclass
class MessageLedger:
    """Cumulative per-edge disposition counters + the bounded-async
    in-flight queue.

    `queue[..., s, e]` counts accepted messages on edge e committing in
    s+1 passes (the count twin of `EventState.pending`: slot 0 drains
    into `delivered` this pass, then the queue shifts and this pass's
    accepted census enters at slot lag-1). `late_queue` carries the lag
    >= 2 sub-census the same way; its drain is `late_committed`. Both are
    None on the synchronous paths (staleness <= 1), where acceptance
    commits the same pass and in_flight is identically zero."""

    counts: torch.Tensor                   # i32 [R, n_rows, n_edges]
    queue: Optional[torch.Tensor] = None       # i32 [R, D, n_edges]
    late_queue: Optional[torch.Tensor] = None  # i32 [R, D, n_edges]

    def replace(self, **kw) -> "MessageLedger":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(cls, n_edges: int, queue_depth: int = 0, *,
             n_ranks: int, device=None) -> "MessageLedger":
        """Zero counters for `n_edges` edges, stacked over the `n_ranks`
        ranks."""

        def z(*shape):
            return torch.zeros((int(n_ranks),) + shape, dtype=torch.int32,
                               device=device)

        return cls(
            counts=z(len(LEDGER_COUNTER_ROWS), n_edges),
            queue=z(queue_depth, n_edges) if queue_depth else None,
            late_queue=z(queue_depth, n_edges) if queue_depth else None,
        )

    def in_flight(self) -> torch.Tensor:
        """Gauge: queued-but-uncommitted messages per edge, i32 [R, E]."""
        if self.queue is None:
            return torch.zeros_like(self.counts[:, 0])
        return torch.sum(self.queue, dim=-2, dtype=torch.int32)


@functools.lru_cache(maxsize=64)
def _slot_ids(depth: int, device: torch.device) -> torch.Tensor:
    """int32 [D, 1]: the queue's slot index, made once per device."""
    return torch.arange(depth, dtype=torch.int32, device=device)[:, None]


def ledger_update(
    led: MessageLedger,
    *,
    prop_fire: Optional[torch.Tensor] = None,   # bool [R, L] proposals
    suppress: Optional[torch.Tensor] = None,    # bool [R, L] or [R, 1] veto
    fire_vec: Optional[torch.Tensor] = None,    # bool [R, L] on the wire
    n_msgs: Optional[torch.Tensor] = None,      # i32 [R, E] raw wire census
    deliver: Optional[torch.Tensor] = None,     # bool [R, E] chaos delivery
    oks: Optional[torch.Tensor] = None,         # bool [R, E] integrity
    lag_vec: Optional[torch.Tensor] = None,     # i32 [R, E] async lags
    leak_mode: str = "",
) -> MessageLedger:
    """THE disposition helper: one pass of message accounting.

    Every message-affecting path calls this once per pass with its raw
    observables; the disposition derivation lives here and nowhere else
    (the `telemetry-counter-ledgered` lint rule keeps it that way).

    Sender side (`prop_fire` / `suppress` / `fire_vec`, broadcast per
    edge): suppressed counts proposals the mask vetoed, deferred counts
    proposals that survived the mask but missed the wire (the capacity
    gate), fired counts what actually shipped, each computed on its own,
    so proposed = suppressed + deferred + fired checks the mask-subset
    invariants instead of restating an identity.

    Receiver side (`n_msgs` = per-edge sum of the neighbor's RAW fire
    bits on the wire): a dropped edge loses its whole census, a
    delivered-but-rejected edge refuses it, the rest commits: the same
    pass without `lag_vec`, through the delivery queue with it (the count
    twin of the bounded-async queue: drain slot 0, shift, enqueue this
    pass's accepted census at slot lag-1). `leak_mode` plants one of
    `LEAKS` (the step passes the value `leak()` read when it was built).

    The rows' increments are stacked into one `[..., rows, E]` tensor and
    added to the counters once."""
    counts = led.counts
    queue, late_queue = led.queue, led.late_queue
    n_edges = counts.shape[-1]
    lead = counts.shape[:-2]
    zero = torch.zeros((), dtype=torch.int32, device=counts.device)
    rows = [None] * len(LEDGER_COUNTER_ROWS)

    if prop_fire is not None:
        prop = prop_fire.to(torch.bool)
        fire = fire_vec.to(torch.bool)
        if suppress is not None:
            sup_mask = prop & suppress.to(torch.bool)
            kept = prop & ~sup_mask
        else:
            sup_mask, kept = None, prop
        sender = torch.stack([
            torch.sum(prop, dim=-1, dtype=torch.int32),
            (torch.sum(sup_mask, dim=-1, dtype=torch.int32)
             if sup_mask is not None
             else torch.zeros(lead, dtype=torch.int32, device=counts.device)),
            torch.sum(kept & ~fire, dim=-1, dtype=torch.int32),
            torch.sum(fire, dim=-1, dtype=torch.int32),
        ], dim=-1)                                           # [..., 4]
        for i, name in enumerate(("proposed", "suppressed", "deferred",
                                  "fired")):
            rows[ROW[name]] = sender[..., i, None].expand(
                lead + (n_edges,))

    if n_msgs is not None:
        msgs = n_msgs.to(torch.int32)
        del_e = deliver.to(torch.bool) if deliver is not None else None
        ok_e = oks.to(torch.bool) if oks is not None else None
        dropped = (torch.where(del_e, zero, msgs) if del_e is not None
                   else torch.zeros_like(msgs))
        if ok_e is None:
            rejected = torch.zeros_like(msgs)
            accepted = msgs if del_e is None else msgs - dropped
        else:
            good = ok_e if del_e is None else del_e & ok_e
            accepted = torch.where(good, msgs, zero)
            rejected = msgs - dropped - accepted
        if leak_mode == "uncounted_drop":
            # seeded leak oracle: the drop path forgets its census
            dropped = torch.zeros_like(dropped)
        elif leak_mode == "double_reject":
            # seeded leak oracle: rejections booked twice
            rejected = 2 * rejected
        rows[ROW["dropped"]] = dropped
        rows[ROW["rejected"]] = rejected
        if lag_vec is None:
            rows[ROW["delivered"]] = accepted
        else:
            # bounded async: accepted messages commit when their lag
            # elapses (drain slot 0, shift, enqueue at slot lag-1), so
            # the in-flight gauge balances fired against delivered at
            # any flush boundary
            depth = queue.shape[-2]
            lag = torch.clamp(lag_vec.to(torch.int32), 1, depth)
            slot = _slot_ids(depth, counts.device) == (lag - 1)[..., None, :]
            late_acc = torch.where(lag >= 2, accepted, zero)
            rows[ROW["delivered"]] = queue[..., 0, :]
            rows[ROW["late_committed"]] = late_queue[..., 0, :]
            acc2 = torch.stack([accepted, late_acc], dim=-2)  # [..., 2, E]
            enq = torch.where(slot[..., None, :, :], acc2[..., :, None, :],
                              zero)
            both = torch.stack([queue, late_queue], dim=-3)  # [..., 2, D, E]
            both = torch.nn.functional.pad(both[..., 1:, :], (0, 0, 0, 1))
            both = both + enq
            queue, late_queue = both[..., 0, :, :], both[..., 1, :, :]

    if any(r is not None for r in rows):
        zrow = torch.zeros(lead + (n_edges,), dtype=torch.int32,
                           device=counts.device)
        inc = torch.stack([zrow if r is None else r for r in rows], dim=-2)
        counts = counts + inc
    return led.replace(counts=counts, queue=queue, late_queue=late_queue)


# ---------------------------------------------------------------------------
# host side: the flush-window record block and the conservation auditor


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.int64)


def window_block(cur: MessageLedger, prev=None):
    """Host-side flush twin of `obs.device.window_record` for the ledger:
    per-disposition per-edge window deltas summed over ranks (stacked
    snapshots, leading axis = ranks), plus the in-flight gauge at the
    window end: the `message_ledger` block of the record's obs dict."""
    c = _np(cur.counts)
    if prev is not None:
        c = c - _np(prev.counts)
    blk = {
        name: [int(v) for v in c[:, ROW[name]].sum(axis=0)]
        for name in LEDGER_COUNTER_ROWS
    }
    q = (_np(cur.queue).sum(axis=1) if cur.queue is not None
         else np.zeros(c.shape[:1] + c.shape[2:], np.int64))
    blk["in_flight"] = [int(v) for v in q.sum(axis=0)]
    return blk


def audit_window(cur: MessageLedger, prev, topo, max_violations: int = 8):
    """The conservation-law auditor: integer equality per edge per flush
    window, on the stacked host snapshots (leading axis = ranks).

    Checks, in order:
      1. monotonicity: every cumulative counter's window delta >= 0;
      2. sender law, per rank per edge:
         proposed = suppressed + deferred + fired;
      3. receiver law, per edge summed over ranks:
         fired = delivered + dropped + rejected + delta(in_flight);
      4. cross-rank law, per rank per edge: the fired count of the edge's
         source rank (on the reverse edge, `chaos.inject
         .reverse_edge_index`) equals this rank's received census
         delivered + dropped + rejected + delta(in_flight);
      5. late sub-law, per rank per edge: late_committed <= delivered.

    Returns {"ok": bool, "checks": int, "violations": [...]} with at
    most `max_violations` named violations (law, rank, edge, lhs, rhs).
    """
    from eventgrad_tpu_torch.chaos import inject as chaos_inject

    d = _np(cur.counts) - (_np(prev.counts) if prev is not None else 0)
    n_ranks, _, n_edges = d.shape

    def q_sum(led):
        if led is None or led.queue is None:
            return np.zeros((n_ranks, n_edges), np.int64)
        return _np(led.queue).sum(axis=1)

    d_inflight = q_sum(cur) - q_sum(prev)

    def row(name):
        return d[:, ROW[name], :]

    violations = []
    checks = 0

    def check(ok_mask, law, lhs, rhs):
        nonlocal checks
        checks += int(ok_mask.size)
        if bool(ok_mask.all()):
            return
        for r, e in zip(*np.nonzero(~ok_mask)):
            if len(violations) >= max_violations:
                return
            violations.append({
                "law": law, "rank": int(r), "edge": int(e),
                "lhs": int(lhs[r, e]), "rhs": int(rhs[r, e]),
            })

    # 1. monotone counters
    for name in LEDGER_COUNTER_ROWS:
        check(row(name) >= 0, f"monotone:{name}", row(name),
              np.zeros_like(row(name)))

    # 2. sender law
    lhs = row("proposed")
    rhs = row("suppressed") + row("deferred") + row("fired")
    check(lhs == rhs, "proposed=suppressed+deferred+fired", lhs, rhs)

    recv = row("delivered") + row("dropped") + row("rejected") + d_inflight

    # 3. receiver law, rank-summed per edge (every rank's send on edge
    # index e is received by exactly one rank on e's reverse, so the rank
    # sums balance even though each rank's own fired and received census
    # count different messages)
    lhs_e = row("fired").sum(axis=0, keepdims=True)
    rhs_e = recv.sum(axis=0, keepdims=True)
    check(lhs_e == rhs_e, "fired=delivered+dropped+rejected+in_flight",
          lhs_e, rhs_e)

    # 4. cross-rank law: the per-rank refinement of (3)
    sources = chaos_inject.host_source_table(topo)      # [R, E]
    rev = chaos_inject.reverse_edge_index(topo)         # [E] or None
    if rev is not None and sources.shape == (n_ranks, n_edges):
        sender = row("fired")[sources, np.asarray(rev)[None, :]]
        check(sender == recv, "sender.fired=receiver.census", sender, recv)

    # 5. late commits are a sub-count of delivered
    lhs = row("late_committed")
    check(lhs <= row("delivered"), "late_committed<=delivered", lhs,
          row("delivered"))

    return {"ok": not violations, "checks": checks, "violations": violations}
