"""Elastic membership: live rank join/leave with neighbour-stream bootstrap.

Port of `eventgrad_tpu/chaos/membership.py`. The ring heal
(`policy.heal_ring`) only ever SHRINKS the ring; this module is the
whole membership story: a replayable stream of `join` / `leave` events
applied at dispatch-block boundaries (the port's block is one epoch), so
a step never sees a shape change:

  * **leave** — the clean form of peer death: `policy.apply_ring_heal`
    rewrites the topology to `Ring(n-1)` and re-slices the survivors'
    rows out of every rank-stacked tensor; the stale receive buffers stay
    (legal gossip input) and refresh within one force-fire cycle.
  * **join** — N -> N+1. The newcomer bootstraps its FULL row of the
    state (parameters, momentum trace, BatchNorm statistics, event
    thresholds and slopes, stale receive buffers, carrier scales) from a
    neighbour's, streamed as owned host copies (`utils/checkpoint.
    host_snapshot`) and, with a `bootstrap_dir`, through
    `checkpoint.save` (write-tmp, fsync, atomic swap) and back — the
    wire a joining process would read; both are lossless, so replay stays
    bitwise. The ring regrows to `Ring(n+1)`: the mix weight
    1/(1 + n_neighbours) needs no renormalization, the neighbour count is
    2 at every ring size >= 2.

Every transition ends with a **force-fired first exchange**
(`force_refresh`): the next pass fires every leaf on every rank, so all
receive buffers — the newcomer's copied-stale ones and the survivors'
rewired-stale ones — refresh in one cycle. Forced fires ride the normal
event accounting (`num_events` counts them).

Counters: a departed rank takes its cumulative `num_events` /
`num_deferred` / telemetry (and its message ledger rows) with it, and a
newcomer starts all of them at ZERO (copying the source's would count
sends that happened once), so the ledger's conservation laws hold per
row across a transition; the host's telemetry diff base follows the
same rows (`take_rows_host`, `insert_zero_row_host`). Aggregate
msgs-saved-% is counted against cumulative rank-passes (train/loop.py).

Randomness: the JAX state holds one PRNG key per rank and salts the
newcomer's from its source rank's key with (epoch, position). The port's
`TrainState.rng` is ONE `torch.Generator` for the whole rank stack
(dropout keep bits and augmentation draws are drawn `[R, ...]` from
it), so there is no per-rank stream to copy or salt: a transition leaves
the generator as it is, and the passes after it draw `[n', ...]` from
the same stream. The generator's state is part of every snapshot, so a
run replays bitwise from its schedule and resumes bitwise across a
transition, draws included; its draws are not the JAX run's (they never
were: the port's stream is its own).

Ring(2): both neighbour shifts resolve to the same peer; the heal to 2
keeps the reference's two puts and weight 1/3, and a join from 2 regrows
to Ring(3) like any other size.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.chaos import crashpoint
from eventgrad_tpu_torch.chaos.policy import apply_ring_heal
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring, Topology

KINDS = ("join", "leave")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One transition, applied at the END of `epoch` (a dispatch-block
    boundary).

    kind="leave": `index` is the CURRENT stacked rank index removed.
    kind="join":  `index` is the ring position the newcomer takes (rows
    at >= index shift up by one); `src` is the CURRENT index of the
    bootstrap neighbour (default: the newcomer's left neighbour,
    `(index - 1) % n` at apply time).
    """

    epoch: int
    kind: str
    index: int
    src: Optional[int] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"membership kind must be one of {KINDS}, "
                             f"got {self.kind!r}")
        if self.epoch < 1:
            raise ValueError(f"membership epoch must be >= 1, got {self.epoch}")
        if self.index < 0:
            raise ValueError(f"membership index must be >= 0, got {self.index}")
        if self.src is not None and self.src < 0:
            raise ValueError(f"membership src must be >= 0, got {self.src}")
        if self.kind == "leave" and self.src is not None:
            raise ValueError("leave events take no bootstrap src")


@dataclasses.dataclass(frozen=True)
class MembershipSchedule:
    """A replayable membership log: pure data, like `ChaosSchedule`.

    Events sort stably by epoch (same-epoch events apply in listed
    order); two runs of one schedule perform bit-identical transitions.
    `seed` is provenance only: no transition consumes it.
    """

    seed: int = 0
    events: Tuple[MembershipEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: e.epoch)),
        )

    @property
    def is_noop(self) -> bool:
        return not self.events

    def events_at(self, epoch: int) -> Tuple[MembershipEvent, ...]:
        return tuple(e for e in self.events if e.epoch == int(epoch))

    def n_ranks_at(self, base_n: int, epoch: int) -> int:
        """Rank count AFTER every event with `e.epoch <= epoch` applied
        (transitions land at epoch ends, so a snapshot taken at `epoch`
        reflects them)."""
        n = int(base_n)
        for e in self.events:
            if e.epoch <= epoch:
                n += 1 if e.kind == "join" else -1
                if n < 2:
                    raise ValueError(
                        f"membership schedule drops below 2 ranks at "
                        f"epoch {e.epoch}"
                    )
        return n

    def validate(self, base_n: int) -> None:
        """Fail-fast static walk: simulate the whole schedule from
        `base_n` ranks and reject any event whose index/src falls outside
        the ring it will meet (`MembershipEngine.apply` keeps the same
        checks as its runtime guard)."""
        n = int(base_n)
        for e in self.events:
            if e.kind == "leave":
                if not 0 <= e.index < n:
                    raise ValueError(
                        f"leave index {e.index} at epoch {e.epoch} "
                        f"outside 0..{n - 1}"
                    )
                n -= 1
            else:
                if not 0 <= e.index <= n:
                    raise ValueError(
                        f"join position {e.index} at epoch {e.epoch} "
                        f"outside 0..{n}"
                    )
                if e.src is not None and not 0 <= e.src < n:
                    raise ValueError(
                        f"join src {e.src} at epoch {e.epoch} "
                        f"outside 0..{n - 1}"
                    )
                n += 1
            if n < 2:
                raise ValueError(
                    f"membership schedule drops below 2 ranks at "
                    f"epoch {e.epoch}"
                )

    def topology_at(self, base_topo: Topology, epoch: int) -> Topology:
        """The ring topology after every event with epoch <= `epoch`."""
        n = self.n_ranks_at(base_topo.n_ranks, epoch)
        return (base_topo if n == base_topo.n_ranks
                else Ring(n, axis=base_topo.axes[0]))

    # --- serialization (history records) --------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "events": [
                {"epoch": e.epoch, "kind": e.kind, "index": e.index,
                 **({"src": e.src} if e.src is not None else {})}
                for e in self.events
            ],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MembershipSchedule":
        return cls(
            seed=int(d.get("seed", 0)),
            events=tuple(
                MembershipEvent(
                    epoch=int(e["epoch"]), kind=str(e["kind"]),
                    index=int(e["index"]),
                    src=int(e["src"]) if e.get("src") is not None else None,
                )
                for e in d.get("events", ())
            ),
        )

    # --- spec grammar: leave=IDX@EPOCH, join=POS@EPOCH[:SRC] ------------

    def to_spec(self) -> str:
        parts = [f"seed={self.seed}"]
        parts += [format_event_clause(e) for e in self.events]
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "MembershipSchedule":
        kw: Dict[str, Any] = {"events": []}
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            key, sep, val = clause.partition("=")
            if not sep:
                raise ValueError(
                    f"bad membership clause {clause!r} (expected key=value)"
                )
            try:
                if key == "seed":
                    kw["seed"] = int(val)
                elif key in KINDS:
                    kw["events"].append(parse_event_clause(key, val))
                else:
                    raise ValueError(f"unknown membership key {key!r}")
            except ValueError as err:
                raise ValueError(
                    f"bad membership clause {clause!r}: {err}"
                ) from None
        kw["events"] = tuple(kw["events"])
        return cls(**kw)


def format_event_clause(e: MembershipEvent) -> str:
    """Inverse of `parse_event_clause`: the one emitter of the clause
    grammar, shared by both schedules' `to_spec`."""
    clause = f"{e.kind}={e.index}@{e.epoch}"
    if e.src is not None:
        clause += f":{e.src}"
    return clause


def parse_event_clause(kind: str, val: str) -> MembershipEvent:
    """`IDX@EPOCH` (leave) / `POS@EPOCH[:SRC]` (join): the clause grammar
    of `MembershipSchedule.parse` and of `ChaosSchedule.parse`'s
    join= / leave= clauses."""
    idx, _, rest = val.partition("@")
    epoch, _, src = rest.partition(":")
    if src and kind != "join":
        raise ValueError("only join events take a :SRC suffix")
    return MembershipEvent(
        epoch=int(epoch), kind=kind, index=int(idx),
        src=int(src) if src else None,
    )


def resolve(membership) -> MembershipSchedule:
    """A MembershipSchedule from a schedule, a spec string or a
    serialized dict."""
    if isinstance(membership, MembershipSchedule):
        return membership
    if isinstance(membership, str):
        return MembershipSchedule.parse(membership)
    if isinstance(membership, dict):
        return MembershipSchedule.from_dict(membership)
    raise TypeError(
        "membership must be a MembershipSchedule, spec string, or dict; "
        f"got {type(membership)}"
    )


def force_refresh(state, event_cfg: Optional[EventConfig]):
    """Arm a force-fired next exchange, riding the trigger itself: in
    adaptive mode the thresholds drop to 0 (`value_diff >= 0` always
    holds, and the fire resets them from the slope history); in constant
    mode `last_sent_norm` drops to -1e30, which any drift beats; with a
    constant threshold of 0 every pass fires already. D-PSGD and
    allreduce carry no event state and ship everything every pass. On
    the compact wire a full-fire pass can overflow the budget; deferred
    leaves keep their armed trigger and drain under the capacity gate."""
    ev = getattr(state, "event", None)
    if ev is None:
        return state
    cfg = event_cfg or EventConfig()
    if cfg.adaptive:
        ev = ev.replace(thres=torch.zeros_like(ev.thres))
    elif cfg.constant > 0.0:
        ev = ev.replace(
            last_sent_norm=torch.full_like(ev.last_sent_norm, -1e30))
    else:
        return state
    return state.replace(event=ev)


# --- rank-row helpers -------------------------------------------------------


def _map_rows(fn, x, n_ranks: Optional[int], *rest):
    """`fn(t, *rest_t)` on every rank-stacked tensor or array (leading dim
    `n_ranks`; any leading dim with `n_ranks=None`) of `x` (nested
    dataclasses, tuples, lists and dicts, walked in parallel with
    `rest`); other leaves pass as they are."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        stacked = x.ndim and (n_ranks is None or x.shape[0] == n_ranks)
        return fn(x, *rest) if stacked else x
    if isinstance(x, (tuple, list)):
        return type(x)(_map_rows(fn, v, n_ranks, *(r[i] for r in rest))
                       for i, v in enumerate(x))
    if isinstance(x, dict):
        return {k: _map_rows(fn, v, n_ranks, *(r[k] for r in rest))
                for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_rows(fn, getattr(x, f.name), n_ranks,
                              *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(x)})
    return x


def take_row(state, pos: int, n_ranks: int):
    """Rank `pos`'s row of every rank-stacked tensor of `state` (the
    state's structure, each rank-stacked tensor `[...]` without its rank
    dim); the random stream stays out (it is not per rank)."""
    return _map_rows(lambda t: t[pos], state.replace(rng=None), n_ranks)


def insert_row(state, pos: int, row, n_ranks: int):
    """`row` (a `take_row` structure) inserted at stacked index `pos` of
    every rank-stacked tensor: `[n, ...]` -> `[n + 1, ...]`, rows at >=
    pos shifting up by one."""
    rng = state.rng
    out = _map_rows(
        lambda t, r: torch.cat(
            [t[:pos], r.to(device=t.device, dtype=t.dtype)[None], t[pos:]]),
        state.replace(rng=None), n_ranks, row)
    return out.replace(rng=rng)


def take_rows_host(tree: Any, keep: Tuple[int, ...]) -> Any:
    """Host-side row slice of a numpy-leaf structure (the loop's
    telemetry diff base tracks the device state's row layout)."""
    idx = np.asarray(keep, np.int64)
    return _map_rows(lambda x: np.take(x, idx, axis=0), tree, None)


def insert_zero_row_host(tree: Any, pos: int) -> Any:
    """Host-side zero-row insertion (a newcomer's cumulative telemetry
    counters start at zero on the device; the diff base matches)."""
    return _map_rows(lambda x: np.insert(x, pos, 0, axis=0), tree, None)


class MembershipEngine:
    """Applies one schedule's transitions to (state, topology) at
    dispatch-block boundaries, on the host: a transition changes tensor
    shapes, so it happens between steps.

    `bootstrap_dir` (optional) routes every join's neighbour row through
    the on-disk checkpoint stream (`checkpoint.save` + `latest` + `peek`
    + `restore` at `<dir>/bootstrap`), the path a real newcomer process
    would read; without it the same `host_snapshot` owned copies are
    handed over directly. Both are lossless, so the trained state is
    bitwise identical either way.
    """

    def __init__(
        self,
        schedule: MembershipSchedule,
        *,
        event_cfg: Optional[EventConfig] = None,
        bootstrap_dir: Optional[str] = None,
    ):
        self.schedule = schedule
        self.event_cfg = event_cfg
        self.bootstrap_dir = bootstrap_dir
        #: transitions applied so far (info dicts, in order)
        self.log: List[Dict[str, Any]] = []

    def events_at(self, epoch: int) -> Tuple[MembershipEvent, ...]:
        return self.schedule.events_at(epoch)

    # --- bootstrap stream ----------------------------------------------

    def _stream_row(self, row, ev: MembershipEvent) -> Tuple[Any, bool]:
        """Neighbour-row handoff through the checkpoint machinery:
        `host_snapshot` (owned host copies of the row's flat tensors)
        always; with a bootstrap_dir, also `checkpoint.save` (the same
        write-tmp / atomic swap as training snapshots) and its read back.
        Returns (the row rebuilt from the stream, streamed via disk)."""
        from eventgrad_tpu_torch.train import state as state_lib
        from eventgrad_tpu_torch.utils import checkpoint

        snap = checkpoint.host_snapshot(state_lib.to_flat(row))
        streamed = bool(self.bootstrap_dir)
        if streamed:
            path = os.path.join(self.bootstrap_dir, "bootstrap")
            checkpoint.save(path, snap, {"epoch": int(ev.epoch),
                                         "kind": "membership.bootstrap"})
            # seeded kill between the stream's commit and the newcomer's
            # restore: the transition must be repeatable from the main
            # snapshot (utils/crash_matrix.py proves it)
            crashpoint.hit("membership.bootstrap")
            raw, _ = checkpoint.peek(checkpoint.latest(path), device="cpu")
            snap = checkpoint.restore(raw, snap)
        return state_lib.from_flat(row, snap), streamed

    # --- transitions ---------------------------------------------------

    def apply(self, state, topo: Topology, ev: MembershipEvent):
        """Apply one transition; returns (state, topology, info record).

        Leave re-slices the survivors (exactly `policy.apply_ring_heal`);
        join inserts the bootstrapped row at `ev.index` and regrows the
        ring. Both end force-refreshed (module docstring)."""
        if len(topo.axes) != 1:
            raise ValueError(
                "membership transitions handle single-axis gossip rings; "
                f"got axes {topo.axes}"
            )
        t0 = time.perf_counter()
        n = topo.n_ranks
        info: Dict[str, Any] = {
            "kind": ev.kind, "epoch": ev.epoch, "index": ev.index,
            "n_ranks_before": n,
        }
        if ev.kind == "leave":
            if n <= 2:
                raise ValueError(
                    f"cannot leave at n_ranks={n}: a ring needs >= 2"
                )
            new_state, new_topo, survivors = apply_ring_heal(
                state, topo, {ev.index}
            )
            info["survivors"] = list(survivors)
        else:
            if not 0 <= ev.index <= n:
                raise ValueError(
                    f"join position {ev.index} outside 0..{n}"
                )
            src = ev.src if ev.src is not None else (ev.index - 1) % n
            if not 0 <= src < n:
                raise ValueError(f"join src {src} outside 0..{n - 1}")
            row, streamed = self._stream_row(take_row(state, src, n), ev)
            new_state = insert_row(state, ev.index, row, n)
            new_state = self._init_newcomer(new_state, ev.index)
            new_topo = Ring(n + 1, axis=topo.axes[0])
            info.update(src=src, bootstrap_streamed=streamed)
        new_state = force_refresh(new_state, self.event_cfg)
        info["n_ranks_after"] = new_topo.n_ranks
        info["apply_s"] = round(time.perf_counter() - t0, 4)
        self.log.append(info)
        return new_state, new_topo, info

    @staticmethod
    def _init_newcomer(state, pos: int):
        """Post-insert fix-ups at row `pos`: the cumulative counters start
        at zero (the bootstrap copies STATE, not HISTORY): the event
        counters, every telemetry counter and ledger row, the drop count;
        and, like the heal, every rank's per-edge silence and sync
        requests reset so the fresh edges start healthy. The random
        stream is not per rank (module docstring)."""
        upd = {}

        def zero_row(t):
            t = t.clone()
            t[pos] = 0
            return t

        evs = state.event
        if evs is not None:
            upd["event"] = evs.replace(
                num_events=zero_row(evs.num_events),
                num_deferred=zero_row(evs.num_deferred),
            )
        tel = state.telemetry
        if tel is not None:
            upd["telemetry"] = _map_rows(zero_row, tel,
                                         int(state.params.shape[0]))
        health = state.chaos
        if health is not None:
            upd["chaos"] = health.replace(
                silence=torch.zeros_like(health.silence),
                sync_req=torch.zeros_like(health.sync_req),
                drops=zero_row(health.drops),
            )
        return state.replace(**upd) if upd else state
