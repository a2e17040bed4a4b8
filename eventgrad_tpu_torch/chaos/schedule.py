"""Seeded, reproducible fault schedules for the gossip path.

Port of `eventgrad_tpu/chaos/schedule.py`. A schedule is pure data: it
names what faults happen when, never how they apply (`chaos.inject`).
Every draw is a function of (seed, pass, receiving rank, edge), so two
runs of one schedule meet the same faults and a schedule serialized into
a record replays exactly. The clauses the port runs:

  * `drop`    — `drop=p`: iid per-edge per-pass message-drop probability;
  * `flaky`   — `flaky=S-E@p`: the drop probability raised to max(drop,
                p) for passes in [S, E);
  * `delay`   — `delay=k` (`deliver_every`): an edge refreshes its
                buffer at most every k passes, at a seed-derived phase
                (the skipped payloads are lost: a lossy slow link);
  * `die`     — `die=R@P`: rank R neither sends nor receives from pass P
                on (recovery: `policy.heal_ring`);
  * `bitflip` — `bitflip=S-E@p` (a bare `bitflip=p` covers the run):
                per-edge per-pass probability that one bit of the
                received payload flips in transit (the defense: the wire
                checksums of `chaos/integrity.py`);
  * `nanstep` — `nanstep=R@P`: rank R's update goes NaN on pass P (the
                defense: the non-finite quarantine);
  * `lag`     — `lag=S-E@d`: every message sent during [S, E) arrives d
                passes after its send (d >= 1; a bare `lag=d` covers the
                run), a lossless late link the bounded-async engine
                (`train(staleness=D >= 2)`) queues;
  * `slow`    — `slow=R@f`: every message rank R sends arrives f passes
                late (composes with `lag=` by max);
  * `preempt` — `preempt=E@S` (a bare `preempt=E` means step 1): a
                graceful-preemption notice arriving in epoch E at step
                S, host-side (never inside the step): the training loop
                drains at the end of that epoch (`chaos/crashpoint.py`).
                A resume ignores notices at or before its start epoch,
                so later clauses preempt later incarnations.
  * `leave` / `join` — MEMBERSHIP events (`chaos/membership.py`),
                applied at epoch ends by the training loop, never inside
                the step: `leave=1@3` removes rank 1 after epoch 3,
                `join=1@5[:SRC]` inserts a newcomer at position 1 after
                epoch 5, bootstrapped from rank SRC (default its left
                neighbour). `membership_schedule()` lifts them into a
                `MembershipSchedule`.

The effective lag clamps to the bound D; under staleness <= 1 the clamp
makes `lag=` / `slow=` no-ops in the step. The dict form keeps the JAX
package's keys, so a schedule serializes to the same record.

Spec grammar (comma-separated clauses; `flaky=`, `die=`, `leave=`,
`join=`, `bitflip=`, `nanstep=`, `preempt=`, `lag=`, `slow=`
accumulate):

    drop=0.2,seed=7,flaky=100-200@0.8,delay=3,die=3@500,leave=1@3,join=1@5,
    bitflip=40-60@0.5,nanstep=2@45,preempt=6@2,lag=50-90@3,slow=2@4
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

@dataclasses.dataclass(frozen=True)
class FlakyWindow:
    """Drop probability raised to `drop_p` for passes in [start, end)
    (also the bitflip windows' type, `drop_p` then the flip
    probability)."""

    start_pass: int
    end_pass: int
    drop_p: float = 1.0

    def __post_init__(self):
        if self.start_pass < 0 or self.end_pass < self.start_pass:
            raise ValueError(
                f"flaky window [{self.start_pass}, {self.end_pass}) invalid"
            )
        if not 0.0 <= self.drop_p <= 1.0:
            raise ValueError(f"flaky drop_p {self.drop_p} outside [0, 1]")


@dataclasses.dataclass(frozen=True)
class LagWindow:
    """Messages sent during passes [start, end) arrive `lag` passes after
    their send (a true queueing delay: the payload is kept and committed
    on arrival)."""

    start_pass: int
    end_pass: int
    lag: int

    def __post_init__(self):
        if self.start_pass < 0 or self.end_pass < self.start_pass:
            raise ValueError(
                f"lag window [{self.start_pass}, {self.end_pass}) invalid"
            )
        if self.lag < 1:
            raise ValueError(
                f"lag {self.lag} invalid: delivery lag is >= 1 pass "
                "(lag 1 is the no-fault one-pass asynchrony baseline)"
            )


def _sorted_windows(ws):
    return tuple(sorted(ws, key=lambda w: (w.start_pass, w.end_pass)))


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A replayable fault schedule (the JAX package's fields). `death`
    and `nanstep` are ((rank, pass), ...) pairs, `slow` ((rank, lag),
    ...), `preempt` ((epoch, step), ...); `membership` holds the
    epoch-keyed join/leave events (`membership.MembershipEvent`)."""

    seed: int = 0
    drop_p: float = 0.0
    flaky: Tuple[FlakyWindow, ...] = ()
    deliver_every: int = 1
    death: Tuple[Tuple[int, int], ...] = ()
    membership: Tuple[Any, ...] = ()
    bitflip: Tuple[FlakyWindow, ...] = ()
    nanstep: Tuple[Tuple[int, int], ...] = ()
    preempt: Tuple[Tuple[int, int], ...] = ()
    lag: Tuple[LagWindow, ...] = ()
    slow: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        if not 0.0 <= self.drop_p <= 1.0:
            raise ValueError(f"drop_p {self.drop_p} outside [0, 1]")
        if self.deliver_every < 1:
            raise ValueError(
                f"deliver_every must be >= 1, got {self.deliver_every}")
        # normalize so equal schedules compare and serialize equal
        object.__setattr__(self, "flaky", _sorted_windows(self.flaky))
        object.__setattr__(self, "death", tuple(sorted(self.death)))
        for r, t in self.death:
            if r < 0 or t < 0:
                raise ValueError(f"death ({r}, {t}) invalid")
        object.__setattr__(self, "membership", tuple(
            sorted(self.membership, key=lambda e: e.epoch)))
        object.__setattr__(self, "bitflip", _sorted_windows(self.bitflip))
        object.__setattr__(self, "nanstep", tuple(sorted(self.nanstep)))
        for r, t in self.nanstep:
            if r < 0 or t < 0:
                raise ValueError(f"nanstep ({r}, {t}) invalid")
        object.__setattr__(self, "preempt", tuple(sorted(self.preempt)))
        for e, s in self.preempt:
            if e < 1 or s < 1:
                raise ValueError(
                    f"preempt ({e}, {s}) invalid: epoch and step are "
                    "1-based"
                )
        object.__setattr__(self, "lag", _sorted_windows(self.lag))
        object.__setattr__(self, "slow", tuple(sorted(self.slow)))
        for r, f in self.slow:
            if r < 0 or f < 1:
                raise ValueError(
                    f"slow ({r}, {f}) invalid: rank >= 0 and lag >= 1 "
                    "(lag 1 is the no-fault asynchrony baseline)"
                )

    @property
    def is_noop(self) -> bool:
        """True when the schedule injects nothing (the drop-rate-0 point,
        bitwise the chaos=None trajectory); a preemption notice and a
        membership event count, as in the JAX schedule."""
        return (self.drop_p == 0.0 and not self.flaky
                and self.deliver_every == 1 and not self.death
                and not self.membership and not self.bitflip and not self.nanstep
                and not self.preempt and not self.lag and not self.slow)

    @property
    def has_lags(self) -> bool:
        """True when any clause can deliver a message late (the
        bounded-async engine then services per-edge delivery queues)."""
        return bool(self.lag or self.slow)

    @property
    def has_drops(self) -> bool:
        """True when any clause can keep a message from arriving (drop,
        flaky, delay, die)."""
        return bool(self.drop_p > 0.0 or any(w.drop_p > 0.0
                                             for w in self.flaky)
                    or self.deliver_every > 1 or self.death)

    def max_scheduled_lag(self) -> int:
        """The largest lag any clause can schedule (1 = the no-fault
        asynchrony baseline): the unclamped f."""
        m = 1
        for w in self.lag:
            m = max(m, w.lag)
        for _, f in self.slow:
            m = max(m, f)
        return m

    @property
    def has_bitflips(self) -> bool:
        """True when any pass could corrupt a payload."""
        return any(w.drop_p > 0.0 for w in self.bitflip)

    @property
    def has_nansteps(self) -> bool:
        return bool(self.nanstep)

    def membership_schedule(self):
        """The epoch-keyed join/leave events as a MembershipSchedule (for
        the MembershipEngine); no events -> an is_noop schedule."""
        from eventgrad_tpu_torch.chaos.membership import MembershipSchedule

        return MembershipSchedule(seed=self.seed, events=self.membership)

    def dead_ranks(self, up_to_pass: int) -> Tuple[int, ...]:
        """Ranks whose death pass is <= `up_to_pass`."""
        return tuple(sorted({r for r, t in self.death if t <= up_to_pass}))

    # --- serialization (records) ---------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """The JAX package's dict of the same schedule."""
        d: Dict[str, Any] = {
            "seed": self.seed,
            "drop_p": self.drop_p,
            "flaky": [[w.start_pass, w.end_pass, w.drop_p]
                      for w in self.flaky],
            "deliver_every": self.deliver_every,
            "death": [list(e) for e in self.death],
        }
        if self.membership:
            d["membership"] = self.membership_schedule().to_dict()["events"]
        if self.bitflip:
            d["bitflip"] = [[w.start_pass, w.end_pass, w.drop_p]
                            for w in self.bitflip]
        if self.nanstep:
            d["nanstep"] = [list(e) for e in self.nanstep]
        if self.preempt:
            d["preempt"] = [list(e) for e in self.preempt]
        if self.lag:
            d["lag"] = [[w.start_pass, w.end_pass, w.lag] for w in self.lag]
        if self.slow:
            d["slow"] = [list(e) for e in self.slow]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosSchedule":
        membership = ()
        if d.get("membership"):
            from eventgrad_tpu_torch.chaos.membership import (
                MembershipSchedule,
            )

            membership = MembershipSchedule.from_dict(
                {"events": d["membership"]}).events
        return cls(
            seed=int(d.get("seed", 0)),
            drop_p=float(d.get("drop_p", 0.0)),
            flaky=tuple(FlakyWindow(int(s), int(e), float(p))
                        for s, e, p in d.get("flaky", ())),
            deliver_every=int(d.get("deliver_every", 1)),
            death=tuple((int(r), int(t)) for r, t in d.get("death", ())),
            membership=membership,
            bitflip=tuple(FlakyWindow(int(s), int(e), float(p))
                          for s, e, p in d.get("bitflip", ())),
            nanstep=tuple((int(r), int(t)) for r, t in d.get("nanstep", ())),
            preempt=tuple((int(e), int(s)) for e, s in d.get("preempt", ())),
            lag=tuple(LagWindow(int(s), int(e), int(f))
                      for s, e, f in d.get("lag", ())),
            slow=tuple((int(r), int(f)) for r, f in d.get("slow", ())),
        )

    # --- spec round trip -----------------------------------------------

    def to_spec(self) -> str:
        parts = [f"drop={self.drop_p:g}", f"seed={self.seed}"]
        for w in self.flaky:
            parts.append(f"flaky={w.start_pass}-{w.end_pass}@{w.drop_p:g}")
        if self.deliver_every != 1:
            parts.append(f"delay={self.deliver_every}")
        for r, t in self.death:
            parts.append(f"die={r}@{t}")
        for w in self.bitflip:
            parts.append(f"bitflip={w.start_pass}-{w.end_pass}@{w.drop_p:g}")
        for r, t in self.nanstep:
            parts.append(f"nanstep={r}@{t}")
        for e, s in self.preempt:
            parts.append(f"preempt={e}@{s}")
        for w in self.lag:
            parts.append(f"lag={w.start_pass}-{w.end_pass}@{w.lag}")
        for r, f in self.slow:
            parts.append(f"slow={r}@{f}")
        if self.membership:
            from eventgrad_tpu_torch.chaos.membership import (
                format_event_clause,
            )

            parts += [format_event_clause(e) for e in self.membership]
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        """Parse the JAX package's grammar, e.g. `drop=0.2,seed=7,
        flaky=10-20@0.8`."""
        kw: Dict[str, Any] = {"flaky": [], "death": [], "membership": [],
                              "bitflip": [], "nanstep": [], "preempt": [],
                              "lag": [], "slow": []}
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            key, sep, val = clause.partition("=")
            if not sep:
                raise ValueError(
                    f"bad chaos clause {clause!r} (expected key=value)"
                )
            try:
                if key == "drop":
                    kw["drop_p"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "delay":
                    kw["deliver_every"] = int(val)
                elif key == "flaky":
                    span, _, p = val.partition("@")
                    s, _, e = span.partition("-")
                    kw["flaky"].append(
                        FlakyWindow(int(s), int(e), float(p) if p else 1.0))
                elif key == "bitflip":
                    # a bare probability covers the run, tried first so
                    # `bitflip=1e-3` is not read as a pass range
                    try:
                        p_whole = float(val)
                    except ValueError:
                        p_whole = None
                    if p_whole is not None:
                        kw["bitflip"].append(
                            FlakyWindow(0, 2**31 - 1, p_whole))
                    else:
                        span, _, p = val.partition("@")
                        s, _, e = span.partition("-")
                        kw["bitflip"].append(FlakyWindow(
                            int(s), int(e), float(p) if p else 1.0))
                elif key in ("die", "nanstep"):
                    r, _, t = val.partition("@")
                    kw["death" if key == "die" else key].append(
                        (int(r), int(t)))
                elif key == "preempt":
                    e, _, s = val.partition("@")
                    kw["preempt"].append((int(e), int(s) if s else 1))
                elif key == "lag":
                    span, sep_at, f = val.partition("@")
                    if sep_at:
                        s, _, e = span.partition("-")
                        kw["lag"].append(LagWindow(int(s), int(e), int(f)))
                    else:
                        kw["lag"].append(LagWindow(0, 2**31 - 1, int(val)))
                elif key == "slow":
                    r, _, f = val.partition("@")
                    kw["slow"].append((int(r), int(f)))
                elif key in ("leave", "join"):
                    from eventgrad_tpu_torch.chaos.membership import (
                        parse_event_clause,
                    )

                    kw["membership"].append(parse_event_clause(key, val))
                else:
                    raise ValueError(f"unknown chaos key {key!r}")
            except ValueError as err:
                raise ValueError(
                    f"bad chaos clause {clause!r}: {err}"
                ) from None
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in kw.items()})


def resolve(chaos) -> "ChaosSchedule":
    """A ChaosSchedule from a schedule, a spec string or a serialized
    dict."""
    if isinstance(chaos, ChaosSchedule):
        return chaos
    if isinstance(chaos, str):
        return ChaosSchedule.parse(chaos)
    if isinstance(chaos, dict):
        return ChaosSchedule.from_dict(chaos)
    raise TypeError(
        "chaos must be a ChaosSchedule, spec string, or dict; got "
        f"{type(chaos)}"
    )
