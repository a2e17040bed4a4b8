"""Seeded, reproducible fault schedules for the gossip path: the
straggler clauses.

Port of `eventgrad_tpu/chaos/schedule.py`. A schedule is pure data: it
names what faults happen when, never how they apply (`chaos.inject`).
The port runs the two queueing-delay clauses, which the bounded-async
engine (`train(staleness=D)`, D >= 2) services with per-edge delivery
queues:

  * `lag`  — `lag=S-E@d`: every message sent during passes [S, E)
             arrives d passes after its send (d >= 1; the no-fault
             baseline is lag 1, the one-pass asynchrony staleness=1
             models); a bare `lag=d` covers the whole run;
  * `slow` — `slow=R@f`: every message rank R sends arrives f passes
             late for the whole run (a persistent straggler); composes
             with `lag=` windows by max.

The effective lag clamps to the bound D (the fast rank waits rather
than run further ahead); under staleness <= 1 the clamp makes the
clauses no-ops in the step.

The rest of the JAX vocabulary — `drop`, `flaky`, `delay`, `die`,
`bitflip`, `nanstep`, `preempt`, `leave`/`join` — is accepted by the
grammar and the dataclass at its no-fault value only; a schedule that
sets one raises NotImplementedError naming ROADMAP queue 1, item 6. The
dict form keeps the JAX package's keys, so a lag-only schedule
serializes to the same record.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

#: where the clauses beyond the straggler ones wait
ITEM6 = "ROADMAP queue 1, item 6"


@dataclasses.dataclass(frozen=True)
class FlakyWindow:
    """Drop probability raised to `drop_p` for passes in [start, end)
    (the JAX package's value type; a schedule holding one is not
    ported)."""

    start_pass: int
    end_pass: int
    drop_p: float = 1.0


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


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A replayable fault schedule: `lag` (LagWindow tuples) and `slow`
    ((rank, lag) pairs). The other fields are the JAX schedule's, held at
    their no-fault values: setting one raises NotImplementedError."""

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
        unported = [name for name, on in (
            ("drop", self.drop_p != 0.0), ("flaky", bool(self.flaky)),
            ("delay", self.deliver_every != 1), ("die", bool(self.death)),
            ("leave/join", bool(self.membership)),
            ("bitflip", bool(self.bitflip)), ("nanstep", bool(self.nanstep)),
            ("preempt", bool(self.preempt)),
        ) if on]
        if unported:
            raise NotImplementedError(
                f"chaos clauses {unported} are not ported yet ({ITEM6}); "
                "the port runs the straggler clauses lag= and slow="
            )
        # normalize so equal schedules compare and serialize equal
        object.__setattr__(
            self, "lag",
            tuple(sorted(self.lag, key=lambda w: (w.start_pass, w.end_pass))),
        )
        object.__setattr__(self, "slow", tuple(sorted(self.slow)))
        for r, f in self.slow:
            if r < 0 or f < 1:
                raise ValueError(
                    f"slow ({r}, {f}) invalid: rank >= 0 and lag >= 1 "
                    "(lag 1 is the no-fault asynchrony baseline)"
                )

    @property
    def is_noop(self) -> bool:
        """True when the schedule injects nothing."""
        return not self.lag and not self.slow

    @property
    def has_lags(self) -> bool:
        """True when any clause can deliver a message late (the
        bounded-async engine then services per-edge delivery queues)."""
        return bool(self.lag or self.slow)

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
        return False

    @property
    def has_nansteps(self) -> bool:
        return False

    # --- serialization (records) ---------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        """The JAX package's dict of the same schedule."""
        d: Dict[str, Any] = {
            "seed": self.seed, "drop_p": self.drop_p, "flaky": [],
            "deliver_every": self.deliver_every, "death": [],
        }
        if self.lag:
            d["lag"] = [[w.start_pass, w.end_pass, w.lag] for w in self.lag]
        if self.slow:
            d["slow"] = [list(e) for e in self.slow]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChaosSchedule":
        return cls(
            seed=int(d.get("seed", 0)),
            drop_p=float(d.get("drop_p", 0.0)),
            flaky=tuple(FlakyWindow(int(s), int(e), float(p))
                        for s, e, p in d.get("flaky", ())),
            deliver_every=int(d.get("deliver_every", 1)),
            death=tuple((int(r), int(t)) for r, t in d.get("death", ())),
            membership=tuple(d.get("membership", ()) or ()),
            bitflip=tuple(FlakyWindow(int(s), int(e), float(p))
                          for s, e, p in d.get("bitflip", ())),
            nanstep=tuple((int(r), int(t)) for r, t in d.get("nanstep", ())),
            preempt=tuple((int(e), int(s)) for e, s in d.get("preempt", ())),
            lag=tuple(LagWindow(int(s), int(e), int(f))
                      for s, e, f in d.get("lag", ())),
            slow=tuple((int(r), int(f)) for r, f in d.get("slow", ())),
        )

    # --- CLI spec round trip -------------------------------------------

    def to_spec(self) -> str:
        parts = [f"drop={self.drop_p:g}", f"seed={self.seed}"]
        for w in self.lag:
            parts.append(f"lag={w.start_pass}-{w.end_pass}@{w.lag}")
        for r, f in self.slow:
            parts.append(f"slow={r}@{f}")
        return ",".join(parts)

    @classmethod
    def parse(cls, spec: str) -> "ChaosSchedule":
        """Parse the JAX package's grammar, e.g. `seed=5,slow=1@7,
        lag=50-90@3`. A clause beyond the straggler ones parses, and the
        schedule then refuses it (NotImplementedError, item 6)."""
        kw: Dict[str, Any] = {"flaky": [], "death": [], "bitflip": [],
                              "nanstep": [], "preempt": [], "lag": [],
                              "slow": []}
        for clause in spec.split(","):
            clause = clause.strip()
            if not clause:
                continue
            key, sep, val = clause.partition("=")
            if not sep:
                raise ValueError(
                    f"bad chaos clause {clause!r} (expected key=value)"
                )
            if key in ("leave", "join"):
                raise NotImplementedError(
                    f"chaos clause {clause!r}: membership transitions are "
                    f"not ported yet ({ITEM6})"
                )
            try:
                if key == "drop":
                    kw["drop_p"] = float(val)
                elif key == "seed":
                    kw["seed"] = int(val)
                elif key == "delay":
                    kw["deliver_every"] = int(val)
                elif key in ("flaky", "bitflip"):
                    span, _, p = val.partition("@")
                    s, _, e = span.partition("-")
                    kw[key].append(FlakyWindow(
                        int(s), int(e or 2**31 - 1), float(p) if p else 1.0))
                elif key in ("die", "nanstep", "preempt"):
                    r, _, t = val.partition("@")
                    kw["death" if key == "die" else key].append(
                        (int(r), int(t) if t else 1))
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
