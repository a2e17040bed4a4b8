"""Integrity engine: wire checksums, non-finite quarantine, rollback.

Port of `eventgrad_tpu/chaos/integrity.py`. Three defense layers:

  * wire checksums — every masked or compact gossip payload ships an
    int32 `collectives.wire_checksum` of its exact wire bits; the
    receiver recomputes and compares. A failed check (an injected
    `bitflip=`, a real link error) is treated exactly as an event that
    did not fire: the stale buffer survives and the rejection is counted
    per edge; the edge's silence keeps growing, so persistent
    corruption escalates to the recovery policies.
  * non-finite quarantine — a rank whose gradients go non-finite (a
    `nanstep=`-poisoned rank, an overflowed loss) skips its update,
    suppresses its sends for the pass and keeps mixing with healthy
    neighbours; incoming payloads carrying NaN/Inf are rejected, and a
    non-finite post-update parameter set rolls the rank back to its
    pre-step state. On the port's fused tail the quarantine is kernel
    1's per-row `quar` operand.
  * rollback-to-last-good — a host-side `DivergenceSentinel` judges each
    block (one epoch in the port); on a trip the loop restores every
    rank from the in-memory last-known-good snapshot, re-arms every
    event buffer (`membership.force_refresh`), hardens the step
    (`escalate`: checksums and quarantine on) and replays. With a
    `checkpoint_dir` a healthy epoch at checkpoint cadence is also
    retained on disk (`<checkpoint_dir>/good`, the newest `keep_good`).
    A trip beyond `max_rollbacks` raises `IntegrityEscalation`; the
    process exit code for it is `INTEGRITY_ABORT_EXIT`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

from eventgrad_tpu_torch.exitcodes import INTEGRITY_ABORT_EXIT  # noqa: F401


class IntegrityEscalation(RuntimeError):
    """The divergence sentinel tripped beyond the rollback budget: the
    retained last-known-good state cannot outrun the fault. Human (or
    supervisor-policy) attention required; restarting is not it."""


@dataclasses.dataclass(frozen=True)
class IntegrityConfig:
    """Static integrity-engine configuration (train(integrity=...)).

    checksum / quarantine gate the in-step defenses (fixed when the step
    is built: with both off the step is bit-identical to integrity=None).
    sentinel / rollback control the host-side engine. The sentinel
    thresholds are deliberately loose — they exist to catch order-of-
    magnitude divergence (a flipped exponent bit, a poisoned rank), not
    SGD noise; `loss_floor` keeps early high-loss epochs from tripping.

    escalate=True re-builds the step with checksum+quarantine ON after a
    rollback (one rebuild): the replayed segment meets the same
    scheduled faults — replay is pass-keyed — so rolling back without
    hardening would diverge identically and burn the budget.
    """

    checksum: bool = True
    quarantine: bool = True
    sentinel: bool = True
    rollback: bool = True
    escalate: bool = True
    #: sentinel: trip when a block's mean loss exceeds loss_spike x the
    #: best (finite) block loss seen so far AND the loss_floor, or goes
    #: non-finite
    loss_spike: float = 4.0
    loss_floor: float = 1.0
    #: sentinel: trip when the block consensus-error max exceeds
    #: consensus_spike x the best block value seen so far AND the floor
    consensus_spike: float = 100.0
    consensus_floor: float = 10.0
    #: rollbacks allowed before IntegrityEscalation
    max_rollbacks: int = 1
    #: last-known-good snapshots retained on disk (with a checkpoint_dir:
    #: `<checkpoint_dir>/good`, `utils/checkpoint.RollingRetention`)
    keep_good: int = 2

    def __post_init__(self):
        if self.max_rollbacks < 0 or self.keep_good < 1:
            raise ValueError(
                f"max_rollbacks >= 0 and keep_good >= 1 required, got {self}"
            )
        for name in ("loss_spike", "consensus_spike"):
            if getattr(self, name) <= 1.0:
                raise ValueError(f"{name} must be > 1, got {getattr(self, name)}")

    @property
    def is_noop(self) -> bool:
        return not (
            self.checksum or self.quarantine or self.sentinel or self.rollback
        )

    def hardened(self) -> "IntegrityConfig":
        """The post-rollback escalation target: full in-step defenses."""
        return dataclasses.replace(self, checksum=True, quarantine=True)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IntegrityConfig":
        return cls(**{
            f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d
        })

    @classmethod
    def parse(cls, spec: str) -> "IntegrityConfig":
        """Spec grammar: `on`, `off`, or comma-
        separated `field=value` clauses over the config fields —
        e.g. `checksum=0,quarantine=0,max_rollbacks=2`. Booleans take
        0/1/true/false; `off` is `IntegrityConfig` with every engine
        disabled (resolve() maps it to None)."""
        spec = spec.strip()
        if spec == "on":
            return cls()
        if spec == "off":
            return cls(
                checksum=False, quarantine=False,
                sentinel=False, rollback=False,
            )
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        kw: Dict[str, Any] = {}
        for clause in spec.split(","):
            name, sep, val = clause.partition("=")
            name = name.strip()
            if not sep or name not in fields:
                raise ValueError(
                    f"integrity clause {clause!r} invalid; expected 'on', "
                    "'off', or comma-separated field=value over "
                    f"{sorted(fields)}"
                )
            val = val.strip()
            if fields[name] in ("bool", bool):
                if val.lower() not in ("0", "1", "true", "false"):
                    raise ValueError(
                        f"integrity {name}= takes 0/1/true/false, got {val!r}"
                    )
                kw[name] = val.lower() in ("1", "true")
            elif fields[name] in ("int", int):
                kw[name] = int(val)
            else:
                kw[name] = float(val)
        return cls(**kw)


def resolve(integrity) -> Optional[IntegrityConfig]:
    """Accept an IntegrityConfig, a spec string ("on"/"off"/"k=v,..."),
    a serialized dict, or None — the one coercion `train` and
    `make_train_step` use. A config with every engine off resolves to None."""
    if integrity is None:
        return None
    if isinstance(integrity, IntegrityConfig):
        return None if integrity.is_noop else integrity
    if isinstance(integrity, str):
        return resolve(IntegrityConfig.parse(integrity))
    if isinstance(integrity, dict):
        return resolve(IntegrityConfig.from_dict(integrity))
    raise TypeError(
        "integrity must be an IntegrityConfig, a spec string, dict, or "
        f"None; got {type(integrity)}"
    )


class DivergenceSentinel:
    """Host-side divergence detector riding the per-block drain.

    Tracks the best (minimum, finite) block-mean loss and the best block
    consensus-error max seen so far; `observe()` returns a trip verdict
    when the current block departs by the configured spike factors (or
    the loss goes non-finite — NaN's compare-False semantics must not
    slip through). State is tiny and host-only; after a rollback the
    loop calls `rewind()` so the replayed blocks are judged against the
    pre-divergence baseline, deterministically.
    """

    def __init__(self, cfg: IntegrityConfig):
        self.cfg = cfg
        self.best_loss: Optional[float] = None
        self.best_cerr: Optional[float] = None
        self.trips = 0

    def snapshot(self) -> Dict[str, Optional[float]]:
        """The baseline state a last-known-good snapshot retains (so
        `rewind` restores the sentinel along with the model)."""
        return {"best_loss": self.best_loss, "best_cerr": self.best_cerr}

    def rewind(self, snap: Dict[str, Optional[float]]) -> None:
        self.best_loss = snap["best_loss"]
        self.best_cerr = snap["best_cerr"]

    def observe(
        self, loss: float, consensus_err: Optional[float] = None,
    ) -> Optional[str]:
        """Judge one block; returns a trip reason string or None. A
        healthy block advances the baselines; a tripped block does not
        (the divergent values must never become the yardstick)."""
        cfg = self.cfg
        loss = float(loss)
        if not math.isfinite(loss):
            self.trips += 1
            return f"non-finite block loss ({loss})"
        if (
            self.best_loss is not None
            and loss > cfg.loss_spike * self.best_loss
            and loss > cfg.loss_floor
        ):
            self.trips += 1
            return (
                f"loss spike: {loss:.4g} > {cfg.loss_spike:g} x best "
                f"{self.best_loss:.4g}"
            )
        if consensus_err is not None:
            cerr = float(consensus_err)
            if not math.isfinite(cerr):
                self.trips += 1
                return f"non-finite consensus error ({cerr})"
            if (
                self.best_cerr is not None
                and cerr > cfg.consensus_spike * max(self.best_cerr, 1e-12)
                and cerr > cfg.consensus_floor
            ):
                self.trips += 1
                return (
                    f"consensus-error escalation: {cerr:.4g} > "
                    f"{cfg.consensus_spike:g} x best {self.best_cerr:.4g}"
                )
            if self.best_cerr is None or cerr < self.best_cerr:
                self.best_cerr = cerr
        if self.best_loss is None or loss < self.best_loss:
            self.best_loss = loss
        return None
