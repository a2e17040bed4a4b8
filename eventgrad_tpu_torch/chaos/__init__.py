"""Chaos subsystem of the port: the fault clauses, recovery policies and
the integrity engine.

Port of `eventgrad_tpu/chaos/`: `schedule` (the clauses `drop=`,
`flaky=`, `delay=`, `die=`, `bitflip=`, `nanstep=`, `lag=`, `slow=`,
their parse, spec and dict round trip), `prng` (the port's own copy of
JAX's Threefry draws, bitwise `jax.random`), `inject` (the per-pass
delivery, corruption and nanstep tables, built on the host once per run
and read on the device by pass; `flip_one_bit`; the lags), `monitor`
(`PeerHealth`, `sync_requests`, `consensus_error`, the records'
`health_record`), `policy` (`RecoveryPolicy`, `alive_mask`, the ring
heal), `integrity` (`IntegrityConfig`, `DivergenceSentinel`,
`IntegrityEscalation`), `membership` (the `leave=` / `join=` schedule,
the `MembershipEngine` and `force_refresh`) and `crashpoint` (the crash
sites, `PreemptGuard`, `GracefulPreemption` and the PREEMPTED marker,
with the `preempt=` clause).
"""

from eventgrad_tpu_torch.chaos.crashpoint import (
    GracefulPreemption, PreemptGuard,
)
from eventgrad_tpu_torch.chaos.integrity import (
    DivergenceSentinel, IntegrityConfig, IntegrityEscalation,
)
from eventgrad_tpu_torch.chaos.membership import (
    MembershipEngine, MembershipEvent, MembershipSchedule,
)
from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy
from eventgrad_tpu_torch.chaos.schedule import (
    ChaosSchedule, FlakyWindow, LagWindow,
)

__all__ = ["ChaosSchedule", "DivergenceSentinel", "FlakyWindow",
           "GracefulPreemption", "IntegrityConfig", "IntegrityEscalation",
           "LagWindow", "MembershipEngine", "MembershipEvent",
           "MembershipSchedule", "PeerHealth", "PreemptGuard",
           "RecoveryPolicy"]
