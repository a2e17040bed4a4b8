"""Chaos subsystem of the port: the straggler clauses.

Port of `eventgrad_tpu/chaos/`, the part the bounded-async engine needs
(`train(staleness=D >= 2, chaos=...)`): `schedule` (the `lag=` and
`slow=` clauses of `ChaosSchedule`, their parse, spec, dict round trip,
`has_lags` and `max_scheduled_lag`), `inject` (`rank_and_sources`,
`lag_vector`, `lag_table`, and the all-delivered `delivery_mask` of a
lag-only schedule) and `monitor` (`PeerHealth` and its update, the
records' `health_record`). Every other clause — message drops, flaky
windows, delivery thinning, peer death, bitflips, NaN steps, preemption,
membership — raises NotImplementedError naming ROADMAP queue 1, item 6,
as do the recovery policies.
"""

from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.chaos.schedule import (
    ChaosSchedule, FlakyWindow, LagWindow,
)

__all__ = ["ChaosSchedule", "FlakyWindow", "LagWindow", "PeerHealth"]
