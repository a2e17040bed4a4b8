"""Elastic membership: the buffer re-arm the integrity rollback needs.

Port of `eventgrad_tpu/chaos/membership.py`, its `force_refresh` only:
after a rollback restores every rank from the last-known-good snapshot,
the next pass must force-fire every parameter on every rank so all
receive buffers refresh in one cycle. The rest of that module — the
`leave=` / `join=` membership transitions and their engine — is not
ported yet (ROADMAP queue 1, item 6, part 6d): `MembershipSchedule`
raises naming it.
"""

from __future__ import annotations

from typing import Optional

import torch

from eventgrad_tpu_torch.parallel.events import EventConfig


def force_refresh(state, event_cfg: Optional[EventConfig]):
    """Arm a force-fired next exchange, riding the trigger itself: in
    adaptive mode the thresholds drop to 0 (`value_diff >= 0` always
    holds, and the fire resets them from the slope history); in constant
    mode `last_sent_norm` drops to -1e30, which any drift beats; with a
    constant threshold of 0 every pass fires already. D-PSGD and
    allreduce carry no event state and ship everything every pass."""
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


class MembershipSchedule:
    """The `leave=` / `join=` transitions: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "membership transitions (leave= / join=) are not ported yet "
            "(ROADMAP queue 1, item 6, part 6d)")
