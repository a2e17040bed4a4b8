"""Recovery policies: forced sync, edge freeze, ring heal.

Port of `eventgrad_tpu/chaos/policy.py`. Three escalating answers to a
quiet edge, keyed off the `monitor.PeerHealth` silence counters:

  * forced full-sync (`sync_after`) — when an incoming edge has been
    silent `sync_after` passes, the receiver gossips a 1-bit request
    back along the reverse edge (`monitor.sync_requests`) and the sender
    force-fires every parameter on its next pass;
  * edge freeze (`freeze_after`) — an edge silent that long leaves the
    mix and the weight renormalizes, `p <- (p + sum(alive bufs)) / (1 +
    n_alive)` (`collectives.mix_weighted`; on the fused tail the gated
    forms of kernels 1, 4 and 5); a payload arriving again un-freezes
    it;
  * ring heal (`heal_ring` / `apply_ring_heal`) — permanent peer death:
    the survivors' rows of the rank-stacked state on the `Ring(n - 1)`
    of survivors, silence reset.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from eventgrad_tpu_torch.parallel.topology import Ring, Topology


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Receiver-side recovery bounds (0 disables a mechanism); both
    should exceed the sender's `EventConfig.max_silence`."""

    sync_after: int = 0
    freeze_after: int = 0

    def __post_init__(self):
        if self.sync_after < 0 or self.freeze_after < 0:
            raise ValueError(f"recovery bounds must be >= 0, got {self}")

    @property
    def is_noop(self) -> bool:
        return self.sync_after == 0 and self.freeze_after == 0

    def validate_against(self, max_silence: int) -> None:
        """Bounds at or below the sender-side silence guarantee would
        force-sync or freeze healthy edges every cycle: refused."""
        for name, b in (("sync_after", self.sync_after),
                        ("freeze_after", self.freeze_after)):
            if b and max_silence and b <= max_silence:
                raise ValueError(
                    f"{name}={b} is within the sender's "
                    f"max_silence={max_silence} guarantee: healthy "
                    "event-triggered silence would trip it every cycle "
                    f"(use {name} > max_silence)"
                )

    def to_dict(self) -> dict:
        return {"sync_after": self.sync_after,
                "freeze_after": self.freeze_after}


def alive_mask(silence: torch.Tensor,
               policy: RecoveryPolicy) -> Optional[torch.Tensor]:
    """bool `[R, n_neighbors]`: the edges whose buffers stay in the mix;
    None with freeze off (the untouched uniform mix)."""
    if not policy.freeze_after:
        return None
    return silence < policy.freeze_after


def heal_ring(topo: Topology,
              dead: Iterable[int]) -> Tuple[Topology, Tuple[int, ...]]:
    """(the healed ring, survivors): survivors[j] is the old rank now at
    healed rank j; the healed `neighbor_source` is `Ring(n_survivors)`'s,
    each survivor wired to the cyclically next survivor. Single-axis
    rings only."""
    dead_set = {int(d) for d in dead}
    if len(topo.axes) != 1:
        raise ValueError(
            f"heal_ring handles single-axis rings; got axes {topo.axes}")
    bad = [d for d in dead_set if not 0 <= d < topo.n_ranks]
    if bad:
        raise ValueError(f"dead ranks {bad} outside 0..{topo.n_ranks - 1}")
    survivors = tuple(r for r in range(topo.n_ranks) if r not in dead_set)
    if len(survivors) < 2:
        raise ValueError(
            f"cannot heal: only {len(survivors)} of {topo.n_ranks} ranks "
            "survive (a ring needs >= 2)")
    return Ring(len(survivors), axis=topo.axes[0]), survivors


def _take_rows(x, idx: torch.Tensor, n_ranks: int):
    """The survivors' rows of every rank-stacked tensor in `x` (nested
    dataclasses, tuples and dicts); scalars and other leaves pass."""
    if isinstance(x, torch.Tensor):
        if x.dim() and x.shape[0] == n_ranks:
            return torch.index_select(x, 0, idx.to(x.device))
        return x
    if isinstance(x, (tuple, list)):
        return type(x)(_take_rows(v, idx, n_ranks) for v in x)
    if isinstance(x, dict):
        return {k: _take_rows(v, idx, n_ranks) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _take_rows(getattr(x, f.name), idx, n_ranks)
            for f in dataclasses.fields(x)})
    return x


def apply_ring_heal(state, topo: Topology, dead: Iterable[int]):
    """Slice a rank-stacked train state down to the survivors of a ring
    heal. Returns (healed state, healed topology, survivors). The receive
    buffers now face the bridged neighbours and stay stale until the next
    fire; the silence and sync requests reset so the recovery policies
    do not trip at once on the new edges."""
    healed, survivors = heal_ring(topo, dead)
    idx = torch.as_tensor(survivors, dtype=torch.int64)
    rng = state.rng
    new_state = _take_rows(state.replace(rng=None), idx, topo.n_ranks)
    new_state = new_state.replace(rng=rng)
    if new_state.chaos is not None:
        new_state = new_state.replace(chaos=new_state.chaos.replace(
            silence=torch.zeros_like(new_state.chaos.silence),
            sync_req=torch.zeros_like(new_state.chaos.sync_req)))
    return new_state, healed, survivors
