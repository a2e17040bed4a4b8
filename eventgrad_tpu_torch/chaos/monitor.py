"""Peer-health monitoring: per-edge silence and observed drops.

Port of `eventgrad_tpu/chaos/monitor.py` (`PeerHealth`, `update`,
`edge_status`, `health_record`; the forced-sync gossip `sync_requests`
and the consensus-error probe wait with the recovery policies, ROADMAP
queue 1, item 6). The state is rank-stacked: `silence` is `[R,
n_neighbors]`, `sync_req` and `drops` are `[R]`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from eventgrad_tpu_torch.parallel.topology import Topology


@dataclasses.dataclass
class PeerHealth:
    """Per-rank receiver-side link state.

    silence:  int32 [R, n_neighbors] — passes since a payload last
              arrived on each incoming edge (an unfired or undelivered
              pass counts).
    sync_req: bool [R] — a neighbour asked this rank to force-fire next
              pass (never set without the recovery policies).
    drops:    int32 [R] — cumulative injected drops observed.
    """

    silence: torch.Tensor
    sync_req: torch.Tensor
    drops: torch.Tensor

    def replace(self, **kw) -> "PeerHealth":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(cls, topo: Topology, device=None) -> "PeerHealth":
        r = topo.n_ranks
        return cls(
            silence=torch.zeros((r, topo.n_neighbors), dtype=torch.int32,
                                device=device),
            sync_req=torch.zeros((r,), dtype=torch.bool, device=device),
            drops=torch.zeros((r,), dtype=torch.int32, device=device),
        )


def update(health: PeerHealth, delivered_any: torch.Tensor,
           dropped_any: torch.Tensor) -> PeerHealth:
    """Advance the counters one pass; `delivered_any` / `dropped_any` are
    bool `[R, n_neighbors]`: did a payload arrive / get eaten on each
    edge this pass."""
    zero = torch.zeros((), dtype=torch.int32, device=health.silence.device)
    return health.replace(
        silence=torch.where(delivered_any, zero, health.silence + 1),
        drops=health.drops + torch.sum(dropped_any, dim=-1,
                                       dtype=torch.int32),
    )


def edge_status(silence: int, max_silence: int,
                suspect_factor: float = 3.0) -> str:
    """'healthy', 'suspect' (silence beyond `suspect_factor` x the
    sender's max_silence bound) or 'unbounded' (no sender bound)."""
    if max_silence <= 0:
        return "unbounded"
    return "suspect" if silence > suspect_factor * max_silence else "healthy"


def health_record(silence, drops, max_silence: int) -> Dict[str, object]:
    """The records' fields from host copies of the counters: per-edge max
    silence across ranks, its status, and the total drops. `silence` is
    `[R, n_neighbors]`, `drops` any array of per-rank counts."""
    silence = np.asarray(silence)
    per_edge_max = (silence.max(axis=0) if silence.size
                    else np.zeros((0,), np.int64))
    return {
        "edge_silence_max": [int(v) for v in per_edge_max],
        "edge_status": [edge_status(int(v), max_silence)
                        for v in per_edge_max],
        "chaos_drops": int(np.asarray(drops).sum()),
    }
