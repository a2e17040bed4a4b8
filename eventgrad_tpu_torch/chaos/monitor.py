"""Peer-health monitoring: per-edge silence and observed drops.

Port of `eventgrad_tpu/chaos/monitor.py` (`PeerHealth`, `update`,
`sync_requests`, `consensus_error`, `edge_status`, `health_record`).
The state is rank-stacked: `silence` is `[R, n_neighbors]`, `sync_req`
and `drops` are `[R]` (on a device mesh, this process's rows; the sync
requests gossip back across processes through `recv_from`). With the
sender's `max_silence = M > 0` a healthy incoming edge is silent at
most M passes (plus wire loss), so silence far beyond M is evidence of
a dead or lossy link; the consensus-error probe `||p_r - mean(p)||` is
the host-side drift metric of the records.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Topology


@dataclasses.dataclass
class PeerHealth:
    """Per-rank receiver-side link state.

    silence:  int32 [R, n_neighbors] — passes since a payload last
              arrived on each incoming edge (an unfired or undelivered
              pass counts).
    sync_req: bool [R] — a neighbour asked this rank to force-fire next
              pass (`sync_requests`, under `RecoveryPolicy.sync_after`).
    drops:    int32 [R] — cumulative injected drops observed.
    """

    silence: torch.Tensor
    sync_req: torch.Tensor
    drops: torch.Tensor

    def replace(self, **kw) -> "PeerHealth":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(cls, topo: Topology, device=None) -> "PeerHealth":
        """Zero counters for the rows a step on `topo` holds: every rank,
        or on a topology lifted onto a mesh this process's rows."""
        r = topo.n_local
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


def sync_requests(need: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Gossip each rank's per-edge force-sync requests (`need`, bool `[R,
    n_neighbors]`) back to the edge sources; returns each rank's
    aggregated incoming request, bool `[R]`. The incoming edge with shift
    +o sources from rank me+o, which receives the request through the
    reverse shift -o: a roll of the rank dimension, one bool per edge."""
    got = torch.zeros(need.shape[:1], dtype=torch.bool, device=need.device)
    for i, nb in enumerate(topo.neighbors):
        rev = NeighborSpec(nb.axis, -nb.offset)
        got = got | collectives.recv_from(need[:, i].contiguous(), topo, rev)
    return got


@torch.no_grad()
def consensus_error(params: torch.Tensor) -> torch.Tensor:
    """Per-rank consensus error ||p_r - mean_r(p)||_2 of an `[R, n]`
    arena, f32 `[R]`: the drift metric that tells a healthy quiet
    network from a partitioned one."""
    flat = params.to(torch.float32)
    return torch.linalg.vector_norm(flat - flat.mean(dim=0, keepdim=True),
                                    dim=1)


def edge_status(silence: int, max_silence: int,
                suspect_factor: float = 3.0) -> str:
    """'healthy', 'suspect' (silence beyond `suspect_factor` x the
    sender's max_silence bound) or 'unbounded' (no sender bound)."""
    if max_silence <= 0:
        return "unbounded"
    return "suspect" if silence > suspect_factor * max_silence else "healthy"


def health_record(silence, drops, max_silence: int,
                  edges=None) -> Dict[str, object]:
    """The records' fields from host copies of the counters: per-edge max
    silence across ranks, its status, and the total drops. `silence` is
    `[R, n_neighbors]`, `drops` any array of per-rank counts. `edges`
    (neighbor names, topology order) labels the edges in the record (the
    registry's per-edge gauges pass them); omitted, the lists stay
    positional."""
    silence = np.asarray(silence)
    per_edge_max = (silence.max(axis=0) if silence.size
                    else np.zeros((0,), np.int64))
    rec = {
        "edge_silence_max": [int(v) for v in per_edge_max],
        "edge_status": [edge_status(int(v), max_silence)
                        for v in per_edge_max],
        "chaos_drops": int(np.asarray(drops).sum()),
    }
    if edges is not None:
        rec["edges"] = list(edges)
    return rec
