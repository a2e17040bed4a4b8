"""Fault injection inside the gossip step: the straggler clauses.

Port of `eventgrad_tpu/chaos/inject.py` (`rank_and_sources`,
`lag_vector`, `lag_table`; `delivery_mask` for the lag-only schedules the
port runs, where every message is delivered). The JAX functions run
inside the per-rank SPMD step and derive the rank from the named axes;
here every rank of the topology is one row of the rank-stacked tensors,
so the functions return `[R, n_neighbors]` tables. A lag is pure data —
no random draws — and depends on the edge sources alone, so the host
table `lag_table` replays the step's `lag_vector` exactly.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.parallel.topology import Topology


def host_source_table(topo: Topology) -> np.ndarray:
    """int32 `[n_ranks, n_neighbors]`: entry (r, e) is the flat rank whose
    payload rank r receives on edge e (`Topology.neighbor_source`)."""
    return np.asarray(
        [[topo.neighbor_source(r, nb) for nb in topo.neighbors]
         for r in range(topo.n_ranks)],
        np.int32,
    ).reshape(topo.n_ranks, topo.n_neighbors)


@functools.lru_cache(maxsize=16)
def _sources(topo: Topology, device: torch.device):
    ranks = torch.arange(topo.n_ranks, dtype=torch.int32, device=device)
    srcs = torch.as_tensor(host_source_table(topo), device=device)
    return ranks, srcs


def rank_and_sources(topo: Topology, device=None) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """(flat rank int32 `[R]`, per-edge source rank int32 `[R,
    n_neighbors]`) on `device`: the rank-stacked twin of the JAX
    function's per-rank pair. Cached per device: read only."""
    return _sources(topo, torch.device(device or "cpu"))


def delivery_mask(sched: Optional[ChaosSchedule], topo: Topology,
                  pass_num: int, device=None) -> torch.Tensor:
    """Per-edge delivered bits, bool `[R, n_neighbors]`: every message
    arrives under the schedules the port runs (lag and slow delay a
    message, they never drop it; the drop clauses wait, ROADMAP queue 1,
    item 6)."""
    return torch.ones((topo.n_ranks, topo.n_neighbors), dtype=torch.bool,
                      device=device)


def lag_vector(
    sched: Optional[ChaosSchedule],
    topo: Topology,
    pass_num: int,
    bound: int,
    device=None,
) -> torch.Tensor:
    """Per-edge effective delivery lag, int32 `[R, n_neighbors]`, of the
    messages exchanged on pass `pass_num`: max(1, the lag= windows
    covering the pass, the slow= clauses naming the edge's source),
    clamped to [1, bound]. `sched=None` is the all-baseline (lag 1)
    schedule."""
    _, srcs = rank_and_sources(topo, device)
    lag = torch.ones(srcs.shape, dtype=torch.int32, device=srcs.device)
    if sched is not None:
        p = int(pass_num)
        for w in sched.lag:
            if w.start_pass <= p < w.end_pass:
                lag = torch.clamp_min(lag, int(w.lag))
        for r, f in sched.slow:
            lag = torch.where(srcs == int(r), torch.clamp_min(lag, int(f)),
                              lag)
    return torch.clamp(lag, 1, max(1, int(bound)))


def lag_table(
    sched: Optional[ChaosSchedule],
    topo: Topology,
    n_passes: int,
    start_pass: int = 1,
    bound: Optional[int] = None,
) -> np.ndarray:
    """Host replay of the lag schedule: int32 `[n_passes, n_ranks,
    n_neighbors]`. With `bound`, the clamp of `lag_vector` (the step's
    values); with bound=None the raw scheduled lag."""
    srcs = host_source_table(topo)
    out = np.ones((n_passes, topo.n_ranks, topo.n_neighbors), np.int32)
    for pi in range(n_passes):
        p = start_pass + pi
        for r in range(topo.n_ranks):
            lag = out[pi, r]
            if sched is not None:
                for w in sched.lag:
                    if w.start_pass <= p < w.end_pass:
                        lag[:] = np.maximum(lag, w.lag)
                for sr, f in sched.slow:
                    lag[srcs[r] == sr] = np.maximum(lag[srcs[r] == sr], f)
            if bound is not None:
                np.clip(lag, 1, max(1, int(bound)), out=lag)
    return out
