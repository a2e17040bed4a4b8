"""Fault injection inside the gossip step.

Port of `eventgrad_tpu/chaos/inject.py`. A dropped message is "the
receiver keeps its stale buffer": the exchange ANDs a per-edge delivered
bit into the effective fire bits it already selects with, so an injected
drop is bitwise an event that did not fire. Every draw is a pure
function of (seed, pass, receiving rank, edge): the JAX package's
counter-style `fold_in` chains, run here through the port's own Threefry
(`chaos/prng.py`), bit for bit `jax.random`.

The JAX functions run inside the per-rank SPMD step, one draw per pass.
Here the host builds each table once per run, for every pass of the run
(`delivery_table`, `corruption_table`, `nanstep_table`), and
`FaultTables` uploads them once and indexes them by pass on the device:
a per-pass host copy would be a pageable copy that syncs the stream.
Every rank of the topology is one row of the rank-stacked tensors, so a
pass's draws are `[R, n_neighbors]` tables. On a device mesh every
process draws the tables over all R ranks and reads its own rows, so
each row is the simulator's (`FaultTables.at`). Passes are 1-based, as
in the step.

`lag_vector` / `lag_table` (the bounded-async engine's per-edge lags)
depend on the edge sources alone, no draws.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.chaos import prng
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.parallel.topology import Topology

#: fold_in tags separating the schedule's independent random streams
#: (the JAX package's frozen values: changing one changes every replay)
_TAG_DROP = 0x5EED
_TAG_PHASE = 0x9A5E
_TAG_FLIP = 0xB17F
_TAG_FLIP_POS = 0xB170


def host_source_table(topo: Topology) -> np.ndarray:
    """int32 `[n_ranks, n_neighbors]`: entry (r, e) is the flat rank whose
    payload rank r receives on edge e (`Topology.neighbor_source`)."""
    return np.asarray(
        [[topo.neighbor_source(r, nb) for nb in topo.neighbors]
         for r in range(topo.n_ranks)],
        np.int32,
    ).reshape(topo.n_ranks, topo.n_neighbors)


def reverse_edge_index(topo: Topology):
    """Per edge index e, the index of the reverse edge (same axis,
    negated offset), or None when an edge lacks its reverse."""
    rev = []
    for nb in topo.neighbors:
        match = [j for j, other in enumerate(topo.neighbors)
                 if other.axis == nb.axis and other.offset == -nb.offset]
        if not match:
            return None
        rev.append(match[0])
    return rev


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


def _pass_rank_keys(seed: int, tag: int, passes: np.ndarray, n_ranks: int):
    """Keys `fold_in(fold_in(fold_in(PRNGKey(seed), tag), pass), rank)`,
    shape `[P, R]`."""
    k = prng.fold_in(prng.PRNGKey(seed), tag)
    kp = prng.fold_in(k, passes.astype(np.uint32)[:, None])
    return prng.fold_in(kp, np.arange(n_ranks, dtype=np.uint32)[None, :])


def _window_p(base: float, windows, passes: np.ndarray, n_nb: int):
    """`[P, 1]` float32 probability per pass: `base`, raised to each
    window's probability inside its window (the JAX chain of f32
    maxima)."""
    p = np.full((len(passes), 1), np.float32(base), np.float32)
    for w in windows:
        inside = ((passes >= w.start_pass) & (passes < w.end_pass))[:, None]
        p = np.where(inside, np.maximum(p, np.float32(w.drop_p)), p)
    return p


def delivery_table(sched: ChaosSchedule, topo: Topology, n_passes: int,
                   start_pass: int = 1) -> np.ndarray:
    """bool `[n_passes, n_ranks, n_neighbors]`: did a message sent on
    edge (r, e) in pass `start_pass + i` arrive. The iid drop draw
    (`uniform >= p`, p the drop or flaky probability), the delay phases
    (`pass % k == phase`, a seed-derived phase per edge) and death in
    both directions, bitwise the JAX package's `delivery_table`."""
    R, n_nb = topo.n_ranks, topo.n_neighbors
    passes = np.arange(start_pass, start_pass + n_passes, dtype=np.int64)
    u = prng.uniform(_pass_rank_keys(sched.seed, _TAG_DROP, passes, R), n_nb)
    deliver = u >= _window_p(sched.drop_p, sched.flaky, passes, n_nb)[
        :, :, None]
    if sched.deliver_every > 1:
        k = prng.fold_in(prng.PRNGKey(sched.seed), _TAG_PHASE)
        kr = prng.fold_in(k, np.arange(R, dtype=np.uint32))
        phase = prng.randint(kr, n_nb, 0, sched.deliver_every)  # [R, nb]
        deliver &= (passes % sched.deliver_every)[:, None, None] == phase
    srcs = host_source_table(topo)
    ranks = np.arange(R)
    for dead, t in sched.death:
        dead_now = (passes >= t)[:, None, None]
        deliver &= ~(dead_now & (srcs == dead)[None])
        deliver &= ~(dead_now & (ranks == dead)[None, :, None])
    return deliver


def corruption_tables(sched: ChaosSchedule, topo: Topology, n_passes: int,
                      start_pass: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(corrupt bool, salt int32), each `[n_passes, n_ranks,
    n_neighbors]`: does the payload received on edge (r, e) have one bit
    flipped in transit, and the salt that picks the flipped element
    (`flip_one_bit`), bitwise the JAX package's `corrupt_mask` draws."""
    R, n_nb = topo.n_ranks, topo.n_neighbors
    passes = np.arange(start_pass, start_pass + n_passes, dtype=np.int64)
    u = prng.uniform(_pass_rank_keys(sched.seed, _TAG_FLIP, passes, R), n_nb)
    corrupt = u < _window_p(0.0, sched.bitflip, passes, n_nb)[:, :, None]
    salt = prng.randint(
        _pass_rank_keys(sched.seed, _TAG_FLIP_POS, passes, R), n_nb, 0,
        2**31 - 1)
    return corrupt, salt


def corruption_table(sched: ChaosSchedule, topo: Topology, n_passes: int,
                     start_pass: int = 1) -> np.ndarray:
    """bool `[n_passes, n_ranks, n_neighbors]` of injected corruptions:
    the ground truth the integrity accounting compares against."""
    return corruption_tables(sched, topo, n_passes, start_pass)[0]


def nanstep_table(sched: ChaosSchedule, topo: Topology, n_passes: int,
                  start_pass: int = 1) -> np.ndarray:
    """bool `[n_passes, n_ranks]`: is rank r's update poisoned (NaN) on
    pass `start_pass + i` (the `nanstep=R@P` events; no draws)."""
    out = np.zeros((n_passes, topo.n_ranks), bool)
    for r, t in sched.nanstep:
        if 0 <= t - start_pass < n_passes and 0 <= r < topo.n_ranks:
            out[t - start_pass, r] = True
    return out


def nansteps_in_range(sched: ChaosSchedule, n_ranks: int, n_passes: int,
                      start_pass: int = 1) -> int:
    """How many scheduled nanstep events land within the run."""
    return sum(1 for r, t in sched.nanstep
               if 0 <= r < n_ranks and start_pass <= t < start_pass + n_passes)


class FaultTables:
    """A schedule's per-pass draws on one device: uploaded once for
    passes 1..n_passes, read by pass with no host copy. A pass beyond
    the tables rebuilds them at twice the length (one upload)."""

    def __init__(self, sched: ChaosSchedule, topo: Topology, n_passes: int,
                 device):
        self.sched, self.topo = sched, topo
        self.device = torch.device(device)
        self._build(max(1, int(n_passes)))

    def _build(self, n: int) -> None:
        s, topo, dev = self.sched, self.topo, self.device
        self.n_passes = n
        self.deliver = torch.as_tensor(delivery_table(s, topo, n),
                                       device=dev)
        self.corrupt = self.salt = self.poison = None
        if s.has_bitflips:
            c, salt = corruption_tables(s, topo, n)
            self.corrupt = torch.as_tensor(c, device=dev)
            self.salt = torch.as_tensor(salt.astype(np.int64), device=dev)
        if s.has_nansteps:
            self.poison = torch.as_tensor(nanstep_table(s, topo, n),
                                          device=dev)

    def at(self, pass_num: int):
        """(deliver `[R, n_nb]`, corrupt `[R, n_nb]` or None, salt `[R,
        n_nb]` int64 or None, poison `[R]` or None) of a 1-based pass;
        on a topology lifted onto a mesh, this process's rows of the
        tables drawn over every rank, so each row is the simulator's."""
        p = int(pass_num)
        if p < 1:
            raise ValueError(f"passes are 1-based, got {p}")
        if p > self.n_passes:
            self._build(max(2 * self.n_passes, p))
        i = p - 1
        pick = lambda t: None if t is None else self.topo.local_rows(t[i])
        return (pick(self.deliver), pick(self.corrupt), pick(self.salt),
                pick(self.poison))


def flip_one_bit(buf: torch.Tensor, do_flip: torch.Tensor,
                 salt: torch.Tensor) -> torch.Tensor:
    """Flip one bit of each row of a received `[R, m]` wire buffer where
    `do_flip` (bool `[R]`) is set, in place: element `salt % m` of row r
    (salt int `[R]`), the second most significant bit of its storage
    word — a float payload's exponent MSB, an int8's bit 6. Returns
    `buf`."""
    if buf.is_floating_point():
        nbits = torch.finfo(buf.dtype).bits
        int_dt = {16: torch.int16, 32: torch.int32, 64: torch.int64}[nbits]
        bits = buf.view(int_dt)
    else:
        nbits, int_dt, bits = torch.iinfo(buf.dtype).bits, buf.dtype, buf
    rows = torch.arange(buf.shape[0], device=buf.device)
    idx = salt.to(torch.int64) % buf.shape[-1]
    old = bits[rows, idx]
    mask = torch.full((), 1 << (nbits - 2), dtype=int_dt, device=buf.device)
    bits.index_put_((rows, idx), torch.where(do_flip, old ^ mask, old))
    return buf


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
    schedule. On a mesh, the rows this process holds."""
    srcs = topo.local_rows(rank_and_sources(topo, device)[1])
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
