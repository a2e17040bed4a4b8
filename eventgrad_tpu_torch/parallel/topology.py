"""Neighbor topologies over the rank-stacked dimension.

Port of `eventgrad_tpu/parallel/topology.py` (`Ring` and `Torus`; the
aux and sharded axes of the hybrid topologies wait). A topology names
its axes and enumerates neighbor *shifts*; in the port each shift is a
`torch.roll` of the leading rank dimension, reshaped to the topology's
grid (`collectives.recv_from`).

A `Ring` has two neighbors (offset -1 and +1) and reproduces the
reference's `left = (rank-1+N) % N`, `right = (rank+1) % N`; a `Torus`
has those two along each of its axes. Mixing is uniform,
1/(1+n_neighbors): 1/3 on a ring, 1/5 on a 2-D torus.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class NeighborSpec:
    """One neighbor direction: a shift of `offset` along axis `axis`.

    `offset=-1` means "the value I receive comes from my left neighbor"
    (rank r receives from rank r-1 mod n, the reference's `left`).
    """

    axis: str
    offset: int

    @property
    def name(self) -> str:
        """The edge's label in records and gauges ("ring_m1", "x_p1")."""
        sign = "m" if self.offset < 0 else "p"
        return f"{self.axis}_{sign}{abs(self.offset)}"


@dataclasses.dataclass(frozen=True)
class Topology:
    """A named-axis layout of ranks plus the gossip neighbor set. Every
    axis is a gossip axis in this slice (aux and sharded axes wait)."""

    axes: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape} length mismatch")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"invalid topology shape {self.shape}")

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape)

    @property
    def neighbors(self) -> Tuple[NeighborSpec, ...]:
        """Neighbor shifts, one per gossip partner. An axis of size 1 has
        none; on an axis of size 2, -1 and +1 are the same rank but the
        reference still sends both messages, so both shifts stay."""
        specs = []
        for axis, size in zip(self.axes, self.shape):
            if size > 1:
                specs.append(NeighborSpec(axis, -1))
                specs.append(NeighborSpec(axis, +1))
        return tuple(specs)

    @property
    def n_neighbors(self) -> int:
        return len(self.neighbors)

    @property
    def mix_weight(self) -> float:
        """Uniform gossip mixing weight: 1/3 on a ring, 1/5 on a torus."""
        return 1.0 / (1.0 + self.n_neighbors)

    def neighbor_source(self, rank: int, spec: NeighborSpec) -> int:
        """Flat rank whose payload arrives at `rank` via `spec`, under the
        row-major stacked layout (rank r receives from the rank
        `spec.offset` away along `spec.axis`)."""
        ax = self.axes.index(spec.axis)
        coords = list(np.unravel_index(rank, self.shape))
        coords[ax] = (coords[ax] + spec.offset) % self.shape[ax]
        return int(np.ravel_multi_index(coords, self.shape))


def Ring(n: int, axis: str = "ring") -> Topology:
    """1-D ring of `n` ranks — the reference's only topology."""
    return Topology(axes=(axis,), shape=(n,))


def Torus(nx: int, ny: int, axes: Tuple[str, str] = ("x", "y")) -> Topology:
    """2-D torus (nx x ny) with 4 neighbors per rank."""
    return Topology(axes=tuple(axes), shape=(nx, ny))
