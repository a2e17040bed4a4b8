"""Neighbor topologies over the rank-stacked dimension.

Port of `eventgrad_tpu/parallel/topology.py`: `Topology` with its three
axis classes (gossip, replicated aux and sharded axes, and the data-aux
"ddp" axes of hierarchical data parallelism), `Ring` and `Torus`. A
topology names its axes and enumerates neighbor *shifts* on its gossip
axes; in the port each shift is a `torch.roll` of the leading rank
dimension, reshaped to the topology's grid (`collectives.recv_from`).

A `Ring` has two neighbors (offset -1 and +1) and reproduces the
reference's `left = (rank-1+N) % N`, `right = (rank+1) % N`; a `Torus`
has those two along each of its axes. Mixing is uniform,
1/(1+n_neighbors): 1/3 on a ring, 1/5 on a 2-D torus.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

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
    """A named-axis layout of ranks plus the gossip neighbor set.

    Three axis classes, as in the JAX package:
      * gossip axes (`gossip_axes`, default every axis not sharded or
        data-aux): carry the decentralized neighbor exchanges; per-rank
        parameters differ and mix by averaging.
      * replicated aux axes (everything else not in `sharded_axes`, e.g.
        a sequence-parallel axis): ranks hold identical parameters and
        average their gradients (`train/steps.py`).
      * sharded axes (`sharded_axes`): tensor, pipeline or expert
        parallelism — each rank owns a distinct parameter shard, the
        model synchronizes activations along the axis itself
        (`parallel/collectives.axis_sum`, `axis_all_to_all`), and the
        train step neither averages parameters nor gradients across it.
    `data_aux_axes` are aux axes that shard the data (hierarchical data
    parallelism, "ddp"): synchronous allreduce subgroups inside every
    gossip rank.

    `mesh` (a `parallel.spmd.Mesh`, set by `spmd.lift`) places the ranks
    in the processes of a `torch.distributed` group: each process then
    holds its contiguous rows `[lo, hi)` of every rank-stacked tensor,
    and the collectives exchange the rows other processes hold. It is
    part of equality (a mesh equals only itself), so what is cached on a
    topology is cached apart for a lifted one.
    """

    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    gossip_axes: Tuple[str, ...] = None  # type: ignore[assignment]
    sharded_axes: Tuple[str, ...] = ()
    data_aux_axes: Tuple[str, ...] = ()
    mesh: Any = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} vs shape {self.shape} length mismatch")
        if any(s < 1 for s in self.shape):
            raise ValueError(f"invalid topology shape {self.shape}")
        if self.gossip_axes is None:
            object.__setattr__(
                self,
                "gossip_axes",
                tuple(
                    a
                    for a in self.axes
                    if a not in self.sharded_axes
                    and a not in self.data_aux_axes
                ),
            )
        elif any(a not in self.axes for a in self.gossip_axes):
            raise ValueError(f"gossip_axes {self.gossip_axes} not all in {self.axes}")
        if any(a not in self.axes for a in self.sharded_axes):
            raise ValueError(f"sharded_axes {self.sharded_axes} not all in {self.axes}")
        if set(self.gossip_axes) & set(self.sharded_axes):
            raise ValueError("an axis cannot be both gossip and sharded")
        if any(a not in self.axes for a in self.data_aux_axes):
            raise ValueError(
                f"data_aux_axes {self.data_aux_axes} not all in {self.axes}"
            )
        if set(self.data_aux_axes) & (
            set(self.gossip_axes) | set(self.sharded_axes)
        ):
            raise ValueError(
                "data_aux_axes must be replicated aux axes (not gossip or "
                "sharded)"
            )

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape)

    @property
    def n_local(self) -> int:
        """Rows of a rank-stacked tensor this process holds: every rank on
        the simulator, R / W on a mesh of W processes."""
        return self.n_ranks if self.mesh is None else self.mesh.n_local

    def local_rows(self, x):
        """This process's rows `[lo, hi)` of a full `[R, ...]` stack (the
        stack itself on the simulator)."""
        return x if self.mesh is None else x[self.mesh.lo:self.mesh.hi]

    @property
    def n_gossip_ranks(self) -> int:
        """Extent of the gossip axes."""
        return math.prod(self.axis_size(a) for a in self.gossip_axes)

    @property
    def is_hybrid(self) -> bool:
        """True when the mesh carries axes that do not shard the data
        (sp/tp/pp/ep): batches then need `data.sharding.expand_to_mesh`,
        and a consensus average over every rank would mix differently
        sharded parameters."""
        return self.n_data_ranks != self.n_ranks

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes that shard the data: the gossip axes plus any declared
        `data_aux_axes`. Other aux and sharded axes (sp/tp/pp/ep)
        replicate or chunk batches instead."""
        return tuple(
            a
            for a in self.axes
            if a in self.gossip_axes or a in self.data_aux_axes
        )

    @property
    def n_data_ranks(self) -> int:
        """The data-parallel degree: batches shard across `data_axes`."""
        return math.prod(self.axis_size(a) for a in self.data_axes)

    @property
    def aux_axes(self) -> Tuple[str, ...]:
        """Replicated non-gossip axes; ranks along them hold identical
        parameters and average their gradients."""
        return tuple(
            a
            for a in self.axes
            if a not in self.gossip_axes and a not in self.sharded_axes
        )

    @property
    def neighbors(self) -> Tuple[NeighborSpec, ...]:
        """Neighbor shifts, one per gossip partner, on the gossip axes
        only. An axis of size 1 has none; on an axis of size 2, -1 and +1
        are the same rank but the reference still sends both messages,
        so both shifts stay."""
        specs = []
        for axis, size in zip(self.axes, self.shape):
            if size > 1 and axis in self.gossip_axes:
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

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

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
