"""The two lifts of the per-rank program: all ranks stacked on one
device, or the ranks spread over the processes of a device mesh.

Port of `eventgrad_tpu/parallel/spmd.py`. The JAX package writes a
per-rank function against named axes and lifts it with nested
`jax.vmap` (the simulator) or `shard_map` over a device mesh. Here every
rank-stacked quantity carries an explicit leading `[n_ranks]` dimension
(row-major over `topo.shape`), the neighbor exchange is a `torch.roll`
of that dimension (`collectives.recv_from`), and the one per-rank
computation that needs a transform, the model's forward and backward,
is batched with `torch.func.vmap` (`per_rank`). A model that holds a
collective (ring or Ulysses attention, the tensor-, pipeline- and
expert-parallel transformers) runs rank-stacked instead: `per_rank`
batches its per-rank pieces between the collectives, which run on the
stack along one axis of the topology's grid (`collectives.axis_sum`,
`axis_all_to_all`, `recv_from`).

The device-mesh lift (`build_mesh`, `lift`) is the counterpart of
`shard_map`: a `Mesh` places the R ranks in the W processes of a
`torch.distributed` group (`parallel/multihost.py`), W dividing R,
process p holding the rows `[p R / W, (p + 1) R / W)` (`stacked_rows`,
the counterpart of `stacked_spec`). The per-rank code does not change:
the lifted topology (`topo.mesh`) routes the collectives through the
mesh. A shift (`recv_from`) takes the rows whose source is local from
the local stack and the others by point-to-point from their owners
(`hop`, an autograd Function whose backward sends the gradient back
along the inverse offset). A sum over a grid axis (`axis_sum`, and the
means `allreduce_mean` and `axis_mean` built on it) is a chain
reduction in the simulator's order: each group's partial sum walks its
members in axis order, crossing to the next member's process by
point-to-point, and the last member's process sends the total to the
group's other processes (`fold`), so a process moves one row a group
and a crossing, never the stack, and the lift computes the simulator's
bits. The all-to-all of a grid axis (`axis_all_to_all`) sends each
chunk to the process that holds its destination row (`swap`). With no
group initialised a mesh has one process holding every row.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from eventgrad_tpu_torch.parallel import multihost
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Topology


def stack_for_ranks(tree: Any, topo: Topology) -> Any:
    """Copy a per-rank tensor (or dict / tuple of tensors) to the stacked
    layout: every tensor gains a leading `n_ranks` dimension holding
    identical copies (the reference seeds all ranks identically)."""
    n = topo.n_ranks
    if isinstance(tree, dict):
        return {k: stack_for_ranks(v, topo) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(stack_for_ranks(v, topo) for v in tree)
    return tree.unsqueeze(0).expand((n,) + tuple(tree.shape)).contiguous()


def per_rank(fn: Callable) -> Callable:
    """Lift a per-rank function over the leading rank dimension of every
    argument and output (`torch.func.vmap` over dim 0)."""
    return torch.func.vmap(fn)


def sub_params(params, prefix: str) -> dict:
    """The entries of a dotted-name parameter dict under `prefix`, the
    prefix stripped ("Block_0.Dense_0.kernel" -> "Dense_0.kernel" under
    "Block_0")."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


# --- the device mesh ---------------------------------------------------------


def stacked_rows(n_ranks: int, n_procs: int, proc: int) -> Tuple[int, int]:
    """The rows `[lo, hi)` of an `[R, ...]` stack that process `proc` of
    `n_procs` holds: contiguous, row-major over the topology's shape."""
    if n_ranks % n_procs:
        raise ValueError(
            f"{n_procs} processes cannot hold {n_ranks} ranks: the process "
            "count must divide the rank count (each process holds R / W "
            "contiguous rows)")
    per = n_ranks // n_procs
    return proc * per, (proc + 1) * per


@dataclasses.dataclass(eq=False)
class Mesh:
    """The ranks of a topology placed in a process group: W processes of
    R / W contiguous rows each, this process's rows `[lo, hi)`, its
    device and the transport. `exchange_log` counts the lift's shifts by
    (axis, offset): the exchange the mesh step declares
    (`analysis/audit.mesh_lift_report`); `crossed` sums the bytes this
    process sent to the others by (collective, axis): "hop" for a shift,
    "fold" for a grid sum (the partial sums and the totals), "swap" for
    an all-to-all."""

    n_ranks: int
    n_procs: int
    proc: int
    device: torch.device
    transport: str
    group: Any = None
    exchange_log: Dict[Tuple[str, int], int] = dataclasses.field(
        default_factory=dict)
    crossed: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=dict)
    _plans: Dict[Any, Any] = dataclasses.field(default_factory=dict,
                                               repr=False)

    @property
    def n_local(self) -> int:
        return self.n_ranks // self.n_procs

    @property
    def lo(self) -> int:
        return self.proc * self.n_local

    @property
    def hi(self) -> int:
        return self.lo + self.n_local

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The full stack of this process's rows `x` (rank dimension
        `dim`): an all-gather over the group (a group of one process
        runs it too; with no group the rows are the stack)."""
        if self.transport == "local":
            return x
        if dim:
            return self.gather(x.movedim(dim, 0)).movedim(0, dim)
        return multihost.all_gather_rows(x, self.group, self.transport)

    def _exchange(self, x, sends, recvs, kind: str, axis: str) -> dict:
        """`multihost.exchange` over the group, its sent bytes booked in
        `crossed` under (kind, axis)."""
        if sends:
            key = (kind, axis)
            self.crossed[key] = self.crossed.get(key, 0) + sum(
                t.numel() * t.element_size() for t in sends.values())
        return multihost.exchange(x, sends, recvs, self.group,
                                  self.transport)

    def plan(self, topo: Topology, nb: NeighborSpec, device):
        """Where each local row of a shift by `nb` comes from: (local
        destination rows, their local sources, {peer: destination rows
        received from it}, {peer: local rows sent to it}), each an index
        tensor on `device`. A peer's rows are listed in the receiver's
        row order on both sides."""
        key = (topo.axes, topo.shape, nb, str(device))
        if key not in self._plans:
            per, p = self.n_local, self.proc
            src = [topo.neighbor_source(r, nb) for r in range(self.n_ranks)]
            loc_dst, loc_src, recv, send = [], [], {}, {}
            for r in range(self.n_ranks):
                q, s = r // per, src[r]
                if q == p and s // per == p:
                    loc_dst.append(r - self.lo)
                    loc_src.append(s - self.lo)
                elif q == p:
                    recv.setdefault(s // per, []).append(r - self.lo)
                elif s // per == p:
                    send.setdefault(q, []).append(s - self.lo)
            idx = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
            self._plans[key] = (idx(loc_dst), idx(loc_src),
                                {q: idx(v) for q, v in recv.items()},
                                {q: idx(v) for q, v in send.items()})
        return self._plans[key]

    def shift(self, x: torch.Tensor, topo: Topology,
              nb: NeighborSpec) -> torch.Tensor:
        """`recv_from` on this process's rows: out[r] = x[source(r)], the
        local sources read in place, the rest received from their
        owners in one batch of point-to-point transfers."""
        key = (nb.axis, nb.offset)
        self.exchange_log[key] = self.exchange_log.get(key, 0) + 1
        loc_dst, loc_src, recv, send = self.plan(topo, nb, x.device)
        if not recv and not send:
            return x.index_select(0, loc_src)
        got = self._exchange(
            x, {q: x.index_select(0, rows) for q, rows in send.items()},
            {q: (len(rows),) + tuple(x.shape[1:]) for q, rows in recv.items()},
            "hop", nb.axis)
        out = torch.empty_like(x)
        out[loc_dst] = x.index_select(0, loc_src)
        for q, rows in recv.items():
            out[rows] = got[q]
        return out

    def fold_plan(self, topo: Topology, ax: int):
        """The chain reduction over grid axis `ax` (`fold`): the groups
        (each the ranks along `ax` that share the other coordinates, in
        axis order), this process's first members `[(group, local row)]`,
        one round a later member `(sends, receives, adds)` (a peer's
        groups on both sides in group order; the adds `(group, local
        row)`), the totals' delivery `(sends, receives)`, and each local
        row's group."""
        key = ("fold", topo.shape, ax)
        if key not in self._plans:
            shape, per, p = tuple(topo.shape), self.n_local, self.proc
            a, stride = shape[ax], math.prod(shape[ax + 1:])
            outer = math.prod(shape[:ax])
            groups = [[o * a * stride + k * stride + i for k in range(a)]
                      for o in range(outer) for i in range(stride)]
            own = lambda r: r // per
            first = [(g, m[0] - self.lo) for g, m in enumerate(groups)
                     if own(m[0]) == p]
            rounds = []
            for k in range(1, a):
                send, recv, add = {}, {}, []
                for g, m in enumerate(groups):
                    src, dst = own(m[k - 1]), own(m[k])
                    if src == p and dst != p:
                        send.setdefault(dst, []).append(g)
                    if dst == p and src != p:
                        recv.setdefault(src, []).append(g)
                    if dst == p:
                        add.append((g, m[k] - self.lo))
                rounds.append((send, recv, add))
            send, recv = {}, {}
            for g, m in enumerate(groups):
                last = own(m[-1])
                for q in sorted({own(r) for r in m} - {last}):
                    if last == p:
                        send.setdefault(q, []).append(g)
                    elif q == p:
                        recv.setdefault(last, []).append(g)
            group_of = {r: g for g, m in enumerate(groups) for r in m}
            rows = [group_of[r] for r in range(self.lo, self.hi)]
            self._plans[key] = (first, rounds, (send, recv), rows)
        return self._plans[key]

    def _move(self, x, acc, send, recv, axis, keep=False):
        """One batch of point-to-point transfers of the partial sums along
        `axis`: `send` {peer: groups} leave `acc` (stay in it with
        `keep`), `recv` {peer: groups} land in it."""
        if not send and not recv:
            return
        take = acc.get if keep else acc.pop
        got = self._exchange(
            x, {q: torch.stack([take(g) for g in gs])
                for q, gs in send.items()},
            {q: (len(gs),) + tuple(x.shape[1:]) for q, gs in recv.items()},
            "fold", axis)
        for q, gs in recv.items():
            acc.update(zip(gs, got[q]))

    def fold(self, x: torch.Tensor, topo: Topology, ax: int) -> torch.Tensor:
        """The sum over grid axis `ax` on this process's rows, member by
        member in axis order (`collectives.fold`'s order, so its bits):
        every row receives its group's sum."""
        first, rounds, (send, recv), rows = self.fold_plan(topo, ax)
        axis = topo.axes[ax]
        acc = {g: x[r] for g, r in first}
        for k_send, k_recv, add in rounds:
            self._move(x, acc, k_send, k_recv, axis)
            for g, r in add:
                acc[g] = acc[g] + x[r]
        # the totals to the group's other processes
        self._move(x, acc, send, recv, axis, keep=True)
        return torch.stack([acc[g] for g in rows])

    def swap_plan(self, topo: Topology, ax: int, device):
        """Where each (local row, chunk) of an all-to-all along grid axis
        `ax` comes from: (local destination (rows, chunks), their local
        sources (rows, chunks), {peer: destination (rows, chunks)
        received from it}, {peer: local source (rows, chunks) sent to
        it}); a peer's pairs listed in the receiver's order on both
        sides."""
        key = ("swap", topo.shape, ax, str(device))
        if key not in self._plans:
            shape, per, p = tuple(topo.shape), self.n_local, self.proc
            a, stride = shape[ax], math.prod(shape[ax + 1:])
            coord = lambda r: (r // stride) % a
            loc_dst, loc_src, recv, send = [], [], {}, {}
            for r in range(self.n_ranks):
                for j in range(a):
                    # rank r's chunk j comes from member j's chunk coord(r)
                    s = r + (j - coord(r)) * stride
                    q, sq = r // per, s // per
                    if q == p and sq == p:
                        loc_dst.append((r - self.lo, j))
                        loc_src.append((s - self.lo, coord(r)))
                    elif q == p:
                        recv.setdefault(sq, []).append((r - self.lo, j))
                    elif sq == p:
                        send.setdefault(q, []).append((s - self.lo,
                                                       coord(r)))
            idx = lambda v: tuple(torch.tensor(c, dtype=torch.int64,
                                               device=device)
                                  for c in zip(*v)) if v else None
            self._plans[key] = (idx(loc_dst), idx(loc_src),
                                {q: idx(v) for q, v in recv.items()},
                                {q: idx(v) for q, v in send.items()})
        return self._plans[key]

    def swap(self, x: torch.Tensor, topo: Topology, ax: int) -> torch.Tensor:
        """`collectives.axis_all_to_all` on this process's rows `[n_local,
        A, ...]`: out[r, j] = x[member j of r's group, r's coordinate],
        the local chunks read in place, the rest sent to the process that
        holds their destination row."""
        loc_dst, loc_src, recv, send = self.swap_plan(topo, ax, x.device)
        out = torch.empty_like(x)
        if loc_dst is not None:
            out[loc_dst] = x[loc_src]
        if recv or send:
            got = self._exchange(
                x, {q: x[pairs] for q, pairs in send.items()},
                {q: (len(pairs[0]),) + tuple(x.shape[2:])
                 for q, pairs in recv.items()},
                "swap", topo.axes[ax])
            for q, pairs in recv.items():
                out[pairs] = got[q]
        return out


def build_mesh(topo: Topology, device=None) -> Mesh:
    """The mesh of `topo` over the initialised process group (every
    process holding R / W rows; W must divide R), or with no group one
    process holding every row. Replaces `MPI_Comm_size` /
    `MPI_Comm_rank` (the reference's `dmnist/cent/cent.cpp:42-44`).
    `device=None` means CUDA: the process's card (`multihost.
    local_device`); "cpu" runs on the host."""
    w, p = multihost.process_count(), multihost.process_index()
    stacked_rows(topo.n_ranks, w, p)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by "
                "default; pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU")
        device = multihost.local_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = multihost.local_device()
    return Mesh(n_ranks=topo.n_ranks, n_procs=w, proc=p, device=device,
                transport=multihost.transport(device))


def lift(topo: Topology, mesh: Optional[Mesh]) -> Topology:
    """`topo` placed on `mesh` (the topology the collectives route
    through it); `mesh=None` is the stacked simulator's topology."""
    if mesh is not None and mesh.n_ranks != topo.n_ranks:
        raise ValueError(
            f"the mesh holds {mesh.n_ranks} ranks, the topology "
            f"{topo.n_ranks}")
    return dataclasses.replace(topo, mesh=mesh)


#: the backend names `train(backend=...)` takes: the JAX loop's ("vmap",
#: "shard_map", "auto") and the CLI's spellings ("sim", "mesh")
BACKENDS = ("vmap", "sim", "shard_map", "mesh", "auto")


def resolve_backend(backend: Optional[str], topo: Topology,
                    device=None) -> Optional[Mesh]:
    """Resolve a backend request to the mesh `train` lifts over (None =
    the stacked simulator). None, "vmap" and "sim" pin the simulator;
    "shard_map" and "mesh" build the mesh (`build_mesh`: the process
    group's, or one process holding every rank); "auto" takes the mesh
    when a group of more than one process is initialised, else the
    simulator. The JAX function's "auto" takes the mesh whenever enough
    devices are attached; the port's counts processes, since one process
    drives every rank of its stack on its card (a deliberate divergence,
    `tests/test_torch_mesh.py`)."""
    if backend not in (None,) + BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS} or None; got {backend!r}")
    if backend in (None, "vmap", "sim"):
        return None
    if backend == "auto" and not multihost.is_multiprocess():
        return None
    return build_mesh(topo, device)


def rank_index(topo: Topology, device=None) -> torch.Tensor:
    """Flattened rank id of every row this process holds (replaces
    MPI_Comm_rank): `[n_local]` int64."""
    mesh = topo.mesh
    lo, hi = (0, topo.n_ranks) if mesh is None else (mesh.lo, mesh.hi)
    return torch.arange(lo, hi, device=device)


# --- the lift's collectives --------------------------------------------------


class _Hop(torch.autograd.Function):
    """A shift of the rank dimension across the mesh; its transpose is
    the shift by the inverse offset."""

    @staticmethod
    def forward(x, topo, nb):
        return topo.mesh.shift(x, topo, nb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.topo, ctx.nb = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        inv = NeighborSpec(ctx.nb.axis, -ctx.nb.offset)
        return _Hop.apply(g.contiguous(), ctx.topo, inv), None, None


def hop(x: torch.Tensor, topo: Topology, nb: NeighborSpec) -> torch.Tensor:
    """`collectives.recv_from` on a lifted topology."""
    return _Hop.apply(x, topo, nb)


class _Fold(torch.autograd.Function):
    """The group sum over a grid axis across the mesh; its transpose is
    the same sum of the cotangents (`psum` is self-adjoint)."""

    @staticmethod
    def forward(x, topo, ax):
        return topo.mesh.fold(x.contiguous(), topo, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.topo, ctx.ax = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Fold.apply(g, ctx.topo, ctx.ax), None, None


def fold(x: torch.Tensor, topo: Topology, ax: int) -> torch.Tensor:
    """`collectives.axis_sum` along grid axis `ax` on a lifted
    topology."""
    return _Fold.apply(x, topo, ax)


class _Swap(torch.autograd.Function):
    """The all-to-all of a grid axis across the mesh: an involution, so
    its own transpose."""

    @staticmethod
    def forward(x, topo, ax):
        return topo.mesh.swap(x.contiguous(), topo, ax)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.topo, ctx.ax = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return _Swap.apply(g, ctx.topo, ctx.ax), None, None


def swap(x: torch.Tensor, topo: Topology, ax: int) -> torch.Tensor:
    """`collectives.axis_all_to_all` along grid axis `ax` on a lifted
    topology."""
    return _Swap.apply(x, topo, ax)
