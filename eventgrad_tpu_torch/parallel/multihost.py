"""Multi-process runtime: the ranks of a topology in the processes of a
`torch.distributed` group.

Port of `eventgrad_tpu/parallel/multihost.py`. The reference scales
across nodes with `mpirun` and MPI; the JAX package joins one global
device mesh with `jax.distributed.initialize`. Here every process calls
`init` (a thin wrapper over `torch.distributed.init_process_group`),
after which `parallel.spmd.build_mesh` places the topology's R ranks in
the group's W processes, W dividing R: process p holds the contiguous
rows `[p R / W, (p + 1) R / W)` of every rank-stacked tensor (row-major
over `topo.shape`, as the JAX package's `stacked_spec` shards its
stack), and the same per-rank code runs on those rows.

The transport:
  * "nccl" when the run is on CUDA and every process has a card of its
    own on its host (`plan_backend`, agreed over the store;
    `cuda:{local rank}`);
  * "gloo" on the CPU;
  * "gloo-host" when processes share a card (NCCL refuses two ranks of
    one communicator on one device): the payload is staged through
    pinned host buffers explicitly, so no CUDA tensor meets gloo.
Every payload travels as its raw bytes (`uint8`), so any dtype crosses
any transport bit for bit.

The host helpers cover what differs in a multi-process run: placing a
full host stack (`put_stacked`: this process's rows), reading a
row-sharded stack back (`to_host`: an all-gather of every process's
rows), the primary that owns logging and files (`is_primary`) and the
`barrier`.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import socket
from typing import Any, Callable, List, Optional, Tuple

import torch
import torch.distributed as dist

def plan_backend(device, peers) -> Tuple[str, List[int]]:
    """The group's backend and every process's local rank, from each
    process's `(host name, cards on its host, NCCL built in)` in process
    order: NCCL when the run is on CUDA and every process has NCCL and a
    card of its own on its host (its host's card count at least the
    processes there), gloo otherwise. A process's local rank is its index
    among its host's processes. Every process computes it from the same
    list, so all agree."""
    dev = torch.device("cuda" if device is None else device)
    hosts = [h for h, _, _ in peers]
    per_host = collections.Counter(hosts)
    local = [hosts[:i].count(h) for i, h in enumerate(hosts)]
    nccl = dev.type == "cuda" and all(
        has and cards >= per_host[h] for h, cards, has in peers)
    return ("nccl" if nccl else "gloo"), local


#: this process's index among its host's processes, once `init` has run
_LOCAL_RANK: Optional[int] = None


def init(coordinator: str, num_processes: int, process_id: int,
         device=None) -> None:
    """Join the process group (MPI_Init's role). Call before any device
    computation, with the same coordinator on every process:
    `host:port` (a TCP store the process with id 0 serves) or any
    `init_method` URL (`file:///shared/path`). `device` is the run's
    device ("cuda" or None for the card, "cpu"), which picks the
    transport: the processes first meet on the store and publish their
    host, card count and NCCL build (`plan_backend`), so every host is
    judged by its own cards; an NCCL process binds
    `cuda:{local rank}` (LOCAL_RANK where the launcher sets it)."""
    global _LOCAL_RANK
    num, pid = int(num_processes), int(process_id)
    if not 0 <= pid < num:
        raise ValueError(f"process_id {pid} outside 0..{num - 1}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    store, _, _ = next(dist.rendezvous(url, rank=pid, world_size=num))
    store.set(f"eg/peer/{pid}", json.dumps(
        [socket.gethostname(), torch.cuda.device_count(),
         bool(dist.is_nccl_available())]))
    peers = [json.loads(store.get(f"eg/peer/{q}")) for q in range(num)]
    backend, local = plan_backend(device, peers)
    _LOCAL_RANK = local[pid]
    if backend == "nccl":
        torch.cuda.set_device(local_device(pid))
    dist.init_process_group(backend, store=store, world_size=num, rank=pid)


def init_from_env(device=None) -> bool:
    """Join a multi-process group from the environment (mpirun's
    env-propagation role): EG_COORDINATOR=host:port plus
    EG_NUM_PROCESSES / EG_PROCESS_ID. Returns True when a coordinator
    was configured (and the group joined), False when unset. Missing
    count/id with a set coordinator raise rather than silently running
    single-process."""
    coordinator = os.environ.get("EG_COORDINATOR")
    if not coordinator:
        return False
    try:
        num = int(os.environ["EG_NUM_PROCESSES"])
        pid = int(os.environ["EG_PROCESS_ID"])
    except KeyError as e:
        raise RuntimeError(
            f"EG_COORDINATOR={coordinator!r} is set but {e.args[0]} is "
            "not — a multi-process mesh needs all three of "
            "EG_COORDINATOR / EG_NUM_PROCESSES / EG_PROCESS_ID"
        ) from None
    init(coordinator, num, pid, device=device)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that owns logging and file output."""
    return process_index() == 0


def barrier(name: str) -> None:
    """Block until every process reaches this point (no-op in one
    process). `name` labels the call site, as the JAX function's does."""
    del name
    if is_multiprocess():
        dist.barrier()


def shutdown() -> None:
    """Leave the group (a no-op outside one)."""
    global _LOCAL_RANK
    _LOCAL_RANK = None
    if is_initialized():
        dist.destroy_process_group()


def local_device(process_id: Optional[int] = None) -> torch.device:
    """The card a process of this host uses: `cuda:{local rank}` (the
    launcher's LOCAL_RANK, else its index among its host's processes
    once `init` has run, else the process id) modulo the cards present
    (processes beyond the card count share them)."""
    pid = process_index() if process_id is None else int(process_id)
    local = int(os.environ.get(
        "LOCAL_RANK", pid if _LOCAL_RANK is None else _LOCAL_RANK))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def transport(device) -> str:
    """The transport a tensor on `device` takes in this process's group:
    "local" outside one, else "nccl", "gloo", or "gloo-host" for a CUDA
    tensor in a gloo group."""
    if not is_initialized():
        return "local"
    if dist.get_backend() == "nccl":
        return "nccl"
    return "gloo-host" if torch.device(device).type == "cuda" else "gloo"


# --- the byte transport -----------------------------------------------------


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """The raw bytes of `t` (contiguous, row-major) as a 1-D uint8
    tensor."""
    flat = t.contiguous().reshape(-1)
    if flat.numel() and flat.stride(0) != 1:
        # a broadcast single element: its own storage first
        flat = flat.clone(memory_format=torch.contiguous_format)
    return flat.view(torch.uint8)


def from_bytes(b: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return b.view(dtype).reshape(tuple(shape))


def stage_out(b: torch.Tensor, how: str) -> torch.Tensor:
    """A send buffer for transport `how`: a CUDA payload bound for gloo
    is copied into a pinned host buffer."""
    if how == "gloo-host" and b.is_cuda:
        host = torch.empty(b.shape, dtype=b.dtype, pin_memory=True)
        host.copy_(b)
        return host
    return b


def recv_buffer(n: int, device, how: str) -> torch.Tensor:
    """An `n`-byte receive buffer for transport `how` (pinned host
    memory for a CUDA run on gloo)."""
    dev = torch.device(device)
    if how == "gloo-host" and dev.type == "cuda":
        return torch.empty((n,), dtype=torch.uint8, pin_memory=True)
    return torch.empty((n,), dtype=torch.uint8, device=dev)


def all_gather_rows(x: torch.Tensor, group=None,
                    how: Optional[str] = None) -> torch.Tensor:
    """Every process's rows of `x` (equal row counts), concatenated along
    dim 0 in process order: the full `[R, ...]` stack (`x` itself outside
    a group; a group of one still runs the collective)."""
    if not is_initialized():
        return x
    w = dist.get_world_size(group)
    how = how or transport(x.device)
    b = stage_out(as_bytes(x), how)
    # one buffer (pinned for a staged gather), each process's bytes
    # received into its own slice of it
    full = recv_buffer(w * b.numel(), x.device, how)
    dist.all_gather(list(full.chunk(w)), b, group=group)
    return from_bytes(full.to(x.device), x.dtype,
                      (w * x.shape[0],) + tuple(x.shape[1:]))


def all_gather_object(obj: Any) -> list:
    """Every process's picklable `obj`, in process order (`[obj]` outside
    a group)."""
    if not is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def exchange(x: torch.Tensor, sends, recvs, group=None,
             how: Optional[str] = None) -> dict:
    """One batch of point-to-point transfers (`batch_isend_irecv`):
    `sends` maps a peer process to the tensor it receives from this one,
    `recvs` a peer to the `(rows, ...)` shape this one receives from it
    (rows of `x`'s dtype). Returns {peer: the received tensor} on `x`'s
    device."""
    how = how or transport(x.device)
    ops, bufs = [], {}
    for q in sorted(sends):
        ops.append(dist.P2POp(dist.isend, stage_out(as_bytes(sends[q]), how),
                              q, group))
    for q in sorted(recvs):
        bufs[q] = recv_buffer(math.prod(recvs[q]) * x.element_size(),
                              x.device, how)
        ops.append(dist.P2POp(dist.irecv, bufs[q], q, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return {q: from_bytes(b.to(x.device), x.dtype, recvs[q])
            for q, b in bufs.items()}


# --- host helpers on whole states -------------------------------------------


def map_stacked(fn: Callable, x: Any) -> Any:
    """`fn` applied to every rank-stacked tensor of `x` (a tensor, or a
    nesting of dataclasses, tuples, lists and dicts of them: a
    TrainState). Every tensor with a leading dimension is rank-stacked;
    generators, ints and None pass through."""
    if isinstance(x, torch.Tensor):
        return fn(x) if x.dim() else x
    if isinstance(x, (tuple, list)):
        return type(x)(map_stacked(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: map_stacked(fn, v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: map_stacked(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def put_stacked(x: Any, mesh) -> Any:
    """This process's rows of a full host stack (every rank-stacked
    tensor of `x`, `[R, ...]`), as `mesh` places them. Every process
    calls it with the same values (deterministic seeding makes them so)."""
    if mesh is None:
        return x
    return map_stacked(lambda t: t[mesh.lo:mesh.hi].contiguous(), x)


def to_host(x: Any, mesh=None) -> Any:
    """The full `[R, ...]` stack of every rank-stacked tensor of `x`: an
    all-gather of every process's rows (in one process, `x` itself)."""
    if mesh is not None:
        return map_stacked(mesh.gather, x)
    if not is_multiprocess():
        return x
    return map_stacked(all_gather_rows, x)
