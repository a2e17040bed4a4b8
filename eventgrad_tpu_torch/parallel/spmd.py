"""The rank-stacked lift: all ranks of a topology on one device.

Port of the vmap path of `eventgrad_tpu/parallel/spmd.py`. The JAX
package writes a per-rank function against named axes and lifts it with
nested `jax.vmap`; here every rank-stacked quantity carries an explicit
leading `[n_ranks]` dimension (row-major over `topo.shape`), the
neighbor exchange is a `torch.roll` of that dimension
(`collectives.recv_from`), and the one per-rank computation that needs a
transform — the model's forward and backward — is batched with
`torch.func.vmap` (`per_rank`). A model that holds a collective (ring
or Ulysses attention, the tensor-, pipeline- and expert-parallel
transformers) runs rank-stacked instead: `per_rank` batches its
per-rank pieces between the collectives, which run on the stack along
one axis of the topology's grid (`collectives.axis_sum`,
`axis_all_to_all`, `recv_from`). `resolve_backend` reads the JAX
package's backend names; the device mesh lift (one rank per device,
NCCL collectives) waits.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from eventgrad_tpu_torch.parallel.topology import Topology


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


#: the backend names `train(backend=...)` takes: the JAX loop's ("vmap",
#: "shard_map", "auto") and the CLI's spellings ("sim", "mesh")
BACKENDS = ("vmap", "sim", "shard_map", "mesh", "auto")


def resolve_backend(backend: Optional[str], topo: Topology) -> None:
    """Resolve a backend request as the JAX package's `resolve_backend`
    does, to the lift `train` runs: None, "vmap" and "sim" pin the
    stacked simulator; "auto" takes a device mesh only where the mesh
    lift exists and there are as many devices as ranks, else the
    simulator; the port has no device-mesh lift yet, so "auto" always
    resolves to the simulator (returns None, the JAX function's answer
    for it). "shard_map" and "mesh" demand the device mesh and raise,
    naming ROADMAP queue 1, item 8."""
    if backend not in (None,) + BACKENDS:
        raise ValueError(
            f"backend must be one of {BACKENDS} or None; got {backend!r}")
    if backend in ("shard_map", "mesh"):
        raise NotImplementedError(
            f"backend={backend!r}: the device-mesh lift (one rank per card, "
            "torch.distributed collectives) is not ported yet (ROADMAP "
            f"queue 1, item 8); {topo.n_ranks} ranks run on the stacked "
            "simulator with backend='vmap' or 'auto'")
    return None
