"""Top-k sparsified EventGraD payloads (the reference's `spevent`).

Port of `eventgrad_tpu/parallel/sparsify.py` (`SparseConfig`,
`SparseState`, `sparse_exchange`; the bucketed schedule and the
bounded-async payload queues of staleness >= 2 wait, ROADMAP queue 1,
item 5):

  * a fixed k per parameter tensor, k_i = ceil(topk_percent / 100 *
    numel_i), clamped to [1, numel_i];
  * selection by |p - prev_sent|, the values sent are the CURRENT
    parameter at those indices (`policy.topk_payload`);
  * the sender shadow `prev_sent` updates only at sent indices of fired
    leaves;
  * every receiver keeps a full replica per neighbor and scatters the
    (value, index) payload into it where the sender fired
    (`policy.scatter_into`); unsent coordinates keep their last-known
    values. Every shadow starts as a copy of the initial parameters.

The state lives as `[R, n]` flat arenas over the model's `ArenaSpec`
segments, like the rest of the port's gossip state: the step's tail
kernel (`ops/fused_update.fused_mix_sgd`) reads the summed replicas as
one arena, and the payload scatter is one indexed write per neighbor.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel.arena import ArenaSpec
from eventgrad_tpu_torch.parallel.policy import (
    scatter_into, topk_layout, topk_payload,
)
from eventgrad_tpu_torch.parallel.topology import Topology


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """topk_percent is the reference's argv[4]."""

    topk_percent: float = 10.0

    def k_for(self, numel: int) -> int:
        k = int(math.ceil(self.topk_percent / 100.0 * numel))
        return max(1, min(k, numel))

    def ks(self, spec: ArenaSpec) -> Tuple[int, ...]:
        """k of every leaf of `spec`, in leaf order."""
        return tuple(self.k_for(z) for z in spec.sizes)


@dataclasses.dataclass
class SparseState:
    """prev_sent: the sender shadow of last-transmitted values, `[R, n]`.
    replicas: one persistent full-model replica `[R, n]` per topology
    neighbor."""

    prev_sent: torch.Tensor
    replicas: Tuple[torch.Tensor, ...]

    def replace(self, **kw) -> "SparseState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(cls, flat: torch.Tensor, topo: Topology) -> "SparseState":
        """Every shadow a copy of the initial `[R, n]` parameter arena."""
        return cls(prev_sent=flat.clone(),
                   replicas=tuple(flat.clone() for _ in topo.neighbors))


def _refuse_unported(buckets, staleness: int) -> None:
    if buckets is not None or staleness >= 2:
        raise NotImplementedError(
            "sp_eventgrad's bucketed schedule and staleness >= 2 payload "
            "queues are not ported yet (ROADMAP queue 1, item 5); use "
            "buckets=None and staleness 0 or 1"
        )


def sparse_exchange(
    flat: torch.Tensor,
    fire_vec: torch.Tensor,
    sp: SparseState,
    topo: Topology,
    cfg: SparseConfig,
    spec: ArenaSpec,
    wire=None,
    buckets=None,
    staleness: int = 0,
) -> SparseState:
    """One step of sparsified gossip on the `[R, n]` parameter arena
    with the `[R, L]` fire bits: build the top-k payloads, ship them to
    every neighbor (receivers apply a leaf only where its sender fired),
    update the sender shadow and the neighbor replicas. Returns the new
    SparseState; the caller mixes `flat` with the replicas. `wire`
    ("bf16" / "int8") compresses the top-k values for the transfer with
    per-leaf int8 scales over the payload; indices stay int32, and the
    sender shadow keeps full precision."""
    collectives.check_wire(wire)
    _refuse_unported(buckets, staleness)
    ks = cfg.ks(spec)
    vals, idxs = topk_payload(flat, sp.prev_sent, ks, spec)
    new_prev = scatter_into(sp.prev_sent, vals, idxs, fire_vec, ks, spec)
    lay = topk_layout(spec, ks)
    scale_vec = None
    if wire == "int8":
        kseg = lay.seg_expand(flat.device)
        scale_vec = collectives._int8_scales(collectives._leaf_absmax(vals, lay))
        q = collectives._int8_encode_flat(vals, scale_vec, kseg)
    else:
        q = collectives._wire_out(vals, wire)
    new_replicas = []
    for nb, replica in zip(topo.neighbors, sp.replicas):
        got = collectives.recv_from(q, topo, nb).to(vals.dtype)
        if scale_vec is not None:
            got = got * collectives.recv_from(scale_vec, topo, nb)[:, kseg]
        new_replicas.append(scatter_into(
            replica, got, collectives.recv_from(idxs, topo, nb),
            collectives.recv_from(fire_vec, topo, nb), ks, spec,
        ))
    return sp.replace(prev_sent=new_prev, replicas=tuple(new_replicas))
