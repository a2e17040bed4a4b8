"""Top-k sparsified EventGraD payloads (the reference's `spevent`).

Port of `eventgrad_tpu/parallel/sparsify.py` (`SparseConfig`,
`SparseState` with the bounded-async payload queues of staleness >= 2,
`sparse_exchange` with the bucketed schedule's per-bucket emission):

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
from typing import Any, Optional, Tuple

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
    neighbor.
    pending: the bounded-async payload queues (staleness >= 2; None
    otherwise): per neighbor, `staleness` slots of received `(vals [R,
    K] f32, idxs [R, K] int32, fire [R, L] bool)` payloads. Slot 0
    commits into the replica at the start of the next exchange
    (commit-on-arrival). sp_eventgrad never composes with a lag schedule,
    so every payload enters slot 0 and the deeper slots stay empty."""

    prev_sent: torch.Tensor
    replicas: Tuple[torch.Tensor, ...]
    pending: Optional[Tuple[Any, ...]] = None

    def replace(self, **kw) -> "SparseState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(cls, flat: torch.Tensor, topo: Topology,
             cfg: Optional[SparseConfig] = None,
             spec: Optional[ArenaSpec] = None,
             staleness: int = 0) -> "SparseState":
        """Every shadow a copy of the initial `[R, n]` parameter arena;
        with `staleness >= 2` also the empty payload queues, whose lane
        count needs `cfg` and `spec`."""
        pending = None
        if int(staleness) >= 2:
            if cfg is None or spec is None:
                raise ValueError(
                    "SparseState.init: staleness >= 2 needs cfg= and spec= "
                    "(the queued payloads' lanes depend on topk_percent)"
                )
            r, k = flat.shape[0], sum(cfg.ks(spec))
            dev = flat.device

            def slot():
                return (torch.zeros((r, k), dtype=flat.dtype, device=dev),
                        torch.zeros((r, k), dtype=torch.int32, device=dev),
                        torch.zeros((r, spec.n_leaves), dtype=torch.bool,
                                    device=dev))

            pending = tuple(tuple(slot() for _ in range(int(staleness)))
                            for _ in topo.neighbors)
        return cls(prev_sent=flat.clone(),
                   replicas=tuple(flat.clone() for _ in topo.neighbors),
                   pending=pending)


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
    sender shadow keeps full precision.

    `buckets` (a tuple of `arena.BucketSpec`, the bucketed schedule)
    ships and scatters the lanes bucket by bucket — bucket b's values,
    indices, fire bits (and int8 scales) — with the state layout
    unchanged; every op is per leaf, so the result is bitwise the
    monolithic call. `staleness >= 2` runs the payload queue: the
    payload that arrived last pass (slot 0) scatters into the replicas,
    and this pass's received payload takes its place; the caller then
    mixes the post-exchange replicas, which hold payloads of passes up
    to p - 1 — bitwise the staleness-1 stale-replica mix."""
    collectives.check_wire(wire)
    ks = cfg.ks(spec)
    vals, idxs = topk_payload(flat, sp.prev_sent, ks, spec)
    new_prev = scatter_into(sp.prev_sent, vals, idxs, fire_vec, ks, spec)
    lay = topk_layout(spec, ks)
    kseg = lay.seg_expand(flat.device)
    scale_vec = None
    if wire == "int8":
        scale_vec = collectives._int8_scales(collectives._leaf_absmax(vals, lay))
        q = collectives._int8_encode_flat(vals, scale_vec, kseg)
    else:
        q = collectives._wire_out(vals, wire)
    queue = int(staleness) >= 2
    # (lane range, leaf range) of each shipment: the whole payload, or
    # one bucket's lanes and leaves
    kst = lay.starts + (lay.n_total,)
    parts = ([(0, lay.n_total, 0, spec.n_leaves)] if buckets is None else
             [(kst[b.lo], kst[b.hi], b.lo, b.hi) for b in buckets])
    # the whole payload ships as it is; a bucket as its column slices
    sl = ((lambda x, a, b: x) if buckets is None
          else (lambda x, a, b: x[:, a:b]))
    new_replicas, new_pending = [], []
    for ni, (nb, replica) in enumerate(zip(topo.neighbors, sp.replicas)):
        got_v, got_i, got_f = [], [], []
        out = replica
        if queue:
            v0, i0, f0 = sp.pending[ni][0]
        for k0, k1, l0, l1 in parts:
            g = collectives.recv_from(sl(q, k0, k1), topo, nb).to(vals.dtype)
            if scale_vec is not None:
                g = g * collectives.recv_from(sl(scale_vec, l0, l1), topo,
                                              nb)[:, kseg if buckets is None
                              else kseg[k0:k1] - l0]
            gi = collectives.recv_from(sl(idxs, k0, k1), topo, nb)
            gf = collectives.recv_from(sl(fire_vec, l0, l1), topo, nb)
            if queue:
                # commit-on-arrival: last pass's slot 0 lands in the
                # replica; this pass's lanes fill the new slot 0
                got_v.append(g)
                got_i.append(gi)
                got_f.append(gf)
                g, gi, gf = sl(v0, k0, k1), sl(i0, k0, k1), sl(f0, l0, l1)
            out = scatter_into(out, g, gi, gf, ks, spec, lanes=(k0, k1),
                               leaves=(l0, l1))
        new_replicas.append(out)
        if queue:
            cat = lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs, -1)
            new_pending.append(((cat(got_v), cat(got_i), cat(got_f)),)
                               + tuple(sp.pending[ni][1:]))
    return sp.replace(prev_sent=new_prev, replicas=tuple(new_replicas),
                      pending=tuple(new_pending) if queue else sp.pending)
