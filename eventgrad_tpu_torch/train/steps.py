"""Rank-stacked train steps for the four algorithm families on the flat
arena.

Port of `eventgrad_tpu/train/steps.py` (`make_train_step`, `_xent`,
`_fired_accounting`), covering the arena branches with the fused tail:

  algo="allreduce"    — the gradients average over every rank
                        (`collectives.allreduce_mean`), then momentum SGD;
                        the tail rides the fused mix+SGD kernel with a
                        zero buffer sum and mixing weight 1, which is
                        exactly SGD: `(p + 0)·1 − lr·(m·t + g)`.
  algo="dpsgd"        — every rank receives both ring neighbors' whole
                        parameter arenas and runs the fused mix+SGD kernel
                        (`ops/fused_update.fused_mix_sgd`).
  algo="eventgrad"    — the norm-delta trigger decides per leaf which
                        parameters fire; the masked-wire kernel
                        (`ops/event_engine.masked_wire`) zeroes the rest;
                        the fused commit+mix+SGD kernel
                        (`ops/arena_update.fused_mix_commit`) commits the
                        received buffers and updates in one pass.
  algo="sp_eventgrad" — the same trigger; fired leaves ship their top-k
                        (value, index) lanes (`parallel/sparsify.py`)
                        into the neighbors' persistent replicas, and the
                        fused mix+SGD kernel mixes the summed replicas.

`gossip_wire="compact"` (eventgrad) ships only the fired leaves'
elements, through a static buffer of `compact_capacity` elements
(`collectives.compact_neighbor_vals_flat`); the overflow defers
(`events.capacity_gate`), and the commit runs the same tail kernels.
The `micro` and `hybrid` trigger policies feed their partition masks
into the sender pass as forced and suppressed fires.

`wire="bf16"|"int8"` compresses the exchange (the int8 wire through the
int8 masked-wire kernel `ops/event_engine.masked_wire_int8` on the
EventGraD leg; the top-k values with per-leaf scales on the sparse
leg), `carrier_resident=True` keeps the EventGraD receive buffers in the
wire dtype and runs the carrier tail kernel
(`ops/arena_update.fused_mix_commit_carrier`), and `staleness=1` mixes
the previous step's buffers (or replicas) while committing this step's.
`augment=True` pads, flips and crops every rank's images
(`data/augment.py`), and a model with dropout gets its keep bits: both
drawn from the state's generator before the batched forward.

`bucketed=K` (eventgrad, sp_eventgrad) runs the bucketed gossip
schedule: the arena is cut into K leaf-aligned buckets
(`ArenaSpec.buckets`) and each bucket's wire, exchange and commit + mix +
SGD tail run on their own, the kernels through their pitched forms on
the bucket's columns of the `[R, n]` arenas; training is bitwise the
monolithic schedule, except that the compact wire's capacity splits per
bucket (`collectives.split_capacity`) and deferral re-contends within
the bucket. `staleness=D >= 2` runs the bounded-async engine: each edge
carries a D-slot delivery queue (`EventState.pending`,
`SparseState.pending`), a message commits when its scheduled lag (the
`lag=` / `slow=` clauses of `chaos`, clamped to D) elapses, and the mix
reads what has arrived; at the baseline lag it is bitwise staleness 1.
The arrival commit `where(e0[seg], c0, last)` and the mix of the
post-arrival buffers are exactly kernel 1 (or 5) fed slot 0's candidates
and eff bits with `mix_stale=False`, so the port runs D >= 2 on its
fused tail, where the JAX package's step refuses fused + D >= 2; the
queue's shift, merge and enqueue stay plain PyTorch, as they are jnp
there. `chaos` (a `chaos.ChaosSchedule`) sets the lags and the faults
and carries the per-edge health (`TrainState.chaos`): its per-pass
delivery, corruption and nanstep draws come from tables built on the
host once per run and read on the device by pass (`chaos.inject
.FaultTables`). A dropped message clears the edge's effective fire bits
(EventGraD keeps its stale buffer; D-PSGD's mix leaves the edge out),
`chaos_policy` adds the forced sync and the edge freeze, and
`integrity` the wire checksums and the non-finite quarantine. The JAX
step refuses chaos and integrity with its fused tail (its Pallas kernels
bake in one scalar mix weight) and runs them on the optax tail with
`mix_weighted`; the port has only the fused tail, so kernels 1, 4 and 5
take per-row operands instead: the mix weight 1/(1 + n_alive) and the
edge gates (the freeze; D-PSGD's drops), and on kernel 1 the nanstep
poison and the quarantine. D-PSGD's gated `buf_sum` adds `p + (b0 + b1)`
where `mix_weighted` adds `p + b0 + b1`: one rounding apart at most.

A model that holds a collective (`rank_stacked`: ring or Ulysses
attention, the tensor-, pipeline- and expert-parallel transformers)
runs its `forward_stacked(params, x, topo)` on every rank at once, and
the gradient is that of the sum of the R per-rank losses (plus the MoE
load-balancing losses): through a grid sum each rank's input receives
its group's summed cotangents, the JAX step's transpose of `psum`. On a
hybrid mesh the JAX step's corrections follow, for every model: each
aux axis (sp, ddp) averages the gradients and BatchNorm statistics, and
each sharded axis (tp, pp, ep) divides the `tp_` leaves' gradients by
its size and averages every other leaf's. Gossip and allreduce run on
the gossip axes alone.

The gradient is taken at the pre-mix parameters, the reference's exact
D-PSGD ordering. The R ranks' forward and backward run batched:
`torch.func.functional_call` + `torch.func.vmap` +
`torch.func.grad_and_value`, with the BatchNorm statistics threaded as
explicit tensors (an empty dict for a model without BatchNorm; the
transformer's flash attention joins the batched forward and backward
through its own `vmap` rule, `ops/attention.py`). The JAX package's
unfused optax tail is documented bitwise equal to the fused one, so the
port runs the fused tail only.

`obs=True` accumulates the on-device telemetry (`obs/device.py`: per-leaf
fire and deferral counts, threshold and drift sums, the silence
histogram, per-edge and per-bucket wire bytes, the integrity and
bounded-async counters) and the message-lifecycle ledger (`obs/ledger.py`)
into `state.telemetry`, once per pass, from the observables the branch
already computed: plain PyTorch on device tensors, no host sync. With
`obs=False` the step is the step without telemetry, launch for launch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.chaos import inject as chaos_inject
from eventgrad_tpu_torch.chaos import integrity as chaos_integrity
from eventgrad_tpu_torch.chaos import monitor as chaos_monitor
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy, alive_mask
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.chaos.schedule import resolve as resolve_chaos
from eventgrad_tpu_torch.data.augment import draw_pad_flip_crop, pad_flip_crop
from eventgrad_tpu_torch.models.common import draw_dropout
from eventgrad_tpu_torch.obs import costmodel
from eventgrad_tpu_torch.obs import device as obs_device
from eventgrad_tpu_torch.obs import ledger as obs_ledger
from eventgrad_tpu_torch.ops import event_engine
from eventgrad_tpu_torch.ops.arena_update import (
    fused_mix_commit, fused_mix_commit_carrier,
)
from eventgrad_tpu_torch.ops.fused_update import fused_mix_sgd
from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel import policy as policy_lib
from eventgrad_tpu_torch.parallel.arena import arena_spec, is_sharded_leaf
from eventgrad_tpu_torch.parallel.events import (
    EventConfig, _rows, async_bucket_commit, async_delivery_plan,
    capacity_gate,
)
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig, sparse_exchange
from eventgrad_tpu_torch.parallel import spmd
from eventgrad_tpu_torch.parallel.spmd import per_rank
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.train.state import ALGOS, EVENT_ALGOS


@contextlib.contextmanager
def _phase(name: str):
    """A profiler span `step/<name>` over one phase of the step, named as
    the JAX step's phases (grad, gate_pack, exchange, commit_mix; a
    bucket's as `exchange.b<k>`, `commit_mix.b<k>`), plus `enqueue`, the
    bounded-async queue's shift and merge inside `commit_mix`, and
    `telemetry`, the obs step's counters and ledger; next to free when no
    profiler runs. The phase is also the cost model's label
    (`obs.costmodel.phase_scope`) of the ops a trace records in it."""
    with costmodel.phase_scope(name), \
            torch.profiler.record_function("step/" + name):
        yield


def _fired_accounting(
    fire_vec: torch.Tensor, sizes_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fired payload elements, fired leaf count) per rank as f32, summed
    in int32 (exact to 2^31 elements)."""
    zero = torch.zeros((), dtype=torch.int32, device=fire_vec.device)
    fired_elems = torch.sum(
        torch.where(fire_vec, sizes_t, zero), dim=-1, dtype=torch.int32
    ).to(torch.float32)
    fired_leaves = torch.sum(fire_vec, dim=-1, dtype=torch.int32).to(
        torch.float32
    )
    return fired_elems, fired_leaves


def _xent(output: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy over the trailing class axis."""
    logp = torch.log_softmax(output, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.mean(ll)


def _xent_per_rank(output: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """`[R]`: `_xent` of each rank of rank-stacked logits `[R, ..., V]`."""
    logp = torch.log_softmax(output, dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    return -torch.mean(ll.flatten(1), dim=1)


def check_stacked_model(model, topo: Topology) -> None:
    """A rank-stacked model fits the topology: its sharded axis is a
    sharded axis of the topology, of the model's size; a ring or Ulysses
    model built for a topology steps on that one, and its
    sequence-parallel axis is an axis of it."""
    axis = getattr(model, "shard_axis", None)
    if axis is not None:
        if axis not in topo.sharded_axes:
            raise ValueError(
                f"{type(model).__name__} shards its `tp_` leaves over "
                f"{axis!r}, which is not a sharded axis of the topology "
                f"(axes {topo.axes}, sharded {topo.sharded_axes})")
        if topo.axis_size(axis) != model.shard_size:
            raise ValueError(
                f"{type(model).__name__} is built for {axis}="
                f"{model.shard_size}, the topology has {axis}="
                f"{topo.axis_size(axis)}")
        return
    # a model holds the topology it was built for, not its lift
    if getattr(model, "topo", None) not in (None, spmd.lift(topo, None)):
        raise ValueError(
            f"the model was built for {model.topo}, the step runs {topo}")
    sp = getattr(model, "sp_axis", None) or topo.axes[0]
    if sp not in topo.axes:
        raise ValueError(f"axis {sp!r} is not an axis of {topo.axes}")


def make_train_step(
    model,
    topo: Topology,
    algo: str = "dpsgd",
    event_cfg: Optional[EventConfig] = None,
    *,
    fused_sgd: Tuple[float, float],
    trace: bool = False,
    sync_bn: bool = False,
    trigger_policy: Optional[str] = None,
    wire: Optional[str] = None,
    staleness: int = 0,
    carrier_resident: Optional[bool] = None,
    sparse_cfg: Optional[SparseConfig] = None,
    augment: bool = False,
    gossip_wire: str = "dense",
    compact_capacity: Optional[int] = None,
    bucketed: Optional[int] = None,
    chaos: Optional[ChaosSchedule] = None,
    chaos_policy: Optional[RecoveryPolicy] = None,
    integrity=None,
    n_passes: Optional[int] = None,
    obs: bool = False,
    mesh=None,
) -> Callable:
    """Build the rank-stacked step `step(state, (x, y)) -> (state,
    metrics)`: `x` is `[R, B, H, W, C]` images with `y` int64 `[R, B]`,
    or `[R, B, T]` integer tokens with `y` int64 `[R, B, T]`, and every
    metric is a `[R]` tensor. The model is called as `model(x,
    batch_stats, True)` (plus `drop=` keep bits for a model with
    dropout) and returns `(output, new_batch_stats)`; a model without
    BatchNorm carries an empty statistics dict. `fused_sgd=(lr, momentum)` is the plain
    SGD the state was initialized for (momentum 0 carries no trace).
    `trace=True` (eventgrad, sp_eventgrad) adds the per-leaf send-side
    vectors `trace_norm`, `trace_thres`, `trace_fired` ([R, L]) to the
    metrics. `sync_bn=True` replaces each BatchNorm running statistic
    after the update by its mean over every rank
    (`collectives.allreduce_mean`, the JAX step's pmean), on the
    monolithic and the bucketed schedule alike; without BatchNorm it
    changes nothing.

    `wire` (None = f32, "bf16", "int8") is the exchange's wire format;
    the accounting charges 2 or 1 B per payload element and, for int8,
    4 B per fired leaf's scale (allreduce ships full-precision
    gradients whatever the wire). `staleness=1` (event algorithms) mixes
    the buffers or replicas as they stood before this step's exchange.
    `carrier_resident=True` (eventgrad, bf16/int8 wire) keeps the
    receive buffers in the wire dtype; the state must come from
    `init_train_state(..., resident_wire=wire)`. Both residencies give
    the same bits. `sparse_cfg` (sp_eventgrad; default top-k 10%) sets
    the per-leaf k. `augment=True` pads, flips and crops the images.

    `gossip_wire="compact"` needs a policy that declares the compact wire
    (eventgrad's norm_delta, micro, hybrid; sp_eventgrad's topk takes it
    as a no-op alias) and, where the policy needs one, a static
    `compact_capacity` of at least the largest leaf (pick it with
    `collectives.choose_capacity`, or let `train` autotune it).

    `bucketed=K` (eventgrad, sp_eventgrad; None or 1 = off) runs the
    bucketed schedule: eventgrad's state must come from
    `init_train_state(..., bucketed=K)` (the per-bucket buffer layout),
    and the compact capacity must reach the bucketed floor (the sum of
    the buckets' largest leaves). `staleness=D >= 2` (eventgrad,
    sp_eventgrad) runs the bounded-async engine on the queues of
    `init_train_state(..., staleness=D)`; its metrics add
    `edge_staleness` (`[R, n_nb]`) and `late_commits` (`[R]`). `chaos`
    (a `ChaosSchedule` or its spec string; eventgrad, dpsgd; `bitflip=`
    and `nanstep=` eventgrad only) injects its faults, and the state then
    carries `chaos` (`PeerHealth.init`); the metrics add `edge_silence`
    and `chaos_drops` (cumulative: D-PSGD counts every undelivered edge,
    EventGraD the undelivered edges whose sender fired). `n_passes` sizes
    the fault tables (the run's passes; they grow if a pass runs past
    them). `chaos_policy` (a `RecoveryPolicy`, with `chaos`) adds the
    forced sync (eventgrad) and the edge freeze. `integrity` (an
    `IntegrityConfig`, spec or dict) with `checksum` / `quarantine`
    (eventgrad) adds the wire checksums and the non-finite quarantine;
    with any integrity config the metrics add `integrity_wire_reject`
    (`[R, n_nb]`) and `integrity_quarantined` (`[R]`).

    The bucketed schedule runs under the fault clauses (drop, flaky,
    delay, die, nanstep, the freeze) as the JAX step does: every bucket
    ships with the pass's delivered bits, the health updates once from
    every bucket's raw fire bits, and each bucket's tail is the gated
    pitched form of kernel 1 (or 5 on a carrier) with the pass's gates
    (`w_rows` 1/(1 + n_alive), the alive gate, the nanstep poison). It
    refuses the integrity riders and `bitflip=` as the JAX step does.

    `obs=True` accumulates the telemetry and the message ledger into
    `state.telemetry` (from `init_train_state(..., obs=True)`), at the
    point and from the inputs of the JAX step: the proposal's fire bits,
    threshold, drift and silence, the effective fire bits, the fired
    elements, the wire-real bytes split evenly over the edges and per
    bucket, the integrity verdicts and quarantine, the bounded-async
    staleness and late commits, and for the ledger the applied suppress
    mask, the per-edge census of the neighbour's raw fire bits, the
    delivery bits and the lags. D-PSGD books the dense census (every leaf
    proposes and fires), allreduce only the pass. `EG_LEDGER_LEAK` is
    read here, when the step is built (`obs.ledger.leak`).

    `mesh` (a `parallel.spmd.Mesh`, or a `topo` already lifted onto one)
    builds the step on this process's rows of every rank-stacked input:
    the collectives route through the mesh, and the random draws take
    the full `[R, ...]` lead from the state's generator and keep this
    process's rows, so every process's generator stays the simulator's.
    The metrics are this process's rows. Every model and option runs
    on a mesh: a sharded model's grid sums, stage shifts and
    all-to-alls cross processes through the mesh, and the fault tables
    are drawn over every rank and read on this process's rows
    (`chaos.inject.FaultTables.at`)."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
    if mesh is not None:
        topo = spmd.lift(topo, mesh)
    staleness = int(staleness)
    if staleness < 0:
        raise ValueError(
            f"staleness must be >= 0, got {staleness}: 0 = synchronous "
            "mixing, 1 = one-pass-stale (the deterministic RMA model)"
        )
    if staleness and algo not in EVENT_ALGOS:
        raise ValueError(
            f"staleness={staleness} models the one-sided RMA asynchrony "
            "of the event algorithms (eventgrad, sp_eventgrad); "
            "allreduce/dpsgd are synchronous in the reference"
        )
    if staleness and trace:
        raise ValueError(
            "trace records model the synchronous exchange; not available "
            "with staleness > 0"
        )
    if chaos is not None:
        chaos = resolve_chaos(chaos)
        if algo not in ("dpsgd", "eventgrad"):
            raise ValueError(
                "chaos injection targets the gossip exchange algorithms "
                f"(dpsgd, eventgrad); got algo={algo!r}"
            )
    if chaos_policy is not None and chaos is None:
        raise ValueError(
            "chaos_policy requires chaos (pass ChaosSchedule() to run "
            "monitoring/recovery without injected faults)"
        )
    integrity = chaos_integrity.resolve(integrity)
    integ_checksum = integrity is not None and integrity.checksum
    integ_quar = integrity is not None and integrity.quarantine
    if (integ_checksum or integ_quar) and algo != "eventgrad":
        raise ValueError(
            "integrity checksums/quarantine ride the event exchange's "
            f"not-fired semantics (algo='eventgrad'); got algo={algo!r}"
        )
    if chaos is not None and (chaos.has_bitflips or chaos.has_nansteps):
        if algo != "eventgrad":
            raise ValueError(
                "bitflip=/nanstep= faults target the event exchange "
                f"(algo='eventgrad'); got algo={algo!r}"
            )
    n_buckets = int(bucketed) if bucketed else 1
    if n_buckets < 1:
        raise ValueError(f"bucketed must be >= 1 (or None), got {bucketed}")
    if n_buckets > 1 and algo not in EVENT_ALGOS:
        raise ValueError(
            "bucketed=K pipelines the event-exchange hot path "
            f"(eventgrad, sp_eventgrad); got algo={algo!r}"
        )
    chaos_policy = chaos_policy or RecoveryPolicy()
    if n_buckets > 1:
        if integ_checksum or integ_quar:
            raise ValueError(
                "bucketed is not combinable with the in-step integrity "
                "defenses: checksums and rejection verdicts are "
                "whole-wire per-edge contracts, not per-bucket ones"
            )
        if chaos is not None and chaos.has_bitflips:
            raise ValueError(
                "bucketed is not combinable with chaos bitflip= faults: "
                "the corruption transform targets ONE wire buffer per "
                "edge, which the bucketed schedule splits K ways"
            )
    if chaos is not None:
        chaos_policy.validate_against(
            event_cfg.max_silence if event_cfg else 0)
        if chaos_policy.sync_after and algo != "eventgrad":
            raise ValueError(
                "sync_after rides the event fire decision (force_fire); "
                "dpsgd already sends everything every pass — a dropped "
                "message there is final (use freeze_after / ring heal)"
            )
    collectives.check_wire(wire)
    carrier_wire = None
    if carrier_resident:
        if algo != "eventgrad":
            raise ValueError(
                "carrier_resident=True re-dtypes the event exchange's "
                f"receive buffers (algo='eventgrad'); got algo={algo!r}"
            )
        if wire not in ("bf16", "int8"):
            raise ValueError(
                "carrier_resident=True keeps the buffers in the wire "
                f"carrier dtype, but wire={wire!r} has none — use "
                "wire='bf16'/'int8' (f32 wires are already resident)"
            )
        if integ_checksum or integ_quar:
            raise ValueError(
                "carrier_resident=True is not combinable with the "
                "in-step integrity defenses (their verdicts read "
                "dequantized wire values)"
            )
        if chaos is not None and (chaos.has_bitflips or chaos.has_nansteps):
            raise ValueError(
                "carrier_resident=True is not combinable with chaos "
                "bitflip=/nanstep= faults (the corruption transform "
                "targets the dequantized wire buffer)"
            )
        carrier_wire = wire
    if gossip_wire not in ("dense", "compact"):
        raise ValueError(
            f"gossip_wire must be 'dense' or 'compact', got {gossip_wire!r}"
        )
    lr, mom = float(fused_sgd[0]), float(fused_sgd[1])
    # the seeded ledger leak of the oracle runs, read at build time
    leak_mode = obs_ledger.leak() if obs else ""
    event_cfg = event_cfg or EventConfig()
    sparse_cfg = sparse_cfg or SparseConfig()
    pol = None
    if algo in EVENT_ALGOS or trigger_policy is not None:
        pol = policy_lib.resolve(trigger_policy, algo)
    if gossip_wire == "compact":
        policy_lib.check_compact(pol, algo)
        if pol.compact_needs_capacity:
            if compact_capacity is None or int(compact_capacity) < 1:
                raise ValueError(
                    "gossip_wire='compact' needs a static compact_capacity "
                    "(elements); pick one with collectives.choose_capacity "
                    "or let train(gossip_wire='compact') autotune it"
                )
            compact_capacity = int(compact_capacity)
        else:
            # the top-k lanes are already statically sized: compact is a
            # no-op alias of the native wire
            compact_capacity = None
    else:
        compact_capacity = None
    spec = arena_spec(model)
    n_nb = topo.n_neighbors
    n_params, n_leaves = spec.n_total, spec.n_leaves
    f32 = lambda v, dev: torch.tensor(v, dtype=torch.float32, device=dev)
    # wire accounting (the reference's MPI wire): bytes per payload
    # element, plus one f32 scale per leaf on the int8 wire — per FIRED
    # leaf on the event paths, where a non-fired leaf sends nothing
    val_bytes = collectives.WIRE_VAL_BYTES[wire]
    scale_bytes_per_leaf = 4.0 if wire == "int8" else 0.0
    total_bytes = val_bytes * n_params + scale_bytes_per_leaf * n_leaves
    ks = sparse_cfg.ks(spec)
    buckets = spec.buckets(n_buckets) if n_buckets > 1 else None
    caps = None
    if buckets is not None and compact_capacity is not None:
        # per-bucket static budgets summing to the capacity; raises
        # below the bucketed floor
        caps = collectives.split_capacity(compact_capacity, buckets)
    # the bucketed wire's per-bucket bytes (the metric's split)
    per_bucket = None
    if buckets is not None and algo == "eventgrad":
        per_bucket = collectives.bucketed_wire_real_bytes_per_neighbor(
            buckets, wire, caps)
    elif buckets is not None:
        per_bucket = tuple(
            (val_bytes + 4.0) * sum(ks[b.lo:b.hi]) + 1.0 * b.n_leaves
            + scale_bytes_per_leaf * b.n_leaves for b in buckets)
    # {device: the per-bucket metric row}, made on the step's first call
    per_bucket_metric = {}
    # {(device, ranks): D-PSGD's dense census (all-fire bits, L messages
    # an edge)}
    dense_census = {}

    stacked = bool(getattr(model, "rank_stacked", False))
    if stacked:
        check_stacked_model(model, topo)

        def total_loss(params, x, y):
            # the sum of the R per-rank objectives: under it the
            # cotangent reaching a rank's input of a grid sum is the sum
            # of its group's cotangents, the transpose of the JAX psum
            out, auxes = model.forward_stacked(params, x, topo)
            loss = _xent_per_rank(out, y)
            for aux in auxes:
                loss = loss + aux
            return loss.sum(), (loss, out)

        grad_total = torch.func.grad(total_loss, has_aux=True)

        def grad_fn(params, stats, x, y, drop):
            grads, (loss, out) = grad_total(params, x, y)
            return grads, (loss, (out, stats))
    else:
        def loss_fn(params, stats, x, y, drop):
            kw = {"drop": drop} if drop else {}
            out, new_stats = torch.func.functional_call(
                model, params, (x, stats, True), kw)
            return _xent(out, y), (out, new_stats)

        grad_fn = per_rank(torch.func.grad_and_value(loss_fn, has_aux=True))
    # the hybrid mesh's gradient corrections (the JAX step's): aux axes
    # average; on a sharded axis the `tp_` leaves divide by the axis
    # size and every other leaf averages
    hybrid_grads = bool(topo.aux_axes or topo.sharded_axes)
    sharded_cols = {}

    def _sharded_cols(dev):
        """`[n]` bool: the arena positions of the sharded leaves."""
        if dev not in sharded_cols:
            sharded_cols[dev] = torch.tensor(
                [is_sharded_leaf(nm) for nm in spec.names], device=dev)[
                    spec.seg_expand(dev)]
        return sharded_cols[dev]

    def _hybrid_fix(g_flat, new_stats, dev):
        for ax in topo.aux_axes:
            g_flat = collectives.axis_mean(g_flat, topo, ax)
            new_stats = {k: collectives.axis_mean(v, topo, ax)
                         for k, v in new_stats.items()}
        for ax in topo.sharded_axes:
            # one arena-sized temporary: the mean, then the sharded
            # columns' quotient written over it
            mean = collectives.axis_mean(g_flat, topo, ax)
            g_flat = torch.where(_sharded_cols(dev),
                                 g_flat.div_(topo.axis_size(ax)), mean,
                                 out=mean)
        return g_flat, new_stats
    sites = getattr(model, "dropout_sites", lambda b: {})
    draws = augment or bool(sites(1))

    carrier = carrier_wire is not None
    # the bucketed schedule under chaos (the JAX step's chaos branch):
    # every bucket ships first, the health updates once from every
    # bucket's raw bits, and each bucket's tail takes the pass's gates
    bucket_chaos = buckets is not None and chaos is not None
    # the in-step integrity riders and the in-transit corruption: the
    # exchange then returns its per-edge verdicts
    bitflips = chaos is not None and chaos.has_bitflips
    integ_wire = bool(integ_checksum or integ_quar or bitflips)
    # {device: chaos.inject.FaultTables}, made on the step's first call
    fault_tables = {}

    def _bucket_gate(prop, fire_vec, force):
        """The per-bucket fire bits: each bucket's columns of the
        sender's bits, gated within the bucket's share of the compact
        capacity (max_silence-overdue and forced leaves first)."""
        if caps is None:
            return [fire_vec[:, b.lo:b.hi] for b in buckets]
        pri = None
        if event_cfg.max_silence > 0:
            pri = prop.iter_diff >= float(event_cfg.max_silence)
        if force is not None:
            ff = torch.broadcast_to(force, fire_vec.shape)
            pri = ff if pri is None else (pri | ff)
        dev = fire_vec.device
        return [
            capacity_gate(fire_vec[:, b.lo:b.hi], b.sizes_tensor(dev),
                          caps[i],
                          priority=None if pri is None else pri[:, b.lo:b.hi])
            for i, b in enumerate(buckets)
        ]

    def _ship(flat, fire_vec, fire_bs, packed, leaf_id, scale_vec, bi,
              faults=None):
        """One exchange: the whole arena (`bi` None), with the pass's
        delivered bits and integrity riders (`faults`), or bucket `bi`
        with the delivered bits alone."""
        if bi is None:
            kw = dict(faults or {}, carrier=carrier)
            if compact_capacity is not None:
                return collectives.compact_neighbor_vals_flat(
                    flat, fire_vec, packed, leaf_id, topo, compact_capacity,
                    spec, wire, **kw)
            return collectives.masked_neighbor_vals_flat(
                flat, fire_vec, topo, spec, wire,
                wire_builder=event_engine.masked_wire, **kw)
        b = buckets[bi]
        sv = None if scale_vec is None else scale_vec[:, b.lo:b.hi]
        deliver = (faults or {}).get("deliver")
        if caps is not None:
            pk, lid = collectives._compact_pack(
                flat[:, b.start:b.start + b.size], fire_bs[bi],
                collectives.bucket_spec_of(b), caps[bi])
            return collectives.compact_neighbor_vals_bucket(
                pk, lid, fire_bs[bi], topo, b, caps[bi], flat.dtype, wire,
                scale_vec=sv, carrier=carrier, deliver=deliver)
        return collectives.masked_neighbor_vals_bucket(
            flat, fire_bs[bi], topo, b, wire, scale_vec=sv,
            wire_builder=event_engine.masked_wire, carrier=carrier,
            deliver=deliver)

    def _tail(flat, g_flat, t_flat, event_state, res, q_plan, out, bi,
              gates=None):
        """One commit + mix + SGD tail through kernel 1 (or 5 on a
        carrier): the whole arena (`bi` None) or bucket `bi`, whose
        pitched form writes p', t' into the bucket's columns of `out`.
        Under staleness >= 2 the queue's arrival (slot 0) is what
        commits, and the mix reads the post-arrival buffers. `gates`
        holds the gated form's per-row operands (on a bucket, the whole
        pass's).
        Returns (p', t', committed buffers, their scales, the queue's new
        slots)."""
        dev = flat.device
        cands, effs = res[:2]
        cand_scales = res[3] if carrier else None
        seg = (spec.seg_expand(dev) if bi is None
               else buckets[bi].seg_expand(dev))
        pick = (lambda x: x) if bi is None else (lambda x: x[bi])
        lasts = tuple(pick(b) for b in event_state.bufs)
        last_scales = (None if event_state.buf_scales is None
                       else tuple(pick(sc) for sc in event_state.buf_scales))
        new_scales, mix_scales, pend = last_scales, None, None
        if q_plan is not None:
            pend, arrivals, arrived_scales = [], [], []
            with _phase("enqueue"):
                for i in range(n_nb):
                    arr, ncs, nes, nss, bsc = async_bucket_commit(
                        event_state.pending[i], q_plan[0][i], cands[i],
                        effs[i], seg, bucket=bi,
                        cand_scale=None if cand_scales is None
                        else cand_scales[i],
                        last_scale=None if last_scales is None
                        else last_scales[i],
                    )
                    arrivals.append(arr)
                    arrived_scales.append(bsc)
                    pend.append((ncs, nes, nss))
            cands = tuple(a[0] for a in arrivals)
            effs = tuple(a[1] for a in arrivals)
            if last_scales is not None:
                new_scales = tuple(arrived_scales)
                mix_scales = tuple(sc[:, seg] for sc in new_scales)
            mix_stale = False
        else:
            if cand_scales is not None:
                # the scales commit outside the kernel (an [R, L] select)
                # and ride in per position for the mix dequant
                new_scales = collectives.commit_carrier_scales(
                    cand_scales, effs, last_scales)
                src = last_scales if staleness else new_scales
                mix_scales = tuple(sc[:, seg] for sc in src)
            mix_stale = bool(staleness)
        keeps = tuple(e.to(torch.float32)[:, seg] for e in effs)
        kw = dict(gates or {})
        if bi is not None:
            kw.update(off=buckets[bi].start, out=out)
        if carrier:
            p_new, t_new, bufs = fused_mix_commit_carrier(
                flat, cands, keeps, lasts, g_flat, t_flat, lr, mom,
                topo.mix_weight, mix_scales=mix_scales, mix_stale=mix_stale,
                **kw)
        else:
            p_new, t_new, bufs = fused_mix_commit(
                flat, cands, keeps, lasts, g_flat, t_flat, lr, mom,
                topo.mix_weight, mix_stale=mix_stale, **kw)
        return p_new, t_new, bufs, new_scales, pend

    def _plan(event_state, delivered, pass_num, dev):
        """(the bounded-async queue's scalar half for this pass, the
        per-edge lags it used)."""
        lag_vec = chaos_inject.lag_vector(chaos, topo, pass_num, staleness,
                                          dev)
        return async_delivery_plan(event_state, delivered, lag_vec,
                                   pass_num, staleness), lag_vec

    def _health(health, raws, deliver, oks):
        """EventGraD's peer health after an exchange: a sender that fired
        any leaf sent a message; it arrived unless the schedule dropped
        it or the integrity verdict rejected it (a rejection keeps the
        edge's silence growing); the drops count sent & ~deliver."""
        sent_any = torch.stack([r.any(dim=-1) for r in raws], dim=-1)
        delivered = sent_any & deliver
        if oks is not None:
            delivered = delivered & oks
        health = chaos_monitor.update(health, delivered, sent_any & ~deliver)
        if chaos_policy.sync_after:
            health = health.replace(sync_req=chaos_monitor.sync_requests(
                health.silence >= chaos_policy.sync_after, topo))
        return health

    def _event_exchange(flat, g_flat, t_flat, fire_vec, fire_bs, packed,
                        leaf_id, event_state, pass_num, faults, health,
                        poison, quar, dev):
        """EventGraD's exchange and tail, monolithic or bucket by bucket
        (bucket k's exchange, then its tail). On the monolithic schedule
        the exchange carries the pass's faults (`faults`: the delivered
        bits and integrity riders), its verdicts and the updated health
        gate the tail (the freeze, the poison, the quarantine) and, at
        D >= 2, fold into the queue's delivered bits. Under chaos the
        bucketed schedule ships every bucket with the delivered bits
        first, updates the health once from every bucket's raw bits
        (concatenated per edge), and then runs each bucket's tail with
        the gates computed once. Returns (p', t',
        the event state with its buffers, scales and queues committed,
        the raw `[R, L]` fire bits received per neighbor, the edge
        staleness gauge, this pass's late commits and the lags (each None
        below D = 2), the health, the verdicts `[R, n_nb]` or None)."""
        deliver = faults.get("deliver") if faults else None
        q_plan = oks = lag_vec = None
        if staleness >= 2 and buckets is not None:
            q_plan, lag_vec = _plan(event_state, deliver, pass_num, dev)
        scale_vec = out = None
        parts = [None]
        if buckets is not None:
            parts = list(range(len(buckets)))
            out = (torch.empty_like(flat), torch.empty_like(flat))
            if wire == "int8":
                # per-leaf scales do not depend on the bucket: one pass
                # over the arena, sliced per bucket
                scale_vec = collectives._masked_scales(
                    collectives._leaf_absmax(flat, spec), fire_vec)
        done = []
        if bucket_chaos:
            shipped = []
            for bi in parts:
                with _phase(f"exchange.b{bi}"):
                    shipped.append(_ship(flat, fire_vec, fire_bs, packed,
                                         leaf_id, scale_vec, bi, faults))
            health = _health(health, tuple(
                torch.cat([res[2][i] for res in shipped], dim=-1)
                for i in range(n_nb)), deliver, None)
            gates = _gates(health, poison, quar)
            for bi, res in zip(parts, shipped):
                with _phase(f"commit_mix.b{bi}"):
                    p_new, t_new, bufs, scales, pend = _tail(
                        flat, g_flat, t_flat, event_state, res, q_plan, out,
                        bi, gates)
                done.append((res[2], bufs, scales, pend))
        # without chaos: bucket k's exchange, then its tail
        for bi in (() if bucket_chaos else parts):
            sfx = "" if bi is None else f".b{bi}"
            gates = None
            with _phase("exchange" + sfx):
                res = _ship(flat, fire_vec, fire_bs, packed, leaf_id,
                            scale_vec, bi, faults if bi is None else None)
            if bi is None:
                if integ_wire:
                    res, oks = res[:3], res[3]
                if health is not None:
                    health = _health(health, res[2], deliver, oks)
                if staleness >= 2:
                    delivered = deliver
                    if oks is not None:
                        delivered = oks if delivered is None else (
                            delivered & oks)
                    q_plan, lag_vec = _plan(event_state, delivered,
                                            pass_num, dev)
                gates = _gates(health, poison, quar)
            with _phase("commit_mix" + sfx):
                p_new, t_new, bufs, scales, pend = _tail(
                    flat, g_flat, t_flat, event_state, res, q_plan, out, bi,
                    gates)
            done.append((res[2], bufs, scales, pend))
        join = ((lambda xs: xs[0]) if buckets is None
                else (lambda xs: tuple(xs)))
        raws = tuple(
            done[0][0][i] if buckets is None
            else torch.cat([d[0][i] for d in done], dim=-1)
            for i in range(n_nb))
        new_bufs = tuple(join([d[1][i] for d in done]) for i in range(n_nb))
        new_scales = event_state.buf_scales
        if done[0][2] is not None:
            new_scales = tuple(join([d[2][i] for d in done])
                               for i in range(n_nb))
        event_state = event_state.replace(bufs=new_bufs,
                                          buf_scales=new_scales)
        edge_stale = late = None
        if q_plan is not None:
            _, sent_all, late_all, clock, late = q_plan
            slots = []
            for i in range(n_nb):
                per_edge = []
                for rr in range(staleness):
                    slot = (join([d[3][i][0][rr] for d in done]),
                            join([d[3][i][1][rr] for d in done]),
                            sent_all[i][rr], late_all[i][rr])
                    if done[0][3][i][2] is not None:
                        slot = slot + (join([d[3][i][2][rr] for d in done]),)
                    per_edge.append(slot)
                slots.append(tuple(per_edge))
            event_state = event_state.replace(
                pending=tuple(slots), edge_clock=clock,
                late_commits=event_state.late_commits + late)
            edge_stale = torch.full((), int(pass_num), dtype=torch.int32,
                                    device=dev) - clock
        return (p_new, t_new, event_state, raws, (edge_stale, late, lag_vec),
                health, oks)

    def _gates(health, poison, quar):
        """The gated tail's per-row operands (EventGraD): the frozen
        edges leave the mix (its weight renormalizes), a poisoned rank's
        update and trace take the NaN factor, a quarantined rank keeps
        the mixed parameters and its trace. Empty when nothing gates."""
        g = {}
        gate = (alive_mask(health.silence, chaos_policy)
                if health is not None else None)
        if gate is not None:
            g.update(w_rows=collectives.mix_weights(gate), gate=gate)
        if poison is not None:
            g["poison"] = poison
        if quar is not None:
            g["quar"] = quar
        return g

    def _bucket_row(dev):
        """The per-bucket wire-real bytes `[K]`: a constant of the step,
        made once per device (a host copy waits for the stream)."""
        if dev not in per_bucket_metric:
            per_bucket_metric[dev] = f32(n_nb, dev) * torch.tensor(
                per_bucket, dtype=torch.float32, device=dev)
        return per_bucket_metric[dev]

    def _accumulate(tel, o, r, dev):
        """One pass of telemetry from the branch's observables `o` (the
        JAX step's `obs=True` block): event algorithms book the proposal
        and the ledger's sender and receiver sides, D-PSGD the dense
        census, allreduce the pass alone."""
        per_edge = per_bucket_tel = None
        if algo != "allreduce" and n_nb:
            # the exchange ships the same payload to every neighbour: the
            # wire-real bytes split evenly over the edges (times the f32
            # reciprocal, as XLA rewrites the JAX package's division)
            per_edge = (o["wire_real"] * float(
                np.float32(1.0) / np.float32(n_nb))).expand(r, n_nb)
            per_bucket_tel = (_bucket_row(dev) if per_bucket is not None
                              else o["wire_real"].reshape(1))
        if algo in EVENT_ALGOS:
            prop, fire_vec = o["prop"], o["fire_vec"]
            ledger_inputs = None
            if o["n_msgs"] is not None:
                ledger_inputs = dict(
                    prop_fire=prop.fire_vec, suppress=o["suppress"],
                    fire_vec=fire_vec, n_msgs=o["n_msgs"],
                    deliver=o["deliver"], oks=o["oks"],
                    lag_vec=o["lag_vec"], leak_mode=leak_mode)
            oks = o["oks"]
            return obs_device.accumulate(
                tel, fire_vec=fire_vec, defer_vec=prop.fire_vec & ~fire_vec,
                thres=prop.thres, drift=prop.value_diff,
                silence=prop.iter_diff, fired_elems=o["fired_elems"],
                edge_bytes=per_edge, bucket_bytes=per_bucket_tel,
                wire_reject=None if oks is None else ~oks,
                quarantined=o["quar_eff"], edge_staleness=o["edge_stale"],
                late_commits=o["late_now"], ledger_inputs=ledger_inputs)
        ledger_inputs = None
        if algo == "dpsgd" and n_nb:
            # dense gossip: every leaf proposes and fires every pass, and
            # a chaos drop is the only non-delivery
            if (dev, r) not in dense_census:
                dense_census[dev, r] = (
                    torch.ones((r, n_leaves), dtype=torch.bool, device=dev),
                    torch.full((r, n_nb), n_leaves, dtype=torch.int32,
                               device=dev))
            ones_l, full = dense_census[dev, r]
            ledger_inputs = dict(prop_fire=ones_l, fire_vec=ones_l,
                                 n_msgs=full, deliver=o["deliver"],
                                 leak_mode=leak_mode)
        return obs_device.accumulate(
            tel, edge_bytes=per_edge, bucket_bytes=per_bucket_tel,
            ledger_inputs=ledger_inputs)

    def step(state, batch):
        x, y = batch
        pass_num = state.pass_num + 1
        flat = state.params
        dev = flat.device
        r = flat.shape[0]
        seg, sizes_t = spec.seg_expand(dev), spec.sizes_tensor(dev)
        if draws and state.rng is None:
            raise ValueError(
                "augmentation and dropout draw from the state's generator "
                "(TrainState.rng, set by init_train_state); this state has "
                "none"
            )
        # every process draws the full [R, ...] lead and keeps its rows
        n_all = topo.n_ranks
        if augment:
            x = pad_flip_crop(x, *map(topo.local_rows, draw_pad_flip_crop(
                (n_all,) + tuple(x.shape[1:2]), state.rng, dev)))
        drop = {k: topo.local_rows(v) for k, v in draw_dropout(
            sites(x.shape[1]), (n_all,), state.rng, dev).items()}

        with _phase("grad"):
            grads, (loss, (out, new_stats)) = grad_fn(
                spec.unravel(flat), state.batch_stats, x, y, drop
            )
            g_flat = spec.ravel(grads)
            del grads
            if hybrid_grads:
                g_flat, new_stats = _hybrid_fix(g_flat, new_stats, dev)
        t_flat = state.trace if mom else torch.zeros_like(flat)

        event_state, sparse_state = state.event, state.sparse
        health = state.chaos
        metrics = {}
        fired_leaves = None
        # bounded-async: the per-edge staleness gauge, this pass's late
        # commits and the lags (staleness >= 2 only)
        edge_stale = late_now = lag_vec = None
        # the ledger's receiver census: per edge, the neighbour's raw fire
        # bits on the wire (telemetry only)
        n_msgs = None
        deliver = corrupt_bits = salts = poison = None
        if chaos is not None:
            if health is None:
                raise ValueError(
                    "a chaos step carries the per-edge peer health "
                    "(TrainState.chaos = chaos.PeerHealth.init(topo)); "
                    "this state has none"
                )
            if dev not in fault_tables:
                fault_tables[dev] = chaos_inject.FaultTables(
                    chaos, topo, n_passes or pass_num, dev)
            deliver, corrupt_bits, salts, poison = fault_tables[dev].at(
                pass_num)
        # the nanstep poison: NaN or 1 per rank on the update and the new
        # trace (optax's poisoned tail); the non-finite quarantine reads
        # the pristine gradients, or'd with the poison
        bad = quar = None
        if poison is not None:
            bad = torch.where(poison, torch.full((), float("nan"),
                                                 device=dev),
                              torch.ones((), device=dev))
        if integ_quar:
            quar = ~torch.isfinite(g_flat).all(dim=-1)
            if poison is not None:
                quar = quar | poison
        faults = None
        if algo == "eventgrad" and (deliver is not None or integ_wire):
            faults = dict(deliver=deliver, checksum=integ_checksum,
                          finite=integ_quar)
            if bitflips:
                faults["corrupt"] = lambda i, buf: chaos_inject.flip_one_bit(
                    buf, corrupt_bits[:, i], salts[:, i])
        oks = None
        if algo in EVENT_ALGOS:
            # the partitioned policies' masks ride the sender pass's
            # force/suppress seams (suppression wins), as do the forced
            # sync and the quarantine
            force, suppress = pol.masks(spec, topo, pass_num, event_cfg, dev)
            if chaos is not None and chaos_policy.sync_after:
                req = health.sync_req[:, None]
                force = req if force is None else (force | req)
            if quar is not None:
                q = quar[:, None]
                suppress = q if suppress is None else (suppress | q)
            with _phase("gate_pack"):
                # the bucketed schedule gates per bucket below, so the
                # sender pass proposes without a capacity there
                prop, fire_vec, packed, leaf_id = (
                    event_engine.event_propose_pack(
                        flat, event_state, pass_num, event_cfg, spec,
                        capacity=None if buckets is not None
                        else compact_capacity,
                        force_fire=force, suppress_fire=suppress,
                    )
                )
                fire_bs = None
                if buckets is not None:
                    fire_bs = _bucket_gate(prop, fire_vec, force)
                    fire_vec = (fire_bs[0] if len(fire_bs) == 1
                                else torch.cat(fire_bs, dim=-1))
                event_state = pol.commit(event_state, prop, fire_vec,
                                         event_cfg, n_nb)
        if algo == "allreduce":
            # the gradients average over the gossip ranks (aux and
            # sharded axes had their corrections above); the tail is SGD
            # through the mix kernel with nothing mixed in
            g_flat = collectives.allreduce_mean(
                g_flat, topo, axes=None if topo.gossip_axes == topo.axes
                else topo.gossip_axes).contiguous()
            with _phase("commit_mix"):
                p_flat, new_t = fused_mix_sgd(
                    flat, torch.zeros_like(flat), g_flat, t_flat, lr, mom, 1.0
                )
            # full-precision gradients, whatever the gossip wire
            sent_bytes = wire_real = f32(4.0 * n_params, dev)
            fired_elems = f32(n_params, dev)
        elif algo == "dpsgd":
            with _phase("exchange"):
                bufs = collectives.neighbor_vals_flat(flat, topo, spec, wire)
            gate = None
            if deliver is not None:
                # lossy D-PSGD has no stale buffer to fall back to: a
                # dropped (or frozen) edge leaves this pass's mix and the
                # weight renormalizes — kernel 4's gated form
                health = chaos_monitor.update(health, deliver, ~deliver)
                alive = alive_mask(health.silence, chaos_policy)
                gate = deliver if alive is None else deliver & alive
            with _phase("commit_mix"):
                buf_sum = torch.zeros_like(flat)
                zero = torch.zeros((), dtype=flat.dtype, device=dev)
                for i, b in enumerate(bufs):
                    buf_sum = buf_sum + (b if gate is None else torch.where(
                        gate[:, i:i + 1], b, zero))
                p_flat, new_t = fused_mix_sgd(
                    flat, buf_sum, g_flat, t_flat, lr, mom, topo.mix_weight,
                    w_rows=(None if gate is None
                            else collectives.mix_weights(gate)))
            sent_bytes = f32(n_nb, dev) * f32(total_bytes, dev)
            wire_real = f32(n_nb, dev) * f32(
                collectives.wire_real_bytes_per_neighbor(
                    n_params, n_leaves, wire
                ),
                dev,
            )
            fired_elems = f32(n_params, dev)
        elif algo == "sp_eventgrad":
            stale = sparse_state.replicas
            with _phase("exchange"):
                sparse_state = sparse_exchange(
                    flat, fire_vec, sparse_state, topo, sparse_cfg, spec,
                    wire, buckets=buckets, staleness=staleness,
                )
            # staleness 1 mixes the replicas as they stood before this
            # exchange; D >= 2 mixes the post-exchange replicas, whose
            # newest payloads are the queue's slot 0 of the last pass
            bufs = stale if staleness == 1 else sparse_state.replicas
            with _phase("commit_mix"):
                buf_sum = torch.zeros_like(flat)
                for b in bufs:
                    buf_sum = buf_sum + b
                p_flat, new_t = fused_mix_sgd(
                    flat, buf_sum, g_flat, t_flat, lr, mom, topo.mix_weight
                )
            # values + int32 indices per selected element per neighbor
            fired_elems, fired_leaves = _fired_accounting(
                fire_vec, policy_lib.topk_layout(spec, ks).sizes_tensor(dev))
            if obs:
                # the top-k lanes carry no raw fire bits to count (they are
                # masked on receipt), so the census is the neighbour's
                # fired-leaf count itself, received like the payload;
                # sparsified EventGraD runs no chaos and no integrity, and
                # its queue sees every message at lag 1
                cnt = torch.sum(fire_vec, dim=-1, dtype=torch.int32)
                n_msgs = torch.stack([collectives.recv_from(cnt, topo, nb)
                                      for nb in topo.neighbors], dim=-1)
                if staleness >= 2:
                    lag_vec = torch.ones((r, n_nb), dtype=torch.int32,
                                         device=dev)
            sent_bytes = f32(n_nb, dev) * (
                (val_bytes + 4.0) * fired_elems
                + scale_bytes_per_leaf * fired_leaves
            )
            # the top-k lanes ship every pass (masked on receipt): k
            # values and k indices per leaf, the fire bits, int8 scales
            wire_real = f32(n_nb * (
                (val_bytes + 4.0) * sum(ks) + 1.0 * n_leaves
                + scale_bytes_per_leaf * n_leaves
            ), dev)
        else:
            (p_flat, new_t, event_state, raws, (edge_stale, late_now, lag_vec),
             health, oks) = _event_exchange(
                flat, g_flat, t_flat, fire_vec, fire_bs, packed, leaf_id,
                event_state, pass_num, faults, health, bad, quar, dev)
            if obs:
                # every bucket of an edge is in `raws` (concatenated), and
                # a leaf lives in exactly one bucket
                n_msgs = torch.sum(torch.stack(raws, dim=1), dim=-1,
                                   dtype=torch.int32)
            if per_bucket is not None:
                # the same f32(n_nb) * python-float shape as the
                # monolithic metric, so the bits agree across schedules
                wire_real = f32(n_nb, dev) * f32(float(sum(per_bucket)), dev)
            else:
                wire_real = f32(n_nb, dev) * f32(
                    collectives.wire_real_bytes_per_neighbor(
                        n_params, n_leaves, wire,
                        compact_capacity=compact_capacity, fire_bits=True,
                    ),
                    dev,
                )
            fired_elems, fired_leaves = _fired_accounting(fire_vec, sizes_t)
            sent_bytes = f32(n_nb, dev) * (
                val_bytes * fired_elems + scale_bytes_per_leaf * fired_leaves
            )
        if algo in EVENT_ALGOS:
            # times the float32 reciprocal, as XLA rewrites the JAX
            # package's division by the constant leaf count (an IEEE
            # quotient can sit one ulp off it)
            fired_frac = fired_leaves * float(
                np.float32(1.0) / np.float32(n_leaves))
            num_events, num_deferred = (event_state.num_events,
                                        event_state.num_deferred)
            if trace:
                metrics["trace_norm"] = prop.curr_norm
                metrics["trace_thres"] = event_state.thres
                metrics["trace_fired"] = fire_vec.to(torch.float32)
        else:
            fired_frac = f32(1.0, dev)
            num_events = num_deferred = torch.zeros((), dtype=torch.int32,
                                                    device=dev)

        quar_eff = None
        if integ_quar:
            # the quarantine tail: kernel 1 kept a quarantined rank's mixed
            # parameters and trace; its BatchNorm statistics stay too. A
            # non-finite post-update parameter set (an lr blowup, which
            # the gradient guard cannot see) rolls the whole rank back to
            # its pre-step parameters and trace.
            new_stats = {k: torch.where(_rows(quar, v), state.batch_stats[k],
                                        v) for k, v in new_stats.items()}
            params_ok = torch.isfinite(p_flat).all(dim=-1)
            p_flat = torch.where(params_ok[:, None], p_flat, flat)
            if mom:
                new_t = torch.where(params_ok[:, None], new_t, t_flat)
            quar_eff = quar | ~params_ok

        if sync_bn and new_stats:
            new_stats = {k: collectives.allreduce_mean(v, topo).contiguous()
                         for k, v in new_stats.items()}

        telemetry = state.telemetry
        if obs:
            if telemetry is None:
                raise ValueError(
                    "an obs=True step accumulates into state.telemetry "
                    "(init_train_state(..., obs=True)); this state has none"
                )
            with _phase("telemetry"):
                telemetry = _accumulate(
                    telemetry, dict(
                        prop=prop if algo in EVENT_ALGOS else None,
                        fire_vec=fire_vec if algo in EVENT_ALGOS else None,
                        suppress=suppress if algo in EVENT_ALGOS else None,
                        fired_elems=fired_elems, wire_real=wire_real,
                        n_msgs=n_msgs, deliver=deliver, oks=oks,
                        lag_vec=lag_vec, quar_eff=quar_eff,
                        edge_stale=edge_stale, late_now=late_now), r, dev)

        new_state = state.replace(
            params=p_flat,
            trace=new_t if mom else None,
            batch_stats=new_stats,
            pass_num=pass_num,
            event=event_state,
            sparse=sparse_state,
            chaos=health,
            telemetry=telemetry,
        )
        bcast = lambda v: torch.broadcast_to(v, (r,))
        metrics.update(
            loss=loss,
            # per rank, over every label axis: samples of a classifier
            # `[R, B]`, tokens of a language model `[R, B, T]`
            correct=torch.sum((torch.argmax(out, dim=-1) == y).flatten(1),
                              dim=-1, dtype=torch.int32),
            fired_frac=bcast(fired_frac),
            sent_bytes=bcast(sent_bytes),
            fired_elems=bcast(fired_elems),
            sent_bytes_wire_real=bcast(wire_real),
            num_events=bcast(num_events),
            num_deferred=bcast(num_deferred),
        )
        if per_bucket is not None:
            # per-bucket wire truth; the sum is sent_bytes_wire_real
            metrics["sent_bytes_wire_real_per_bucket"] = torch.broadcast_to(
                _bucket_row(dev), (r, len(per_bucket)))
        if edge_stale is not None:
            # how stale each edge's view is (passes since the newest
            # committed delivery was sent) and the cumulative late commits
            metrics["edge_staleness"] = edge_stale
            metrics["late_commits"] = event_state.late_commits
        if chaos is not None:
            metrics["edge_silence"] = health.silence
            metrics["chaos_drops"] = health.drops
        if integrity is not None:
            # per-step verdicts (the loop sums them into the records)
            metrics["integrity_wire_reject"] = (
                (~oks).to(torch.int32) if oks is not None
                else torch.zeros((r, n_nb), dtype=torch.int32, device=dev))
            metrics["integrity_quarantined"] = (
                quar_eff.to(torch.int32) if quar_eff is not None
                else torch.zeros((r,), dtype=torch.int32, device=dev))
        return new_state, metrics

    return step
