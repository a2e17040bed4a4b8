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

The gradient is taken at the pre-mix parameters, the reference's exact
D-PSGD ordering. The R ranks' forward and backward run batched:
`torch.func.functional_call` + `torch.func.vmap` +
`torch.func.grad_and_value`, with the BatchNorm statistics threaded as
explicit tensors (an empty dict for a model without BatchNorm; the
transformer's flash attention joins the batched forward and backward
through its own `vmap` rule, `ops/attention.py`). The JAX package's
unfused optax tail is documented bitwise equal to the fused one, so the
port runs the fused tail only. Staleness >= 2, the bucketed schedule
and the engines are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.data.augment import draw_pad_flip_crop, pad_flip_crop
from eventgrad_tpu_torch.models.common import draw_dropout
from eventgrad_tpu_torch.ops import event_engine
from eventgrad_tpu_torch.ops.arena_update import (
    fused_mix_commit, fused_mix_commit_carrier,
)
from eventgrad_tpu_torch.ops.fused_update import fused_mix_sgd
from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel import policy as policy_lib
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig, sparse_exchange
from eventgrad_tpu_torch.parallel.spmd import per_rank
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.train.state import ALGOS, EVENT_ALGOS


def _phase(name: str):
    """A profiler span `step/<name>` over one phase of the step, named as
    the JAX step's phases (grad, gate_pack, exchange, commit_mix); next
    to free when no profiler runs."""
    return torch.profiler.record_function("step/" + name)


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


def make_train_step(
    model,
    topo: Topology,
    algo: str = "dpsgd",
    event_cfg: Optional[EventConfig] = None,
    *,
    fused_sgd: Tuple[float, float],
    trace: bool = False,
    trigger_policy: Optional[str] = None,
    wire: Optional[str] = None,
    staleness: int = 0,
    carrier_resident: Optional[bool] = None,
    sparse_cfg: Optional[SparseConfig] = None,
    augment: bool = False,
    gossip_wire: str = "dense",
    compact_capacity: Optional[int] = None,
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
    metrics.

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
    `collectives.choose_capacity`, or let `train` autotune it)."""
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
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
    if staleness >= 2:
        raise NotImplementedError(
            f"staleness={staleness}: the bounded-async delivery queues "
            "are not ported yet (ROADMAP queue 1, item 5; staleness 0 or 1)"
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
        carrier_wire = wire
    if gossip_wire not in ("dense", "compact"):
        raise ValueError(
            f"gossip_wire must be 'dense' or 'compact', got {gossip_wire!r}"
        )
    lr, mom = float(fused_sgd[0]), float(fused_sgd[1])
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

    def loss_fn(params, stats, x, y, drop):
        kw = {"drop": drop} if drop else {}
        out, new_stats = torch.func.functional_call(
            model, params, (x, stats, True), kw)
        return _xent(out, y), (out, new_stats)

    grad_fn = per_rank(torch.func.grad_and_value(loss_fn, has_aux=True))
    sites = getattr(model, "dropout_sites", lambda b: {})
    draws = augment or bool(sites(1))

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
        if augment:
            x = pad_flip_crop(x, *draw_pad_flip_crop(x.shape[:2], state.rng,
                                                     dev))
        drop = draw_dropout(sites(x.shape[1]), (r,), state.rng, dev)

        with _phase("grad"):
            grads, (loss, (out, new_stats)) = grad_fn(
                spec.unravel(flat), state.batch_stats, x, y, drop
            )
            g_flat = spec.ravel(grads)
        t_flat = state.trace if mom else torch.zeros_like(flat)

        event_state, sparse_state = state.event, state.sparse
        metrics = {}
        fired_leaves = None
        if algo in EVENT_ALGOS:
            # the partitioned policies' masks ride the sender pass's
            # force/suppress seams (suppression wins)
            force, suppress = pol.masks(spec, topo, pass_num, event_cfg, dev)
            with _phase("gate_pack"):
                prop, fire_vec, packed, leaf_id = (
                    event_engine.event_propose_pack(
                        flat, event_state, pass_num, event_cfg, spec,
                        capacity=compact_capacity, force_fire=force,
                        suppress_fire=suppress,
                    )
                )
                event_state = pol.commit(event_state, prop, fire_vec,
                                         event_cfg, n_nb)
        if algo == "allreduce":
            # the gradients average over the ranks; the tail is SGD
            # through the mix kernel with nothing mixed in
            g_flat = collectives.allreduce_mean(g_flat, topo).contiguous()
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
            with _phase("commit_mix"):
                buf_sum = torch.zeros_like(flat)
                for b in bufs:
                    buf_sum = buf_sum + b
                p_flat, new_t = fused_mix_sgd(
                    flat, buf_sum, g_flat, t_flat, lr, mom, topo.mix_weight
                )
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
                    flat, fire_vec, sparse_state, topo, sparse_cfg, spec, wire
                )
            # staleness 1 mixes the replicas as they stood before this
            # exchange; this step's payloads land for the next one
            bufs = stale if staleness else sparse_state.replicas
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
            with _phase("exchange"):
                if compact_capacity is not None:
                    res = collectives.compact_neighbor_vals_flat(
                        flat, fire_vec, packed, leaf_id, topo,
                        compact_capacity, spec, wire,
                        carrier=carrier_wire is not None,
                    )
                else:
                    res = collectives.masked_neighbor_vals_flat(
                        flat, fire_vec, topo, spec, wire,
                        wire_builder=event_engine.masked_wire,
                        carrier=carrier_wire is not None,
                    )
            wire_real = f32(n_nb, dev) * f32(
                collectives.wire_real_bytes_per_neighbor(
                    n_params, n_leaves, wire,
                    compact_capacity=compact_capacity, fire_bits=True,
                ),
                dev,
            )
            with _phase("commit_mix"):
                cands, effs = res[:2]
                keeps = tuple(e.to(torch.float32)[:, seg] for e in effs)
                if carrier_wire is None:
                    p_flat, new_t, new_bufs = fused_mix_commit(
                        flat, cands, keeps, event_state.bufs, g_flat, t_flat,
                        lr, mom, topo.mix_weight, mix_stale=bool(staleness),
                    )
                    event_state = event_state.replace(bufs=new_bufs)
                else:
                    # the scales commit outside the kernel (an [R, L]
                    # select) and ride in per position for the mix dequant
                    cand_scales, last_scales = res[3], event_state.buf_scales
                    new_scales, mix_scales = last_scales, None
                    if cand_scales is not None:
                        new_scales = collectives.commit_carrier_scales(
                            cand_scales, effs, last_scales
                        )
                        src = last_scales if staleness else new_scales
                        mix_scales = tuple(sc[:, seg] for sc in src)
                    p_flat, new_t, new_bufs = fused_mix_commit_carrier(
                        flat, cands, keeps, event_state.bufs, g_flat, t_flat,
                        lr, mom, topo.mix_weight, mix_scales=mix_scales,
                        mix_stale=bool(staleness),
                    )
                    event_state = event_state.replace(
                        bufs=new_bufs, buf_scales=new_scales
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

        new_state = state.replace(
            params=p_flat,
            trace=new_t if mom else None,
            batch_stats=new_stats,
            pass_num=pass_num,
            event=event_state,
            sparse=sparse_state,
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
        return new_state, metrics

    return step
