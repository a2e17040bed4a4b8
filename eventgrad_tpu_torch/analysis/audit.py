"""The trace auditor: machine-checked invariants of the train step.

Port of `eventgrad_tpu/analysis/audit.py`. For each configuration of the
step (model geometry x algo x wire x gossip wire x policy x carrier x
staleness) the auditor traces the rank-stacked step into an ATen graph
(`walker.trace`, which also runs it) and proves, on the models the
headline numbers ship (LeNetCifar, ResNet18, a small TransformerLM with
full and flash attention) beside the cheap MLP base:

  1. RANK ISOLATION (`analysis/rankflow.py`): the only cross-rank flow is
     the declared neighbour exchange — rolls of the rank dimension whose
     ring offsets are the topology's; no reduction, slice, gather, sort or
     convolution crosses ranks, and every kernel op is registered.
  2. WIRE-BYTE TRUTH: the bytes each exchange moves, derived from the
     rolled lanes' shapes and dtypes, equal the accounting formula
     (`collectives.wire_real_bytes_per_neighbor`, or sparsified
     EventGraD's inline formula) and the `sent_bytes_wire_real` metric the
     same traced run reports — exactly, in the metric's float32.
  3. STEP HYGIENE: no host round trip inside the step (`.item()`, a copy
     to the host); full-model concatenations within the cell's budget;
     wire value lanes at the declared wire dtype.

  4. THE MESH LIFT'S EXCHANGE (`mesh_lift_report`): on a device mesh a
     shift is a transfer between processes, which no trace of the step
     shows as a roll; the lift records the offsets it shifted by, and
     they must be the topology's neighbour offsets.

Every check has a seeded ORACLE violation (`run_oracles`: the 14 of
`ORACLES` and the mesh lift's `MESH_ORACLES`) proving it can fire. One of them runs the seeded unregistered kernel, `eg::leak_kernel`
(`csrc/audit_leak.cu`, the port of the JAX auditor's `_leak_kernel`),
which stays out of the kernel registry on purpose.

The matrix is the JAX package's, under its cell names, all 31 cells: the
chaos cells run a seeded drop schedule (beside a straggler at D >= 2),
and the integrity cell ships each payload's checksum beside it, a
declared one-element rider lane outside the byte formula (as the JAX
auditor declares it). A bucketed cell's exchanges
are K lane groups per neighbour, one per bucket; its trace must also
show the bucketed schedule's emission (`walker.bucket_schedule`: a
bucket's exchange between the tails of its neighbouring buckets). The port runs only the flat
arena, so the `_tree` cells run on it (the JAX record shows tree and
arena cells carry the same bytes); each report lists its substitutions.
The three `_obs` cells trace the step with the telemetry and the message
ledger on: the ledger's receiver census sums the fire bits the exchange
delivered, so it reaches the rank-flow analysis through the declared
exchange. Donation
aliasing has no torch counterpart and reports `null`.

CLI: `python -m eventgrad_tpu_torch.analysis.audit --device cuda|cpu
[--out FILE] [--census]` writes one JSON record shaped like the JAX
package's `artifacts/audit_cpu.json`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.analysis import kernels, rankflow, walker
from eventgrad_tpu_torch.chaos import monitor as chaos_monitor
from eventgrad_tpu_torch.chaos.integrity import IntegrityConfig
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP, LeNetCifar, ResNet18
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.ops import build as kbuild
from eventgrad_tpu_torch.ops import launch_counts
from eventgrad_tpu_torch.parallel import collectives, multihost, spmd
from eventgrad_tpu_torch.parallel import policy as policy_lib
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Ring
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.devices import resolve_device

N_RANKS = 4
IN_SHAPE = (8, 8, 1)
PER_RANK = 4
#: the production geometries trace bigger programs: 2 samples a rank
PER_RANK_PROD = 2
SEQ_LEN = 16
VOCAB = 32
MODEL = dict(hidden=16)
#: the SGD of the JAX matrix (`optax.sgd(0.05)`): lr, momentum
SGD = (0.05, 0.0)


def _transformer(attn, device):
    return TransformerLM(vocab=VOCAB, dim=16, n_heads=2, n_layers=1,
                         max_len=SEQ_LEN, attn=attn, device=device)


#: model name -> (constructor(attn, device), one sample's shape, tokens?,
#: per-rank batch)
GEOMETRIES = {
    "mlp": (lambda attn, dev: MLP(**MODEL, input_shape=IN_SHAPE, device=dev),
            IN_SHAPE, False, PER_RANK),
    "lenet": (lambda attn, dev: LeNetCifar(device=dev), (32, 32, 3), False,
              PER_RANK_PROD),
    "resnet18": (lambda attn, dev: ResNet18(device=dev), (32, 32, 3), False,
                 PER_RANK_PROD),
    "transformer": (_transformer, (SEQ_LEN,), True, PER_RANK_PROD),
}
CFG = EventConfig(adaptive=True, horizon=0.95, warmup_passes=2,
                  max_silence=4)
#: fits Dense_0's kernel+bias, defers the second layer when all fire
CAPACITY = 1100
#: bucketed compact cells need the sum of per-bucket floors; with K = 4
#: on the 4-leaf MLP every leaf is its own bucket: the whole model
BUCKETED_CAPACITY = 1210

_ITEMSIZE = {
    "float32": 4.0, "bfloat16": 2.0, "float16": 2.0, "int8": 1.0,
    "uint8": 1.0, "bool": 1.0, "int32": 4.0, "float64": 8.0, "int64": 8.0,
}
_WIRE_DTYPE = {None: "float32", "bf16": "bfloat16", "int8": "int8"}
_DONATION_NOTE = (
    "no torch counterpart: the step returns new tensors, and XLA's "
    "donation aliasing has no equivalent to check")


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """One cell of the audit matrix (the JAX package's fields; the port
    runs the cells whose dimensions it has)."""

    name: str
    algo: str = "eventgrad"
    #: GEOMETRIES key: mlp | lenet | resnet18 | transformer
    model: str = "mlp"
    #: attention of the transformer geometry: "full" | "flash"
    attn: str = "full"
    wire: Optional[str] = None
    gossip_wire: str = "dense"
    #: compact capacity; -1 = the model's static floor (its largest leaf)
    capacity: Optional[int] = None
    #: the JAX cell's arena flag (the port always runs the arena)
    arena: bool = False
    #: the telemetry and the message ledger in the traced step
    obs: bool = False
    staleness: int = 0
    #: full-model concatenations allowed in the traced step
    ravel_budget: int = 1
    policy: Optional[str] = None
    carrier: bool = False
    #: the bucketed schedule's K (0 = off)
    bucketed: int = 0
    #: a seeded drop schedule (drop 0.4; at D >= 2 also rank 1 three
    #: passes late)
    chaos: bool = False
    #: the in-step integrity defenses (checksums and quarantine)
    integrity: bool = False


#: the JAX matrix's cells whose dimensions the port has, under their
#: JAX names (the JAX package's `audit.CONFIGS`)
CONFIGS: Tuple[AuditConfig, ...] = (
    AuditConfig("dpsgd_f32_tree", algo="dpsgd"),
    AuditConfig("dpsgd_int8_arena", algo="dpsgd", wire="int8", arena=True),
    AuditConfig("event_masked_f32_tree"),
    AuditConfig("event_masked_f32_arena_obs", arena=True, obs=True),
    AuditConfig("event_masked_bf16_arena", arena=True, wire="bf16"),
    AuditConfig("event_compact_f32_tree", gossip_wire="compact",
                capacity=CAPACITY),
    AuditConfig("event_compact_int8_arena_obs", gossip_wire="compact",
                capacity=CAPACITY, wire="int8", arena=True, obs=True),
    AuditConfig("event_compact_bf16_arena_stale", gossip_wire="compact",
                capacity=CAPACITY, wire="bf16", arena=True, staleness=1),
    AuditConfig("event_compact_int8_arena_stale4", gossip_wire="compact",
                capacity=CAPACITY, wire="int8", arena=True, staleness=4),
    AuditConfig("sp_f32_tree", algo="sp_eventgrad"),
    AuditConfig("event_compact_int8_arena_b4_stale2_carrier",
                gossip_wire="compact", capacity=BUCKETED_CAPACITY,
                wire="int8", arena=True, bucketed=4, staleness=2,
                carrier=True),
    AuditConfig("sp_f32_tree_stale2", algo="sp_eventgrad", staleness=2),
    AuditConfig("event_masked_int8_arena_carrier", wire="int8",
                arena=True, carrier=True),
    AuditConfig("event_compact_bf16_arena_carrier", gossip_wire="compact",
                capacity=CAPACITY, wire="bf16", arena=True, carrier=True),
    AuditConfig("event_micro_compact_f32_arena", gossip_wire="compact",
                capacity=-1, arena=True, policy="micro"),
    AuditConfig("event_micro_masked_int8_tree", wire="int8",
                policy="micro"),
    AuditConfig("event_hybrid_masked_f32_arena_obs", arena=True,
                obs=True, policy="hybrid"),
    AuditConfig("event_hybrid_compact_int8_arena_b4",
                gossip_wire="compact", capacity=BUCKETED_CAPACITY,
                wire="int8", arena=True, bucketed=4, policy="hybrid"),
    AuditConfig("event_masked_int8_tree_chaos", wire="int8", chaos=True),
    AuditConfig("event_masked_f32_arena_integrity", arena=True,
                integrity=True),
    AuditConfig("event_masked_f32_arena_stale2_chaos", arena=True,
                staleness=2, chaos=True),
    AuditConfig("event_masked_f32_arena_b4", arena=True, bucketed=4),
    AuditConfig("event_compact_int8_arena_b4", gossip_wire="compact",
                capacity=BUCKETED_CAPACITY, wire="int8", arena=True,
                bucketed=4),
    AuditConfig("lenet_masked_f32_arena", model="lenet", arena=True),
    AuditConfig("lenet_compact_int8_arena", model="lenet",
                gossip_wire="compact", capacity=-1, wire="int8",
                arena=True),
    AuditConfig("lenet_masked_f32_arena_b4", model="lenet", arena=True,
                bucketed=4),
    AuditConfig("resnet18_masked_f32_arena", model="resnet18", arena=True),
    AuditConfig("resnet18_compact_f32_arena", model="resnet18",
                gossip_wire="compact", capacity=-1, arena=True),
    AuditConfig("xfmr_masked_f32_arena", model="transformer", arena=True),
    AuditConfig("xfmr_compact_int8_tree", model="transformer",
                gossip_wire="compact", capacity=-1, wire="int8"),
    AuditConfig("xfmr_flash_masked_f32_tree", model="transformer",
                attn="flash"),
)

#: the JAX cells that wait, and what for (none: all 31 run)
WAITING: Dict[str, str] = {}


def config_by_name(name: str) -> AuditConfig:
    for c in CONFIGS:
        if c.name == name:
            return c
    if name in WAITING:
        raise NotImplementedError(
            f"audit cell {name!r} is not ported yet: it needs "
            f"{WAITING[name]}")
    raise KeyError(f"unknown audit config {name!r}")


def substitutions(cfg: AuditConfig) -> List[str]:
    """How the port's run of a cell differs from the JAX cell."""
    out = []
    if not cfg.arena:
        out.append("tree -> arena (the port runs only the flat arena)")
    return out


# --- the seeded unregistered kernel (TPU kernel 9) --------------------------


def leak_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `leak_kernel`: `x * 2.0`."""
    return x * 2.0


def _check_leak(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("leak_kernel: x must be contiguous float32, got "
                         f"{x.dtype}")


@torch.library.custom_op("eg::leak_kernel", mutates_args=(),
                         device_types="cpu")
def _leak_op(x: torch.Tensor) -> torch.Tensor:
    _check_leak(x)
    return leak_reference(x)


@_leak_op.register_kernel("cuda")
def _leak_cuda(x):
    _check_leak(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kbuild.launch("leak_kernel", kbuild.library().eg_leak_x2,
                      x.data_ptr(), out.data_ptr(), x.numel(),
                      kbuild.stream_of(x.device))
    leak_kernel.launches += 1
    return out


@_leak_op.register_fake
def _leak_fake(x):
    return torch.empty_like(x)


def leak_kernel(x: torch.Tensor) -> torch.Tensor:
    """`x * 2.0`, the operator `eg::leak_kernel`: on a CPU tensor
    `leak_reference`, on a CUDA tensor a launch of `csrc/audit_leak.cu`
    (or an error). Deliberately absent from `kernels.REGISTRY`: the
    `unregistered_kernel` oracle puts it in the audited step, and the
    audit must refuse it."""
    return _leak_op(x)


leak_kernel.launches = 0


# --- building the step under audit -----------------------------------------


def _model(cfg: AuditConfig, device):
    make, in_shape, _, _ = GEOMETRIES[cfg.model]
    return make(cfg.attn, device), in_shape


def _batch(cfg: AuditConfig, device=None):
    """`(x, y)` for the cell: synthetic images (the JAX package's
    `synthetic_dataset`, seed 0), or tokens from a numpy seed with
    next-token targets."""
    _, in_shape, tokens, per_rank = GEOMETRIES[cfg.model]
    device = resolve_device(device)
    if tokens:
        toks = np.random.default_rng(0).integers(
            0, VOCAB, (N_RANKS, per_rank) + tuple(in_shape))
        toks = torch.as_tensor(toks, dtype=torch.int64, device=device)
        return toks, torch.roll(toks, -1, dims=-1)
    x, y = synthetic_dataset(N_RANKS * per_rank, in_shape, seed=0)
    return (
        torch.as_tensor(x.reshape((N_RANKS, per_rank) + tuple(in_shape)),
                        device=device),
        torch.as_tensor(y.reshape(N_RANKS, per_rank), dtype=torch.int64,
                        device=device),
    )


def resolved_capacity(cfg: AuditConfig, model) -> Optional[int]:
    """The compact capacity a cell runs at: `capacity=-1` is the model's
    static floor (its largest leaf, or the sum of the buckets' under the
    bucketed schedule), from the same arena spec the step uses."""
    if cfg.gossip_wire != "compact":
        return None
    if cfg.capacity is not None and cfg.capacity >= 0:
        return cfg.capacity
    spec = arena_spec(model)
    if cfg.bucketed >= 2:
        return int(collectives.bucketed_capacity_floor(
            spec.buckets(cfg.bucketed)))
    return int(collectives.compact_capacity_floor(spec.sizes))


def bucket_info(cfg: AuditConfig, model):
    """(buckets, capacity split) of a bucketed cell, None otherwise: the
    step's own `ArenaSpec.buckets` and `split_capacity`."""
    if cfg.bucketed < 2:
        return None
    buckets = arena_spec(model).buckets(cfg.bucketed)
    caps = (collectives.split_capacity(resolved_capacity(cfg, model),
                                       buckets)
            if cfg.gossip_wire == "compact" else None)
    return buckets, caps


def build(cfg: AuditConfig, device=None, mesh=None):
    """(state, step, topo, model) of one audit cell on `device` (None:
    CUDA); with a `mesh` the step and the topology are lifted onto it."""
    device = resolve_device(device)
    topo = Ring(N_RANKS)
    model, in_shape = _model(cfg, device)
    state = init_train_state(
        model, in_shape, topo, cfg.algo, CFG, seed=0, momentum=SGD[1],
        resident_wire=(cfg.wire if cfg.carrier and cfg.algo == "eventgrad"
                       else None),
        bucketed=cfg.bucketed or None, staleness=cfg.staleness,
        obs=cfg.obs, device=device,
    )
    chaos = None
    if cfg.chaos:
        # the JAX cells' schedule; a bounded-async cell adds a straggler
        # so the lag path is in the audited step too
        slow = ((1, 3),) if cfg.staleness >= 2 else ()
        chaos = ChaosSchedule(seed=3, drop_p=0.4, slow=slow)
        state = state.replace(chaos=chaos_monitor.PeerHealth.init(
            topo, device))
    step = make_train_step(
        model, topo, cfg.algo, CFG, fused_sgd=SGD, wire=cfg.wire,
        gossip_wire=cfg.gossip_wire,
        compact_capacity=resolved_capacity(cfg, model),
        staleness=cfg.staleness, trigger_policy=cfg.policy,
        carrier_resident=cfg.carrier, bucketed=cfg.bucketed or None,
        chaos=chaos, integrity=IntegrityConfig() if cfg.integrity else None,
        obs=cfg.obs, mesh=mesh,
    )
    return state, step, spmd.lift(topo, mesh), model


def _meta(model) -> Tuple[int, int, int]:
    """(parameters, leaves, top-k lanes at the default 10%) per rank."""
    spec = arena_spec(model)
    return spec.n_total, spec.n_leaves, sum(SparseConfig().ks(spec))


# --- wire classification ----------------------------------------------------


def _expected_lanes(cfg: AuditConfig, n_params: int, n_leaves: int,
                    capacity: Optional[int] = None, binfo=None):
    """[(role, elems, dtype)] one neighbour's exchange must ship; None for
    sparsified EventGraD, whose top-k lanes compare by totals. A bucketed
    cell ships K lane groups: per bucket its value lane (its elements or
    its capacity share), fire bits (and int8 scales)."""
    if cfg.algo == "sp_eventgrad":
        return None
    if binfo is not None:
        buckets, caps = binfo
        lanes = []
        for i, b in enumerate(buckets):
            lanes.append(("value", b.size if caps is None else caps[i],
                          _WIRE_DTYPE[cfg.wire]))
            lanes.append(("fire", b.n_leaves, "bool"))
            if cfg.wire == "int8":
                lanes.append(("scale", b.n_leaves, "float32"))
        return lanes
    val_elems = capacity if cfg.gossip_wire == "compact" else n_params
    lanes = [("value", val_elems, _WIRE_DTYPE[cfg.wire])]
    if cfg.algo == "eventgrad":
        lanes.append(("fire", n_leaves, "bool"))
    if cfg.wire == "int8":
        lanes.append(("scale", n_leaves, "float32"))
    return lanes


def _riders(cfg: AuditConfig):
    """[(role, elems, dtype)] of the transfer metadata a neighbour's
    exchange ships outside the byte formula: the integrity checksum."""
    return [("checksum", 1, "int32")] if cfg.integrity else []


def _formula_bytes_per_neighbor(
    cfg: AuditConfig, n_params: int, n_leaves: int, k_total: int,
    capacity: Optional[int] = None, binfo=None,
) -> float:
    """The accounting formula the step's metric is built from: what the
    graph-derived bytes are checked against (a bucketed cell: the sum of
    the per-bucket formula, the step's own definition)."""
    if cfg.algo == "sp_eventgrad":
        val = collectives.WIRE_VAL_BYTES[cfg.wire]
        scale = 4.0 if cfg.wire == "int8" else 0.0
        return (val + 4.0) * k_total + 1.0 * n_leaves + scale * n_leaves
    if binfo is not None:
        buckets, caps = binfo
        return float(sum(collectives.bucketed_wire_real_bytes_per_neighbor(
            buckets, cfg.wire, caps)))
    return collectives.wire_real_bytes_per_neighbor(
        n_params, n_leaves, cfg.wire,
        compact_capacity=(capacity if cfg.gossip_wire == "compact"
                          else None),
        fire_bits=(cfg.algo == "eventgrad"),
    )


def _classify_exchanges(
    cfg: AuditConfig,
    report: rankflow.RankFlowReport,
    n_params: int,
    n_leaves: int,
    capacity: Optional[int] = None,
    binfo=None,
) -> Dict[str, Any]:
    """Group the rolled lanes by ring offset and check them against the
    expected wire; returns the per-neighbour derived bytes and the lane
    problems."""
    groups: Dict[int, List[rankflow.Exchange]] = {}
    for ex in report.exchanges:
        groups.setdefault(ex.offset, []).append(ex)
    problems: List[str] = []
    per_offset_bytes: Dict[int, float] = {}
    rider_bytes: Dict[int, float] = {}
    want = _expected_lanes(cfg, n_params, n_leaves, capacity, binfo)
    for off, lanes in groups.items():
        got = sorted((e.lane_elems, e.dtype) for e in lanes)
        # derived from the lanes the graph actually rolls, never from the
        # expectation, or an upcast would launder itself; the declared
        # riders are counted apart
        per_offset_bytes[off] = sum(n * _ITEMSIZE[dt] for n, dt in got)
        rider_bytes[off] = 0.0
        if want is None:
            continue
        remaining = list(got)
        for _, elems, dt in want:
            if (elems, dt) in remaining:
                remaining.remove((elems, dt))
            else:
                problems.append(f"offset {off:+d}: missing expected lane "
                                f"{elems} elems of {dt}")
        for _, elems, dt in _riders(cfg):
            if (elems, dt) in remaining:
                remaining.remove((elems, dt))
                rider_bytes[off] += elems * _ITEMSIZE[dt]
            else:
                problems.append(f"offset {off:+d}: missing declared rider "
                                f"{elems} elems of {dt}")
        per_offset_bytes[off] -= rider_bytes[off]
        for elems, dt in remaining:
            problems.append(f"offset {off:+d}: UNDECLARED lane {elems} "
                            f"elems of {dt} on the wire")
        for role, elems, dt in want:
            if role == "value" and (elems, dt) not in got:
                problems.append(
                    f"offset {off:+d}: value lane not carried as {dt} "
                    f"({cfg.wire or 'native f32'} wire) — silent dtype "
                    "promotion")
    return {"offsets": sorted(groups), "per_offset_bytes": per_offset_bytes,
            "rider_bytes": rider_bytes, "problems": problems}


# --- hygiene ---------------------------------------------------------------


def count_callbacks(gm: torch.fx.GraphModule) -> int:
    """Host round trips inside the traced step: a read of a tensor into a
    Python number (`.item()`, `.tolist()`: `aten::_local_scalar_dense`),
    or a copy to the host (`.cpu()`: `aten::_to_copy` to a CPU device)."""
    total = 0
    for node, _ in walker.iter_nodes(gm):
        name = walker.op_name(node)
        if name == "aten::_local_scalar_dense":
            total += 1
        elif name == "aten::_to_copy":
            dev = node.kwargs.get("device")
            if dev is not None and torch.device(dev).type == "cpu":
                total += 1
    return total


# --- the per-configuration audit -------------------------------------------


def _kernel_launches() -> Dict[str, int]:
    """Launches per kernel, as the trace names its ops: a gated launch
    already counts in its kernel, so the `<kernel>_gated` counts stay
    out."""
    out = {k: v for k, v in launch_counts().items()
           if not k.endswith("_gated")}
    out["leak_kernel"] = leak_kernel.launches
    return out


def _analyze(cfg, fn, state, batch, model, topo) -> Dict[str, Any]:
    """Trace `fn(state, batch)` and run every check on the graph; the
    shared body of `audit_step` and the oracles."""
    before = _kernel_launches()
    tr = walker.trace(fn, state, batch)
    after = _kernel_launches()
    n_params, n_leaves, k_total = _meta(model)
    capacity = resolved_capacity(cfg, model)
    report = rankflow.analyze(tr.graph, topo.n_ranks, grid=topo.shape)
    declared = sorted(nb.offset for nb in topo.neighbors)
    binfo = bucket_info(cfg, model)
    wire = _classify_exchanges(cfg, report, n_params, n_leaves, capacity,
                               binfo)
    formula = _formula_bytes_per_neighbor(cfg, n_params, n_leaves, k_total,
                                          capacity, binfo)
    schedule = None
    if binfo is not None and cfg.algo == "eventgrad":
        buckets, caps = binfo
        schedule = walker.bucket_schedule(
            tr.graph, [b.size if caps is None else caps[i]
                       for i, b in enumerate(buckets)],
            [b.size for b in buckets])
    derived = list(wire["per_offset_bytes"].values())
    metric = float(tr.out[1]["sent_bytes_wire_real"][0])
    # traced kernel ops by the kernel they launch (a pitched form counts
    # in its kernel, as its wrapper's launch counter does)
    graph_ops = {"leak_kernel": walker.count_ops(tr.graph, "eg::leak_kernel")}
    for name in kernels.registered_names():
        key = kernels.REGISTRY[name].counter
        graph_ops[key] = (graph_ops.get(key, 0)
                          + walker.count_ops(tr.graph, f"eg::{name}"))
    return {
        "trace": tr,
        "report": report,
        "n_params": n_params,
        "n_leaves": n_leaves,
        "capacity": capacity,
        "declared": declared,
        "wire": wire,
        "formula": float(formula),
        "derived": derived,
        "derived_total": float(sum(derived)),
        "metric_total": metric,
        "kernel_ops": {k: v for k, v in graph_ops.items() if v},
        "kernel_launches": {k: after[k] - before[k] for k in after
                            if after[k] != before[k]},
        "ravels": walker.count_full_ravels(tr.graph, int(n_params)),
        "callbacks": count_callbacks(tr.graph),
        "schedule": schedule,
    }


def audit_step(cfg: AuditConfig, step, state, batch, model, topo,
               run_metric: bool = True,
               census: bool = False) -> Dict[str, Any]:
    """Trace one built step (`cfg` describes its wire: algo, wire, gossip
    wire, capacity, policy) and run every check; returns the report
    `main` serializes (findings only: the caller decides what is
    fatal). The device is the state's."""
    t0 = time.perf_counter()
    res = _analyze(cfg, step, state, batch, model, topo)
    report, wire = res["report"], res["wire"]
    violations = [{"prim": f.prim, "reason": f.reason,
                   "path": "/".join(f.path)} for f in report.violations]
    undeclared = sorted(set(wire["offsets"]) - set(res["declared"]))
    missing = sorted(set(res["declared"]) - set(wire["offsets"]))
    wire_match = (not wire["problems"] and not undeclared and not missing
                  and all(b == res["formula"] for b in res["derived"]))
    metric_total = metric_match = None
    if run_metric:
        metric_total = res["metric_total"]
        # the step carries the metric as an f32 scalar: the derived total
        # is compared after the same quantization, still exactly
        metric_match = metric_total == float(np.float32(res["derived_total"]))
    partitions = partitions_ok = None
    if cfg.policy in ("micro", "hybrid"):
        spec = arena_spec(model)
        partitions = list(policy_lib.partition_table(spec, topo.n_ranks))
        partitions_ok = bool(policy_lib.validate_partitions(
            spec, topo.n_ranks)["ok"])
    out = {
        "name": cfg.name,
        "algo": cfg.algo,
        "model": cfg.model,
        "attn": cfg.attn,
        "capacity": res["capacity"],
        "wire": cfg.wire,
        "gossip_wire": cfg.gossip_wire,
        "arena": cfg.arena,
        "obs": cfg.obs,
        "staleness": cfg.staleness,
        "policy": cfg.policy,
        "carrier": cfg.carrier,
        "bucketed": cfg.bucketed,
        "chaos": cfg.chaos,
        "integrity": cfg.integrity,
        # the bucketed schedule's emission (None: not a bucketed
        # EventGraD cell): a bucket's exchange between the tails of the
        # buckets before and after it
        "bucket_schedule_interleaved": (
            None if res["schedule"] is None
            else res["schedule"]["interleaved"]),
        "substitutions": substitutions(cfg),
        "partitions": partitions,
        "partitions_ok": partitions_ok,
        "n_ranks": topo.n_ranks,
        "n_params": int(res["n_params"]),
        "n_leaves": int(res["n_leaves"]),
        "graph_nodes": len(res["trace"].graph.graph.nodes),
        "violations": len(violations),
        "violation_details": violations,
        "exchange_offsets": wire["offsets"],
        "declared_offsets": res["declared"],
        "undeclared_offsets": undeclared,
        "missing_offsets": missing,
        "wire_problems": wire["problems"],
        "wire_bytes_per_neighbor_derived": (res["derived"][0]
                                            if res["derived"] else 0.0),
        "wire_bytes_per_neighbor_formula": res["formula"],
        "wire_rider_bytes_per_neighbor": (
            max(wire["rider_bytes"].values()) if wire["rider_bytes"]
            else 0.0),
        "wire_metric_total": metric_total,
        "wire_match": bool(wire_match),
        "metric_match": metric_match,
        "ravel_count": int(res["ravels"]),
        "ravel_budget": int(cfg.ravel_budget),
        "ravel_ok": res["ravels"] <= cfg.ravel_budget,
        "callbacks": int(res["callbacks"]),
        "kernel_ops": res["kernel_ops"],
        "kernel_launches": res["kernel_launches"],
        "donation_ok": None,
        "donation_note": _DONATION_NOTE,
        "device": str(state.params.device),
        "wall_s": time.perf_counter() - t0,
    }
    if census:
        out["census"] = walker.op_census(res["trace"].graph)
    return out


def audit_config(cfg: AuditConfig, run_metric: bool = True,
                 device=None, census: bool = False) -> Dict[str, Any]:
    """Build one audit cell on `device` (None: CUDA) and audit its
    step."""
    state, step, topo, model = build(cfg, device)
    return audit_step(cfg, step, state, _batch(cfg, device), model, topo,
                      run_metric=run_metric, census=census)


def clean(report: Dict[str, Any]) -> bool:
    """The acceptance predicate for one cell."""
    return (
        report["violations"] == 0
        and report["wire_match"]
        and report["metric_match"] in (None, True)
        and report["ravel_ok"]
        and report["callbacks"] == 0
        and report["donation_ok"] in (None, True)
        and report.get("partitions_ok") in (None, True)
        and report.get("bucket_schedule_interleaved") in (None, True)
    )


def audit_matrix(run_metric: bool = True, device=None,
                 census: bool = False) -> List[Dict[str, Any]]:
    return [audit_config(c, run_metric=run_metric, device=device,
                         census=census) for c in CONFIGS]


# --- seeded oracle violations ----------------------------------------------
#
# Each oracle sabotages a CLEAN cell in exactly one way and returns
# (detected, reason). A check that cannot fire proves nothing.


def _audit_with(cfg_name: str, wrap, device, run_metric: bool = False):
    """Audit cell `cfg_name` with its step wrapped by `wrap(step, topo,
    model)`; returns `_analyze`'s result plus the verdict fields."""
    cfg = config_by_name(cfg_name)
    state, step, topo, model = build(cfg, device)
    fn = step if wrap is None else wrap(step, topo, model)
    res = _analyze(cfg, fn, state, _batch(cfg, device), model, topo)
    res["violation_details"] = [f.reason for f in res["report"].violations]
    res["undeclared_offsets"] = sorted(
        set(res["wire"]["offsets"]) - set(res["declared"]))
    res["formula_match"] = all(b == res["formula"] for b in res["derived"])
    res["metric_match"] = (res["metric_total"]
                           == float(np.float32(res["derived_total"])))
    return res


def _with_metric(fn):
    """Wrap a step so that `extra(new_state, metrics, batch)` adds to its
    metrics."""
    def wrap(step, topo, model):
        def bad(state, batch):
            ns, m = step(state, batch)
            m = dict(m)
            fn(ns, m, batch, topo, model)
            return ns, m
        return bad
    return wrap


def oracle_rank_coupling(device=None) -> Tuple[bool, str]:
    """A roll by an undeclared ring offset (+2) smuggled into the
    metrics: cross-rank flow outside the declared exchange."""
    def leak(ns, m, batch, topo, model):
        m["leak"] = collectives.recv_from(
            m["loss"], topo, NeighborSpec(topo.axes[0], 2))

    rep = _audit_with("event_masked_f32_arena_obs", _with_metric(leak),
                      device)
    detected = bool(rep["undeclared_offsets"]) or bool(
        rep["wire"]["problems"])
    return detected, f"undeclared exchange offsets {rep['undeclared_offsets']}"


def oracle_rank_roll(device=None) -> Tuple[bool, str]:
    """A read of the neighbour through the stacked rank dimension by
    slices and a concatenation (the way `jnp.roll` lowers): 'peek at your
    neighbour through the lift'."""
    def leak(ns, m, batch, topo, model):
        p = ns.params
        m["leak"] = torch.sum(p * torch.cat([p[-1:], p[:-1]], dim=0), dim=1)

    rep = _audit_with("event_masked_f32_tree", _with_metric(leak), device)
    n = len(rep["violation_details"])
    return n > 0, (f"{n} rank-flow violations: "
                   f"{rep['violation_details'][:2]}")


def oracle_wire_dtype_upcast(device=None) -> Tuple[bool, str]:
    """The bf16 wire's downcast silently dropped: lanes ship f32 while
    the accounting still claims 2 bytes an element."""
    orig = collectives._wire_out
    try:
        collectives._wire_out = lambda x, wire: x  # the sabotage
        rep = _audit_with("event_masked_bf16_arena", None, device)
    finally:
        collectives._wire_out = orig
    problems = rep["wire"]["problems"]
    return bool(problems) and not rep["formula_match"], (
        f"wire problems {problems[:2]}")


def oracle_extra_ravel(device=None) -> Tuple[bool, str]:
    """A second full-model flatten in the arena step: the regression the
    ravel budget stops."""
    def leak(ns, m, batch, topo, model):
        spec = arena_spec(model)
        m["extra"] = torch.sum(spec.ravel(spec.unravel(ns.params)))

    cfg = config_by_name("event_masked_f32_arena_obs")
    rep = _audit_with(cfg.name, _with_metric(leak), device)
    return rep["ravels"] > cfg.ravel_budget, (
        f"{rep['ravels']} full-model ravels > budget {cfg.ravel_budget}")


def oracle_byte_formula_drift(device=None) -> Tuple[bool, str]:
    """The accounting formula forgets the fire-bit lane: the metric the
    step reports no longer equals what the graph ships."""
    orig = collectives.wire_real_bytes_per_neighbor

    def broken(n_params, n_leaves, wire=None, compact_capacity=None,
               fire_bits=False):
        return orig(n_params, n_leaves, wire,
                    compact_capacity=compact_capacity, fire_bits=False)

    try:
        collectives.wire_real_bytes_per_neighbor = broken
        rep = _audit_with("event_masked_f32_tree", None, device)
    finally:
        collectives.wire_real_bytes_per_neighbor = orig
    return rep["metric_match"] is False, (
        f"metric {rep['metric_total']} != derived wire truth")


def oracle_host_callback(device=None) -> Tuple[bool, str]:
    """A host round trip inside the step: the sync a pipelined loop
    exists to delete."""
    def leak(ns, m, batch, topo, model):
        m["loss_host"] = float(m["loss"][0].item())

    rep = _audit_with("event_masked_f32_tree", _with_metric(leak), device)
    return rep["callbacks"] > 0, f"{rep['callbacks']} host callbacks"


def oracle_conv_rank_merge(device=None) -> Tuple[bool, str]:
    """The ranks merged rank-major into the channels (the legal layout
    `vmap` gives a convolution) but convolved with groups=1: every output
    channel reads every rank's channels. The legal merge carries groups
    divisible by the rank count and audits clean in the lenet and resnet
    cells."""
    def leak(ns, m, batch, topo, model):
        x = batch[0]  # [R, B, H, W, C]
        r, b, h, w, c = x.shape
        merged = x.permute(1, 0, 4, 2, 3).reshape(b, r * c, h, w)
        kern = torch.ones((2, r * c, 3, 3), dtype=x.dtype, device=x.device)
        m["leak"] = torch.sum(torch.nn.functional.conv2d(merged, kern))

    rep = _audit_with("lenet_masked_f32_arena", _with_metric(leak), device)
    hits = [r for r in rep["violation_details"]
            if "feature groups" in r or "conv" in r]
    return bool(hits), (f"{len(rep['violation_details'])} violations: "
                        f"{hits[:1]}")


def oracle_unregistered_kernel(device=None) -> Tuple[bool, str]:
    """A kernel op with no declared rank layout (`eg::leak_kernel`, TPU
    kernel 9): an opaque boundary the dataflow cannot see through must
    stay a violation, or any new kernel would bypass the audit."""
    def leak(ns, m, batch, topo, model):
        val = torch.broadcast_to(m["loss"][:, None, None],
                                 (m["loss"].shape[0], 8, 128))
        val = val.to(torch.float32).contiguous()
        m["leak"] = torch.sum(leak_kernel(val), dim=(1, 2))

    rep = _audit_with("event_masked_f32_arena_obs", _with_metric(leak),
                      device)
    hits = [r for r in rep["violation_details"]
            if "unregistered kernel" in r]
    return bool(hits), f"{hits[:1]}"


def oracle_attention_cross_rank_gather(device=None) -> Tuple[bool, str]:
    """A data-dependent gather across the rank dimension: each rank reads
    the parameters of a peer chosen by the losses instead of the
    topology's declared offsets."""
    def leak(ns, m, batch, topo, model):
        idx = torch.argsort(m["loss"])
        m["leak"] = torch.sum(torch.index_select(ns.params, 0, idx), dim=1)

    rep = _audit_with("xfmr_masked_f32_arena", _with_metric(leak), device)
    det = rep["violation_details"]
    detected = any("across the rank axis" in r for r in det)
    return detected, f"{len(det)} violations: {det[:1]}"


def oracle_partition_overlap(device=None) -> Tuple[bool, str]:
    """A partition geometry that double-claims a leaf: overlapping sends
    are last-writer-wins on the receive buffer, so training runs, just
    wrong. The micro cell's `partitions_ok` must go false."""
    orig = policy_lib.partition_masks

    def overlapping(spec, n_parts):
        masks = [list(mk) for mk in orig(spec, n_parts)]
        if len(masks) >= 2:
            grab = next((i for i, on in enumerate(masks[1]) if on), None)
            if grab is not None:
                masks[0][grab] = True
        return tuple(tuple(mk) for mk in masks)

    try:
        policy_lib.partition_masks = overlapping
        rep = audit_config(config_by_name("event_micro_compact_f32_arena"),
                           run_metric=False, device=device)
    finally:
        policy_lib.partition_masks = orig
    return rep["partitions_ok"] is False and not clean(rep), (
        f"partitions_ok={rep['partitions_ok']} "
        f"(sizes {[p['size'] for p in (rep['partitions'] or [])]})")


def oracle_stale_scale_reuse(device=None) -> Tuple[bool, str]:
    """The carrier commit sabotaged to keep the resident int8 scales: a
    fired leaf's carrier takes the candidate's values but the previous
    scale. Carrier-resident buffers are bitwise their f32-resident twin,
    so the clean carrier cell matches the f32 reference and the torn one
    diverges."""
    cfgc = config_by_name("event_masked_int8_arena_carrier")
    cfgf = dataclasses.replace(cfgc, name="carrier_f32_ref", carrier=False)

    def run(cfg, sabotage=None):
        orig = collectives.commit_carrier_scales
        try:
            if sabotage is not None:
                collectives.commit_carrier_scales = sabotage
            state, step, topo, _ = build(cfg, device)
            batch = _batch(cfg, device)
            for _ in range(4):
                state, _m = step(state, batch)
        finally:
            collectives.commit_carrier_scales = orig
        return state

    ref = run(cfgf)
    good = run(cfgc)
    bad = run(cfgc, sabotage=lambda cand, effs, last: last)
    clean_holds = torch.equal(ref.params, good.params)
    detected = clean_holds and not torch.equal(ref.params, bad.params)
    return detected, (
        "clean carrier cell == f32-resident twin bitwise; the scale-reuse "
        "commit diverges" if detected
        else "carrier equivalence harness failed to fire")


def _run_steps(cfg: AuditConfig, device, n_steps: int = 4,
               sabotage_bucket=None):
    """The state after `n_steps` steps of one cell on one batch: the
    value harness of the bounded-async oracles. `sabotage_bucket`
    replaces the step's queue seam (`events.async_bucket_commit`, which
    the step looks up at each call) for the run."""
    from eventgrad_tpu_torch.train import steps as steps_mod

    orig = steps_mod.async_bucket_commit
    try:
        if sabotage_bucket is not None:
            steps_mod.async_bucket_commit = sabotage_bucket
        state, step, _, _ = build(cfg, device)
        batch = _batch(cfg, device)
        for _ in range(n_steps):
            state, _m = step(state, batch)
    finally:
        steps_mod.async_bucket_commit = orig
    return state


def _queue_oracle(cfg2: AuditConfig, sabotage, device, what: str):
    """The bounded-async equivalence harness: staleness 2 at the
    baseline lag is bitwise staleness 1 (a late delivery is a deferred
    fire), so the clean D = 2 run equals the D = 1 reference and a
    sabotaged queue seam must leave it."""
    cfg1 = dataclasses.replace(cfg2, name=cfg2.name + "_stale1_ref",
                               staleness=1)
    ref = _run_steps(cfg1, device)
    good = _run_steps(cfg2, device)
    bad = _run_steps(cfg2, device, sabotage_bucket=sabotage)
    clean_holds = torch.equal(ref.params, good.params)
    detected = clean_holds and not torch.equal(ref.params, bad.params)
    return detected, (
        f"clean D=2 == D=1 bitwise; {what} diverges" if detected
        else "equivalence harness failed to fire")


def oracle_late_delivery_drift(device=None) -> Tuple[bool, str]:
    """The bounded-async arrival sabotaged by one pass: the commit takes
    queue slot 1 instead of slot 0, so every delivery lands a pass late
    (an off-by-one between commit-on-arrival and the queue). The
    staleness-2 == staleness-1 contract at the baseline lag must catch
    it."""
    from eventgrad_tpu_torch.parallel import events as events_mod

    cfg2 = dataclasses.replace(config_by_name("event_masked_f32_tree"),
                               name="masked_f32_arena_stale2", arena=True,
                               staleness=2)

    def late(slots, here, cand, eff, seg, bucket=None, cand_scale=None,
             last_scale=None):
        arr, ncs, nes, nss, bs = events_mod.async_bucket_commit(
            slots, here, cand, eff, seg, bucket=bucket,
            cand_scale=cand_scale, last_scale=last_scale)
        pick = lambda v: v if bucket is None else v[bucket]
        return (pick(slots[1][0]), pick(slots[1][1])), ncs, nes, nss, bs

    return _queue_oracle(cfg2, late, device,
                         "the arrival read a slot late")


def oracle_bucket_queue_skew(device=None) -> Tuple[bool, str]:
    """One bucket's delivery queue rotated by a slot without its clock
    (the per-bucket queue carry out of step with the shared sent/late
    stamps): the bucket commits another pass's payload, and the composed
    bucketed D = 2 == D = 1 contract must catch it."""
    from eventgrad_tpu_torch.parallel import events as events_mod

    cfg2 = dataclasses.replace(config_by_name("event_masked_f32_arena_b4"),
                               name="b4_stale2", staleness=2)

    def skewed(slots, here, cand, eff, seg, bucket=None, cand_scale=None,
               last_scale=None):
        arr, ncs, nes, nss, bs = events_mod.async_bucket_commit(
            slots, here, cand, eff, seg, bucket=bucket,
            cand_scale=cand_scale, last_scale=last_scale)
        if bucket == 0:
            ncs = tuple(ncs[1:]) + (ncs[0],)
            nes = tuple(nes[1:]) + (nes[0],)
        return arr, ncs, nes, nss, bs

    return _queue_oracle(cfg2, skewed, device,
                         "skewing one bucket's queue against its clock")


def oracle_bucket_undeclared_offset(device=None) -> Tuple[bool, str]:
    """One bucket's receive buffer re-shipped at an undeclared offset
    (+2) in the bucketed schedule: per-bucket exchanges must stay on the
    topology's declared offsets like every monolithic lane."""
    def leak(ns, m, batch, topo, model):
        m["leak"] = collectives.recv_from(
            ns.event.bufs[0][1], topo, NeighborSpec(topo.axes[0], 2))

    rep = _audit_with("event_masked_f32_arena_b4", _with_metric(leak),
                      device)
    detected = bool(rep["undeclared_offsets"]) or bool(
        rep["wire"]["problems"])
    return detected, f"undeclared exchange offsets {rep['undeclared_offsets']}"


ORACLES = {
    "rank_coupling_ppermute": oracle_rank_coupling,
    "rank_coupling_roll": oracle_rank_roll,
    "wire_dtype_upcast": oracle_wire_dtype_upcast,
    "extra_full_ravel": oracle_extra_ravel,
    "byte_formula_drift": oracle_byte_formula_drift,
    "host_callback": oracle_host_callback,
    "conv_rank_merge": oracle_conv_rank_merge,
    "unregistered_kernel": oracle_unregistered_kernel,
    "attention_cross_rank_gather": oracle_attention_cross_rank_gather,
    "partition_overlap": oracle_partition_overlap,
    "stale_scale_reuse": oracle_stale_scale_reuse,
    "late_delivery_drift": oracle_late_delivery_drift,
    "bucket_queue_skew": oracle_bucket_queue_skew,
    "bucket_undeclared_offset": oracle_bucket_undeclared_offset,
}

# --- the mesh lift's declared exchange ---------------------------------------


def mesh_lift_report(cfg_name: str, wrap=None, device=None) -> Dict[str, Any]:
    """One step of cell `cfg_name` lifted onto a device mesh
    (`spmd.build_mesh`: the process group's, or one process holding every
    rank, where every shift still runs through the lift's `Mesh.shift`),
    its step wrapped by `wrap(step, topo, model)`. The lift keeps a
    record of its shifts (`Mesh.exchange_log`), the exchange the mesh
    step declares; inside the lift a shift is a transfer, not a roll
    the rank-flow analysis could see, so the record is held to the
    topology's neighbour offsets directly (the JAX auditor's
    `shard_lift_report`)."""
    cfg = config_by_name(cfg_name)
    device = resolve_device(device)
    mesh = spmd.build_mesh(Ring(N_RANKS), device)
    state, step, topo, model = build(cfg, device, mesh=mesh)
    fn = step if wrap is None else wrap(step, topo, model)
    fn(multihost.put_stacked(state, mesh),
       tuple(map(topo.local_rows, _batch(cfg, device))))
    exchanged = sorted(mesh.exchange_log)
    declared = sorted((nb.axis, nb.offset) for nb in topo.neighbors)
    return {"cell": cfg.name, "exchange_offsets": exchanged,
            "declared_offsets": declared,
            "offsets_ok": set(exchanged) <= set(declared)}


def oracle_mesh_undeclared_offset(device=None) -> Tuple[bool, str]:
    """An undeclared shift (offset +2) smuggled into the MESH step's
    metrics: the lift's twin of `oracle_rank_coupling`. Inside the lift
    a shift is a point-to-point transfer, so the auditor must flag the
    stray offset in the lift's own record (`mesh_lift_report`)."""
    def leak(ns, m, batch, topo, model):
        m["leak"] = collectives.recv_from(
            m["loss"], topo, NeighborSpec(topo.axes[0], 2))

    rep = mesh_lift_report("event_masked_f32_arena_obs", _with_metric(leak),
                           device)
    extra = sorted(o for a, o in set(rep["exchange_offsets"])
                   - set(rep["declared_offsets"]))
    return not rep["offsets_ok"], f"undeclared mesh exchange offsets {extra}"


#: the oracles of the device-mesh lift (the JAX auditor's MESH_ORACLES)
MESH_ORACLES = {
    "mesh_undeclared_offset": oracle_mesh_undeclared_offset,
}


def oracle(name: str):
    """The oracle function `name` (of `ORACLES` or `MESH_ORACLES`)."""
    return {**ORACLES, **MESH_ORACLES}[name]


def run_oracles(device=None) -> List[Dict[str, Any]]:
    out = []
    for name in list(ORACLES) + list(MESH_ORACLES):
        detected, reason = oracle(name)(device=device)
        out.append({"name": name, "detected": bool(detected),
                    "reason": reason})
    return out


# --- CLI --------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Audit the port's train step: rank isolation, wire-byte "
        "truth, step hygiene, and the seeded oracles.")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="write the JSON record here")
    ap.add_argument("--census", action="store_true",
                    help="add each cell's op census to its report")
    args = ap.parse_args(argv)
    from eventgrad_tpu_torch.analysis import lint

    t0 = time.perf_counter()
    configs = audit_matrix(device=args.device, census=args.census)
    oracles = run_oracles(device=args.device)
    lint_v = lint.run()
    rec = {
        "bench": "audit",
        "impl": "torch",
        "platform": args.device,
        "device": (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu"),
        "op_point": (f"Ring({N_RANKS}) geometries "
                     f"{'+'.join(sorted(GEOMETRIES))} "
                     f"mlp_capacity={CAPACITY}"),
        "models": sorted(GEOMETRIES),
        "configs": configs,
        "n_configs": len(configs),
        "n_clean": sum(clean(c) for c in configs),
        "waiting_configs": WAITING,
        "oracles": oracles,
        "n_oracles": len(oracles),
        "n_detected": sum(o["detected"] for o in oracles),
        "lint_rules": len(lint.RULES),
        "lint_violations": len(lint_v),
        "wall_s": time.perf_counter() - t0,
    }
    text = json.dumps(rec, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    for c in configs:
        print(f"{c['name']:40s} clean={clean(c)!s:5s} "
              f"derived={c['wire_bytes_per_neighbor_derived']} "
              f"metric={c['wire_metric_total']} ops={c['kernel_ops']}",
              file=sys.stderr)
    print(f"{rec['n_clean']}/{rec['n_configs']} configs clean, "
          f"{rec['n_detected']}/{rec['n_oracles']} oracles detected, "
          f"{rec['lint_violations']} lint violations", file=sys.stderr)
    ok = (rec["n_clean"] == rec["n_configs"]
          and rec["n_detected"] == rec["n_oracles"]
          and rec["lint_violations"] == 0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
