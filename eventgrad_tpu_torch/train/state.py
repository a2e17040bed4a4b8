"""Train state: everything a rank mutates, rank-stacked.

Port of `eventgrad_tpu/train/state.py` (`TrainState`,
`init_train_state`). The state holds every rank of the topology:
parameters and the momentum trace as `[R, n]` f32 arenas
(`parallel/arena.py`), BatchNorm statistics as a dict of `[R, C]`
tensors (rank-local, never gossiped; empty for a model without BatchNorm), the event state for
EventGraD and sparsified EventGraD, the top-k shadows and replicas for
the latter, the pass counter, the step's random stream, the
per-edge peer health of a run with a chaos schedule, and the cumulative
telemetry counters of a run with telemetry on (`obs/device.py`). Every rank
starts from the same parameters (the reference seeds every rank
identically); the random stream draws each rank's own dropout and
augmentation.

`to_flat` / `from_flat` carry a state through a flat ``{path: tensor}``
dict, every field included (the random stream as its
`torch.Generator.get_state()` bytes), with the paths spelled as the JAX
package's checkpoint spells its leaves (``state/event/bufs/0``);
`layout` names what a resume must match, and `payload` is the
(tensors, manifest) pair `utils/checkpoint.save` writes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.obs.device import TelemetryState
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.collectives import axis_index
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig, SparseState
from eventgrad_tpu_torch.parallel.spmd import stack_for_ranks
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.utils.devices import resolve_device

#: the four algorithm families, and those with an event trigger
ALGOS = ("allreduce", "dpsgd", "eventgrad", "sp_eventgrad")
EVENT_ALGOS = ("eventgrad", "sp_eventgrad")


@dataclasses.dataclass
class TrainState:
    #: f32 [R, n] parameter arena
    params: torch.Tensor
    #: f32 [R, n] momentum trace (optax's sgd trace); None without momentum
    trace: Optional[torch.Tensor]
    #: f32 [R, C] BatchNorm running statistics, flax order
    batch_stats: Dict[str, torch.Tensor]
    #: passes run so far (the same on every rank)
    pass_num: int = 0
    event: Optional[EventState] = None
    sparse: Optional[SparseState] = None
    #: the step's random stream on the state's device (dropout keep bits,
    #: augmentation draws); a model without dropout and a step without
    #: augmentation draw nothing from it
    rng: Optional[torch.Generator] = None
    #: per-edge peer health (`chaos/monitor.py`), carried when the step
    #: runs a chaos schedule; None otherwise
    chaos: Optional[PeerHealth] = None
    #: cumulative telemetry counters and the message ledger
    #: (`obs/device.py`), carried when telemetry is on; None otherwise
    telemetry: Optional[TelemetryState] = None

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


def init_train_state(
    model,
    input_shape,
    topo: Topology,
    algo: str,
    event_cfg: Optional[EventConfig] = None,
    seed: int = 0,
    *,
    momentum: float = 0.0,
    resident_wire=None,
    bucketed: Optional[int] = None,
    staleness: int = 0,
    sparse_cfg: Optional[SparseConfig] = None,
    obs: bool = False,
    device=None,
) -> TrainState:
    """A rank-stacked TrainState for `topo.n_ranks` ranks, initialized
    like flax from `seed` (the model's `init_variables`; `input_shape` is
    one sample's shape, checked by the model's `check_input_shape`). A
    model without BatchNorm has an empty `batch_stats` dict, as flax's. `momentum` nonzero
    carries a momentum trace (optax.sgd(momentum=...)). `resident_wire`
    ("bf16" | "int8"; eventgrad) holds the receive buffers carrier-
    resident: in the wire dtype, with the int8 dequant scales in
    `EventState.buf_scales` — the layout of a `carrier_resident` step.
    sp_eventgrad carries the trigger's event state (no receive buffers)
    and a `SparseState` whose shadows start as copies of the parameters
    (its layout does not depend on the top-k percent, so unlike the JAX
    function this one needs `sparse_cfg` only for staleness >= 2, whose
    payload queues hold the top-k lanes). `bucketed=K` (eventgrad) holds
    the receive buffers per bucket, the layout of a `bucketed=K` step;
    `staleness=D` (D >= 2) adds the bounded-async delivery queues
    (EventGraD: `EventState.pending`, `edge_clock`, `late_commits`;
    sparsified EventGraD: `SparseState.pending`). `obs=True` adds the
    zeroed telemetry counters (`TelemetryState`, with the message
    ledger's in-flight queues D deep at staleness D >= 2), the state of
    a `make_train_step(..., obs=True)` step. The random stream is seeded
    from `seed`. A model sharded over an axis of the topology
    (`shard_axis`: the tensor-, pipeline- and expert-parallel
    transformers) draws each rank's `tp_` leaves for its index on that
    axis and every other leaf once, from `seed` alone
    (`models.transformer.init_lm_shards`), the contract of the JAX
    package's `init_train_state_spmd`.
    `device=None` means CUDA and raises without it."""
    device = resolve_device(device)
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
    model.check_input_shape(input_shape)
    spec = arena_spec(model)
    axis = getattr(model, "shard_axis", None)
    if axis in topo.axes and topo.axis_size(axis) > 1:
        # sharded leaves distinct per index of the model's axis, every
        # replicated leaf the same on the whole mesh
        idx = axis_index(topo, axis).tolist()
        shards = sorted(set(idx))
        rows = dict(zip(shards, map(spec.ravel, model.init_shards(
            seed, shards, device=device))))
        flat = torch.stack([rows[i] for i in idx])
        stats = {}
    else:
        params, stats = model.init_variables(seed, device=device)
        flat = stack_for_ranks(spec.ravel(params), topo)
    event = sparse = None
    if algo in EVENT_ALGOS:
        event = EventState.init(spec, topo, event_cfg or EventConfig(),
                                resident_wire=resident_wire, device=device,
                                with_bufs=algo == "eventgrad",
                                buckets=bucketed or 1, staleness=staleness)
    if algo == "sp_eventgrad":
        sparse = SparseState.init(flat, topo, sparse_cfg or SparseConfig(),
                                  spec, staleness=staleness)
    telemetry = None
    if obs:
        telemetry = TelemetryState.init(
            spec.n_leaves, topo.n_neighbors,
            n_buckets=min(bucketed or 1, spec.n_leaves),
            queue_depth=staleness if staleness >= 2 else 0,
            n_ranks=topo.n_ranks, device=device)
    # a stream of its own, apart from the weights' (seeded with `seed`)
    rng_seed = int(np.random.SeedSequence([int(seed), 1]).generate_state(1)[0])
    return TrainState(
        params=flat,
        trace=torch.zeros_like(flat) if momentum else None,
        batch_stats=stack_for_ranks(stats, topo),
        pass_num=0,
        event=event,
        sparse=sparse,
        rng=torch.Generator(device=device).manual_seed(rng_seed),
        telemetry=telemetry,
    )


def _flatten(x, path: str, out: Dict[str, torch.Tensor]) -> None:
    if x is None:
        return
    if isinstance(x, torch.Tensor):
        out[path] = x
    elif isinstance(x, torch.Generator):
        out[path] = x.get_state()
    elif isinstance(x, int):
        out[path] = torch.tensor(x, dtype=torch.int64)
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            _flatten(v, f"{path}/{i}", out)
    elif isinstance(x, dict):
        for k, v in x.items():
            _flatten(v, f"{path}/{k.replace('.', '/')}", out)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _flatten(getattr(x, f.name), f"{path}/{f.name}", out)
    else:
        raise TypeError(f"{path}: no flat form for {type(x).__name__}")


def _rebuild(x, path: str, flat: Dict[str, torch.Tensor]):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return flat[path]
    if isinstance(x, torch.Generator):
        # the state bytes live on the host; set_state runs on the
        # template's generator device (a CUDA stream stays on the card)
        g = torch.Generator(device=x.device)
        g.set_state(flat[path].cpu())
        return g
    if isinstance(x, int):
        return int(flat[path])
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, f"{path}/{i}", flat)
                       for i, v in enumerate(x))
    if isinstance(x, dict):
        return {k: _rebuild(v, f"{path}/{k.replace('.', '/')}", flat)
                for k, v in x.items()}
    return dataclasses.replace(x, **{
        f.name: _rebuild(getattr(x, f.name), f"{path}/{f.name}", flat)
        for f in dataclasses.fields(x)})


def to_flat(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every field of `state` as a flat ``{path: tensor}`` dict (the
    tensors themselves, not copies): nested dataclasses by field name,
    tuples by index, BatchNorm keys with `/` for `.`, `pass_num` as an
    int64 scalar, the random stream as its state bytes; None fields
    have no entry."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(state, "state", out)
    return out


def from_flat(template: TrainState, flat: Dict[str, torch.Tensor]
              ) -> TrainState:
    """The state of `template`'s structure holding `flat`'s values (a
    `to_flat` dict of the same structure, e.g. restored from a
    snapshot); the random stream is rebuilt on the template's device."""
    return _rebuild(template, "state", flat)


def layout(state: TrainState, algo: str) -> Dict[str, Any]:
    """The layout keys a resume must match: algo, ranks R, arena size n,
    the receive buffers' resident dtype ("f32" | "bf16" | "int8"), the
    bounded-async queue depth D (0 = no queues) and the bucket count K
    of the receive buffers."""
    r, n = state.params.shape
    resident, depth, k = "f32", 0, 1
    ev, sp = state.event, state.sparse
    if ev is not None:
        if ev.bufs:
            b0 = ev.bufs[0]
            if isinstance(b0, tuple):
                k, b0 = len(b0), b0[0]
            resident = {torch.int8: "int8",
                        torch.bfloat16: "bf16"}.get(b0.dtype, "f32")
        if ev.pending:
            depth = len(ev.pending[0])
    if sp is not None and sp.pending:
        depth = len(sp.pending[0])
    return {"algo": algo, "ranks": int(r), "n_params": int(n),
            "resident_dtype": resident, "staleness_depth": depth,
            "buckets": k}


def payload(state: TrainState, epoch: int, algo: str
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The snapshot of `state` after `epoch`: (its `to_flat` tensors, the
    manifest entries `utils/checkpoint.save` writes beside them)."""
    return to_flat(state), {
        "epoch": int(epoch), "layout": layout(state, algo),
        "device": state.params.device.type,
    }
