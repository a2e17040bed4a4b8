"""Train state: everything a rank mutates, rank-stacked.

Port of `eventgrad_tpu/train/state.py` (`TrainState`,
`init_train_state`). The state holds every rank of the topology:
parameters and the momentum trace as `[R, n]` f32 arenas
(`parallel/arena.py`), BatchNorm statistics as a dict of `[R, C]`
tensors (rank-local, never gossiped; empty for a model without BatchNorm), the event state for
EventGraD and sparsified EventGraD, the top-k shadows and replicas for
the latter, the pass counter, the step's random stream, and the
per-edge peer health of a run with a chaos schedule. Every rank
starts from the same parameters (the reference seeds every rank
identically); the random stream draws each rank's own dropout and
augmentation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.parallel.arena import arena_spec
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
    sparsified EventGraD: `SparseState.pending`). The random stream is
    seeded from `seed`.
    `device=None` means CUDA and raises without it."""
    device = resolve_device(device)
    if algo not in ALGOS:
        raise ValueError(f"unknown algo {algo!r}; one of {ALGOS}")
    model.check_input_shape(input_shape)
    spec = arena_spec(model)
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
    )
