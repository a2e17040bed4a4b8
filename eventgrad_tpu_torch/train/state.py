"""Train state: everything a rank mutates, rank-stacked.

Port of `eventgrad_tpu/train/state.py` (`TrainState`,
`init_train_state`). The state holds every rank of the topology:
parameters and the momentum trace as `[R, n]` f32 arenas
(`parallel/arena.py`), BatchNorm statistics as a dict of `[R, C]`
tensors (rank-local, never gossiped; empty for a model without BatchNorm), the event state for EventGraD,
and the pass counter. Every rank starts from the same parameters (the
reference seeds every rank identically).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.spmd import stack_for_ranks
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.utils.devices import resolve_device


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
    `device=None` means CUDA and raises without it."""
    device = resolve_device(device)
    if algo not in ("eventgrad", "dpsgd"):
        raise NotImplementedError(
            f"algo {algo!r} is not ported yet (eventgrad, dpsgd)"
        )
    model.check_input_shape(input_shape)
    spec = arena_spec(model)
    params, stats = model.init_variables(seed, device=device)
    flat = stack_for_ranks(spec.ravel(params), topo)
    event = None
    if algo == "eventgrad":
        event = EventState.init(spec, topo, event_cfg or EventConfig(),
                                resident_wire=resident_wire, device=device)
    return TrainState(
        params=flat,
        trace=torch.zeros_like(flat) if momentum else None,
        batch_stats=stack_for_ranks(stats, topo),
        pass_num=0,
        event=event,
    )
