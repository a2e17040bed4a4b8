"""eventgrad-tpu on PyTorch and CUDA: the port of the JAX package.

The JAX package `eventgrad_tpu` is the reference; this package grows
beside it slice by slice and mirrors its module paths, so every module
here has a counterpart there (`eventgrad_tpu_torch/parallel/events.py`
<-> `eventgrad_tpu/parallel/events.py`, and so on). It imports torch and
numpy only — never JAX, flax, optax or the JAX package.

The ranks of the simulated ring are a leading `[R, ...]` dimension on
one device (the rank-stacked lift, `parallel/spmd.py`). The flat
parameter arena (`parallel/arena.py`) holds each rank-stacked quantity
as one `[R, n]` tensor (f32, or the bf16/int8 wire carrier for
carrier-resident receive buffers), and the gossip tail runs through five
CUDA kernels written for Hopper (`csrc/*.cu`, bound in `ops/`). The
transformer LM (`models/transformer.py`) adds three more, the
flash-attention forward, dQ and dK/dV kernels (`ops/attention.py`).
Each kernel stands beside its plain PyTorch version. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.

Entry points (`train`, `evaluate`, `init_train_state`) take `device=`:
None means CUDA and raises when CUDA is absent.
"""

from eventgrad_tpu_torch.parallel.topology import Ring, Topology
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.models.resnet import ResNet, ResNet18
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.loop import (
    consensus_params, evaluate, rank0_slice, train,
)

__all__ = [
    "Ring", "Topology", "EventConfig", "EventState", "ResNet", "ResNet18",
    "TransformerLM",
    "TrainState", "init_train_state", "consensus_params", "evaluate",
    "rank0_slice", "train",
]
