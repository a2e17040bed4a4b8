"""eventgrad-tpu on PyTorch and CUDA: the port of the JAX package.

The JAX package `eventgrad_tpu` is the reference; this package grows
beside it slice by slice and mirrors its module paths, so every module
here has a counterpart there (`eventgrad_tpu_torch/parallel/events.py`
<-> `eventgrad_tpu/parallel/events.py`, and so on). It imports torch and
numpy only — never JAX, flax, optax or the JAX package.

It trains the four algorithm families of the JAX package (allreduce,
D-PSGD, EventGraD, sparsified EventGraD) on the MLP, the MNIST CNNs, the
CIFAR LeNet, the BasicBlock and Bottleneck ResNets and the transformer LM (with
ring or Ulysses attention inside the model, and its tensor-, pipeline-
and expert-parallel forms), over rings, 2-D tori and hybrid meshes (a
gossip axis with sequence-parallel, data-parallel-allreduce, tensor,
pipeline or expert axes). The ranks of the simulated topology are a leading
`[R, ...]` dimension on one device (the rank-stacked lift, `parallel/spmd.py`). The flat
parameter arena (`parallel/arena.py`) holds each rank-stacked quantity
as one `[R, n]` tensor (f32, or the bf16/int8 wire carrier for
carrier-resident receive buffers); the event exchange ships on the
masked wire or the compact static-capacity wire, under the norm-delta,
top-k, micro or hybrid trigger policy (`parallel/policy.py`), monolithic
or bucket by bucket (the bucketed schedule), with staleness 0, 1 or the
bounded-async D >= 2 delivery queues, under the seeded fault clauses,
the recovery policies and the integrity engine (`chaos/`); and the
gossip tail runs through five
CUDA kernels written for Hopper (`csrc/*.cu`, bound in `ops/`). The
transformer LM (`models/transformer.py`) adds three more, the
flash-attention forward, dQ and dK/dV kernels (`ops/attention.py`).
Each kernel stands beside its plain PyTorch version. A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. The on-device telemetry, the
message-lifecycle ledger and the host registry of spans, gauges and
records (`obs/`) observe a run without changing it.

Entry points (`train`, `evaluate`, `init_train_state`) take `device=`:
None means CUDA and raises when CUDA is absent.
"""

from eventgrad_tpu_torch.parallel.topology import Ring, Topology, Torus
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.models import (
    CNN1, CNN2, MLP, MODEL_REGISTRY, LeNetCifar, ResNet, ResNet18, ResNet34,
    ResNet50, ResNet101, ResNet152,
)
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.loop import (
    consensus_params, evaluate, rank0_slice, train,
)

__all__ = [
    "Ring", "Topology", "Torus", "EventConfig", "EventState", "SparseConfig",
    "CNN1", "CNN2", "MLP", "MODEL_REGISTRY", "LeNetCifar", "ResNet",
    "ResNet18", "ResNet34", "ResNet50", "ResNet101", "ResNet152",
    "TransformerLM",
    "TrainState", "init_train_state", "consensus_params", "evaluate",
    "rank0_slice", "train",
]
