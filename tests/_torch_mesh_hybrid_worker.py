"""The legs of `tests/test_torch_mesh_hybrid.py` (not a test module): they
run in both processes of a gloo group (`_torch_dist.start`), and the
primary writes what the parent compares to a `torch.save` file. The
parent runs the simulator's side of each leg with the same functions and
no mesh.

Four model families on an 8-rank grid whose sharded (or sequence) axis
is the outer one, so that at W = 2 process p holds index p of that axis
and each of its collectives crosses the process boundary:

  * the tensor-parallel transformer on `tp:2,dp:4` (the forward sums and
    their transposes, the gradient corrections over tp);
  * the pipeline on `pp:2,dp:4` (GPipe's stage shifts, one a tick, and
    the last stage's broadcast sum);
  * the expert-parallel MoE on `ep:4,dp:2` (the all-to-all pair, two
    experts' rows a process);
  * Ulysses attention through the flash path on `sp:2,dp:4` (the two
    all-to-alls and the gradient mean over sp).

Each family runs two passes of its step from the state carried from the
JAX package (`_torch_hybrid.carried_start`, written by the parent) and
`train` from the seed, with the mesh's record of the bytes each
collective sent across processes (`spmd.Mesh.crossed`).
"""

import os

import numpy as np
import torch

from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset
from eventgrad_tpu_torch.models.moe import MoETransformerLM
from eventgrad_tpu_torch.models.pp import PPTransformerLM
from eventgrad_tpu_torch.models.tp import TPTransformerLM
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.parallel import multihost, spmd
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.steps import make_train_step

#: the small LM of the hybrid tests (`_torch_hybrid.LM`) at one layer
#: (the pipeline at two, one a stage), the experts of the MoE family and
#: the pipeline's microbatches
LM = dict(vocab=32, dim=32, n_heads=2, n_layers=1, max_len=16)
N_EXPERTS, N_MICRO = 4, 2
SHARDED = ("tp", "pp", "ep")
#: family -> its mesh, the sharded (or sequence) axis outer
FAMILIES = {"tp": "tp:2,dp:4", "pp": "pp:2,dp:4", "moe": "ep:4,dp:2",
            "ulysses": "sp:2,dp:4"}
#: the collectives each family's `train` sends across the two processes:
#: (kind, axis) of `spmd.Mesh.crossed`. The dp rings lie within a
#: process, so no gossip crosses; each sharded axis also carries the
#: gradient corrections' sums
CROSSED = {"tp": {("fold", "tp")},
           "pp": {("hop", "pp"), ("fold", "pp")},
           "moe": {("swap", "ep"), ("fold", "ep")},
           "ulysses": {("swap", "sp"), ("fold", "sp")}}
TRAIN = dict(algo="eventgrad", epochs=2, batch_size=2, learning_rate=0.1,
             momentum=0.9, seed=9, device="cpu")


def topology(family) -> Topology:
    """The family's mesh, classed as the CLI classes it."""
    axes, shape = zip(*((a, int(n)) for a, n in (
        part.split(":") for part in FAMILIES[family].split(","))))
    return Topology(axes=axes, shape=shape, gossip_axes=("dp",),
                    sharded_axes=tuple(a for a in axes if a in SHARDED))


def model(family, topo):
    """The port's model of the family on `topo` (unlifted)."""
    if family == "tp":
        return TPTransformerLM(**LM, axis="tp", tp_size=2)
    if family == "pp":
        return PPTransformerLM(**dict(LM, n_layers=2), axis="pp", pp_size=2,
                               n_micro=N_MICRO)
    if family == "moe":
        return MoETransformerLM(**LM, n_experts=N_EXPERTS, axis="ep",
                                ep_size=4)
    return TransformerLM(**LM, attn="ulysses", topo=topo, sp_axis="sp",
                         use_flash=True)


def train_run(family, mesh):
    """`train` from the seed on the family's mesh (the simulator with
    `mesh=None`): (the gathered final state as `to_flat`, the records)."""
    topo = topology(family)
    x, y = synthetic_lm_dataset(topo.n_data_ranks * 2 * 3, LM["max_len"],
                                vocab=LM["vocab"], seed=13)
    state, hist = train(
        model(family, topo), topo, x, y,
        event_cfg=EventConfig(adaptive=True, horizon=0.9, warmup_passes=2,
                              max_silence=4),
        mesh=mesh, **TRAIN)
    return state_lib.to_flat(multihost.to_host(state, mesh)), hist


def carried_run(family, carried, mesh):
    """The port's EventGraD step (its trace on) from the carried state
    over the carried batches on the family's mesh (the simulator with
    `mesh=None`), with the carried step options (`_torch_hybrid`'s):
    per pass, (the gathered state, the gathered metrics)."""
    topo = topology(family)
    lifted = spmd.lift(topo, mesh)
    step = make_train_step(
        model(family, topo), topo, "eventgrad",
        EventConfig(**carried["cfg"]), fused_sgd=carried["sgd"], trace=True,
        mesh=mesh)
    start, batches = carried[family]
    state = multihost.put_stacked(start, mesh)
    out = []
    for x, y in batches:
        xb = torch.from_numpy(np.asarray(x, np.int64))
        yb = torch.from_numpy(np.asarray(y, np.int64))
        state, m = step(state, (lifted.local_rows(xb),
                                lifted.local_rows(yb)))
        out.append((multihost.to_host(state, mesh),
                    {k: v.numpy() for k, v in
                     multihost.to_host(m, mesh).items()}))
    return out


def hybrid(out_dir):
    """Every family on a mesh of this group: the carried passes, then
    `train` with the mesh's crossing record."""
    carried = torch.load(os.path.join(out_dir, "carried.pt"),
                         weights_only=False)
    out = {"carried": {}, "train": {}, "crossed": {}}
    for family in FAMILIES:
        topo = topology(family)
        out["carried"][family] = carried_run(
            family, carried, spmd.build_mesh(topo, "cpu"))
        mesh = spmd.build_mesh(topo, "cpu")
        out["train"][family] = train_run(family, mesh)
        out["crossed"][family] = dict(mesh.crossed)
        out.setdefault("rows", (mesh.n_procs, mesh.lo, mesh.hi))
    if multihost.is_primary():
        torch.save(out, os.path.join(out_dir, "hybrid.pt"))

