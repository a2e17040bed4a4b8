"""The legs of `tests/test_torch_mesh.py` (not a test module): each runs
in every process of a gloo group (`_torch_dist.start`), and the primary
writes what the parent compares to a `torch.save` file. The parent runs
the simulator's side of each leg with the same functions and `mesh=None`.

  * `matrix` (W = 4, `Ring(4)`, one rank a process): the step-level
    matrix of `tests/test_mesh_parity.py` on the MLP, five steps a case,
    the full state and metrics gathered; then the scale leg, `Ring(16)`
    with the telemetry on, four ranks a process; then the grid
    collectives (`axis_sum`, `axis_mean`, `axis_all_to_all`) and their
    gradients on `dp:2,sp:4`, two ranks a process.
  * `pair` (W = 2): the four families on `Torus(2, 2)`; the `Ring(8)`
    MLP from a carried snapshot, uninterrupted and interrupted at epoch
    2 and resumed; a narrow ResNet-18 (BatchNorm, augmentation, momentum)
    on `Ring(8)` with EventGraD and D-PSGD; the `sp:2,dp:4`
    ring-attention LM (sp outer: every K/V hop crosses the process
    boundary); the "auto" resolution, a W that does not divide R, and
    the multi-process refusals.

A process computes with one torch thread, and the parent runs the
simulator's side of the ResNet leg with one thread too: a CPU reduction
split over threads splits it by the tensor's size, so a stack of four
rows would round otherwise than one of eight.
"""

import os

import numpy as np
import torch

from eventgrad_tpu_torch.data.datasets import (
    synthetic_dataset, synthetic_lm_dataset,
)
from eventgrad_tpu_torch.models import MLP, ResNet18
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.parallel import collectives, multihost, spmd
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.topology import Ring, Topology, Torus
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step

IN_SHAPE = (8, 8, 1)
PER_RANK = 4
STEPS = 5
HIDDEN = 8
CFG = dict(adaptive=True, horizon=0.9, warmup_passes=2, max_silence=4)


def _matrix_cases():
    cases = {}
    for gw in ("dense", "compact"):
        for wire in (None, "int8"):
            for k in (None, 4):
                for d in (0, 1):
                    cases[f"{gw}-{wire or 'f32'}-b{k or 1}-s{d}"] = dict(
                        gossip_wire=gw, wire=wire, bucketed=k, staleness=d)
    # bounded asynchrony at D = 2 (the baseline lag; the fault clauses
    # that stretch it are held on the lift by test_torch_mesh_chaos.py)
    for gw, wire in (("dense", None), ("compact", "int8")):
        cases[f"async-{gw}-{wire or 'f32'}-D2"] = dict(
            gossip_wire=gw, wire=wire, staleness=2)
    for wire in ("int8", "bf16"):
        for k in (None, 4):
            cases[f"carrier-{wire}-b{k or 1}"] = dict(
                wire=wire, bucketed=k, carrier=True)
    cases["telemetry-b4"] = dict(bucketed=4, obs=True)
    return cases


#: case name -> the step's options
MATRIX = _matrix_cases()


def _batches(n_ranks, steps=STEPS, seed=3):
    x, y = synthetic_dataset(n_ranks * PER_RANK * steps, IN_SHAPE, seed=seed)
    xb = torch.from_numpy(x).reshape((n_ranks, steps, PER_RANK) + IN_SHAPE)
    yb = torch.from_numpy(np.asarray(y, np.int64)).reshape(
        n_ranks, steps, PER_RANK)
    return [(xb[:, s], yb[:, s]) for s in range(steps)]


def run_steps(topo, mesh, *, gossip_wire="dense", wire=None, bucketed=None,
              staleness=0, carrier=False, obs=False, steps=STEPS):
    """Five eventgrad steps of the MLP on `topo` (the simulator with
    `mesh=None`): (the full final state as `to_flat`, the full last
    metrics)."""
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE)
    cfg = EventConfig(**CFG)
    state = init_train_state(
        model, IN_SHAPE, topo, "eventgrad", cfg, seed=0,
        resident_wire=wire if carrier else None, bucketed=bucketed or 1,
        staleness=staleness, obs=obs, device="cpu")
    # a non-binding capacity, so the bucketed split admits what the
    # monolithic gate admits
    capacity = arena_spec(model).n_total if gossip_wire == "compact" else None
    step = make_train_step(
        model, topo, "eventgrad", cfg, fused_sgd=(0.05, 0.0),
        gossip_wire=gossip_wire, compact_capacity=capacity, wire=wire,
        bucketed=bucketed, staleness=staleness, carrier_resident=carrier,
        obs=obs, mesh=mesh)
    lifted = spmd.lift(topo, mesh)
    state = multihost.put_stacked(state, mesh)
    m = None
    for xb, yb in _batches(topo.n_ranks, steps):
        state, m = step(state, (lifted.local_rows(xb),
                                lifted.local_rows(yb)))
    state = multihost.to_host(state, mesh)
    m = multihost.to_host(m, mesh)
    return state_lib.to_flat(state), m


#: the grid collectives' topology: the sp groups (4 members) span two
#: processes of two rows at W = 4, the dp pairs (rows r and r + 4) two
GRID_TOPO = Topology(axes=("dp", "sp"), shape=(2, 4), gossip_axes=("dp",))


def grid_collectives(axis, mesh):
    """`axis_sum`, `axis_mean`, `axis_all_to_all` along `axis` of
    GRID_TOPO on `[R, n, 3]` values, and the gradient of a fixed
    weighting of the three through them (the backward of each: its
    transpose), as full stacks."""
    topo = spmd.lift(GRID_TOPO, mesh)
    n = GRID_TOPO.axis_size(axis)
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.standard_normal(
        (GRID_TOPO.n_ranks, n, 3)).astype(np.float32)) for _ in range(2))
    x = topo.local_rows(x).clone().requires_grad_(True)
    w = topo.local_rows(w)
    outs = (collectives.axis_sum(x, topo, axis),
            collectives.axis_mean(x, topo, axis),
            collectives.axis_all_to_all(x, topo, axis))
    (grad,) = torch.autograd.grad(
        sum((o * w * (i + 1)).sum() for i, o in enumerate(outs)), x)
    return [multihost.to_host(v.detach(), mesh) for v in outs + (grad,)]


def matrix(out_dir):
    mesh = spmd.build_mesh(Ring(4), "cpu")
    out = {"cases": {name: run_steps(Ring(4), mesh, **kw)
                     for name, kw in MATRIX.items()},
           "n_local": mesh.n_local, "transport": mesh.transport}
    out["exchange_log"] = dict(mesh.exchange_log)
    scale = spmd.build_mesh(Ring(16), "cpu")
    out["scale"] = run_steps(Ring(16), scale, obs=True)
    out["scale_n_local"] = scale.n_local
    grid = spmd.build_mesh(GRID_TOPO, "cpu")
    out["grid"] = {a: grid_collectives(a, grid) for a in GRID_TOPO.axes}
    if multihost.is_primary():
        torch.save(out, os.path.join(out_dir, "matrix.pt"))


# --- pair ----------------------------------------------------------------------

#: the four families on Torus(2, 2): (algo, extra train() options)
FAMILIES = {
    "allreduce": {},
    "dpsgd": {},
    "eventgrad": {},
    "sp_eventgrad": {"sparse_cfg": SparseConfig(25.0)},
}
RING8 = dict(algo="eventgrad", batch_size=PER_RANK, learning_rate=0.05,
             random_sampler=True, seed=5)
LM_TOPO = Topology(axes=("sp", "dp"), shape=(2, 4), gossip_axes=("dp",))


def family_run(algo, backend):
    x, y = synthetic_dataset(4 * PER_RANK * 4, IN_SHAPE, seed=1)
    state, hist = train(
        MLP(hidden=HIDDEN, input_shape=IN_SHAPE), Torus(2, 2), x, y,
        algo=algo, epochs=2, batch_size=PER_RANK, learning_rate=0.05,
        event_cfg=EventConfig(**CFG), backend=backend, device="cpu",
        **FAMILIES[algo])
    return state_lib.to_flat(multihost.to_host(state)), hist


def ring8_data():
    return synthetic_dataset(8 * PER_RANK * 6, IN_SHAPE, seed=0)


def ring8_run(ck, epochs, backend, **kw):
    x, y = ring8_data()
    state, hist = train(
        MLP(hidden=16, input_shape=IN_SHAPE), Ring(8), x, y, epochs=epochs,
        event_cfg=EventConfig(**CFG), checkpoint_dir=ck, resume=True,
        backend=backend, device="cpu", **RING8, **kw)
    return state_lib.to_flat(multihost.to_host(state)), hist


def cnn_run(algo, backend):
    """A narrow ResNet-18 (4 filters) on CIFAR-shaped data, Ring(8), two
    epochs of two passes: BatchNorm statistics, the augmentation draws
    (the full `[R, ...]` lead, this process's rows) and the momentum
    trace through the lift."""
    x, y = synthetic_dataset(8 * PER_RANK * 2, (32, 32, 3), seed=2)
    kw = {"max_silence": 50} if algo == "eventgrad" else {}
    state, hist = train(
        ResNet18(num_filters=4), Ring(8), x, y, algo=algo, epochs=2,
        batch_size=PER_RANK, learning_rate=0.01, momentum=0.9,
        event_cfg=EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                              **kw),
        augment=True, random_sampler=True, seed=0, backend=backend,
        device="cpu")
    return state_lib.to_flat(multihost.to_host(state)), hist


#: the ResNet leg's algorithms
CNN_ALGOS = ("eventgrad", "dpsgd")


def lm_model():
    return TransformerLM(vocab=32, dim=16, n_heads=2, n_layers=1,
                         max_len=16, attn="ring", topo=LM_TOPO,
                         sp_axis="sp", device="cpu")


def lm_run(backend):
    x, y = synthetic_lm_dataset(64, 16, vocab=32, seed=13)
    state, hist = train(
        lm_model(), LM_TOPO, x, y, algo="eventgrad", epochs=2, batch_size=4,
        learning_rate=0.1, event_cfg=EventConfig(
            adaptive=True, horizon=0.9, warmup_passes=2),
        seed=9, backend=backend, device="cpu")
    return state_lib.to_flat(multihost.to_host(state)), hist


def _refusals():
    """The words of what a multi-process run refuses."""
    x, y = synthetic_dataset(4 * PER_RANK * 2, IN_SHAPE, seed=1)
    out = {}
    try:
        train(MLP(hidden=HIDDEN, input_shape=IN_SHAPE), Ring(4), x, y,
              algo="eventgrad", epochs=2, batch_size=PER_RANK,
              backend="mesh", pipeline=True, device="cpu")
    except ValueError as e:
        out["pipeline"] = str(e)
    try:
        spmd.build_mesh(Ring(3), "cpu")
    except ValueError as e:
        out["divides"] = str(e)
    return out


def pair(out_dir, ck_root):
    out = {"families": {a: family_run(a, "mesh") for a in FAMILIES}}
    out["ring8"] = ring8_run(os.path.join(ck_root, "a"), 3, "mesh")
    out["ring8_cut"] = ring8_run(os.path.join(ck_root, "b"), 2, "mesh",
                                 save_every=1)
    multihost.barrier("snapshot-read")
    out["ring8_resumed"] = ring8_run(os.path.join(ck_root, "b"), 3, "mesh",
                                     save_every=1)
    out["cnn"] = {a: cnn_run(a, "mesh") for a in CNN_ALGOS}
    out["lm"] = lm_run("mesh")
    auto = spmd.resolve_backend("auto", Ring(8), "cpu")
    out["auto"] = (type(auto).__name__, auto.n_procs, auto.lo, auto.hi,
                   auto.transport)
    out["refusals"] = _refusals()
    lifted = spmd.lift(Ring(8), auto)
    out["rows"] = (collectives.axis_index(lifted, "ring").tolist(),
                   spmd.rank_index(lifted).tolist())
    if multihost.is_primary():
        torch.save(out, os.path.join(out_dir, "pair.pt"))
