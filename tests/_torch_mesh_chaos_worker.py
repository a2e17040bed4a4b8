"""The legs of `tests/test_torch_mesh_chaos.py` (not a test module): they
run in both processes of a gloo group (`_torch_dist.start`), and the
primary writes what the parent compares to a `torch.save` file. The
parent runs the simulator's side of each leg with the same functions and
no mesh.

The MLP on `Ring(8)`, four rows a process, so that the ring's edges 3-4
and 7-0 cross the process boundary:

  * `train` under the fault clauses (`CASES`): EventGraD at staleness 2
    under drop, flaky, bitflip, nanstep, lag and slow with the in-step
    integrity riders (checksums and quarantine, no sentinel) and the
    recovery policy; D-PSGD under drop, flaky and die with the edge
    freeze; the bucketed schedule (K = 4) under drop, flaky and die with
    the policy (it refuses the riders as the JAX step does, so a nanstep
    there would spread its NaN). Telemetry on, so the records carry the
    message ledger;
  * single steps from the JAX package's state before each pass (written
    by the parent, `carried.pt`), under the schedules of `STEP_CASES`.
"""

import os
import time

import numpy as np
import torch

from eventgrad_tpu_torch.chaos.integrity import IntegrityConfig
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel import multihost, spmd
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.steps import make_train_step

R, IN_SHAPE, HIDDEN, PER_RANK, LR = 8, (8, 8, 1), 8, 4, 0.05
CFG = dict(adaptive=True, horizon=0.9, warmup_passes=2, max_silence=4)
#: the in-step riders alone: the sentinel/rollback engine is refused on
#: a mesh, as the JAX loop refuses it
RIDERS = dict(checksum=True, quarantine=True, sentinel=False, rollback=False)
POLICY = dict(sync_after=6, freeze_after=9)

#: case -> `train` options (two epochs of five passes)
CASES = {
    "eventgrad-async-integrity": dict(
        algo="eventgrad", staleness=2, momentum=0.9,
        chaos=("drop=0.2,seed=7,flaky=3-6@0.6,bitflip=2-9@0.5,nanstep=3@4,"
               "lag=4-7@2,slow=5@2"),
        integrity=RIDERS, chaos_policy=POLICY),
    "dpsgd": dict(algo="dpsgd", momentum=0.9,
                  chaos="drop=0.2,seed=7,flaky=3-6@0.6,die=6@7",
                  chaos_policy=dict(freeze_after=5)),
    "eventgrad-bucketed": dict(
        algo="eventgrad", bucketed=4,
        chaos="drop=0.25,seed=3,flaky=2-5@0.7,die=5@6",
        chaos_policy=POLICY),
}
#: case -> the single steps' options (MLP, no momentum, as the JAX
#: package's chaos tests run them): EventGraD with the riders under
#: drops, a flaky window, flips and a poisoned rank; D-PSGD under drops,
#: a flaky window and a death, with the freeze; EventGraD at staleness 2
#: under drops and a straggler
STEP_CASES = {
    "eventgrad-integrity": dict(
        algo="eventgrad",
        chaos="drop=0.2,seed=5,flaky=3-5@0.8,bitflip=2-6@0.5,nanstep=2@3",
        integrity=dict(checksum=True, quarantine=True), chaos_policy=POLICY),
    "dpsgd": dict(algo="dpsgd", chaos="drop=0.3,seed=2,flaky=3-5@0.9,die=2@2",
                  chaos_policy=dict(freeze_after=6)),
    "eventgrad-async": dict(algo="eventgrad", staleness=2,
                            chaos="drop=0.4,seed=3,slow=1@3,lag=3-5@2",
                            chaos_policy=POLICY),
}
STEPS = 6


def _options(kw):
    kw = dict(kw)
    if "integrity" in kw:
        kw["integrity"] = IntegrityConfig(**kw["integrity"])
    kw["chaos_policy"] = RecoveryPolicy(**kw["chaos_policy"])
    return kw


def model():
    return MLP(hidden=HIDDEN, input_shape=IN_SHAPE)


def train_run(case, mesh):
    """Two epochs of `train` under the case's faults (the simulator with
    `mesh=None`): (the gathered final state as `to_flat`, the records)."""
    x, y = synthetic_dataset(R * PER_RANK * 5, IN_SHAPE, seed=1)
    kw = _options(CASES[case])
    state, hist = train(
        model(), Ring(R), x, y, epochs=2, batch_size=PER_RANK,
        learning_rate=LR, event_cfg=EventConfig(**CFG), seed=0, obs="block",
        mesh=mesh, device="cpu", **kw)
    return state_lib.to_flat(multihost.to_host(state, mesh)), hist


def carried_run(case, carried, mesh):
    """The step under the case's faults from each carried pre-pass state
    (the simulator with `mesh=None`): per pass, (the gathered state, the
    gathered metrics as numpy)."""
    kw = _options(STEP_CASES[case])
    algo = kw.pop("algo")
    topo = Ring(R)
    lifted = spmd.lift(topo, mesh)
    step = make_train_step(model(), topo, algo, EventConfig(**CFG),
                           fused_sgd=(LR, 0.0), n_passes=STEPS, mesh=mesh,
                           **kw)
    out = []
    for before, (x, y) in carried[case]:
        state = multihost.put_stacked(before, mesh)
        xb = torch.from_numpy(np.asarray(x))
        yb = torch.from_numpy(np.asarray(y, np.int64))
        state, m = step(state, (lifted.local_rows(xb),
                                lifted.local_rows(yb)))
        out.append((multihost.to_host(state, mesh),
                    {k: v.numpy() for k, v in
                     multihost.to_host(m, mesh).items()}))
    return out


def chaos(out_dir):
    """Every case on a mesh of this group, with its crossing record."""
    out = {"train": {}, "crossed": {}, "carried": {}}
    for case in CASES:
        mesh = spmd.build_mesh(Ring(R), "cpu")
        out["train"][case] = train_run(case, mesh)
        out["crossed"][case] = dict(mesh.crossed)
    # the parent writes the JAX states once its JAX steps have run
    path = os.path.join(out_dir, "carried.pt")
    t_end = time.monotonic() + 300
    while not os.path.exists(path):
        if time.monotonic() > t_end:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.05)
    carried = torch.load(path, weights_only=False)
    for case in STEP_CASES:
        out["carried"][case] = carried_run(
            case, carried, spmd.build_mesh(Ring(R), "cpu"))
    if multihost.is_primary():
        torch.save(out, os.path.join(out_dir, "chaos.pt"))
