"""The chaos op-point: drop-rate, flaky-window and ring-heal legs, the
port's counterpart of the JAX package's `tools/chaos_sweep.py`
(reference numbers in `artifacts/chaos_sweep_cpu.json`).

MLP(hidden=32) on 8x8x1 inputs, Ring(4), batch 16 per rank, SGD lr 0.1,
`synthetic_dataset(2048, seed=1)` with a test set of 256,
`EventConfig(adaptive=True, horizon=0.95, warmup_passes=5,
max_silence=5)`, the recovery policy `sync_after=12, freeze_after=24`:

  * drop curve — `train` for 6 epochs (192 passes) at drop 0 / 0.2 /
    0.5 (seed 0), beside the fault-free run; drop 0 must be bitwise the
    fault-free run. Each point records the host table's undelivered
    edges (`undelivered`): EventGraD counts a drop only where the sender
    fired, so its `chaos_drops` is at most that;
  * flaky window — a blackout `flaky=20-32@1.0`, 70 passes a step at a
    time with the consensus error after each; recovery latency = passes
    from the window's end until the error is back within 1.5x its level
    two passes before the window;
  * ring heal — `die=2@15`: 40 passes, detection when an edge's silence
    passes 3x max_silence (`monitor.edge_status` "suspect"), then
    `policy.apply_ring_heal` to the 3 survivors and 40 passes more;
    recovery = passes until the survivors' consensus error is back at
    its pre-heal level.

The committed artifact was drawn with JAX's original Threefry counter
layout (`jax_threefry_partitionable=False`, JAX's default when it was
made; with the installed JAX's default layout its schedules draw other
edges), so the legs always draw in that layout
(`chaos.prng.threefry_partitionable(False)`) to replay its faults.

    python -m eventgrad_tpu_torch.utils.chaos_sweep --device cpu \
        [--seed N] [--out FILE]

prints one JSON record. `chip_smoke.py` runs it on the card and holds
it to the JAX package's artifact.

    python -m eventgrad_tpu_torch.utils.chaos_sweep --device cpu \
        --spread 10 [--out FILE]

records instead the drop curve's test accuracies (fault-free, drop 0.2,
drop 0.5) for training seeds 0..9: the op-point's spread over seeds
(`artifacts/torch_chaos_seeds_cpu.json`), the floor `chip_smoke.py`
holds the card's fault-free run to.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import numpy as np
import torch

from eventgrad_tpu_torch.chaos import inject, monitor, prng
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy, apply_ring_heal
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule, FlakyWindow
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.data.sharding import epoch_index_plan
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.devices import resolve_device

N_RANKS, BATCH, LR, EPOCHS, HIDDEN = 4, 16, 0.1, 6, 32
IN_SHAPE = (8, 8, 1)
DROPS = (0.0, 0.2, 0.5)
EVENT_CFG = EventConfig(adaptive=True, horizon=0.95, warmup_passes=5,
                        max_silence=5)
POLICY = RecoveryPolicy(sync_after=12, freeze_after=24)


def data():
    x, y = synthetic_dataset(2048, IN_SHAPE, seed=1)
    xt, yt = synthetic_dataset(256, IN_SHAPE, seed=1, split="test")
    return x, y, xt, yt


def _model(device):
    return MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device=device)


def train_point(device, seed=0, chaos=None, policy=None, integrity=None,
                epochs=EPOCHS):
    """One `train` run of the op-point (also the integrity sweep's)."""
    x, y, xt, yt = data()
    return train(_model(device), Ring(N_RANKS), x, y, algo="eventgrad",
                 epochs=epochs, batch_size=BATCH, learning_rate=LR,
                 event_cfg=EVENT_CFG, seed=seed, x_test=xt, y_test=yt,
                 chaos=chaos, chaos_policy=policy, integrity=integrity,
                 device=device)


def _manual_leg(sched, passes, device, seed=0, topo=None, state=None,
                data_seed=2):
    """`passes` steps one at a time on `topo` (from `state`, or a fresh
    one), with the consensus error and the per-edge silence maxima after
    each (the JAX sweep's `_manual_leg`)."""
    topo = topo or Ring(N_RANKS)
    model = _model(device)
    x, y = synthetic_dataset(topo.n_ranks * BATCH * passes, IN_SHAPE,
                             seed=data_seed)
    idx = epoch_index_plan(len(x), topo.n_ranks, BATCH)
    xb = torch.as_tensor(x[idx], device=device)
    yb = torch.as_tensor(y[idx], dtype=torch.int64, device=device)
    if state is None:
        state = init_train_state(model, IN_SHAPE, topo, "eventgrad",
                                 EVENT_CFG, seed, device=device)
        state = state.replace(chaos=monitor.PeerHealth.init(topo, device))
    step = make_train_step(model, topo, "eventgrad", EVENT_CFG,
                           fused_sgd=(LR, 0.0), chaos=sched,
                           chaos_policy=POLICY, n_passes=passes)
    errs, silences = [], []
    for s in range(passes):
        k = s % xb.shape[1]
        state, _ = step(state, (xb[:, k], yb[:, k]))
        errs.append(float(monitor.consensus_error(state.params).max()))
        silences.append(state.chaos.silence.max(dim=0).values.cpu().numpy())
    return state, topo, np.asarray(errs), np.asarray(silences)


def flaky_leg(device, seed=0) -> Dict[str, Any]:
    w_start, w_end, passes = 20, 32, 70
    sched = ChaosSchedule(seed=seed, flaky=(FlakyWindow(w_start, w_end, 1.0),))
    _, _, errs, _ = _manual_leg(sched, passes, device, seed)
    pre = float(errs[w_start - 2])
    target = max(pre * 1.5, 1e-6)
    rec = next((p for p in range(w_end, passes) if errs[p] <= target), None)
    return {
        "schedule": sched.to_dict(), "policy": POLICY.to_dict(),
        "window": [w_start, w_end],
        "pre_window_consensus_err": pre,
        "peak_consensus_err": float(errs[w_start:w_end + 5].max()),
        "recovered": rec is not None,
        "recovery_latency_passes": None if rec is None else rec - w_end,
    }


def ring_heal_leg(device, seed=0) -> Dict[str, Any]:
    death_pass, pre_passes, dead = 15, 40, 2
    sched = ChaosSchedule(seed=seed, death=((dead, death_pass),))
    state, topo, errs, silences = _manual_leg(sched, pre_passes, device, seed)
    detect = next((p + 1 for p in range(pre_passes)
                   if monitor.edge_status(int(silences[p].max()),
                                          EVENT_CFG.max_silence)
                   == "suspect"), None)
    alive = torch.as_tensor([r for r in range(N_RANKS) if r != dead])
    pre_err = float(monitor.consensus_error(
        state.params[alive.to(state.params.device)]).max())
    healed, htopo, survivors = apply_ring_heal(state, topo, {dead})
    # the healed ring on its own data (the JAX leg's seed 4), no faults
    # left: the dead rank is gone from the topology
    _, _, heal_errs, _ = _manual_leg(ChaosSchedule(seed=seed), 40, device,
                                     seed, topo=htopo, state=healed,
                                     data_seed=4)
    target = max(pre_err, 1e-6)
    rec = next((i + 1 for i, e in enumerate(heal_errs) if e <= target), None)
    return {
        "schedule": sched.to_dict(), "policy": POLICY.to_dict(),
        "dead_rank": dead, "death_pass": death_pass,
        "detect_pass": detect,
        "detect_latency_passes": None if detect is None
        else detect - death_pass,
        "survivors": list(survivors),
        "pre_heal_survivor_consensus_err": pre_err,
        "healed_consensus_err_final": float(heal_errs[-1]),
        "recovered": rec is not None,
        "recovery_latency_passes": rec,
    }


def run_sweep(device=None, seed=0) -> Dict[str, Any]:
    """The three legs, drawn in the artifacts' Threefry layout."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    with prng.threefry_partitionable(False):
        base_state, base_hist = train_point(device, seed)
        out: Dict[str, Any] = {
            "bench": "chaos_sweep_torch", "device": str(device),
            "threefry_layout": "original",
            "op_point": {"model": f"mlp{HIDDEN}", "n_ranks": N_RANKS,
                         "batch": BATCH, "epochs": EPOCHS, "lr": LR,
                         "horizon": EVENT_CFG.horizon,
                         "max_silence": EVENT_CFG.max_silence},
            "policy": POLICY.to_dict(),
            "baseline_test_acc": base_hist[-1]["test_accuracy"],
            "points": [],
        }
        steps = base_hist[0]["steps"]
        for p in DROPS:
            sched = ChaosSchedule(seed=seed, drop_p=float(p))
            st, hist = train_point(device, seed, chaos=sched, policy=POLICY)
            table = inject.delivery_table(sched, Ring(N_RANKS),
                                          EPOCHS * steps)
            last = hist[-1]
            point = {
                "drop_p": float(p), "schedule": sched.to_dict(),
                "test_acc": last["test_accuracy"],
                "final_loss": last["loss"],
                "msgs_saved_pct": last["msgs_saved_pct"],
                "edge_silence_max": last["edge_silence_max"],
                "edge_status": last["edge_status"],
                "chaos_drops": last["chaos_drops"],
                "undelivered": int((~table).sum()),
                "consensus_err_max": last["consensus_err_max"],
            }
            if p == 0.0:
                point["bitwise_identical_to_baseline"] = bool(torch.equal(
                    base_state.params.view(torch.int32),
                    st.params.view(torch.int32)))
            out["points"].append(point)
        out["flaky_recovery"] = flaky_leg(device, seed)
        out["ring_heal"] = ring_heal_leg(device, seed)
    out["wall_s"] = time.perf_counter() - t0
    return out


def run_spread(device=None, n_seeds=10) -> Dict[str, Any]:
    """The drop curve's test accuracies for training seeds 0..n_seeds-1
    (schedule seed = training seed, as `run_sweep(seed=...)`)."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    seeds = []
    with prng.threefry_partitionable(False):
        for seed in range(n_seeds):
            _, hist = train_point(device, seed)
            row = {"seed": seed,
                   "baseline_test_acc": hist[-1]["test_accuracy"]}
            for p in DROPS[1:]:
                _, hist = train_point(
                    device, seed, chaos=ChaosSchedule(seed=seed, drop_p=p),
                    policy=POLICY)
                row[f"test_acc_drop{p}"] = hist[-1]["test_accuracy"]
            seeds.append(row)
    base = [r["baseline_test_acc"] for r in seeds]
    return {"bench": "chaos_sweep_torch_seeds", "device": str(device),
            "threefry_layout": "original", "seeds": seeds,
            "min_baseline_test_acc": min(base),
            "max_baseline_test_acc": max(base),
            "wall_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spread", type=int, default=None, metavar="N",
                    help="record the drop curve's accuracies for training "
                    "seeds 0..N-1 instead of the sweep")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    rec = (run_sweep(args.device, args.seed) if args.spread is None
           else run_spread(args.device, args.spread))
    text = json.dumps(rec)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(json.dumps(rec, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
