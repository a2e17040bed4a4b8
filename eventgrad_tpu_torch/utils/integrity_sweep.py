"""The integrity op-point: no corruption passes silently, the port's
counterpart of the JAX package's `tools/integrity_sweep.py` (reference
numbers in `artifacts/integrity_cpu.json`).

The chaos sweep's op-point (`utils/chaos_sweep.py`: MLP(hidden=32),
Ring(4), batch 16, 6 epochs of 32 passes, lr 0.1), training seed 0,
under `seed=13,bitflip=64-128@0.15,nanstep=2@144` with checksums on,
quarantine off and the sentinel with rollback and escalation on
(`max_rollbacks=1`). Every bitflip is rejected at the wire; the
nanstep lands, the sentinel trips, the loop restores the last-known-good
epoch, hardens the step (quarantine on) and replays, where the same
pass-keyed nanstep is quarantined. The ledger reconciles the observed
rejections and quarantines with the host-replayed ground truth
(`chaos.inject.corruption_table`; the replayed segment's draws are met
twice and counted twice): a corruption is silently accepted when it
enters the final trajectory undetected, and the count must be 0.

Legs: baseline (no chaos, no integrity), faulted, replay (the faulted
run again: parameters bitwise and every counter equal) and off
(`integrity="off"` against no integrity: parameters bitwise). The
reference's step-overhead leg is a CPU timing of the JAX step and has
no counterpart here; the riders' device time on the card is
`utils/profile_step.py --integrity`'s.

The committed artifact's schedule was drawn with JAX's original
Threefry counter layout (`jax_threefry_partitionable=False`: 83 flips;
the installed JAX's default layout draws 71), so the legs draw in that
layout, as `utils/chaos_sweep.py` does.

    python -m eventgrad_tpu_torch.utils.integrity_sweep --device cpu \
        [--seed N] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict

import torch

from eventgrad_tpu_torch.chaos import inject, prng
from eventgrad_tpu_torch.chaos.integrity import IntegrityConfig
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.utils import chaos_sweep
from eventgrad_tpu_torch.utils.devices import resolve_device

#: checksums on, quarantine off: the nanstep must land so that the
#: sentinel and the rollback run; escalation hardens the replay
FAULT_CFG = IntegrityConfig(checksum=True, quarantine=False, escalate=True,
                            max_rollbacks=1)
SCHED_SEED = 13


def fault_schedule(steps: int, epochs: int) -> ChaosSchedule:
    """The bitflip window across the middle third, one nanstep at ~2/3
    of the run after the window."""
    total = steps * epochs
    return ChaosSchedule.parse(
        f"seed={SCHED_SEED},bitflip={total // 3}-{2 * total // 3}@0.15,"
        f"nanstep=2@{2 * total // 3 + steps // 2}")


def ledger(sched: ChaosSchedule, steps: int, epochs: int, hist):
    """The zero-silent-acceptance accounting of the JAX sweep."""
    total = steps * epochs
    per_pass = inject.corruption_table(sched, Ring(chaos_sweep.N_RANKS),
                                       total).sum(axis=(1, 2))
    rbs = [r["integrity_rollback"] for r in hist if "integrity_rollback" in r]
    expected = int(per_pass.sum())
    replayed_nan = 0
    for rb in rbs:
        lo, hi = rb["restored_epoch"] * steps, rb["tripped_epoch"] * steps
        expected += int(per_pass[lo:hi].sum())
        replayed_nan += sum(1 for _r, t in sched.nanstep if lo < t <= hi)
    rejects = sum(r.get("wire_rejects", 0) for r in hist)
    quarantined = sum(r.get("quarantined_steps", 0) for r in hist)
    visits = inject.nansteps_in_range(sched, chaos_sweep.N_RANKS,
                                      total) + replayed_nan
    silent = (expected - rejects) + (visits - quarantined - replayed_nan)
    return {
        "injected_bitflips": expected, "injected_nansteps": visits,
        "wire_rejects": rejects, "quarantined_steps": quarantined,
        "rollback_covered_nansteps": replayed_nan,
        "silent_acceptances": silent, "rollbacks": len(rbs),
        "rollback": rbs[0] if rbs else None,
    }


def _same(a, b) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def _eq(a, b) -> bool:
    """Record values equal, a NaN loss (the tripped epoch's) included."""
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and math.isnan(a) and math.isnan(b))


def run_sweep(device=None, seed=0) -> Dict[str, Any]:
    device = resolve_device(device)
    t0 = time.perf_counter()
    point = chaos_sweep.train_point
    with prng.threefry_partitionable(False):
        st_base, h_base = point(device, seed)
        steps = h_base[0]["steps"]
        sched = fault_schedule(steps, chaos_sweep.EPOCHS)
        st_f, h_f = point(device, seed, chaos=sched, integrity=FAULT_CFG)
        st_r, h_r = point(device, seed, chaos=sched, integrity=FAULT_CFG)
        st_off, _ = point(device, seed, integrity="off")
        rec = {
            "bench": "integrity_torch", "device": str(device),
            "threefry_layout": "original",
            "op_point": {"model": f"mlp{chaos_sweep.HIDDEN}",
                         "n_ranks": chaos_sweep.N_RANKS,
                         "batch": chaos_sweep.BATCH,
                         "epochs": chaos_sweep.EPOCHS,
                         "steps_per_epoch": steps, "lr": chaos_sweep.LR},
            "schedule": sched.to_dict(), "integrity": FAULT_CFG.to_dict(),
            **ledger(sched, steps, chaos_sweep.EPOCHS, h_f),
        }
    keys = ("loss", "wire_rejects", "quarantined_steps",
            "integrity_rollbacks")
    rec.update(
        final_acc_baseline=h_base[-1]["test_accuracy"],
        final_acc_faulted=h_f[-1]["test_accuracy"],
        acc_gap_pt=h_base[-1]["test_accuracy"] - h_f[-1]["test_accuracy"],
        replay_bitwise=_same(st_f.params, st_r.params) and all(
            _eq(ra.get(k), rb.get(k)) for ra, rb in zip(h_f, h_r)
            for k in keys) and len(h_f) == len(h_r),
        integrity_off_bitwise=_same(st_base.params, st_off.params),
        params_finite=bool(torch.isfinite(st_f.params).all()),
        wall_s=time.perf_counter() - t0,
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    rec = run_sweep(args.device, args.seed)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(json.dumps(rec, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
