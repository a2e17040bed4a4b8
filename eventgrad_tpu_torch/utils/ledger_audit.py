"""Message-lifecycle conservation audit: every message's fate, accounted.

Port of `tools/ledger_audit.py` at its op-point: MLP(hidden=16),
Ring(4), batch 8, 256 synthetic samples, 3 epochs, lr 0.05, EventGraD
with `EventConfig(adaptive=True, horizon=0.95, warmup_passes=2,
max_silence=4)`, bounded-async staleness D = 2, the compact wire at
`compact_frac` 0.5 (dense through the warmup, then compact), the chaos
schedule `seed=7,drop=0.2,bitflip=4-20@0.2,lag=0-12@2,nanstep=1@3,
nanstep=2@5` and the integrity checksums and quarantine. Every
disposition of the taxonomy is live there: suppressed by the quarantined
passes, deferred by the capacity gate, dropped by the chaos drops,
rejected by the checksums, late_committed and in_flight by the delivery
queue. Three legs:

  * composed: `train(obs="epoch")`; every flush window's conservation
    audit holds with integer equality (zero violations) and every
    disposition row is above 0;
  * oracles: the same run with each seeded leak armed
    (`EG_LEDGER_LEAK=uncounted_drop | double_reject`, set in this
    process around the run: the step reads it when it is built); the
    auditor must catch both, naming the broken law;
  * off: `obs="off"` twice against the ledgered run: the whole final
    train state (parameters, trace, event state, receive buffers, queues,
    peer health, random stream) bitwise equal: the ledger observes, it
    never changes the run.

The counts are not the JAX artifact's (`artifacts/ledger_conservation_
cpu.json`): the port's leaf norms reduce in another order, so fire
decisions drift apart over the run, and on the card the reductions
differ again. The laws, not the counts, are the contract.

    python -m eventgrad_tpu_torch.utils.ledger_audit --device cpu \\
        [--epochs 3] [--seed 0] [--out artifacts/torch_ledger_conservation_cpu.json]

On the card (`--device cuda`, the default device) the legs run under
`torch.use_deterministic_algorithms(True)` with `CUBLAS_WORKSPACE_CONFIG`
set before CUDA starts. The run is timed by a `Registry` span.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
from typing import Any, Dict, List

import torch

from eventgrad_tpu_torch.chaos.integrity import IntegrityConfig
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.obs import Registry
from eventgrad_tpu_torch.obs import ledger as obs_ledger
from eventgrad_tpu_torch.obs.schema import LEDGER_COUNTER_ROWS
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.utils.devices import resolve_device

LEDGER_SCHEMA_VERSION = 1
N_RANKS = 4
BATCH = 8
N_PER_RANK = 64
#: drops and bitflips throughout, a lag window over the first half (so
#: late commits are a strict sub-count of delivered), two nansteps early
#: enough that the quarantined rank still proposes densely
CHAOS_SPEC = ("seed=7,drop=0.2,bitflip=4-20@0.2,lag=0-12@2,"
              "nanstep=1@3,nanstep=2@5")
EVENT_CFG = EventConfig(adaptive=True, horizon=0.95, warmup_passes=2,
                        max_silence=4)


def run_leg(x, y, epochs: int, seed: int, device, obs: str = "epoch"):
    """(final state, history) of the op-point's run."""
    return train(
        MLP(hidden=16, input_shape=(8, 8, 1), device=device),
        Ring(N_RANKS), x, y, algo="eventgrad", epochs=epochs,
        batch_size=BATCH, learning_rate=0.05, event_cfg=EVENT_CFG,
        seed=seed, staleness=2, gossip_wire="compact", compact_frac=0.5,
        chaos=ChaosSchedule.parse(CHAOS_SPEC),
        integrity=IntegrityConfig(checksum=True, quarantine=True),
        obs=obs, log_every_epoch=False, device=device,
    )


def fold_windows(history) -> Dict[str, Any]:
    """The per-window ledger blocks and audits -> windows, run totals,
    checks and violations."""
    windows: List[Dict[str, Any]] = []
    totals = {name: 0 for name in LEDGER_COUNTER_ROWS}
    checks = 0
    violations: List[Dict[str, Any]] = []
    in_flight_final = 0
    for rec in history:
        obs = rec.get("obs")
        if not obs or "message_ledger" not in obs:
            continue
        blk, aud = obs["message_ledger"], obs["ledger_audit"]
        for name in LEDGER_COUNTER_ROWS:
            totals[name] += sum(blk[name])
        in_flight_final = sum(blk["in_flight"])
        checks += int(aud["checks"])
        violations.extend(aud["violations"])
        windows.append({"epoch": rec["epoch"],
                        "ledger": {k: sum(v) for k, v in blk.items()},
                        "audit_ok": bool(aud["ok"])})
    return {"windows": windows, "totals": totals,
            "in_flight_final": in_flight_final, "checks": checks,
            "violations": violations}


def states_bitwise(a, b) -> bool:
    """Every field of two train states bitwise equal (the telemetry
    aside: an obs-off state has none)."""
    fa = {k: v for k, v in state_lib.to_flat(a).items()
          if not k.startswith("state/telemetry")}
    fb = {k: v for k, v in state_lib.to_flat(b).items()
          if not k.startswith("state/telemetry")}
    if fa.keys() != fb.keys():
        return False
    for k, v in fa.items():
        w = fb[k]
        if v.dtype != w.dtype or v.shape != w.shape:
            return False
        if v.is_floating_point():
            v = v.reshape(-1).view(torch.uint8)
            w = w.reshape(-1).view(torch.uint8)
        if not torch.equal(v.cpu(), w.cpu()):
            return False
    return True


def run(device=None, epochs: int = 3, seed: int = 0) -> Dict[str, Any]:
    """The three legs; returns the artifact record (see the module doc).
    On CUDA the legs run under deterministic algorithms (the caller sets
    `CUBLAS_WORKSPACE_CONFIG` before CUDA starts)."""
    device = resolve_device(device)
    if os.environ.get(obs_ledger.LEAK_ENV):
        raise SystemExit(
            f"{obs_ledger.LEAK_ENV} is set: the composed leg must run "
            "leak-free (the oracle legs arm it themselves)")
    x, y = synthetic_dataset(N_PER_RANK * N_RANKS, (8, 8, 1), seed=1)
    was = torch.are_deterministic_algorithms_enabled()
    if device.type == "cuda":
        torch.use_deterministic_algorithms(True)
    reg = Registry()
    try:
        with reg.span("ledger_audit", cat="run"):
            state, hist = run_leg(x, y, epochs, seed, device)
            fold = fold_windows(hist)
            oracles = []
            for leak in obs_ledger.LEAKS:
                os.environ[obs_ledger.LEAK_ENV] = leak
                try:
                    _, lh = run_leg(x, y, epochs, seed, device)
                finally:
                    del os.environ[obs_ledger.LEAK_ENV]
                lf = fold_windows(lh)
                oracles.append({
                    "leak": leak,
                    "caught": bool(lf["violations"]),
                    "checks": lf["checks"],
                    "violated_laws": sorted({v["law"]
                                             for v in lf["violations"]}),
                    "first_violation": (lf["violations"][0]
                                        if lf["violations"] else None),
                })
            s_off, _ = run_leg(x, y, epochs, seed, device, obs="off")
            s_off2, _ = run_leg(x, y, epochs, seed, device, obs="off")
            off_det = states_bitwise(s_off, s_off2)
            off_match = states_bitwise(state, s_off)
    finally:
        torch.use_deterministic_algorithms(was)
    totals = fold["totals"]
    exercised = {name: totals[name] > 0 for name in LEDGER_COUNTER_ROWS}
    exercised["in_flight"] = any(w["ledger"]["in_flight"] > 0
                                 for w in fold["windows"])
    sender = (totals["proposed"]
              == totals["suppressed"] + totals["deferred"] + totals["fired"])
    receiver = (totals["fired"]
                == totals["delivered"] + totals["dropped"]
                + totals["rejected"] + fold["in_flight_final"])
    return {
        "bench": "ledger_conservation",
        "schema_version": LEDGER_SCHEMA_VERSION,
        "platform": f"{platform.system()}-{device.type}",
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else platform.machine()),
        "topo": f"ring:{N_RANKS}",
        "algo": "eventgrad",
        "op_point": {
            "epochs": epochs, "batch_size": BATCH,
            "n_synth": int(len(x)), "model": "mlp16", "seed": seed,
            "staleness": 2, "gossip_wire": "compact", "compact_frac": 0.5,
        },
        "chaos": CHAOS_SPEC,
        "integrity": {"checksum": True, "quarantine": True},
        "windows": fold["windows"],
        "totals": totals,
        "in_flight_final": fold["in_flight_final"],
        "conservation": {
            "checks": fold["checks"],
            "violations": len(fold["violations"]),
            "all_windows_ok": all(w["audit_ok"] for w in fold["windows"]),
            "sender_identity_run_total": bool(sender),
            "receiver_identity_run_total": bool(receiver),
        },
        "dispositions_exercised": exercised,
        "all_dispositions_exercised": all(exercised.values()),
        "leak_oracles": oracles,
        "all_leaks_caught": all(o["caught"] for o in oracles),
        "obs_off_deterministic": bool(off_det),
        "obs_off_matches_obs_run": bool(off_match),
        "wall_s": round(reg.spans[-1].dur_us / 1e6, 1),
    }


def ok(rec: Dict[str, Any]) -> bool:
    """Every gate of the record."""
    c = rec["conservation"]
    return bool(
        c["all_windows_ok"] and c["violations"] == 0
        and c["sender_identity_run_total"]
        and c["receiver_identity_run_total"]
        and rec["all_dispositions_exercised"] and rec["all_leaks_caught"]
        and all(o["violated_laws"] for o in rec["leak_oracles"])
        and rec["obs_off_deterministic"] and rec["obs_off_matches_obs_run"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without it)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    # deterministic cuBLAS for the bitwise off leg: read when the first
    # cuBLAS handle is made, so set before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    rec = run(args.device, args.epochs, args.seed)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(json.dumps({k: v for k, v in rec.items() if k != "windows"},
                     indent=1))
    if not ok(rec):
        print("ledger audit: GATES FAILING", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
