"""Supervised soak: survive a scripted kill/join/leave/flaky schedule and
prove it with a record in the JAX soak artifact's schema.

Port of `tools/soak.py`. One supervised training service
(`eventgrad_tpu_torch.supervise` over `python -m eventgrad_tpu_torch.cli`)
is driven through

  * >= 6 scripted membership transitions (>= 2 joins): ranks leave
    cleanly and newcomers bootstrap from a neighbour's snapshot
    (`chaos/membership.py`), applied between epochs;
  * a flaky network window (the chaos schedule's total blackout for a
    slice of passes) in the same run;
  * a process kill (`--fault-inject crash:N`) that the supervisor (sliding
    restart-budget window, exponential backoff) recovers from the latest
    snapshot.

Then three verdicts are measured:

  * recovery — per transition the lost recomputation epochs, at most one
    `--save-every` interval (a membership transition loses none; the
    restart at most the epochs since the last snapshot);
  * accuracy — the final consensus test accuracy against a
    transition-free baseline trained in this process on the same data;
  * replay — the membership and chaos schedules parsed back out of the
    soak's own log, trained again in this process, end bitwise on the
    soak's final snapshot.

The op points are the JAX tool's (`full`: 5 ranks, 18 epochs, 8
transitions; `smoke`: 4 ranks, 6 epochs, 6 transitions). The record
keeps the JAX artifact's keys (`tools/validate_artifacts.SOAK_SCHEMA`,
`artifacts/soak_cpu.json`); `verdicts` checks the schema's gates.

Usage:
    python -m eventgrad_tpu_torch.utils.soak --device cpu [--smoke] \\
        [--out artifacts/torch_soak_cpu.json]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: (ranks, epochs, n_synth, batch, save_every, crash_epoch, membership
#: spec, chaos spec) per mode: the JAX tool's. The crash epoch sits on
#: the save_every grid, so the kill lands right after a snapshot, at a
#: membership-transition boundary (the elastic resume path); flaky
#: windows are pass-indexed. `seeds`: the full run also trains the
#: transition-free baseline at training seeds 0..seeds-1 (the MLP's
#: ReLU logits make its accuracy bimodal over the initial draw: a dead
#: logit class ends near 90%), recorded as `final_acc_baseline_seeds`.
OP_POINTS = {
    "full": dict(
        ranks=5, epochs=18, n_synth=768, batch=8, save_every=2,
        crash_epoch=8,
        membership=("leave=2@2,join=2@4,leave=4@6,join=4@8,"
                    "leave=1@11,join=1@13,leave=3@15,join=3@16"),
        chaos="drop=0,seed=11,flaky=40-60@1.0", seeds=10,
    ),
    "smoke": dict(
        ranks=4, epochs=6, n_synth=192, batch=8, save_every=2,
        crash_epoch=4,
        membership=("leave=1@1,join=1@2,leave=2@3,join=2@4,"
                    "leave=0@5,join=0@5"),
        chaos="drop=0,seed=11,flaky=10-16@1.0", seeds=0,
    ),
}

_COMMON_CLI = ["--algo", "eventgrad", "--dataset", "synthetic", "--model",
               "mlp", "--warmup-passes", "2", "--max-silence", "8", "--lr",
               "0.1"]


def _train_kwargs(op: Dict[str, Any], seed: int = 0) -> Dict[str, Any]:
    """The in-process mirror of the child's flags (the baseline and the
    replay train the program the supervised child ran)."""
    from eventgrad_tpu_torch.parallel.events import EventConfig

    return dict(
        algo="eventgrad",
        epochs=op["epochs"],
        batch_size=op["batch"],
        learning_rate=0.1,
        event_cfg=EventConfig(warmup_passes=2, max_silence=8),
        seed=seed,
    )


def _load_data(op: Dict[str, Any]):
    from eventgrad_tpu_torch.data.datasets import load_or_synthesize

    n_test = max(512, op["n_synth"] // 8)
    x, y = load_or_synthesize("mnist", None, "train", op["n_synth"], 0)
    xt, yt = load_or_synthesize("mnist", None, "test", n_test, 0)
    return x, y, xt, yt


def _records(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _restart_transitions(
    epoch_recs: List[Dict[str, Any]], save_every: int
) -> List[Dict[str, Any]]:
    """Supervisor restarts, recovered from the log itself: every attempt
    stamps the membership schedule on its first record, so attempt
    boundaries are the records after the first that carry the
    `membership` rider. Each restart lost `prev_epoch - (cur_epoch - 1)`
    epochs of recompute (0 when the kill landed right on a snapshot)."""
    out = []
    starts = [i for i, r in enumerate(epoch_recs) if "membership" in r]
    for i in starts[1:]:
        prev = int(epoch_recs[i - 1]["epoch"])
        cur = int(epoch_recs[i]["epoch"])
        out.append({
            "kind": "restart", "epoch": prev,
            "lost_epochs": max(0, prev - (cur - 1)),
            "save_every": int(save_every),
        })
    return out


@contextlib.contextmanager
def _child_env():
    """The supervised children import the package from this checkout and
    run one torch thread each (the soak's MLP gains nothing from more)."""
    saved = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, saved["PYTHONPATH"]) if p)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_soak(
    out_path: Optional[str], mode: str = "full",
    workdir: Optional[str] = None, device=None,
) -> Dict[str, Any]:
    """Run the soak at `OP_POINTS[mode]` on `device` (None = CUDA) and
    return its record; with `out_path`, also write it there."""
    import tempfile

    from eventgrad_tpu_torch import supervise
    from eventgrad_tpu_torch.chaos.membership import MembershipSchedule
    from eventgrad_tpu_torch.models import MODEL_REGISTRY
    from eventgrad_tpu_torch.parallel.topology import Ring
    from eventgrad_tpu_torch.train.loop import (
        consensus_params, evaluate, rank0_slice, train,
    )
    from eventgrad_tpu_torch.utils import checkpoint
    from eventgrad_tpu_torch.utils.devices import resolve_device

    dev = resolve_device(device)
    op = OP_POINTS[mode]
    t_start = time.perf_counter()
    x, y, xt, yt = _load_data(op)
    model = MODEL_REGISTRY["mlp"]()
    kw = dict(_train_kwargs(op), device=dev)

    ctx = tempfile.TemporaryDirectory() if workdir is None else None
    tmp = workdir if workdir is not None else ctx.name
    os.makedirs(tmp, exist_ok=True)
    try:
        # --- leg 1: the transition-free baseline (in this process) -----
        st_base, _ = train(model, Ring(op["ranks"]), x, y, **kw)
        acc_base = evaluate(
            model, consensus_params(st_base.params),
            rank0_slice(st_base.batch_stats), xt, yt, device=dev,
        )["accuracy"]

        # --- leg 2: the supervised soak (subprocesses, killed once) -----
        ck = os.path.join(tmp, "ck")
        log = os.path.join(tmp, "soak.jsonl")
        child = list(_COMMON_CLI) + [
            "--mesh", f"ring:{op['ranks']}",
            "--epochs", str(op["epochs"]),
            "--batch-size", str(op["batch"]),
            "--n-synth", str(op["n_synth"]),
            "--membership", op["membership"],
            "--chaos", op["chaos"],
            "--fault-inject", f"crash:{op['crash_epoch']}",
            "--checkpoint-dir", ck,
            "--save-every", str(op["save_every"]),
            "--log-file", log,
            "--device", dev.type,
        ]
        with _child_env():
            rc = supervise.supervise(
                child, timeout=0.0, max_restarts=3, restart_window=600.0,
                backoff_base=0.2, backoff_max=2.0,
            )
        escalations = 0 if rc == 0 else 1
        recs = _records(log)
        epoch_recs = [r for r in recs if "epoch" in r]
        final_rec = next(r for r in reversed(recs) if r.get("final"))
        acc_soak = float(final_rec["accuracy"])
        msgs_saved = float(next(
            r["msgs_saved_pct"] for r in reversed(epoch_recs)
            if "msgs_saved_pct" in r
        ))

        # --- transition accounting -----------------------------------
        # ground truth is the schedule the run logged about itself (the
        # membership rider on each attempt's first record); every
        # record's active_ranks must track it exactly. A membership
        # transition loses no epoch (the state carries over live); a kill
        # at a transition's epoch eats that attempt's next record, never
        # the transition
        memb_logged = next(
            r["membership"] for r in epoch_recs if "membership" in r
        )
        sched = MembershipSchedule.from_dict(memb_logged)
        active_ranks_verified = all(
            int(r["active_ranks"])
            == sched.n_ranks_at(op["ranks"], int(r["epoch"]) - 1)
            for r in epoch_recs
        )
        applied = {
            (t["kind"], int(t["epoch"]), int(t["index"])): t
            for r in epoch_recs
            for t in r.get("membership_transitions", ())
        }
        transitions: List[Dict[str, Any]] = []
        for e in sched.events:
            t = {"kind": e.kind, "epoch": e.epoch, "index": e.index,
                 "lost_epochs": 0}
            seen = applied.get((e.kind, e.epoch, e.index))
            if seen is not None:
                t["apply_s"] = float(seen.get("apply_s", 0.0))
                t["n_ranks_after"] = int(seen["n_ranks_after"])
            transitions.append(t)
        restarts = _restart_transitions(epoch_recs, op["save_every"])
        transitions = sorted(transitions + restarts,
                             key=lambda t: t["epoch"])
        n_joins = sum(1 for t in transitions if t["kind"] == "join")
        n_memb = sum(1 for t in transitions if t["kind"] != "restart")
        recovery_ok = all(
            t["lost_epochs"] <= op["save_every"] for t in transitions
        )

        # --- leg 3: replay from the run's own logged schedules ----------
        chaos_logged = next(r["chaos"] for r in epoch_recs if "chaos" in r)
        st_replay, _ = train(
            model, Ring(op["ranks"]), x, y,
            membership=memb_logged, chaos=chaos_logged, **kw,
        )
        found = checkpoint.latest(os.path.join(ck, "ckpt"))
        raw, _ = checkpoint.peek(found, device=dev)
        replay_bitwise = bool(torch.equal(
            raw["state/params"].view(torch.int32),
            st_replay.params.view(torch.int32)))
        seeds_acc = []
        for seed in range(op["seeds"]):
            st, _ = train(model, Ring(op["ranks"]), x, y,
                          **dict(kw, seed=seed))
            seeds_acc.append(round(float(evaluate(
                model, consensus_params(st.params),
                rank0_slice(st.batch_stats), xt, yt, device=dev,
            )["accuracy"]), 3))
    finally:
        if ctx is not None:
            ctx.cleanup()

    out = {
        "bench": "soak",
        "platform": dev.type,
        "mode": mode,
        "op_point": {
            k: op[k]
            for k in ("ranks", "epochs", "n_synth", "batch", "crash_epoch",
                      "membership", "chaos")
        },
        "save_every": op["save_every"],
        "n_transitions": n_memb,
        "n_joins": n_joins,
        "supervisor_restarts": len(restarts),
        "supervisor_escalations": escalations,
        "transitions": transitions,
        "active_ranks_verified": bool(active_ranks_verified),
        "recovery_ok": bool(recovery_ok),
        "final_acc_baseline": round(float(acc_base), 3),
        "final_acc_soak": round(acc_soak, 3),
        "final_acc_gap_pt": round(abs(float(acc_base) - acc_soak), 3),
        "msgs_saved_pct": round(msgs_saved, 2),
        "replay_bitwise": bool(replay_bitwise),
        "wall_s": round(time.perf_counter() - t_start, 1),
    }
    if op["seeds"]:
        out["final_acc_baseline_seeds"] = seeds_acc
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
    return out


def verdicts(out: Dict[str, Any]) -> List[str]:
    """The gates of the JAX soak schema, each failure named: >= 6
    transitions with >= 2 joins, >= 1 supervisor restart and no
    escalation, every recovery within one save interval, the active
    ranks tracking the schedule, the replay bitwise, the accuracy within
    0.5 point of the baseline."""
    fails = []
    checks = (
        ("n_transitions", out["n_transitions"] >= 6),
        ("n_joins", out["n_joins"] >= 2),
        ("supervisor_restarts", out["supervisor_restarts"] >= 1),
        ("supervisor_escalations", out["supervisor_escalations"] == 0),
        ("transitions", len(out["transitions"]) >= 6),
        ("active_ranks_verified", out["active_ranks_verified"] is True),
        ("recovery_ok", out["recovery_ok"] is True),
        ("replay_bitwise", out["replay_bitwise"] is True),
        ("final_acc_gap_pt", 0 <= out["final_acc_gap_pt"] <= 0.5),
    )
    for name, ok in checks:
        if not ok:
            fails.append(f"{name} = {out[name]!r}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced op point (same record, same >= 6 "
                         "transitions)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None,
                    help="default: artifacts/torch_soak_<device>.json "
                         "(the full op point) or no file (--smoke)")
    args = ap.parse_args(argv)
    out_path = args.out
    if out_path is None and not args.smoke:
        out_path = os.path.join(_ROOT, "artifacts",
                                f"torch_soak_{args.device}.json")
    out = run_soak(out_path, mode="smoke" if args.smoke else "full",
                   device=None if args.device == "cuda" else args.device)
    print(json.dumps(out, indent=1, sort_keys=True))
    fails = verdicts(out)
    for f in fails:
        print(f"soak verdict failed: {f}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
