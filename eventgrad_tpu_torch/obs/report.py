"""Run-report builder: history/JSONL in, one self-contained report out.

Port of `eventgrad_tpu/obs/report.py`. Consumes the per-epoch history
records of `train(obs="block"|"epoch")` (the in-memory list, or the
JSONL stream a `Registry` / `JsonlLogger` writes) and renders the
derived series `obs.schema.REPORT_FIELDS` documents: per-layer
msgs-saved-% vs epoch, threshold/fire-rate heatmap data, compact-wire
capacity utilization (fired bytes vs C, deferral rate), the
consensus-error trajectory, the bounded-async staleness surface and the
message-lifecycle table. `python -m eventgrad_tpu_torch.utils.obs_report`
renders it from the command line.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from eventgrad_tpu_torch.obs.schema import OBS_SCHEMA_VERSION
from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.utils.metrics import msgs_saved_pct_per_leaf


def load_history_jsonl(path: str) -> List[Dict[str, Any]]:
    """Epoch records (lines carrying "epoch") from a metrics JSONL stream;
    non-record lines (final summary, malformed tails from a crash) are
    skipped — a crash-truncated log still reports its completed epochs."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and "epoch" in rec:
                out.append(rec)
    return out


def _obs_windows(history: List[Dict[str, Any]]):
    """(epoch, obs-dict) pairs in epoch order, plus the run meta carried
    by the first obs record."""
    windows, meta = [], {}
    for rec in history:
        obs = rec.get("obs")
        if not obs:
            continue
        if not meta and "meta" in obs:
            meta = obs["meta"]
        windows.append((rec["epoch"], obs))
    return windows, meta


def build_report(history: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One self-contained dict from a train() history (see module doc).
    Works on any history: sections whose inputs are absent (no obs
    telemetry, no compact wire, no consensus probe) come out None rather
    than failing, so the tool renders partial reports from legacy logs."""
    windows, meta = _obs_windows(history)
    n_ranks = int(meta.get("n_ranks", 1))
    n_nb = int(meta.get("n_neighbors", 1))
    wire = meta.get("wire")

    report: Dict[str, Any] = {
        "obs_schema": OBS_SCHEMA_VERSION,
        "algo": history[0].get("algo") if history else None,
        "epochs": [h["epoch"] for h in history],
        "meta": meta or None,
        "msgs_saved_pct": [h.get("msgs_saved_pct") for h in history],
        "sent_bytes_wire_real_per_step_per_chip": [
            h.get("sent_bytes_wire_real_per_step_per_chip")
            for h in history
        ],
        "loss": [h.get("loss") for h in history],
        "test_accuracy": [h.get("test_accuracy") for h in history],
    }

    # consensus-error trajectory (block-end probe; obs or chaos runs)
    cons = [
        (h["epoch"], h["consensus_err_max"], h["consensus_err_mean"])
        for h in history
        if "consensus_err_max" in h
    ]
    report["consensus_error"] = (
        {
            "epochs": [e for e, _, _ in cons],
            "max": [m for _, m, _ in cons],
            "mean": [m for _, _, m in cons],
        }
        if cons else None
    )

    if not windows:
        report.update(
            msgs_saved_pct_per_leaf=None, fire_rate_heatmap=None,
            thres_heatmap=None, silence_hist_total=None,
            capacity_utilization=None,
        )
        return report

    epochs_w = [e for e, _ in windows]
    per_leaf_saved, fire_rows, thres_rows, drift_rows = [], [], [], []
    hist_total: Optional[List[int]] = None
    for _, w in windows:
        steps = max(1, int(w["steps"]))
        fire = w.get("fire_count")
        if fire is not None:
            per_leaf_saved.append(msgs_saved_pct_per_leaf(
                fire, steps, n_nb, n_ranks
            ))
            fire_rows.append([f / (steps * n_ranks) for f in fire])
        thres_rows.append(w.get("thres_mean"))
        drift_rows.append(w.get("drift_mean"))
        sh = w.get("silence_hist")
        if sh is not None:
            hist_total = (
                [a + b for a, b in zip(hist_total, sh)]
                if hist_total else list(sh)
            )

    report["msgs_saved_pct_per_leaf"] = {
        "epochs": epochs_w,
        "leaves": meta.get("leaves"),
        "pct": per_leaf_saved,
    } if per_leaf_saved else None
    report["fire_rate_heatmap"] = {
        "epochs": epochs_w, "leaves": meta.get("leaves"),
        "rows": fire_rows,
    } if fire_rows else None
    report["thres_heatmap"] = {
        "epochs": epochs_w, "leaves": meta.get("leaves"),
        "rows": thres_rows, "drift_rows": drift_rows,
    } if any(r is not None for r in thres_rows) else None
    report["silence_hist_total"] = hist_total

    # compact-wire capacity utilization: fired bytes vs the static C.
    # Only COMPACT-ERA windows count — the dense warmup/autotune phase
    # fires everything through the unbudgeted wire (fired_elems up to
    # n_params > C), so folding it in would report a physically
    # impossible >100% utilization of a budget the gate never exceeded.
    caps = [h for h in history if h.get("compact_capacity")]
    if caps:
        cap = int(caps[-1]["compact_capacity"])
        compact_epochs = {h["epoch"] for h in caps}
        util_rows = []
        defer_total = fire_total = 0
        n_leaves = len(meta.get("leaves") or []) or 1
        for e, w in windows:
            if e not in compact_epochs:
                continue
            fe_mean = w.get("fired_elems_mean")
            if fe_mean is None:
                continue
            fired_leaves = (
                sum(w["fire_count"]) / (max(1, int(w["steps"])) * n_ranks)
                if w.get("fire_count") else n_leaves
            )
            util_rows.append({
                "epoch": e,
                "steps": int(w["steps"]),
                "utilization": fe_mean / cap,
                "fired_bytes_per_step_per_edge":
                    collectives.fired_wire_bytes_per_neighbor(
                        fe_mean, fired_leaves, wire
                    ),
            })
            defer_total += int(sum(w.get("defer_count") or [0]))
            fire_total += int(sum(w.get("fire_count") or [0]))
        proposed = defer_total + fire_total
        total_steps = sum(r["steps"] for r in util_rows)
        report["capacity_utilization"] = {
            "compact_capacity": cap,
            "capacity_bytes_per_edge":
                collectives.wire_real_bytes_per_neighbor(
                    cap, n_leaves, wire,
                    compact_capacity=cap, fire_bits=True,
                ),
            # steps-weighted mean over compact-era windows; per-pass
            # peaks are bounded by C by construction (capacity_gate), so
            # the mean + deferral rate carry the tuning signal
            "utilization_mean": (
                sum(r["utilization"] * r["steps"] for r in util_rows)
                / total_steps
                if total_steps else None
            ),
            # cumulative running max since init — INCLUDES the dense
            # warmup phase (a running max cannot be windowed); kept for
            # autotune forensics, not a utilization of C
            "fired_elems_peak_cumulative": max(
                (w.get("fired_elems_peak") or 0) for _, w in windows
            ),
            "deferral_rate": (defer_total / proposed) if proposed else 0.0,
            "per_window": util_rows,
        }
    else:
        report["capacity_utilization"] = None

    # bounded-async staleness surface (train(staleness=D >= 2),
    # docs/chaos.md "Bounded-async gossip & stragglers"): the per-edge
    # staleness gauge trajectory, the staleness histogram, and late
    # commits. D <= 1 runs emit all-zero counters — report None there
    # so legacy/lockstep reports stay unchanged.
    stale_rows = [
        (e, w["edge_staleness_per_step"], int(w.get("late_commit_count", 0)),
         w.get("staleness_hist"))
        for e, w in windows if "edge_staleness_per_step" in w
    ]
    if any(any(v > 0 for v in row) for _, row, _, _ in stale_rows):
        hist_tot = None
        for _, _, _, sh in stale_rows:
            if sh is not None:
                hist_tot = (
                    [a + b for a, b in zip(hist_tot, sh)] if hist_tot
                    else list(sh)
                )
        report["edge_staleness"] = {
            "epochs": [e for e, _, _, _ in stale_rows],
            "edges": meta.get("edges"),
            "rows": [row for _, row, _, _ in stale_rows],
            "late_commits": [lc for _, _, lc, _ in stale_rows],
            "staleness_hist_total": hist_tot,
            "staleness_bound": next(
                (h["staleness"] for h in reversed(history)
                 if h.get("staleness")), None
            ),
        }
    else:
        report["edge_staleness"] = None

    # message-lifecycle ledger (obs/ledger.py): fold the per-window
    # `message_ledger` blocks into a run-total per-edge disposition
    # table, keep the per-window timeline (rank+edge sums), and
    # aggregate the conservation auditor's verdicts
    led_rows = [
        (e, w["message_ledger"], w.get("ledger_audit"))
        for e, w in windows if "message_ledger" in w
    ]
    if led_rows:
        totals: Dict[str, List[int]] = {}
        for _, blk, _ in led_rows:
            for k, v in blk.items():
                if k == "in_flight":
                    continue  # gauge, not a windowable count
                totals[k] = (
                    [a + b for a, b in zip(totals[k], v)]
                    if k in totals else list(v)
                )
        audits = [a for _, _, a in led_rows if a]
        report["message_lifecycle"] = {
            "epochs": [e for e, _, _ in led_rows],
            "edges": meta.get("edges"),
            "totals": totals,
            "in_flight_final": led_rows[-1][1].get("in_flight"),
            "timeline": [
                {"epoch": e, **{k: sum(v) for k, v in blk.items()}}
                for e, blk, _ in led_rows
            ],
            "audit": {
                "windows": len(audits),
                "checks": sum(int(a.get("checks", 0)) for a in audits),
                "ok": all(a.get("ok", False) for a in audits),
                "violations": [
                    v for a in audits for v in a.get("violations", [])
                ][:8],
            } if audits else None,
        }
    else:
        report["message_lifecycle"] = None
    return report


def render_text(report: Dict[str, Any]) -> str:
    """Terse human summary of a report (the tool's stdout)."""
    lines = [
        f"obs report (schema v{report['obs_schema']}) — "
        f"algo={report.get('algo')}, {len(report.get('epochs') or [])} "
        "epoch records",
    ]
    pls = report.get("msgs_saved_pct_per_leaf")
    if pls and pls["pct"]:
        last = pls["pct"][-1]
        names = pls.get("leaves") or [str(i) for i in range(len(last))]
        worst = min(range(len(last)), key=lambda i: last[i])
        best = max(range(len(last)), key=lambda i: last[i])
        lines.append(
            f"per-leaf msgs saved (last window): best {names[best]} "
            f"{last[best]:.1f}%, worst {names[worst]} {last[worst]:.1f}%"
        )
    cap = report.get("capacity_utilization")
    if cap:
        util = cap.get("utilization_mean")
        util_s = f"{100 * util:.1f}%" if util is not None else "n/a"
        lines.append(
            f"compact wire: C={cap['compact_capacity']} elems, mean "
            f"utilization {util_s}, deferral "
            f"rate {100 * cap['deferral_rate']:.2f}%"
        )
    cons = report.get("consensus_error")
    if cons and cons["max"]:
        lines.append(
            f"consensus error: max {cons['max'][-1]:.3g} "
            f"(mean {cons['mean'][-1]:.3g}) at epoch {cons['epochs'][-1]}"
        )
    st = report.get("edge_staleness")
    if st and st["rows"]:
        last = st["rows"][-1]
        names = st.get("edges") or [str(i) for i in range(len(last))]
        worst = max(range(len(last)), key=lambda i: last[i])
        lines.append(
            f"bounded-async (D={st.get('staleness_bound')}): stalest "
            f"edge {names[worst]} at {last[worst]:.2f} passes (last "
            f"window), {sum(st['late_commits'])} late commits total"
        )
    ml = report.get("message_lifecycle")
    if ml and ml.get("totals"):
        totals = ml["totals"]
        rows = list(totals)
        n_edges = len(next(iter(totals.values())))
        names = ml.get("edges") or [str(i) for i in range(n_edges)]
        aud = ml.get("audit")
        aud_s = (
            f"audit {aud['checks']} checks "
            + ("OK" if aud["ok"] else
               f"FAILED ({len(aud['violations'])}+ violations)")
            if aud else "no audit"
        )
        lines.append(
            f"message lifecycle ({len(ml['epochs'])} windows, {aud_s}):"
        )
        width = max(len(n) for n in names) if names else 4
        lines.append(
            "  " + "edge".ljust(width) + "  "
            + "  ".join(f"{r:>10}" for r in rows)
        )
        for e in range(n_edges):
            lines.append(
                "  " + str(names[e]).ljust(width) + "  "
                + "  ".join(f"{totals[r][e]:>10d}" for r in rows)
            )
        infl = ml.get("in_flight_final")
        if infl and any(infl):
            lines.append(f"  in-flight at run end: {infl}")
        tl = ml.get("timeline") or []
        if len(tl) > 1:
            lines.append(
                "  timeline (fired/delivered/dropped/rejected per window): "
                + " ".join(
                    f"e{t['epoch']}:{t.get('fired', 0)}/"
                    f"{t.get('delivered', 0)}/{t.get('dropped', 0)}/"
                    f"{t.get('rejected', 0)}"
                    for t in tl
                )
            )
        if aud and not aud["ok"]:
            for v in aud["violations"][:4]:
                lines.append(
                    f"  VIOLATION {v['law']} rank={v['rank']} "
                    f"edge={v['edge']}: {v['lhs']} != {v['rhs']}"
                )
    return "\n".join(lines)
