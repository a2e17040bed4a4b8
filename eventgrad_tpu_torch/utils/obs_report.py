"""The run report from the command line: a telemetry JSONL in, one
report JSON out.

Port of `tools/obs_report.py`. Renders the derived observability series
(`obs.schema.REPORT_FIELDS`, `obs/report.py`) from the JSONL stream a
`train(obs=..., registry=Registry(jsonl_path=...), on_epoch=reg.record)`
run wrote: per-layer msgs-saved-% vs epoch, the threshold / fire-rate
heatmaps, the compact wire's capacity utilization, the consensus-error
trajectory, the bounded-async staleness surface and the message
lifecycle. With `--trace TRACE.json` (a `Registry.write_chrome_trace`
export) it adds the host-bubble decomposition (`obs/bubble.py`), one
section per `train` window of the trace; a truncated or partial trace
degrades to a named `IncompleteTraceWarning` and a partial
decomposition.

    python -m eventgrad_tpu_torch.utils.obs_report HISTORY.jsonl \\
        [--trace TRACE.json] [--out REPORT.json] [--quiet]

It reads files only and touches no device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

from eventgrad_tpu_torch.obs import bubble as obs_bubble
from eventgrad_tpu_torch.obs.bubble import IncompleteTraceWarning
from eventgrad_tpu_torch.obs.report import (
    build_report, load_history_jsonl, render_text,
)


def _trace_events(path: str):
    """The trace file's event list, or None with a named warning."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        warnings.warn(f"trace {path} unreadable ({e}); skipping the bubble "
                      "decomposition", IncompleteTraceWarning, stacklevel=2)
        return None
    events = data.get("traceEvents") if isinstance(data, dict) else data
    if not isinstance(events, list) or not events:
        warnings.warn(f"trace {path} carries no traceEvents; skipping the "
                      "bubble decomposition", IncompleteTraceWarning,
                      stacklevel=2)
        return None
    return events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("history", help="metrics JSONL of a train(obs=...) run")
    ap.add_argument("--trace", default=None, metavar="TRACE.json",
                    help="span trace (Registry.write_chrome_trace): adds "
                         "the host-bubble decomposition")
    ap.add_argument("--out", default=None, help="report JSON path")
    ap.add_argument("--quiet", action="store_true",
                    help="no text summary on stdout")
    args = ap.parse_args(argv)

    history = load_history_jsonl(args.history)
    if not history:
        print(f"no epoch records in {args.history}", file=sys.stderr)
        return 1
    report = build_report(history)
    bubbles = []
    if args.trace:
        events = _trace_events(args.trace)
        if events is not None:
            windows = obs_bubble.train_windows(events) or [events]
            bubbles = [obs_bubble.decompose(w) for w in windows]
            report["bubble"] = bubbles
            report["bubble_source"] = os.path.basename(args.trace)
    report["source"] = os.path.basename(args.history)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    if not args.quiet:
        print(render_text(report))
        for i, d in enumerate(bubbles):
            print(obs_bubble.render_text(d, label=f"train window {i}"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
