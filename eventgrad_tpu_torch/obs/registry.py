"""Host-side observability registry: one schema, three exporters.

Port of `eventgrad_tpu/obs/registry.py`. Unifies the port's record
stream, the chaos peer-health counters and step latencies behind
`obs.schema.OBS_SCHEMA_VERSION`:

  * `utils.metrics.JsonlLogger` records  -> `record()` (the JSONL stream;
    every line gains `obs_schema`)
  * `chaos.monitor` per-edge health      -> `observe_health()` (gauges)
  * step-latency summaries               -> `observe_latency()` (gauges)

plus host span traces (`span()`: the loop's data, device-ready wait,
telemetry flush, eval and checkpoint) exported as Chrome-trace/Perfetto
JSON, so a training run opens in `chrome://tracing` or
https://ui.perfetto.dev.

Everything here is host Python and touches no device. A span times the
HOST: around asynchronous CUDA launches it measures their enqueue, so
the loop puts its device-time span (`block_ready`) around the
synchronize it already does. Recording one span is two `perf_counter`
reads and a tuple append.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from eventgrad_tpu_torch.obs.schema import OBS_SCHEMA_VERSION, PROM_PREFIX
from eventgrad_tpu_torch.utils.metrics import JsonlLogger


class Span(tuple):
    """(name, cat, ts_us, dur_us, depth, args, tid) — depth is the
    nesting level at open time (0 = top-level) on the RECORDING thread,
    which Chrome trace infers from timestamps but tests assert directly;
    tid is a small per-registry thread index (0 = the first recording
    thread, i.e. the loop) so spans recorded from worker threads (the
    async checkpoint writer) land on their own trace track instead of
    fake-nesting under main-thread spans."""

    __slots__ = ()
    name = property(lambda s: s[0])
    cat = property(lambda s: s[1])
    ts_us = property(lambda s: s[2])
    dur_us = property(lambda s: s[3])
    depth = property(lambda s: s[4])
    args = property(lambda s: s[5])
    tid = property(lambda s: s[6] if len(s) > 6 else 0)


def _prom_escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


class Registry:
    """The one run-wide sink. Construct with an existing `JsonlLogger`
    (not owned; `close()` leaves it open for the caller) or a
    `jsonl_path` (owned; closed with the registry). Usable as a context
    manager — exceptions still flush exporter files the caller set up via
    `write_*` in its `finally`."""

    def __init__(
        self,
        logger: Optional[JsonlLogger] = None,
        jsonl_path: Optional[str] = None,
        echo: bool = False,
        fsync: bool = False,
        run_meta: Optional[Dict[str, Any]] = None,
    ):
        if logger is not None and jsonl_path is not None:
            raise ValueError("pass logger= or jsonl_path=, not both")
        self._own_logger = logger is None and jsonl_path is not None
        if self._own_logger:
            logger = JsonlLogger(jsonl_path, echo=echo, fsync=fsync)
        self._logger = logger
        self._t0 = time.perf_counter()
        self._spans: List[Span] = []
        self._spans_lock = threading.Lock()
        # per-thread open stack: spans are recorded from the loop AND from
        # background workers (the async checkpoint writer) — depth is the
        # nesting level within the RECORDING thread
        self._tls = threading.local()
        #: thread ident -> small stable tid (0 = first recording thread)
        self._tids: Dict[int, int] = {}
        #: (name, labels-frozenset-or-None) -> (value, labels-dict)
        self._gauges: Dict[Tuple[str, Any], Tuple[float, Optional[Dict]]] = {}
        self.run_meta = dict(run_meta or {})
        self.n_records = 0

    # --- JSONL stream ----------------------------------------------------
    def record(self, rec: Dict[str, Any]) -> None:
        """Stamp the schema version and forward to the JSONL stream (and
        echo, if the logger echoes). Safe without a logger: the record
        still counts, so spans/gauges-only registries work."""
        rec = {"obs_schema": OBS_SCHEMA_VERSION, **rec}
        self.n_records += 1
        if self._logger is not None:
            self._logger.log(rec)

    # --- spans -----------------------------------------------------------
    def _open_stack(self) -> List[Tuple[str, str, float, Dict[str, Any]]]:
        stack = getattr(self._tls, "open", None)
        if stack is None:
            stack = self._tls.open = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "run", **args):
        """Record one host span; nests (depth = open spans at entry on the
        recording thread). Thread-safe: worker threads (e.g. the async
        checkpoint writer) record flat spans of their own."""
        stack = self._open_stack()
        depth = len(stack)
        t0 = time.perf_counter()
        stack.append((name, cat, t0, args))
        try:
            yield
        finally:
            stack.pop()
            t1 = time.perf_counter()
            ident = threading.get_ident()
            with self._spans_lock:
                tid = self._tids.setdefault(ident, len(self._tids))
                self._spans.append(Span((
                    name, cat,
                    (t0 - self._t0) * 1e6, (t1 - t0) * 1e6,
                    depth, dict(args), tid,
                )))

    @property
    def spans(self) -> List[Span]:
        with self._spans_lock:
            return list(self._spans)

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome Trace Event Format (complete "X" events) — loads in
        chrome://tracing and Perfetto. Spans sort by start time; nesting
        is recovered by the viewer from containment per tid (worker
        threads — the async checkpoint writer — get their own track, so
        their spans can overlap the loop's without fake nesting)."""
        events = [
            {
                "name": s.name,
                "cat": s.cat,
                "ph": "X",
                "ts": round(s.ts_us, 1),
                "dur": round(s.dur_us, 1),
                "pid": 0,
                "tid": s.tid,
                "args": {**s.args, "depth": s.depth},
            }
            for s in sorted(self.spans, key=lambda s: (s.ts_us, -s.dur_us))
        ]
        other: Dict[str, Any] = {
            "obs_schema": OBS_SCHEMA_VERSION,
            **{k: str(v) for k, v in self.run_meta.items()},
        }
        if self._gauges:
            # gauges ride along so a trace file is self-contained (the
            # Prometheus textfile is the scrapeable form of the same data)
            other["gauges"] = {
                name + (
                    "{%s}" % ",".join(
                        f"{k}={v}" for k, v in sorted(labels.items())
                    ) if labels else ""
                ): value
                for (name, _), (value, labels) in sorted(self._gauges.items())
            }
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)

    # --- gauges (Prometheus textfile) ------------------------------------
    def gauge(
        self, name: str, value: float,
        labels: Optional[Dict[str, Any]] = None,
    ) -> None:
        key = (name, frozenset((labels or {}).items()))
        self._gauges[key] = (float(value), dict(labels) if labels else None)

    def observe_latency(self, timed: Dict[str, Any], prefix: str = "step") -> None:
        """Fold a step-latency summary (`step_ms_mean` / `_p50` / `_p95`,
        `compile_s`; `utils/obs_overhead.py` prints one) into gauges
        (`<prefix>_ms_mean/p50/p95`, `<prefix>_compile_s`)."""
        for k in ("step_ms_mean", "step_ms_p50", "step_ms_p95"):
            if k in timed:
                self.gauge(k.replace("step", prefix, 1), timed[k])
        if "compile_s" in timed:
            self.gauge(f"{prefix}_compile_s", timed["compile_s"])

    def observe_health(
        self, silence, drops, max_silence: int, edges=None,
    ) -> Dict[str, Any]:
        """Fold chaos.monitor PeerHealth counters into per-edge gauges;
        returns (and records nothing — caller attaches) the same summary
        dict `chaos.monitor.health_record` produces."""
        from eventgrad_tpu_torch.chaos import monitor as chaos_monitor

        rec = chaos_monitor.health_record(
            silence, drops, max_silence, edges=edges
        )
        names = edges or [str(i) for i in range(len(rec["edge_silence_max"]))]
        for name, v in zip(names, rec["edge_silence_max"]):
            self.gauge("edge_silence_max", v, labels={"edge": name})
        self.gauge("chaos_drops_total", rec["chaos_drops"])
        return rec

    def prometheus_text(self) -> str:
        """Prometheus textfile-collector format (one gauge family per
        metric name, labels sorted) — point node_exporter's textfile
        collector at the written file."""
        by_name: Dict[str, List[Tuple[Optional[Dict], float]]] = {}
        for (name, _), (value, labels) in sorted(self._gauges.items()):
            by_name.setdefault(name, []).append((labels, value))
        lines = []
        for name, series in by_name.items():
            full = f"{PROM_PREFIX}_{name}"
            lines.append(f"# TYPE {full} gauge")
            for labels, value in series:
                if labels:
                    lab = ",".join(
                        f'{k}="{_prom_escape(v)}"'
                        for k, v in sorted(labels.items())
                    )
                    lines.append(f"{full}{{{lab}}} {value}")
                else:
                    lines.append(f"{full} {value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())

    # --- lifecycle -------------------------------------------------------
    def close(self) -> None:
        if self._own_logger and self._logger is not None:
            self._logger.close()

    def __enter__(self) -> "Registry":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
