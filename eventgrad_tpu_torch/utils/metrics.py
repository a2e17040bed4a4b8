"""Run metrics and the JSONL record stream.

Port of `eventgrad_tpu/utils/metrics.py`: `median`, `JsonlLogger` (one
JSON line per record, optionally fsynced, non-finite values scrubbed to
valid JSON), the headline `msgs_saved_pct` and its per-leaf form, and
the steady-state slice and collapse verdict the benchmark reads
(`steady_records`, `collapse_verdict`). The obs.Registry wraps the
stream behind the versioned telemetry schema.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Optional


def median(vals) -> float:
    """Plain middle-of-sorted median (even length: mean of the two
    middles)."""
    s = sorted(vals)
    mid = len(s) // 2
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def _scrub_nonfinite(obj: Any, path: str, bad: List[str]) -> Any:
    """Copy `obj` with NaN/Inf number leaves replaced by None, recording
    each replaced leaf's dotted path in `bad`. Python and numpy scalars
    both; containers recurse; everything else passes through untouched
    (json's `default=` hook still sees it)."""
    if isinstance(obj, dict):
        return {
            k: _scrub_nonfinite(v, f"{path}.{k}" if path else str(k), bad)
            for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [
            _scrub_nonfinite(v, f"{path}[{i}]", bad)
            for i, v in enumerate(obj)
        ]
    v = obj
    if not isinstance(v, (bool, int, float, str, type(None))):
        try:
            v = float(v)  # numpy floating scalars and friends
        except (TypeError, ValueError):
            return obj
    if isinstance(v, float) and not math.isfinite(v):
        bad.append(path)
        return None
    return obj


class JsonlLogger:
    """Append-only JSONL sink; every record is timestamped and flushed.

    Context-manager friendly (`with JsonlLogger(path) as log:`) so the
    stream closes on exception paths too. `fsync=True` additionally
    fsyncs after every record — crash-safe artifacts at the cost of one
    syscall per line (records are per-epoch, so the cost is noise)."""

    def __init__(
        self, path: Optional[str] = None, echo: bool = True,
        fsync: bool = False,
    ):
        self.path = path
        self.echo = echo
        self.fsync = fsync
        self._fh = open(path, "a") if path else None

    def log(self, record: Dict[str, Any]) -> None:
        record = {"ts": round(time.time(), 3), **record}
        try:
            line = json.dumps(record, default=float, allow_nan=False)
        except ValueError:
            # a NaN/Inf metric (a diverging loss — exactly the record an
            # operator most needs) must neither crash the run mid-stream
            # nor emit the bare `NaN` token json.loads rejects: serialize
            # the offenders as null and name them in a rider, so the
            # line stays valid JSON and the divergence stays visible
            bad: List[str] = []
            record = _scrub_nonfinite(record, "", bad)
            record["nonfinite_fields"] = bad
            line = json.dumps(record, default=float, allow_nan=False)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
        if self.echo:
            print(line)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None  # idempotent: with-block + explicit close

    def __enter__(self) -> "JsonlLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def msgs_saved_pct(num_events: int, passes: int, n_tensors: int, n_neighbors: int, n_ranks: int) -> float:
    """1 - events/possible, the reference's headline metric
    (events counted per neighbor per tensor per pass)."""
    possible = n_neighbors * passes * n_tensors * n_ranks
    return 100.0 * (1.0 - num_events / possible) if possible else 0.0


def msgs_saved_pct_per_leaf(
    fire_counts, passes: int, n_neighbors: int, n_ranks: int,
) -> list:
    """Per-leaf msgs-saved-%: `fire_counts` is per-leaf EFFECTIVE fire
    counts summed over ranks (obs telemetry `fire_count`); each fire is
    `n_neighbors` messages, out of `n_neighbors * passes * n_ranks`
    possible per leaf — so the neighbor factor cancels and the mean over
    leaves equals the aggregate `msgs_saved_pct` exactly (the oracle
    cross-check of the obs tests). Division-guarded like the
    aggregate: zero possible messages reports 0.0 saved."""
    possible = passes * n_ranks
    if not possible or not n_neighbors:
        return [0.0 for _ in fire_counts]
    return [100.0 * (1.0 - float(f) / possible) for f in fire_counts]


def steady_records(history) -> list:
    """The steady-state slice of a train() history: every record outside a
    COLD dispatch block (a block that paid the first run's set-up: block
    0, plus the first block of any other size). A record without the
    JAX loop's `dispatch_cold` / `dispatch_block` tags (the port's loop,
    whose block is one epoch) is cold when it is epoch 1, the epoch that
    builds the kernels and warms the allocator.

    When EVERY block was cold no honest steady slice exists: fall back to
    dropping the first record, and to the full history only when that
    leaves nothing. Every fallback record is a COPY carrying
    `steady_contaminated: True`, so a benchmark reports the set-up
    contamination instead of silently absorbing it."""
    out = [
        h for h in history
        if not h.get("dispatch_cold", h.get("dispatch_block", h["epoch"] - 1) == 0)
    ]
    if out:
        return out
    fallback = list(history)[1:] or list(history)
    return [dict(h, steady_contaminated=True) for h in fallback]


def collapse_verdict(
    losses,
    twin_loss: Optional[float] = None,
    *,
    factor: float = 2.0,
    abs_floor: float = 0.5,
    bounce: float = 1.25,
    random_loss: float = 2.35,
) -> bool:
    """True when an event-triggered run has DIVERGED rather than trained —
    the guard that keeps a collapsed run from ever presenting as a
    messages-saved win (an aggressive horizon can trade accuracy for
    silence: the measured cliff is horizon 1.05 + max-silence 50 at 360
    passes -> 81.66% "saved" at 36.5% test accuracy, the JAX package's
    artifacts/mnist_knee_r3_cpu.jsonl).

    `losses` is the per-epoch train-loss history (a scalar is accepted
    as a 1-entry history). Collapse is distinct from UNDERtraining: a
    short smoke tier legitimately ends with high loss while still
    descending, and must not be flagged. Three signals, any of which
    flags:

    - twin divergence: final loss > `factor`x the dense D-PSGD twin's
      AND above `abs_floor` (the floor keeps both-converged pairs like
      0.06-vs-0.02 from false-flagging; an undertrained pair shares its
      high loss with its twin, so the ratio stays ~1)
    - bounce: final loss > `bounce`x the history's minimum AND above
      `abs_floor` — the cliff's signature (the run trains through
      warmup, then climbs once the trigger silences the exchange); a
      monotone still-descending run has min ~= final
    - never trained: final loss at or above `random_loss` (10-class
      random guessing is ln 10 ~= 2.303), or non-finite (NaN/inf — the
      hardest divergence mode must not slip through NaN's
      compare-False semantics).

    When a twin exists and the run TRACKS it (final within `factor`x),
    the bounce signal is vetoed: a late-epoch noise bounce that the
    dense twin shares is SGD noise, not collapse."""
    import math

    if hasattr(losses, "__iter__"):
        hist = [float(x) for x in losses]  # list, array, or generator
        if not hist:
            raise ValueError("collapse_verdict: empty loss history")
    else:
        hist = [float(losses)]
    final = hist[-1]
    if not math.isfinite(final) or final >= random_loss:
        return True
    if twin_loss is not None:
        return final > max(factor * float(twin_loss), abs_floor)
    return final > max(bounce * min(hist), abs_floor)
