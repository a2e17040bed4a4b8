"""Host-bubble decomposition of a training run's span trace.

Port of `eventgrad_tpu/obs/bubble.py`. The HOST BUBBLE is the fraction
of the train() wall during which the device sits idle because the host
does serialized work between dispatch blocks: telemetry flush, history
records, eval, checkpoint serialization, input assembly.

The decomposition reads the `obs.Registry` span trace the loop records
(the same spans `Registry.write_chrome_trace` exports):

  * device-busy intervals: one per dispatch block, from the
    `dispatch_block` span's start to the block's observed readiness:
    the span's own end in serial mode (it wraps the synchronize; the
    port's loop is serial, one epoch a block), the matching
    `block_ready` span's end in pipelined mode. The UNION of these
    intervals is `steps_s`.
  * wall: the `train` root span.
  * `host_bubble_frac` = 1 - steps_s / wall: everything the device was
    NOT kept busy.
  * component sums (`data_s`, `flush_s`, `eval_s`, `checkpoint_s`) are
    raw span-duration sums; `other_s` is the bubble left after the
    named components (records, python glue).

A span times the host: on the card, a dispatch block's span ends at the
synchronize inside it, so its length is the device's.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


class IncompleteTraceWarning(UserWarning):
    """A span trace is missing a span type the decomposition wants —
    e.g. a run killed mid-flight exported no `train` root, or a
    pipelined block's deferred `block_ready` span never landed. The
    decomposition degrades to a PARTIAL answer (envelope wall, enqueue
    end as readiness) and names what was missing in `missing_spans`
    instead of raising — a truncated trace is evidence, not an error."""


#: span names summed into each named bubble component
_COMPONENTS = {
    "data_s": ("data",),
    "flush_s": ("obs_flush",),
    "eval_s": ("eval", "eval_readback"),
    "checkpoint_s": ("checkpoint", "ckpt_snapshot", "ckpt_write"),
}


def _norm(span: Any) -> Tuple[str, float, float, Dict[str, Any]]:
    """(name, ts_us, dur_us, args) from an obs.registry.Span OR a
    Chrome-trace event dict (so a written trace.json replays)."""
    if isinstance(span, dict):
        return (
            span.get("name", ""),
            float(span.get("ts", 0.0)),
            float(span.get("dur", 0.0)),
            dict(span.get("args") or {}),
        )
    return span.name, float(span.ts_us), float(span.dur_us), dict(span.args)


def _union_s(intervals: List[Tuple[float, float]]) -> float:
    """Total covered length (seconds) of microsecond intervals."""
    cur_start: Optional[float] = None
    cur_end = 0.0
    total = 0.0
    for start, end in sorted(intervals):
        if cur_start is None:
            cur_start, cur_end = start, end
        elif start <= cur_end:
            cur_end = max(cur_end, end)
        else:
            total += cur_end - cur_start
            cur_start, cur_end = start, end
    if cur_start is not None:
        total += cur_end - cur_start
    return total / 1e6


def train_windows(spans: Sequence[Any]) -> List[List[Any]]:
    """Split a span list into per-`train`-root windows (a bench registry
    records several train() legs back to back); spans are assigned to
    the root whose [ts, ts+dur] contains them."""
    normed = [(_norm(s), s) for s in spans]
    roots = [
        (n[1], n[1] + n[2]) for n, _ in normed if n[0] == "train"
    ]
    out: List[List[Any]] = [[] for _ in roots]
    for n, s in normed:
        for i, (lo, hi) in enumerate(roots):
            if n[0] != "train" and lo - 1 <= n[1] and n[1] + n[2] <= hi + 1:
                out[i].append(s)
                break
            if n[0] == "train" and n[1] == lo:
                out[i].append(s)
                break
    return out


def decompose(spans: Iterable[Any]) -> Dict[str, Any]:
    """wall = steps + bubble; bubble >= data + flush + eval + checkpoint
    (serial) — returns the seconds of each plus `host_bubble_frac`."""
    normed = [_norm(s) for s in spans]
    missing: List[str] = []
    train = [n for n in normed if n[0] == "train"]
    if train:
        wall_us = train[0][2]
        t_lo = train[0][1]
    else:  # no root span: fall back to the observed envelope
        if normed:
            missing.append("train")
        t_lo = min((n[1] for n in normed), default=0.0)
        wall_us = max((n[1] + n[2] for n in normed), default=0.0) - t_lo

    # device-busy intervals: dispatch start -> observed readiness
    ready_end = {
        n[3].get("block"): n[1] + n[2]
        for n in normed if n[0] == "block_ready"
    }
    busy: List[Tuple[float, float]] = []
    n_blocks = 0
    n_ready_missing = 0
    pipelined = False
    for n in normed:
        if n[0] != "dispatch_block":
            continue
        n_blocks += 1
        blk_piped = bool(n[3].get("pipelined", False))
        pipelined = pipelined or blk_piped
        # serial blocks: the dispatch span wraps block_until_ready, so its
        # own end IS the observed readiness (the later block_ready span is
        # a no-op recorded after other host work — using it would swallow
        # that work into "busy"). Pipelined blocks: the dispatch span is
        # just the enqueue; readiness is the deferred block_ready end —
        # a truncated trace (run killed before the readback) falls back
        # to the enqueue end, UNDERCOUNTING steps_s, and says so.
        end = n[1] + n[2]
        if blk_piped:
            if n[3].get("block") in ready_end:
                end = max(end, ready_end[n[3].get("block")])
            else:
                n_ready_missing += 1
        busy.append((n[1], end))
    if n_ready_missing:
        missing.append("block_ready")
    if n_blocks == 0 and normed:
        missing.append("dispatch_block")
    if missing:
        warnings.warn(
            "span trace incomplete — missing span types "
            f"{missing}"
            + (
                f" (block_ready absent for {n_ready_missing} pipelined "
                "blocks: their steps intervals end at the enqueue)"
                if n_ready_missing else ""
            )
            + "; returning a PARTIAL decomposition",
            IncompleteTraceWarning,
            stacklevel=2,
        )
    steps_s = _union_s(busy)

    comp = {
        key: sum(n[2] for n in normed if n[0] in names) / 1e6
        for key, names in _COMPONENTS.items()
    }
    wall_s = wall_us / 1e6
    bubble_s = max(0.0, wall_s - steps_s)
    other_s = max(0.0, bubble_s - sum(comp.values()))
    out = {
        "wall_s": round(wall_s, 4),
        "steps_s": round(steps_s, 4),
        "bubble_s": round(bubble_s, 4),
        "host_bubble_frac": round(bubble_s / wall_s, 4) if wall_s else 0.0,
        **{k: round(v, 4) for k, v in comp.items()},
        "other_s": round(other_s, 4),
        "n_blocks": n_blocks,
        "pipelined": pipelined,
    }
    if missing:
        out["missing_spans"] = sorted(set(missing))
    return out


def render_text(d: Dict[str, Any], label: str = "") -> str:
    """Human-readable one-block summary of a decomposition. Tolerates
    PARTIAL dicts (a truncated trace's decomposition, or one written by
    an older tool) — absent components render as 0 rather than raising."""
    head = f"bubble decomposition{' (' + label + ')' if label else ''}:"
    lines = [
        head,
        f"  wall            {d.get('wall_s', 0.0):9.3f} s",
        f"  steps (device)  {d.get('steps_s', 0.0):9.3f} s",
        f"  host bubble     {d.get('bubble_s', 0.0):9.3f} s"
        f"  ({100 * d.get('host_bubble_frac', 0.0):.1f}% of wall)",
    ]
    for key, title in (
        ("data_s", "data"), ("flush_s", "obs flush"), ("eval_s", "eval"),
        ("checkpoint_s", "checkpoint"), ("other_s", "other"),
    ):
        lines.append(f"    {title:<13} {d.get(key, 0.0):9.3f} s")
    lines.append(
        f"  blocks={d.get('n_blocks', 0)} pipelined={d.get('pipelined', False)}"
    )
    if d.get("missing_spans"):
        lines.append(
            f"  PARTIAL: trace missing span types {d['missing_spans']}"
        )
    return "\n".join(lines)
