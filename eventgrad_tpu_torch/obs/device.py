"""On-device telemetry: cumulative accumulators carried in the train state.

Port of `eventgrad_tpu/obs/device.py` on the rank-stacked layout. The
design rule is ZERO added host syncs: every counter is a device tensor
in `TrainState.telemetry` and is CUMULATIVE, so the host reads it once
per flush (`train/loop.py` packs it into one buffer at the epoch end and
diffs consecutive snapshots, `window_record`; no device-side reset
either). A pass adds a handful of elementwise ops on `[R, L]` (L leaves)
and `[R, E]` (E edges) tensors, built from tensors only: no `.item()`,
no branch on a device value, no host-to-device copy; the constants
(log 2, the bucket ids, the queue's slot index) are made once per device.

The histograms are compare-and-sum one-hots (`(bucket[..., None] ==
arange(16)).sum(-2)`), integer-exact and deterministic on every device
(`scatter_add_` / `bincount` are not, under deterministic algorithms on
CUDA). Field semantics: `obs.schema.TELEMETRY_FIELDS`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.obs import ledger as obs_ledger
from eventgrad_tpu_torch.obs.schema import OBS_SCHEMA_VERSION, SILENCE_BUCKETS


@dataclasses.dataclass
class TelemetryState:
    """Per-rank cumulative telemetry counters (units: schema
    .TELEMETRY_FIELDS), stacked over ranks like every other TrainState
    field. The fields after `edge_bytes` were added to the JAX state
    after its first snapshots, so they default to None (a hand-built
    state without them skips their record keys, as the JAX one does)."""

    steps: torch.Tensor             # i32 [R]
    fire_count: torch.Tensor        # i32 [R, L]
    defer_count: torch.Tensor       # i32 [R, L]
    thres_sum: torch.Tensor         # f32 [R, L]
    drift_sum: torch.Tensor         # f32 [R, L]
    silence_hist: torch.Tensor      # i32 [R, SILENCE_BUCKETS]
    fired_elems_sum: torch.Tensor   # f32 [R]
    fired_elems_peak: torch.Tensor  # f32 [R]
    edge_bytes: torch.Tensor        # f32 [R, E]
    #: integrity counters: per-edge wire rejections, quarantined passes
    wire_reject: Optional[torch.Tensor] = None     # i32 [R, E]
    quarantined: Optional[torch.Tensor] = None     # i32 [R]
    #: per-bucket wire-real bytes ([1] on the monolithic schedule)
    bucket_bytes: Optional[torch.Tensor] = None    # f32 [R, K]
    #: bounded-async: per-edge staleness sums, its log2 histogram, and
    #: the late commits
    edge_staleness: Optional[torch.Tensor] = None  # f32 [R, E]
    staleness_hist: Optional[torch.Tensor] = None  # i32 [R, SILENCE_BUCKETS]
    late_commits: Optional[torch.Tensor] = None    # i32 [R]
    #: the message-lifecycle ledger, moved only by ledger_update
    ledger: Optional[obs_ledger.MessageLedger] = None

    def replace(self, **kw) -> "TelemetryState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def init(cls, n_leaves: int, n_edges: int, n_buckets: int = 1,
             queue_depth: int = 0, *, n_ranks: int,
             device=None) -> "TelemetryState":
        """Zero counters, stacked over the `n_ranks` ranks."""

        def z(dtype, *shape):
            return torch.zeros((int(n_ranks),) + shape, dtype=dtype,
                               device=device)

        i32, f32 = torch.int32, torch.float32
        return cls(
            steps=z(i32),
            fire_count=z(i32, n_leaves),
            defer_count=z(i32, n_leaves),
            thres_sum=z(f32, n_leaves),
            drift_sum=z(f32, n_leaves),
            silence_hist=z(i32, SILENCE_BUCKETS),
            fired_elems_sum=z(f32),
            fired_elems_peak=z(f32),
            edge_bytes=z(f32, n_edges),
            wire_reject=z(i32, n_edges),
            quarantined=z(i32),
            bucket_bytes=z(f32, max(1, int(n_buckets))),
            edge_staleness=z(f32, n_edges),
            staleness_hist=z(i32, SILENCE_BUCKETS),
            late_commits=z(i32),
            ledger=obs_ledger.MessageLedger.init(
                n_edges, queue_depth, n_ranks=n_ranks, device=device),
        )


@functools.lru_cache(maxsize=16)
def _bucket_consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f32 [] log(2); i32 [16] the bucket ids), made once per device
    without a host copy."""
    ln2 = torch.log(torch.full((), 2.0, dtype=torch.float32, device=device))
    ids = torch.arange(SILENCE_BUCKETS, dtype=torch.int32, device=device)
    return ln2, ids


def silence_bucket(silence: torch.Tensor) -> torch.Tensor:
    """Silence (passes since last send) -> log2 bucket index, int32 of the
    same shape: bucket k counts silence in [2^k, 2^(k+1)); the last
    bucket absorbs the tail; silence < 1 clamps into bucket 0.

    The JAX function's expression, `clip(floor(log2(max(s, 1))), 0, 15)`
    with `jnp.log2(s)` = `log(s) / log(2)` in float32, computed the same
    way (an IEEE division by a device tensor), so the buckets are the
    reference's: on the CPU that float32 quotient lands just below 13 and
    15 at s = 8192 and 32768, which the reference (and so the port) puts
    one bucket low."""
    ln2, _ = _bucket_consts(silence.device)
    s = torch.clamp_min(silence.to(torch.float32), 1.0)
    return torch.clamp(torch.floor(torch.log(s) / ln2).to(torch.int32),
                       0, SILENCE_BUCKETS - 1)


def _hist(values: torch.Tensor) -> torch.Tensor:
    """int32 [..., SILENCE_BUCKETS]: the one-hot count of the values'
    buckets over the last dimension."""
    _, ids = _bucket_consts(values.device)
    return torch.sum(silence_bucket(values)[..., None] == ids, dim=-2,
                     dtype=torch.int32)


def accumulate(
    tel: TelemetryState,
    *,
    fire_vec: Optional[torch.Tensor] = None,      # bool [R, L] effective
    defer_vec: Optional[torch.Tensor] = None,     # bool [R, L] gated out
    thres: Optional[torch.Tensor] = None,         # f32 [R, L] post-decay
    drift: Optional[torch.Tensor] = None,         # f32 [R, L] |norm - sent|
    silence: Optional[torch.Tensor] = None,       # f32/i32 [R, L]
    fired_elems: Optional[torch.Tensor] = None,   # f32 [R] admitted elements
    edge_bytes: Optional[torch.Tensor] = None,    # f32 [R, E] this pass
    wire_reject: Optional[torch.Tensor] = None,   # bool/i32 [R, E]
    quarantined: Optional[torch.Tensor] = None,   # bool/i32 [R]
    bucket_bytes: Optional[torch.Tensor] = None,  # f32 [R, K] this pass
    edge_staleness: Optional[torch.Tensor] = None,  # i32/f32 [R, E]
    late_commits: Optional[torch.Tensor] = None,    # i32 [R] this pass
    ledger_inputs: Optional[dict] = None,  # keyword arguments of ledger_update
) -> TelemetryState:
    """One pass of counter updates; omitted (None) quantities leave their
    counters untouched (the non-event algorithms pass only edge_bytes).
    Every input is a device tensor; every update is elementwise, or a sum
    over the trailing dimension, in int32 for the counts."""
    i32, f32 = torch.int32, torch.float32
    upd = {"steps": tel.steps + 1}
    if fire_vec is not None:
        upd["fire_count"] = tel.fire_count + fire_vec.to(i32)
    if defer_vec is not None:
        upd["defer_count"] = tel.defer_count + defer_vec.to(i32)
    if thres is not None:
        upd["thres_sum"] = tel.thres_sum + thres
    if drift is not None:
        upd["drift_sum"] = tel.drift_sum + drift
    if silence is not None:
        upd["silence_hist"] = tel.silence_hist + _hist(silence)
    if fired_elems is not None:
        fe = fired_elems.to(f32)
        upd["fired_elems_sum"] = tel.fired_elems_sum + fe
        upd["fired_elems_peak"] = torch.maximum(tel.fired_elems_peak, fe)
    if edge_bytes is not None:
        upd["edge_bytes"] = tel.edge_bytes + edge_bytes
    if wire_reject is not None:
        upd["wire_reject"] = tel.wire_reject + wire_reject.to(i32)
    if quarantined is not None:
        upd["quarantined"] = tel.quarantined + quarantined.to(i32)
    if bucket_bytes is not None:
        upd["bucket_bytes"] = tel.bucket_bytes + bucket_bytes
    if edge_staleness is not None:
        upd["edge_staleness"] = tel.edge_staleness + edge_staleness.to(f32)
        upd["staleness_hist"] = tel.staleness_hist + _hist(edge_staleness)
    if late_commits is not None:
        upd["late_commits"] = tel.late_commits + late_commits.to(i32)
    if ledger_inputs is not None and tel.ledger is not None:
        # the message-lifecycle ledger: ALL disposition arithmetic lives
        # in obs.ledger.ledger_update; the step hands over the branch's
        # raw observables (obs/schema.py DISPOSITIONS)
        upd["ledger"] = obs_ledger.ledger_update(tel.ledger, **ledger_inputs)
    return tel.replace(**upd)


# --- the flush: one device-to-host copy of the whole state ------------------


def _fields(tel: TelemetryState) -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every present counter, ledger included."""
    out = []
    for f in dataclasses.fields(tel):
        v = getattr(tel, f.name)
        if v is None:
            continue
        if isinstance(v, obs_ledger.MessageLedger):
            out.extend((f"ledger/{g.name}", getattr(v, g.name))
                       for g in dataclasses.fields(v)
                       if getattr(v, g.name) is not None)
        else:
            out.append((f.name, v))
    return out


def pack(tel: TelemetryState) -> torch.Tensor:
    """Every counter in one int32 device buffer (the f32 ones by their
    bits): the flush then reads the whole state with one copy."""
    return torch.cat([
        (t.view(torch.int32) if t.dtype == torch.float32 else t).reshape(-1)
        for _, t in _fields(tel)])


def unpack(buf, like: TelemetryState) -> TelemetryState:
    """The host snapshot (numpy arrays) of a `pack` buffer, in the layout
    of `like` (the device state it was packed from)."""
    buf = np.asarray(buf, np.int32)
    vals: Dict[str, np.ndarray] = {}
    off = 0
    for path, t in _fields(like):
        n = t.numel()
        a = buf[off:off + n].reshape(tuple(t.shape))
        vals[path] = a.view(np.float32) if t.dtype == torch.float32 else a
        off += n
    led = None
    if like.ledger is not None:
        led = obs_ledger.MessageLedger(
            counts=vals["ledger/counts"], queue=vals.get("ledger/queue"),
            late_queue=vals.get("ledger/late_queue"))
    return TelemetryState(**{
        f.name: (led if f.name == "ledger" else vals.get(f.name))
        for f in dataclasses.fields(like)})


def window_record(cur, prev=None):
    """Host-side flush: diff two cumulative stacked snapshots (leading
    axis = ranks; numpy arrays or tensors) into one flush-window `obs`
    dict, the schema.RECORD_FIELDS shape the history records carry.
    `prev=None` means "since init" (the first flush). Counts sum over
    ranks; means average over ranks; the fired-elements peak is the max
    over ranks of the CUMULATIVE running peak (a running max cannot be
    windowed)."""

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def d(field):
        c = np.asarray(host(getattr(cur, field)), np.float64)
        if prev is None:
            return c
        return c - np.asarray(host(getattr(prev, field)), np.float64)

    steps = int(d("steps").reshape(-1)[0])
    denom = max(1, steps)
    rec = {
        "schema": OBS_SCHEMA_VERSION,
        "steps": steps,
        "fire_count": [int(v) for v in d("fire_count").sum(axis=0)],
        "defer_count": [int(v) for v in d("defer_count").sum(axis=0)],
        "thres_mean": [
            round(float(v), 6) for v in d("thres_sum").mean(axis=0) / denom
        ],
        "drift_mean": [
            round(float(v), 6) for v in d("drift_sum").mean(axis=0) / denom
        ],
        "silence_hist": [int(v) for v in d("silence_hist").sum(axis=0)],
        "fired_elems_mean": round(
            float(d("fired_elems_sum").mean()) / denom, 2
        ),
        "fired_elems_peak": float(
            np.asarray(host(cur.fired_elems_peak), np.float64).max()
        ),
        "edge_bytes_per_step": [
            round(float(v), 2) for v in d("edge_bytes").mean(axis=0) / denom
        ],
    }
    if cur.wire_reject is not None:
        rec["wire_reject_count"] = [
            int(v) for v in d("wire_reject").sum(axis=0)
        ]
        rec["quarantined_steps"] = int(d("quarantined").sum())
    if cur.bucket_bytes is not None:
        rec["bucket_bytes_per_step"] = [
            round(float(v), 2)
            for v in d("bucket_bytes").mean(axis=0) / denom
        ]
    if cur.edge_staleness is not None:
        rec["edge_staleness_per_step"] = [
            round(float(v), 4)
            for v in d("edge_staleness").mean(axis=0) / denom
        ]
        rec["staleness_hist"] = [
            int(v) for v in d("staleness_hist").sum(axis=0)
        ]
        rec["late_commit_count"] = int(d("late_commits").sum())
    if cur.ledger is not None:
        rec["message_ledger"] = obs_ledger.window_block(
            cur.ledger, None if prev is None else prev.ledger
        )
    return rec
