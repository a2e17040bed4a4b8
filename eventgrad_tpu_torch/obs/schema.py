"""The ONE versioned schema behind every observability surface.

A copy of `eventgrad_tpu/obs/schema.py`, table for table (the port
imports nothing of the JAX package; `tests/test_torch_obs.py` holds
every table here equal to the JAX one, key for key, which is the port's
counterpart of the JAX package's doc-coverage test of
`docs/OBSERVABILITY.md`). Everything of the port's telemetry (the
on-device `TelemetryState` accumulators, the per-record `obs` block in
train() history, the Registry's Prometheus gauges) names its fields from
the tables below, as do the membership engine's records
(`MEMBERSHIP_FIELDS`, `chaos/membership.py`) and the cost model's
(`PERF_FIELDS`, `obs/costmodel.py`). On a device mesh the counters are
gathered from every process at each block's flush, so the exports and
the ledger's audit read all R ranks, as on the simulator.

Bump OBS_SCHEMA_VERSION when a field changes meaning or units; adding a
field is backward compatible (readers must tolerate unknown keys).
"""

from __future__ import annotations

#: version stamp carried by every Registry record (`obs_schema`) and every
#: per-block `obs` telemetry dict in train() history
OBS_SCHEMA_VERSION = 1

#: silence histogram geometry: bucket k counts leaf-passes with silence in
#: [2^k, 2^(k+1)) passes (bucket 0 = fired on the previous pass); the last
#: bucket absorbs everything >= 2^(SILENCE_BUCKETS-1)
SILENCE_BUCKETS = 16

#: Prometheus metric-name prefix for every exported gauge
PROM_PREFIX = "eventgrad"

#: The message-lifecycle disposition taxonomy (obs/ledger.py): every
#: per-edge message a pass can affect lands in EXACTLY ONE leaf
#: disposition, so integer balance laws hold per edge per flush window
#: (docs/OBSERVABILITY.md "Message-lifecycle ledger"):
#:
#:   proposed  = suppressed + deferred + fired            (sender side)
#:   fired     = delivered + dropped + rejected + in_flight
#:                                         (receiver side, rank-summed)
#:   sender.fired(e) = receiver.(delivered+dropped+rejected+
#:                     in_flight)(e)       (cross-rank, per edge)
#:
#: name -> (parent disposition or None, description). The dict order IS
#: the counter-row order of MessageLedger.counts.
DISPOSITIONS = {
    "proposed": (
        None,
        "trigger raised the leaf this pass (threshold crossing, "
        "max-silence forced fire, or membership force-fire) — the root "
        "of the sender-side tree",
    ),
    "suppressed": (
        "proposed",
        "proposal cancelled before the wire: quarantine (non-finite "
        "grads/params) or a trigger-policy veto — nothing shipped",
    ),
    "deferred": (
        "proposed",
        "proposal admitted by the trigger but pushed past this pass by "
        "the compact-wire capacity gate — ships on a later pass",
    ),
    "fired": (
        "proposed",
        "proposal actually put on the wire this pass (post-suppression, "
        "post-capacity-gate) — the sender-side leaf that the "
        "receiver-side tree partitions",
    ),
    "delivered": (
        "fired",
        "message committed into the receiver's gossip buffer (same pass "
        "on the synchronous paths; on arrival under bounded async)",
    ),
    "dropped": (
        "fired",
        "message lost on the wire (chaos delivery mask) — the receiver "
        "kept the stale buffer",
    ),
    "rejected": (
        "fired",
        "message refused at the wire by the integrity engine (checksum "
        "mismatch or non-finite payload) — stale buffer kept, "
        "bitwise an event that did not fire",
    ),
    "in_flight": (
        "fired",
        "message accepted into the bounded-async delivery queue but not "
        "yet committed (a gauge, not a cumulative counter: the queued "
        "census drains into delivered)",
    ),
    "late_committed": (
        "in_flight",
        "delivered message that committed >= 2 passes after its send — "
        "the genuinely-late arrivals the staleness bound admitted "
        "(a sub-count of delivered, never exceeding it)",
    ),
}

#: the cumulative-counter rows of MessageLedger.counts, in row order —
#: every DISPOSITIONS leaf except the in_flight gauge (derived from the
#: ledger's delivery queue instead)
LEDGER_COUNTER_ROWS = tuple(d for d in DISPOSITIONS if d != "in_flight")

#: On-device accumulator fields (obs.device.TelemetryState). All counters
#: are CUMULATIVE on device — the host diffs consecutive flushes, so a
#: flush costs one device->host read and zero device writes.
#: name -> (units, wire modes that populate it, description)
TELEMETRY_FIELDS = {
    "steps": (
        "passes", "all",
        "passes accumulated since telemetry init",
    ),
    "fire_count": (
        "fires[leaf]", "event algos",
        "per-leaf EFFECTIVE fires (committed after any capacity gating); "
        "sum * n_neighbors reconciles with EventState.num_events",
    ),
    "defer_count": (
        "deferrals[leaf]", "compact wire",
        "per-leaf fires proposed by the trigger but deferred by the "
        "compact wire budget; sums to EventState.num_deferred",
    ),
    "thres_sum": (
        "threshold-sum[leaf]", "event algos",
        "per-leaf post-decay threshold sums (mean = /steps): the "
        "threshold trajectory at block granularity",
    ),
    "drift_sum": (
        "norm-drift-sum[leaf]", "event algos",
        "per-leaf |  ||p||_2 - last_sent_norm | sums — the trigger's "
        "drive signal",
    ),
    "silence_hist": (
        "leaf-passes[bucket]", "event algos",
        "log2-bucketed histogram of per-leaf silence (passes since last "
        "send) observed at each pass; bucket k = [2^k, 2^(k+1))",
    ),
    "fired_elems_sum": (
        "elements", "event algos",
        "payload elements admitted to the wire, summed over passes "
        "(capacity-utilization numerator on the compact wire)",
    ),
    "fired_elems_peak": (
        "elements", "event algos",
        "max per-pass admitted payload elements since init",
    ),
    "edge_bytes": (
        "bytes[edge]", "gossip algos",
        "per-edge wire-real bytes accumulated (the SPMD bytes the "
        "collective actually moved — dense/masked ship the full payload, "
        "compact ships the static capacity; see docs/compaction.md)",
    ),
    "wire_reject": (
        "rejections[edge]", "integrity runs",
        "per-edge payloads rejected at the wire (checksum mismatch or "
        "non-finite content) — each rejection kept the stale buffer, "
        "bitwise an event that did not fire (docs/chaos.md)",
    ),
    "quarantined": (
        "passes", "integrity runs",
        "passes this rank spent quarantined (non-finite local gradients "
        "or post-update parameters: update skipped, sends suppressed)",
    ),
    "bucket_bytes": (
        "bytes[bucket]", "gossip algos",
        "per-bucket wire-real bytes accumulated under the bucketed "
        "gossip schedule (train(bucketed=K)); [1] on the monolithic "
        "path — the sum always equals the edge_bytes total (see "
        "docs/ARCHITECTURE.md 'Bucketed gossip schedule')",
    ),
    "edge_staleness": (
        "staleness-sum[edge]", "bounded-async runs",
        "per-edge staleness gauge accumulated per pass (passes between "
        "the newest committed delivery's send and now; mean = /steps) "
        "under the bounded-async engine (train(staleness=D >= 2)) — "
        "bounded by D plus any drop streak; also the Prometheus gauge "
        "eventgrad_edge_staleness (docs/chaos.md 'Bounded-async gossip "
        "& stragglers')",
    ),
    "staleness_hist": (
        "edge-passes[bucket]", "bounded-async runs",
        "log2-bucketed histogram of the per-edge-pass staleness gauge "
        "(same bucket geometry as silence_hist)",
    ),
    "late_commits": (
        "commits", "bounded-async runs",
        "deliveries committed >= 2 passes after their send — the "
        "genuinely-late arrivals the bound admitted (each one bitwise "
        "a fire deferred to its arrival pass); reconciles with "
        "EventState.late_commits",
    ),
}

#: Host-side `obs` block attached to block-end history records
#: (train/loop.py). Every count is the DELTA over the flush window, per
#: rank summed unless noted. name -> (units, wire modes, description)
RECORD_FIELDS = {
    "schema": ("int", "all", "OBS_SCHEMA_VERSION of the writer"),
    "steps": ("passes", "all", "passes in this flush window"),
    "fire_count": (
        "fires[leaf]", "event algos",
        "per-leaf effective fires, summed over ranks",
    ),
    "defer_count": (
        "deferrals[leaf]", "compact wire",
        "per-leaf deferrals, summed over ranks",
    ),
    "thres_mean": (
        "threshold[leaf]", "event algos",
        "per-leaf mean post-decay threshold over the window (rank mean)",
    ),
    "drift_mean": (
        "norm-drift[leaf]", "event algos",
        "per-leaf mean norm drift over the window (rank mean)",
    ),
    "silence_hist": (
        "leaf-passes[bucket]", "event algos",
        "silence histogram delta, summed over ranks",
    ),
    "fired_elems_mean": (
        "elements", "event algos",
        "mean per-pass admitted payload elements (rank mean)",
    ),
    "fired_elems_peak": (
        "elements", "event algos",
        "peak per-pass admitted payload elements (max over ranks, "
        "cumulative since init — peaks cannot be windowed from a "
        "running max)",
    ),
    "edge_bytes_per_step": (
        "bytes[edge]", "gossip algos",
        "per-edge wire-real bytes per pass (rank mean)",
    ),
    "wire_reject_count": (
        "rejections[edge]", "integrity runs",
        "per-edge wire rejections in this flush window, summed over ranks",
    ),
    "quarantined_steps": (
        "rank-passes", "integrity runs",
        "quarantined rank-passes in this flush window, summed over ranks",
    ),
    "bucket_bytes_per_step": (
        "bytes[bucket]", "gossip algos",
        "per-bucket wire-real bytes per pass (rank mean) — the bucketed "
        "gossip schedule's wire split; a single entry on the "
        "monolithic path",
    ),
    "edge_staleness_per_step": (
        "staleness[edge]", "bounded-async runs",
        "per-edge mean staleness per pass over the window (rank mean) "
        "— 1.0 is the no-fault asynchrony baseline, a persistent "
        "straggler's edges sit at min(f, D)",
    ),
    "late_commit_count": (
        "commits", "bounded-async runs",
        "late (lag >= 2) delivery commits in this flush window, summed "
        "over ranks",
    ),
}

#: keys the first obs-carrying record of a run additionally carries
RECORD_META_FIELDS = {
    "leaves": ("names[leaf]", "all", "parameter leaf names, leaf-major"),
    "edges": ("names[edge]", "all", "gossip edge names (topology order)"),
    "silence_buckets": (
        "int", "all", "histogram bucket count (log2 geometry)",
    ),
    "n_ranks": ("int", "all", "ranks contributing to summed counts"),
    "n_neighbors": ("int", "all", "gossip neighbors per rank"),
    "wire": (
        "str|null", "all", "gossip wire dtype (null = f32, bf16, int8)",
    ),
}


#: Elastic-membership surfaces (chaos/membership.py): per-epoch history
#: record fields plus the Prometheus gauges `eventgrad_active_ranks` and
#: `eventgrad_membership_transitions_total`. name -> (units, modes,
#: description)
MEMBERSHIP_FIELDS = {
    "active_ranks": (
        "int", "all",
        "ranks alive during the record's dispatch block (constant "
        "without membership; the elasticity trajectory with it) — also "
        "a Prometheus gauge",
    ),
    "membership": (
        "schedule dict", "membership runs",
        "the serialized MembershipSchedule, stamped on the run's first "
        "record (replayability rider, like `chaos`)",
    ),
    "membership_transitions": (
        "records[transition]", "membership runs",
        "transition info dicts (kind, epoch, index, src, "
        "n_ranks_before/after, bootstrap_streamed, apply_s) on the "
        "record FOLLOWING the block boundary they were applied at; "
        "their cumulative count is the "
        "membership_transitions_total gauge",
    ),
}


#: Integrity-engine surfaces (chaos/integrity.py): per-epoch history
#: record fields plus the Prometheus gauges
#: `eventgrad_wire_rejects_total`, `eventgrad_quarantined_steps_total`,
#: and `eventgrad_integrity_rollbacks_total`.
#: name -> (units, modes, description)
INTEGRITY_FIELDS = {
    "wire_rejects": (
        "rejections", "integrity runs",
        "payloads rejected at the wire this epoch (checksum mismatch or "
        "non-finite content), summed over ranks and edges — cumulative "
        "form is the wire_rejects_total gauge",
    ),
    "quarantined_steps": (
        "rank-passes", "integrity runs",
        "rank-passes quarantined this epoch (update skipped, sends "
        "suppressed) — cumulative form is the quarantined_steps_total "
        "gauge",
    ),
    "integrity": (
        "config dict", "integrity runs",
        "the serialized IntegrityConfig, stamped on the run's first "
        "record (replayability rider, like `chaos`)",
    ),
    "integrity_rollbacks": (
        "int", "integrity runs",
        "rollbacks performed so far (cumulative; also the "
        "integrity_rollbacks_total gauge)",
    ),
    "integrity_rollback": (
        "info dict", "integrity runs",
        "rollback info (reason, tripped_epoch, restored_epoch, "
        "hardened) on the first record AFTER the engine restored the "
        "last-known-good snapshot",
    ),
}


#: Preemption & crash-drill surfaces (chaos/crashpoint.py): terminal/
#: first-record riders plus the Prometheus gauge
#: `eventgrad_preemptions_total`. name -> (units, modes, description)
PREEMPTION_FIELDS = {
    "preempted": (
        "record", "preemption runs",
        "terminal record the CLI writes after a graceful drain: reason "
        "(signal:SIGTERM|signal:SIGINT|schedule:E@S), epoch (the "
        "drained block boundary), snapshot (a boundary snapshot is on "
        "disk), drain_s, marker (the PREEMPTED file path) — the "
        "process then exits exitcodes.PREEMPTED_EXIT and the "
        "supervisor relaunches without charging its restart budget",
    ),
    "drain_s": (
        "seconds", "preemption runs",
        "time the graceful drain spent (pipeline drain + writer join + "
        "boundary snapshot), inside the `preempted` record",
    ),
    "crashpoint": (
        "rider", "crash-drill runs",
        "the armed EG_CRASHPOINT as {site, hit}, stamped on the run's "
        "first record (replayability rider, like `chaos`): the log of "
        "a killed run names the site it died at",
    ),
    "preemptions_total": (
        "count", "preemption runs",
        "Prometheus gauge: graceful preemption drains this process "
        "performed (0 normally, 1 after a drain)",
    ),
}


#: Performance-ledger surfaces (obs/costmodel.py + obs/devicespec.py +
#: tools/perf_ledger.py): the `costmodel` block bench.py and
#: tools/tpu_flagship.py attach to their records, and the per-round
#: trajectory fields of artifacts/perf_ledger*.json.
#: name -> (units, modes, description)
PERF_FIELDS = {
    "flops_per_step": (
        "FLOP", "all",
        "analytic FLOPs of one full train step (all vmap-ranks), from "
        "the obs.costmodel jaxpr walk: dot_general/conv exactly from "
        "shapes, elementwise/reductions per operand element — "
        "backend-independent, unlike the XLA cost_analysis number it "
        "rides next to",
    ),
    "hbm_bytes_per_step": (
        "bytes", "all",
        "analytic per-step memory-traffic CEILING (operand + result "
        "bytes of every traced equation, no fusion credit) — stable "
        "across rounds by construction, the regression ledger's "
        "bytes denominator",
    ),
    "flops_by_phase": (
        "FLOP[phase]", "all",
        "the per-phase split grad / gate_pack / exchange / commit_mix "
        "/ other from the egphase named scopes in train/steps.py "
        "(per-bucket labels <phase>.bK under bucketed=K)",
    ),
    "hbm_bytes_by_phase": (
        "bytes[phase]", "all",
        "the same phase split for the analytic byte ceiling",
    ),
    "mfu": (
        "fraction", "all",
        "model-FLOPs utilization: flops_per_step / (step_s * "
        "peak_flops) of the device spec — on a nominal spec "
        "(generic-cpu) a cross-round TRACKING number, not a hardware "
        "claim (obs/devicespec.py)",
    ),
    "achieved_flops_per_s": (
        "FLOP/s", "all", "flops_per_step / measured step seconds",
    ),
    "achieved_bytes_per_s": (
        "bytes/s", "all",
        "hbm_bytes_per_step / measured step seconds (against the "
        "analytic ceiling, so a lower bound on achieved bandwidth "
        "efficiency)",
    ),
    "arithmetic_intensity": (
        "FLOP/byte", "all",
        "flops_per_step / hbm_bytes_per_step — the roofline x-axis",
    ),
    "ridge_intensity": (
        "FLOP/byte", "all",
        "peak_flops / peak_hbm_bytes_per_s of the device spec: the "
        "roofline ridge — below it memory-bound, above compute-bound",
    ),
    "roofline_bound": (
        "compute|memory", "all",
        "which roofline regime the step sits in (arithmetic_intensity "
        "vs ridge_intensity)",
    ),
    "roofline_frac": (
        "fraction", "all",
        "achieved FLOP/s over the ATTAINABLE ceiling at this "
        "intensity, min(peak_flops, intensity * peak_bw) — the honest "
        "utilization for memory-bound steps where raw MFU reads low",
    ),
    "device_spec": (
        "str", "all",
        "obs.devicespec name the peaks came from (tpu-v5e, ..., "
        "generic-cpu); nominal_spec=true marks placeholder peaks",
    ),
    "peak_hbm_bytes": (
        "bytes", "all",
        "the backend's own compiled-program memory analysis "
        "(obs.costmodel.compiled_memory: argument/output/temp/code "
        "bytes + peak_bytes), when the backend reports one",
    ),
    "compile_spans": (
        "seconds[stage]", "all",
        "trace / lower / compile / first-dispatch wall spans "
        "(obs.costmodel.compile_timed; span names compile_trace, "
        "compile_lower, compile_compile, first_dispatch in the span "
        "registry, cat=\"compile\")",
    ),
    "resident_dtype": (
        "f32|bf16|int8", "event algos",
        "resident dtype of the EventState receive buffers — 'f32' "
        "unless the run is carrier-resident (train "
        "carrier_resident=True keeps the buffers in the wire carrier "
        "dtype); part of every history record and of the perf "
        "ledger's residency rows, so byte comparisons are keyed on "
        "the layout that actually ran",
    ),
}


#: Message-lifecycle ledger surfaces (obs/ledger.py): the per-edge
#: disposition counters inside TelemetryState, the `message_ledger`
#: block window_record attaches to the record's `obs` dict, and the
#: host-side conservation auditor's verdict. name -> (units, modes,
#: description)
LEDGER_FIELDS = {
    "ledger": (
        "counts[disposition][edge]", "gossip algos",
        "the on-device MessageLedger block of TelemetryState: cumulative "
        "int32 per-edge counters, one row per DISPOSITIONS leaf (plus "
        "the bounded-async in-flight delivery queue the in_flight gauge "
        "derives from); every message-affecting path increments exactly "
        "one disposition through obs.ledger.ledger_update",
    ),
    "message_ledger": (
        "counts[disposition][edge]", "gossip algos",
        "record-surface twin of the device ledger: per-disposition "
        "per-edge window deltas summed over ranks, plus the in_flight "
        "gauge at the window end",
    ),
    "ledger_audit": (
        "verdict dict", "gossip algos",
        "the host-side conservation auditor's verdict for the flush "
        "window (obs.ledger.audit_window): ok, checks performed, and "
        "the first few violations with edge/rank/law attribution",
    ),
    "in_flight": (
        "messages[edge]", "bounded-async runs",
        "gauge: messages accepted into the bounded-async delivery queue "
        "but not yet committed (row-sum of the ledger's queue) — the "
        "balancing term that makes fired = delivered + dropped + "
        "rejected + in_flight exact mid-flight",
    ),
}


#: The Prometheus export contract: every field
#: of every *_FIELDS group above is either exported as a gauge (its
#: entry here names the gauge, sans PROM_PREFIX) or listed in
#: PROM_EXCLUDED with a reason — a new field can no longer silently
#: skip the exporter (tests/test_ledger.py keeps the partition total).
PROM_EXPORTED = {
    # TELEMETRY_FIELDS
    "edge_staleness": "edge_staleness",          # {edge=...} labels
    "late_commits": "late_commits_total",
    "wire_reject": "wire_rejects_total",         # cumulative twin
    "quarantined": "quarantined_steps_total",    # cumulative twin
    # MEMBERSHIP_FIELDS
    "active_ranks": "active_ranks",
    "membership_transitions": "membership_transitions_total",
    # INTEGRITY_FIELDS
    "wire_rejects": "wire_rejects_total",
    "quarantined_steps": "quarantined_steps_total",
    "integrity_rollbacks": "integrity_rollbacks_total",
    # PREEMPTION_FIELDS
    "preemptions_total": "preemptions_total",
    # LEDGER_FIELDS: one gauge per cumulative disposition row (summed
    # over ranks and edges) + the in-flight gauge + the audit verdict
    "ledger": "ledger_disposition_total",        # {disposition=...}
    "message_ledger": "ledger_disposition_total",
    "in_flight": "ledger_in_flight",
    "ledger_audit": "ledger_audit_failures_total",
}

#: field -> why it is NOT a Prometheus gauge. Vectors/histograms stay on
#: the JSONL/report surface (Prometheus gauges are scalars per label
#: set and these would explode cardinality); config/info dicts are
#: replayability riders, not time series; perf/report fields live in
#: artifacts, not the live exporter.
PROM_EXCLUDED = {
    # TELEMETRY_FIELDS — per-leaf/bucket vectors and report-only scalars
    "steps": "window bookkeeping; wall-clock rates come from the span "
             "registry, not a pass counter",
    "fire_count": "per-leaf vector (one gauge per leaf would explode "
                  "cardinality); report surface renders the heatmap",
    "defer_count": "per-leaf vector; the ledger's deferred row carries "
                   "the per-edge scalar twin",
    "thres_sum": "per-leaf vector; report-surface heatmap",
    "drift_sum": "per-leaf vector; report-surface heatmap",
    "silence_hist": "histogram; chaos.monitor exports edge_silence_max "
                    "as the live scalar",
    "fired_elems_sum": "capacity-utilization numerator; report surface",
    "fired_elems_peak": "running max, not a rate; report surface",
    "edge_bytes": "per-edge byte vector; sent_bytes rides the history "
                  "records and bench artifacts",
    "bucket_bytes": "per-bucket vector; report surface",
    "staleness_hist": "histogram; edge_staleness is the live gauge",
    # RECORD_FIELDS — window-delta twins of the device counters above;
    # the JSONL history is their surface
    "schema": "version stamp, not a metric",
    "thres_mean": "per-leaf vector (see thres_sum)",
    "drift_mean": "per-leaf vector (see drift_sum)",
    "fired_elems_mean": "report surface (see fired_elems_sum)",
    "edge_bytes_per_step": "per-edge vector (see edge_bytes)",
    "wire_reject_count": "window delta; wire_rejects_total is the "
                         "cumulative gauge",
    "bucket_bytes_per_step": "per-bucket vector (see bucket_bytes)",
    "edge_staleness_per_step": "window delta; edge_staleness is the "
                               "live gauge",
    "late_commit_count": "window delta; late_commits_total is the "
                         "cumulative gauge",
    # RECORD_META_FIELDS — run metadata, not time series
    "leaves": "metadata rider", "edges": "metadata rider",
    "silence_buckets": "metadata rider", "n_ranks": "metadata rider",
    "n_neighbors": "metadata rider", "wire": "metadata rider",
    # MEMBERSHIP / INTEGRITY / PREEMPTION info dicts
    "membership": "config dict replayability rider",
    "integrity": "config dict replayability rider",
    "integrity_rollback": "info dict; integrity_rollbacks_total is the "
                          "gauge",
    "preempted": "terminal record; preemptions_total is the gauge",
    "drain_s": "inside the terminal preempted record",
    "crashpoint": "replayability rider",
    # PERF_FIELDS — artifact surface (perf ledger), not the live
    # exporter: one reason for the whole group
    **{f: "perf-ledger artifact surface (tools/perf_ledger.py), not a "
          "live exporter metric" for f in (
        "flops_per_step", "hbm_bytes_per_step", "flops_by_phase",
        "hbm_bytes_by_phase", "mfu", "achieved_flops_per_s",
        "achieved_bytes_per_s", "arithmetic_intensity",
        "ridge_intensity", "roofline_bound", "roofline_frac",
        "device_spec", "peak_hbm_bytes", "compile_spans",
        "resident_dtype",
    )},
    # REPORT_FIELDS — derived report series
    **{f: "derived report series (tools/obs_report.py), not a live "
          "exporter metric" for f in (
        "msgs_saved_pct_per_leaf", "fire_rate_heatmap", "thres_heatmap",
        "capacity_utilization", "consensus_error", "message_lifecycle",
    )},
}


#: derived series emitted by obs.report.build_report (tools/obs_report.py)
REPORT_FIELDS = {
    "msgs_saved_pct_per_leaf": (
        "%[leaf] per window", "event algos",
        "per-leaf messages saved vs D-PSGD "
        "(utils.metrics.msgs_saved_pct_per_leaf over window fire counts)",
    ),
    "fire_rate_heatmap": (
        "rate[window][leaf]", "event algos",
        "per-leaf fire rate per flush window (fire_count / (steps * "
        "n_ranks)) — heatmap rows",
    ),
    "thres_heatmap": (
        "threshold[window][leaf]", "event algos",
        "per-leaf mean post-decay threshold per flush window",
    ),
    "capacity_utilization": (
        "fraction", "compact wire",
        "mean admitted payload elements / compact_capacity per window, "
        "with fired bytes vs the capacity bytes and the deferral rate",
    ),
    "consensus_error": (
        "l2-norm", "all",
        "||p_i - mean(p)||_2 trajectory at block ends (max/mean over "
        "ranks)",
    ),
    "message_lifecycle": (
        "counts[disposition][edge]", "gossip algos",
        "run-total per-edge disposition table + per-window timeline + "
        "aggregated conservation-audit verdict, folded from the "
        "message_ledger / ledger_audit blocks of the obs records",
    ),
}


def all_field_names():
    """Every schema field name, for doc-coverage tests."""
    names = set(TELEMETRY_FIELDS) | set(RECORD_FIELDS)
    names |= set(RECORD_META_FIELDS) | set(REPORT_FIELDS)
    names |= set(MEMBERSHIP_FIELDS) | set(INTEGRITY_FIELDS)
    names |= set(PREEMPTION_FIELDS) | set(PERF_FIELDS)
    names |= set(LEDGER_FIELDS) | set(DISPOSITIONS)
    return sorted(names)


def field_groups():
    """name -> fields for every *_FIELDS group in this module, for the
    Prometheus export-coverage test (each field must be PROM_EXPORTED
    or PROM_EXCLUDED)."""
    import sys

    mod = sys.modules[__name__]
    return {
        name: getattr(mod, name)
        for name in dir(mod)
        if name.endswith("_FIELDS") and isinstance(getattr(mod, name), dict)
    }
