"""Telemetry: on-device accumulators, the message ledger, host registry.

Port of `eventgrad_tpu/obs/`. Device side: `TelemetryState` rides the
rank-stacked `TrainState.telemetry`, cumulative, and the loop flushes it
to the host once per epoch (`train(obs="block"|"epoch")`; the port's
dispatch block is one epoch, so the two modes agree), with the message
ledger (`obs.ledger`) and its conservation auditor. Host side:
`Registry` puts the JSONL record stream, the peer-health and latency
gauges and the loop's spans behind one versioned schema (`obs.schema`),
with Prometheus-textfile and Chrome-trace exporters. `obs.report`
renders a run report from a history, and `obs.bubble` splits a span
trace into wall = steps + host bubble.
"""

from eventgrad_tpu_torch.obs.device import TelemetryState, accumulate
from eventgrad_tpu_torch.obs.registry import Registry
from eventgrad_tpu_torch.obs.schema import OBS_SCHEMA_VERSION, SILENCE_BUCKETS

OBS_MODES = ("off", "block", "epoch")

__all__ = [
    "TelemetryState",
    "accumulate",
    "Registry",
    "OBS_SCHEMA_VERSION",
    "SILENCE_BUCKETS",
    "OBS_MODES",
]
