"""Run metrics. Port of `eventgrad_tpu/utils/metrics.py` (`msgs_saved_pct`)."""

from __future__ import annotations


def msgs_saved_pct(num_events: int, passes: int, n_tensors: int, n_neighbors: int, n_ranks: int) -> float:
    """1 - events/possible, the reference's headline metric
    (events counted per neighbor per tensor per pass)."""
    possible = n_neighbors * passes * n_tensors * n_ranks
    return 100.0 * (1.0 - num_events / possible) if possible else 0.0
