"""Distributed data sharding — the reference's samplers as index arrays.

Port of `eventgrad_tpu/data/sharding.py` (`shard_random`,
`epoch_steps`, `epoch_index_plan`, `batched_epoch`), verbatim in numpy:
identical batches are what make trajectory parity with the JAX package
possible. A shard plan is an index array in the stacked layout
`[n_ranks, steps, batch]`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _per_rank_count(n: int, n_ranks: int) -> int:
    """Samples per rank, dropping the remainder (allow_duplicates=false)."""
    return n // n_ranks


def shard_sequential(n: int, n_ranks: int) -> np.ndarray:
    """[n_ranks, per_rank] contiguous index slices (sequential sampler)."""
    per = _per_rank_count(n, n_ranks)
    return np.arange(n_ranks * per, dtype=np.int64).reshape(n_ranks, per)


def shard_random(n: int, n_ranks: int, seed: int = 0, epoch: int = 0) -> np.ndarray:
    """[n_ranks, per_rank] disjoint shards of a global permutation
    (random sampler); reshuffled per epoch via the seed mix."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    per = _per_rank_count(n, n_ranks)
    perm = rng.permutation(n)[: n_ranks * per]
    return perm.reshape(n_ranks, per).astype(np.int64)


def epoch_steps(n: int, n_ranks: int, batch_size: int) -> int:
    """Steps per epoch (full batches only)."""
    per = _per_rank_count(n, n_ranks)
    steps = per // batch_size
    if steps == 0:
        raise ValueError(
            f"batch_size {batch_size} larger than per-rank shard {per} "
            f"({n} samples / {n_ranks} ranks)"
        )
    return steps


def epoch_index_plan(
    n: int,
    n_ranks: int,
    batch_size: int,
    *,
    random: bool = False,
    seed: int = 0,
    epoch: int = 0,
) -> np.ndarray:
    """[n_ranks, steps, batch] sample indices for one epoch. Trailing
    partial batches are dropped, matching the reference loaders."""
    steps = epoch_steps(n, n_ranks, batch_size)
    shards = (
        shard_random(n, n_ranks, seed, epoch)
        if random
        else shard_sequential(n, n_ranks)
    )
    return shards[:, : steps * batch_size].reshape(n_ranks, steps, batch_size)


def batched_epoch(
    x: np.ndarray,
    y: np.ndarray,
    n_ranks: int,
    batch_size: int,
    *,
    random: bool = False,
    seed: int = 0,
    epoch: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One epoch of per-rank batches in stacked layout: (xb, yb) shaped
    [n_ranks, steps, batch, ...] / [n_ranks, steps, batch]."""
    idx = epoch_index_plan(
        len(x), n_ranks, batch_size, random=random, seed=seed, epoch=epoch
    )
    return x[idx], y[idx]
