"""Distributed data sharding — the reference's samplers as index arrays.

Port of `eventgrad_tpu/data/sharding.py` (`shard_random`,
`epoch_steps`, `epoch_index_plan`, `batched_epoch`, and
`expand_to_mesh`, which lifts the data ranks' batches onto a hybrid
mesh's full rank set), verbatim in numpy:
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


def expand_to_mesh(
    xb: np.ndarray, yb: np.ndarray, topo, sp_axis: str = "sp"
) -> Tuple[np.ndarray, np.ndarray]:
    """Lift data-sharded batches onto a hybrid mesh's full rank set.

    `xb`/`yb` arrive in the stacked layout over the data ranks only
    (`[n_data, steps, batch, ...]`, each data rank a disjoint shard; the
    data axes are the gossip axes plus a "ddp" axis if present). Each
    rank of the full mesh, in the topology's row-major order, takes its
    data rank's batch: the same batch along tp/pp/ep (the model, not the
    data, differs there), and along the sequence-parallel axis its own
    chunk of the trailing token dimension (ring attention's layout).
    Returns `[topo.n_ranks, steps, batch, ...(chunked)]`."""
    shape = topo.shape
    data_idx = [topo.axes.index(a) for a in topo.data_axes]
    sp_pos = topo.axes.index(sp_axis) if sp_axis in topo.axes else None
    n_sp = shape[sp_pos] if sp_pos is not None else 1
    if sp_pos is not None:
        t_global = xb.shape[-1]
        if n_sp > 1 and not np.issubdtype(xb.dtype, np.integer):
            raise ValueError(
                f"{sp_axis} axis chunks the TRAILING batch dimension (size "
                f"{t_global}) as a token sequence, but batches are "
                f"{xb.dtype} — image channels must not be sliced; "
                f"sequence parallelism requires integer token data"
            )
        if t_global % n_sp:
            raise ValueError(
                f"sequence length {t_global} not divisible by {sp_axis} size {n_sp}"
            )
        t_local = t_global // n_sp

    xs, ys = [], []
    for r in range(topo.n_ranks):
        multi = np.unravel_index(r, shape)
        g = 0
        for ax in data_idx:
            g = g * shape[ax] + multi[ax]
        xr, yr = xb[g], yb[g]
        if sp_pos is not None:
            sl = slice(multi[sp_pos] * t_local, (multi[sp_pos] + 1) * t_local)
            xr, yr = xr[..., sl], yr[..., sl]
        xs.append(xr)
        ys.append(yr)
    return np.stack(xs), np.stack(ys)
