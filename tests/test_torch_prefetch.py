"""The port's block prefetcher against the JAX package's.

  * the blocks of `eventgrad_tpu_torch.data.prefetch.EpochPrefetcher`
    equal the JAX `EpochPrefetcher`'s bitwise (the images; the labels by
    value, int64 against the JAX package's int32), for the sequential
    and the random sampler, single epochs and K-epoch blocks, with the
    JAX side's native gather turned off as its own test does;
  * the counterparts of `tests/test_prefetch.py`: assembly on the worker
    equals assembly inline in any access order, misses counted and
    logged, no speculation past the last epoch, the transfer run on the
    worker, `close` idempotent and silent about a discarded worker
    error while a consumed one raises, reshuffled and deterministic
    epochs, the batch-size guard.

Small random arrays (64-128 samples of 4x4x1), 2-4 ranks, CPU only.
"""

import logging
import threading

import numpy as np
import pytest

from eventgrad_tpu.data import native as jax_native
from eventgrad_tpu.data.prefetch import EpochPrefetcher as JaxPrefetcher
from eventgrad_tpu_torch.data.prefetch import EpochPrefetcher


def _data(n=64, shape=(4, 4, 1), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n,) + shape).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int64)
    return x, y


@pytest.mark.parametrize("native_on", [True, False])
@pytest.mark.parametrize("random", [False, True])
def test_blocks_equal_the_jax_prefetcher(random, native_on, monkeypatch):
    if not native_on:
        monkeypatch.setattr(jax_native, "load_library", lambda: None)
    x, y = _data(n=96, seed=4)
    port = EpochPrefetcher(x, y, 2, 8, random=random, seed=7, last_epoch=6)
    ref = JaxPrefetcher(x, y.astype(np.int32), 2, 8, random=random, seed=7,
                        last_epoch=6)
    try:
        spans = [(1, 1), (2, 3), (4, 6)]
        for i, (a, b) in enumerate(spans):
            nxt = spans[i + 1] if i + 1 < len(spans) else None
            xp, yp = port.get_block(a, b, next_span=nxt)
            xr, yr = ref.get_block(a, b, next_span=nxt)
            assert xp.dtype == np.float32 and xp.shape == xr.shape
            np.testing.assert_array_equal(xp.view(np.int32),
                                          np.asarray(xr).view(np.int32))
            np.testing.assert_array_equal(yp, np.asarray(yr).astype(np.int64))
        assert port.misses == ref.misses == 0
        assert port.steps == ref.steps
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("random", [False, True])
def test_prefetched_epochs_match_inline(random):
    x, y = _data()
    pre = EpochPrefetcher(x, y, n_ranks=4, batch_size=4, random=random,
                          seed=3)
    try:
        for epoch in (1, 2, 3):
            xb, yb = pre.get(epoch)  # 2 and 3 come from the worker
            xe, ye = pre._assemble(epoch)
            np.testing.assert_array_equal(xb, xe)
            np.testing.assert_array_equal(yb, ye)
            assert xb.shape == (4, 4, 4, 4, 4, 1) and yb.shape == (4, 4, 4)
    finally:
        pre.close()


def test_out_of_order_epoch_still_correct():
    x, y = _data(seed=1)
    pre = EpochPrefetcher(x, y, n_ranks=2, batch_size=8, random=True, seed=0)
    try:
        pre.get(1)  # pending is now epoch 2
        xb, yb = pre.get(7)  # a jump: assembled on the caller's thread
        xe, ye = pre._assemble(7)
        np.testing.assert_array_equal(xb, xe)
        np.testing.assert_array_equal(yb, ye)
    finally:
        pre.close()


def test_sequential_plan_is_disjoint_cover():
    x, y = _data(n=32)
    pre = EpochPrefetcher(x, y, n_ranks=4, batch_size=8, random=False)
    try:
        xb, _ = pre.get(1)
        # rank r sees samples [r * 8, (r + 1) * 8)
        np.testing.assert_array_equal(xb.reshape(4, 8, -1),
                                      x.reshape(4, 8, -1))
    finally:
        pre.close()


def test_no_speculation_past_last_epoch():
    x, y = _data()
    pre = EpochPrefetcher(x, y, 2, 8, random=True, last_epoch=3)
    try:
        pre.get(1)
        assert pre._pending is not None
        pre.get(2)
        pre.get(3)  # the last epoch: nothing further to assemble
        assert pre._pending is None
    finally:
        pre.close()


def test_batch_too_large_raises():
    x, y = _data(n=16)
    with pytest.raises(ValueError, match="larger than per-rank shard"):
        EpochPrefetcher(x, y, n_ranks=4, batch_size=8)


def test_speculation_misses_counted_and_logged(caplog):
    x, y = _data(seed=1)
    pre = EpochPrefetcher(x, y, n_ranks=2, batch_size=8, random=True, seed=0)
    try:
        pre.get(1)  # speculates epoch 2
        assert pre.misses == 0
        with caplog.at_level(logging.WARNING,
                             "eventgrad_tpu_torch.data.prefetch"):
            pre.get(7)  # a miss
        assert pre.misses == 1
        assert any("speculation miss" in r.message for r in caplog.records)
        pre.get(8)  # predicted: no new miss
        assert pre.misses == 1
    finally:
        pre.close()


def test_get_block_matches_epoch_concat():
    x, y = _data(n=96, seed=6)
    pre = EpochPrefetcher(x, y, n_ranks=2, batch_size=8, random=True, seed=2)
    try:
        xb, yb = pre.get_block(1, 3, next_span=(4, 5))
        parts = [pre._assemble(e) for e in (1, 2, 3)]
        np.testing.assert_array_equal(
            xb, np.concatenate([p[0] for p in parts], axis=1))
        np.testing.assert_array_equal(
            yb, np.concatenate([p[1] for p in parts], axis=1))
        pre.get_block(4, 5)  # the speculated block: no miss
        assert pre.misses == 0
    finally:
        pre.close()


def test_block_transfer_runs_on_worker():
    x, y = _data(seed=8)
    threads = []

    def tag(arr):
        threads.append(threading.current_thread().name)
        return ("transferred", arr)

    pre = EpochPrefetcher(x, y, 2, 8, random=True, seed=1, transfer=tag)
    try:
        xb, yb = pre.get_block(1, 1, next_span=(2, 2))
        assert xb[0] == "transferred" and yb[0] == "transferred"
        xb2, _ = pre.get_block(2, 2)
        assert xb2[0] == "transferred"
        # the speculated block's transfer ran on a prefetch worker
        assert any(t.startswith("eg-prefetch-") for t in threads)
    finally:
        pre.close()


def test_close_idempotent_and_safe_after_worker_error(monkeypatch):
    x, y = _data(seed=9)
    pre = EpochPrefetcher(x, y, 2, 8, random=True, seed=1)
    monkeypatch.setattr(
        pre, "_assemble",
        lambda e: (_ for _ in ()).throw(RuntimeError("boom")))
    pre._pending = pre._start((2, 2))  # a doomed speculation
    pre.close()  # swallows the worker's error
    pre.close()  # idempotent
    assert pre._pending is None
    # a consumed speculation raises its error to the caller
    pre._pending = pre._start((3, 3))
    with pytest.raises(RuntimeError, match="boom"):
        pre.get_block(3, 3)
    pre.close()


def test_shuffled_epochs_differ_and_are_deterministic():
    x, y = _data(n=128, seed=2)
    a = EpochPrefetcher(x, y, 2, 8, random=True, seed=5)
    b = EpochPrefetcher(x, y, 2, 8, random=True, seed=5)
    try:
        x1, _ = a.get(1)
        x2, _ = a.get(2)
        assert not np.array_equal(x1, x2)  # reshuffled every epoch
        x1b, _ = b.get(1)
        np.testing.assert_array_equal(x1, x1b)
    finally:
        a.close()
        b.close()
