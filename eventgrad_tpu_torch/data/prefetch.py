"""Epoch and block prefetcher: host batch assembly beside device compute.

Port of `eventgrad_tpu/data/prefetch.py` (`EpochPrefetcher`). While the
device runs dispatch block B, a worker thread assembles block B+1's
stacked `[n_ranks, K * steps, batch, ...]` arrays: the shard plan comes
from `data/sharding.epoch_index_plan` (numpy's PCG, the JAX package's
plan bit for bit) and the gather is the port's native memcpy gather
(`data/native.gather_rows`, the gather of `native.gather_batches` that
the JAX prefetcher calls, here in each array's own dtype; ctypes
releases the GIL for the copy), so the block is bitwise `x[idx]`,
`y[idx]`; numpy indexing serves where the native
library is missing. An optional `transfer` runs on the worker too, so
the upload of B+1 also overlaps B's compute.

On the card `CudaTransfer` is that upload: the worker pins the block
(a copy from pageable memory with `non_blocking=True` would be a
synchronous copy), copies it on a side stream of its own and records an
event; `CudaTransfer.consume` makes the consumer's stream wait on that
event and marks the tensor as used there (`record_stream`), so the
caching allocator does not hand its memory to the side stream while the
consumer still reads it.

Speculation misses (an access order the speculation did not predict)
fall back to assembly on the caller's thread, are counted in `.misses`
and logged: a cold prefetcher costs time, never correctness.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.data import native
from eventgrad_tpu_torch.data.sharding import epoch_index_plan, epoch_steps

_log = logging.getLogger(__name__)


class CudaTransfer:
    """The worker's upload of one host array to `device`: pinned, copied
    on the transfer's own side stream, with an event recorded after the
    copy. Returns `(tensor, event)`; the consumer calls `consume` before
    the first read."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def __call__(self, arr: np.ndarray):
        host = torch.from_numpy(arr).pin_memory()
        with torch.cuda.stream(self.stream):
            dev = host.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return dev, ready

    def consume(self, upload) -> torch.Tensor:
        """The uploaded tensor, safe to read on the current stream."""
        dev, ready = upload
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ready)
        dev.record_stream(cur)
        return dev


class EpochPrefetcher:
    """Double-buffered epoch and block batch assembly.

    `get(epoch)` returns `(xb, yb)` shaped `[n_ranks, steps, batch, ...]`
    / `[n_ranks, steps, batch, ...labels]` — `x[idx]`, `y[idx]` for the
    epoch's `epoch_index_plan` — and starts assembling epoch + 1 on the
    worker. `get_block(first, last, next_span=...)` returns the epochs
    `first..last` concatenated along the steps axis (what a K-epoch
    dispatch block consumes) and speculates `next_span` instead. With
    `transfer` set, the worker also applies it to each array, so the
    block comes back uploaded. `x` and `y` are taken as given (the loop
    passes them in the model's input dtype and int64 labels). `expand`
    maps the assembled `(xb, yb)` of the data ranks before the transfer
    (a hybrid mesh's `data.sharding.expand_to_mesh`)."""

    def __init__(
        self,
        x: np.ndarray,
        y: np.ndarray,
        n_ranks: int,
        batch_size: int,
        *,
        random: bool = False,
        seed: int = 0,
        last_epoch: Optional[int] = None,
        transfer: Optional[Callable[[np.ndarray], object]] = None,
        expand: Optional[Callable] = None,
    ):
        self.x = np.ascontiguousarray(x)
        self.y = np.ascontiguousarray(y)
        self.n_ranks = n_ranks
        self.batch = batch_size
        self.random = random
        self.seed = seed
        self.last_epoch = last_epoch  # no speculative assembly past this
        self.transfer = transfer
        self.expand = expand
        #: speculation misses: a get()/get_block() the pending assembly
        #: did not predict (assembled on the caller's thread instead)
        self.misses = 0
        # validates the batch and shard sizes too
        self.steps = epoch_steps(len(x), n_ranks, batch_size)
        #: ((first, last), thread, box) of the speculation in flight
        self._pending: Optional[Tuple[Tuple[int, int], threading.Thread,
                                      dict]] = None

    def _assemble(self, epoch: int) -> Tuple[np.ndarray, np.ndarray]:
        idx = epoch_index_plan(
            len(self.x), self.n_ranks, self.batch,
            random=self.random, seed=self.seed, epoch=epoch,
        )
        return native.gather_rows(self.x, idx), native.gather_rows(self.y,
                                                                   idx)

    def _assemble_span(self, first: int, last: int):
        """Epochs first..last stacked `[n_ranks, K * steps, B, ...]`, then
        the transfer: the worker runs this whole chain."""
        parts = [self._assemble(e) for e in range(first, last + 1)]
        if len(parts) == 1:
            xb, yb = parts[0]
        else:
            xb = np.concatenate([p[0] for p in parts], axis=1)
            yb = np.concatenate([p[1] for p in parts], axis=1)
        del parts
        if self.expand is not None:
            xb, yb = self.expand(xb, yb)
        if self.transfer is not None:
            return self.transfer(xb), self.transfer(yb)
        return xb, yb

    def _start(self, span: Tuple[int, int]):
        box: dict = {}

        def work():
            try:
                box["out"] = self._assemble_span(*span)
            except BaseException as e:  # surfaced by the consuming get
                box["err"] = e

        th = threading.Thread(target=work, daemon=True,
                              name=f"eg-prefetch-{span[0]}-{span[1]}")
        th.start()
        return (span, th, box)

    def _take(self, span: Tuple[int, int]):
        """The pending speculation if it is `span`; None on a miss
        (counted and logged: the caller assembles it)."""
        if self._pending is None:
            return None
        pspan, th, box = self._pending
        th.join()  # either our span, or a stale speculation to retire
        self._pending = None
        if pspan != span:
            self.misses += 1
            _log.warning(
                "prefetch speculation miss #%d: assembled epochs %s, "
                "requested %s; assembling on the caller's thread",
                self.misses, pspan, span,
            )
            if "err" in box:
                _log.warning("stale prefetch speculation %s had failed: %r",
                             pspan, box["err"])
            return None
        if "err" in box:
            raise box["err"]
        return box["out"]

    def _clamp_span(self, span: Optional[Tuple[int, int]]):
        if span is None:
            return None
        first, last = span
        if self.last_epoch is not None:
            if first > self.last_epoch:
                return None
            last = min(last, self.last_epoch)
        return (first, last)

    def get_block(self, first: int, last: int,
                  next_span: Optional[Tuple[int, int]] = None):
        """One dispatch block's stacked arrays; speculates `next_span`
        (the loop's next block) on the worker."""
        out = self._take((first, last))
        if out is None:  # a miss, or the first call
            out = self._assemble_span(first, last)
        nxt = self._clamp_span(next_span)
        if nxt is not None:
            self._pending = self._start(nxt)
        return out

    def get(self, epoch: int):
        """One epoch (the pre-block access): speculates epoch + 1."""
        nxt = (epoch + 1, epoch + 1)
        if self.last_epoch is not None and epoch >= self.last_epoch:
            nxt = None
        return self.get_block(epoch, epoch, next_span=nxt)

    def close(self) -> None:
        """Idempotent teardown: retire the speculation in flight without
        raising (a worker's error in work nobody consumes must not mask
        the loop's own exception)."""
        if self._pending is not None:
            _, th, box = self._pending
            self._pending = None
            th.join()
            if "err" in box:
                _log.warning("prefetch worker error discarded at close: %r",
                             box["err"])
