"""Crash-safe snapshots of a training run, and their restore.

Port of `eventgrad_tpu/utils/checkpoint.py`. The JAX module writes orbax
trees; the port keeps its own format. A snapshot is a directory holding

  * ``state.pt`` — one `torch.save` file of a flat ``{path: tensor}``
    dict (`train/state.to_flat`: the paths spelled as the JAX package's
    `_path_name` spells them, e.g. ``state/event/num_deferred``), read
    back with ``torch.load(..., weights_only=True, map_location=device)``;
  * ``manifest.json`` — the format version, the epoch, the layout keys
    the resume guards read (algo, ranks R, arena size n, resident dtype,
    queue depth D, bucket count K), the device type it was written from,
    and the byte size of ``state.pt`` (a torn file fails the read).

`save` writes ``<path>.tmp``, fsyncs every file and directory of it,
demotes the old snapshot to ``<path>.prev``, promotes the new one, drops
``.prev`` and fsyncs the parent: a kill at any instant leaves ``<path>``
or ``<path>.prev`` complete, and `latest` finds whichever survived. The
crash sites ``ckpt.tmp_written`` (the tmp tree written and fsynced,
before the swap), ``ckpt.mid_swap`` and ``ckpt.post_promote``
(`chaos/crashpoint.py`) sit at the JAX module's seams. `peek` reads a
snapshot without a template, falling back loudly to ``.prev`` when the
primary is unreadable; `restore` grafts its
tensors onto a template's flat dict exactly, `restore_with_fill` lets
missing leaves keep the template's values. `AsyncWriter` serializes on a
background thread and `RollingRetention` keeps the integrity engine's
newest validated snapshots.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import pickle
import shutil
import threading
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from eventgrad_tpu_torch.chaos import crashpoint

#: the on-disk format this module writes and reads
FORMAT_VERSION = 1
TENSORS = "state.pt"
MANIFEST = "manifest.json"

#: what a torn, truncated or foreign snapshot raises on read
_READ_ERRORS = (OSError, ValueError, KeyError, RuntimeError, EOFError,
                pickle.UnpicklingError)

Tensors = Dict[str, torch.Tensor]


def _fsync_path(path: str) -> None:
    """fsync one file or directory (best-effort where a filesystem
    rejects directory descriptors)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - directory fsync unsupported
        pass
    finally:
        os.close(fd)


def _fsync_tree(root: str) -> None:
    """fsync every file and directory under `root`, bottom-up: a
    rename-commit is durable only once the renamed tree's data and the
    directory entries naming it are on disk."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for f in filenames:
            _fsync_path(os.path.join(dirpath, f))
        _fsync_path(dirpath)


def _write(directory: str, tensors: Tensors, meta: Dict[str, Any]) -> None:
    if os.path.exists(directory):  # a stale tmp of an interrupted save
        shutil.rmtree(directory)
    os.makedirs(directory)
    fpath = os.path.join(directory, TENSORS)
    torch.save({k: v.detach().cpu() for k, v in tensors.items()}, fpath)
    manifest = {"format": FORMAT_VERSION, **meta,
                "bytes": os.path.getsize(fpath)}
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)


def save(path: str, tensors: Tensors, meta: Dict[str, Any]) -> None:
    """Crash-safe snapshot of `tensors` (a flat dict, on any device) with
    `meta` (JSON: at least the `epoch`) into the directory `path`. Writes
    `<path>.tmp`, fsyncs it, swaps the old snapshot to `<path>.prev`,
    promotes the new one, drops `.prev` and fsyncs the parent, so a kill
    at any point leaves `<path>` or `<path>.prev` complete and a host
    crash after the return cannot lose the promoted snapshot."""
    path = os.path.abspath(path)
    _stage(path, tensors, meta)
    _promote(path)


def _stage(path: str, tensors: Tensors, meta: Dict[str, Any]) -> None:
    """Write `<path>.tmp` and fsync it: the durability point, the tmp
    tree's bytes on disk before any rename makes them the snapshot of
    record."""
    _write(path + ".tmp", tensors, meta)
    _fsync_tree(path + ".tmp")


def _promote(path: str) -> None:
    """Swap the staged `<path>.tmp` in as the snapshot of record: demote
    the old one to `.prev`, promote, drop `.prev`, fsync the parent (the
    crash sites `ckpt.tmp_written` before the swap, `ckpt.mid_swap` and
    `ckpt.post_promote` inside it)."""
    crashpoint.hit("ckpt.tmp_written")
    tmp, prev = path + ".tmp", path + ".prev"
    if os.path.exists(path):
        if os.path.exists(prev):
            shutil.rmtree(prev)
        os.rename(path, prev)
        crashpoint.hit("ckpt.mid_swap")
    # the primary may be absent (a first save, or a resume from .prev):
    # a surviving .prev is never touched before the new one is in place
    os.rename(tmp, path)
    crashpoint.hit("ckpt.post_promote")
    if os.path.exists(prev):
        shutil.rmtree(prev)
    _fsync_path(os.path.dirname(path))


def _host_copies(tensors: Tensors, ready=None) -> Tensors:
    """Host copies of `tensors`: with `ready` (a CUDA event recorded
    after the device tensors were made), copied on a side stream that
    waits on it, so the copy does not queue behind the device work
    launched after the event."""
    if ready is None:
        return {k: v.detach().cpu() for k, v in tensors.items()}
    dev = next(v.device for v in tensors.values() if v.is_cuda)
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        side.wait_event(ready)
        return {k: v.detach().cpu() for k, v in tensors.items()}


def host_snapshot(tensors: Tensors) -> Tensors:
    """Owned host copies of every tensor (blocking): the eager half of an
    asynchronous save, after which the caller may go on mutating the
    originals while `AsyncWriter` serializes the copies."""
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


class AsyncWriter:
    """One background thread for snapshot serialization.

    `save()` joins the save in flight (two writers must never race the
    tmp/prev swap), then runs the next on the thread, as the JAX
    package's writer does: past the ``writer.bg_save`` crash site it
    copies the tensors to the host (on a side stream of its own that
    waits on `ready`, when the loop hands it device copies), writes and
    fsyncs `<path>.tmp` beside the next blocks' compute, and swaps it in
    as the snapshot of record at once. `wait()` (the join before the
    next save, at a preemption drain and at the end of the run) and
    `close()` are the barriers; an atexit hook closes at interpreter
    exit. A failed save re-raises at the next barrier. `_staged` is the
    seam between the fsync and the swap, a no-op here (the crash matrix
    holds it to the next barrier, `utils/crash_matrix.BarrierWriter`)."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._atexit_hook: Optional[Callable[[], None]] = None

    def save(self, path: str, tensors: Tensors, meta: Dict[str, Any],
             ready=None) -> None:
        """Stage `tensors` (owned copies, on any device: nothing else may
        write them) as the snapshot of `path` on the writer thread;
        joins the previous save first. `ready` is a CUDA event recorded
        after the device copies were made."""
        self.wait()
        if self._atexit_hook is None:
            self._atexit_hook = lambda: self.close(raise_errors=False)
            atexit.register(self._atexit_hook)
        path = os.path.abspath(path)
        started = threading.Event()

        def work() -> None:
            try:
                crashpoint.hit("writer.bg_save")
                started.set()
                _stage(path, _host_copies(tensors, ready), meta)
                self._staged()
                _promote(path)
            except BaseException as e:  # re-raised at the next barrier
                self._exc = e
            finally:
                started.set()

        self._thread = threading.Thread(target=work, daemon=True,
                                        name="eg-ckpt-writer")
        self._thread.start()
        # the thread has passed its crash site before the loop goes on
        started.wait()

    def _staged(self) -> None:
        """On the writer thread, between the fsync of `<path>.tmp` and
        the swap: nothing."""

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def wait(self) -> None:
        """The barrier: join the save in flight (if any) and re-raise its
        error."""
        self._join()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise RuntimeError("async checkpoint save failed") from exc

    def close(self, raise_errors: bool = True) -> None:
        """Exit barrier. `raise_errors=False` is for unwind paths: join
        without masking the exception in flight, and log a failed save
        (the snapshot on disk is then the previous one)."""
        if self._atexit_hook is not None:
            atexit.unregister(self._atexit_hook)
            self._atexit_hook = None
        if raise_errors:
            self.wait()
            return
        self._join()
        if self._exc is not None:
            logging.getLogger(__name__).warning(
                "async checkpoint save failed during unwind (snapshot on "
                "disk is the previous one): %r", self._exc)
        self._exc = None


class RollingRetention:
    """Rolling retention of validated last-known-good snapshots: the
    integrity engine keeps each healthy epoch at checkpoint cadence as
    `<directory>/good-<epoch>`, each through `save`'s fsynced swap, and
    keeps the newest `keep`. Pruning runs before a new save and once more
    after it, so at least one complete validated snapshot is on disk at
    every instant."""

    PREFIX = "good-"

    def __init__(self, directory: str, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def path_for(self, epoch: int) -> str:
        return os.path.join(self.directory, f"{self.PREFIX}{epoch:06d}")

    def snapshots(self) -> List[Tuple[int, str]]:
        """Committed snapshots as sorted (epoch, path); in-flight `.tmp`
        and demoted `.prev` directories excluded."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith(self.PREFIX) or name.endswith(
                    (".tmp", ".prev")):
                continue
            try:
                epoch = int(name[len(self.PREFIX):])
            except ValueError:
                continue
            out.append((epoch, os.path.join(self.directory, name)))
        return sorted(out)

    def latest_good(self) -> Optional[Tuple[int, str]]:
        """The newest retained (epoch, path), or None."""
        snaps = self.snapshots()
        return snaps[-1] if snaps else None

    def prune(self) -> int:
        """Delete the oldest snapshots beyond `keep`; returns how many."""
        snaps = self.snapshots()
        drop = snaps[: max(0, len(snaps) - self.keep)]
        for _, p in drop:
            shutil.rmtree(p, ignore_errors=True)
            for suffix in (".tmp", ".prev"):
                if os.path.exists(p + suffix):
                    shutil.rmtree(p + suffix, ignore_errors=True)
        return len(drop)

    def save_good(self, epoch: int, tensors: Tensors,
                  meta: Dict[str, Any]) -> str:
        """Retain one validated snapshot: prune, write it to
        `path_for(epoch)`, prune again."""
        os.makedirs(self.directory, exist_ok=True)
        self.prune()
        path = self.path_for(epoch)
        save(path, tensors, meta)
        self.prune()
        return path


def latest(path: str) -> Optional[str]:
    """The newest complete snapshot for `path` (the primary, or the
    `.prev` a save interrupted mid-swap left); None if neither exists."""
    path = os.path.abspath(path)
    for cand in (path, path + ".prev"):
        if os.path.exists(cand):
            return cand
    return None


def _read(path: str, device) -> Tuple[Tensors, Dict[str, Any]]:
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT_VERSION:
        raise ValueError(f"snapshot format {manifest.get('format')!r}, this "
                         f"reader takes {FORMAT_VERSION}")
    fpath = os.path.join(path, TENSORS)
    size = os.path.getsize(fpath)
    if size != manifest["bytes"]:
        raise ValueError(f"{TENSORS} holds {size} bytes, the manifest "
                         f"says {manifest['bytes']}")
    tensors = torch.load(fpath, weights_only=True, map_location=device)
    return tensors, manifest


def peek(path: str, device=None) -> Tuple[Tensors, Dict[str, Any]]:
    """Template-free read: (the flat tensors on `device`, the manifest).

    An unreadable primary (truncated, torn, foreign) with a complete
    `.prev` twin recovers from the twin with a RuntimeWarning naming both,
    after the corrupt primary is renamed to `.corrupt` (so the next save
    cannot demote it over the good twin). No twin, or both unreadable,
    raises RuntimeError naming the paths: a resume never proceeds from
    garbage."""
    path = os.path.abspath(path)
    try:
        return _read(path, device)
    except _READ_ERRORS as exc:
        prev = path + ".prev"
        if path.endswith(".prev") or not os.path.exists(prev):
            raise RuntimeError(
                f"checkpoint at {path} is unreadable (truncated or "
                f"corrupted): {type(exc).__name__}: {exc}. No .prev twin "
                "exists; restore from a retained last-known-good "
                "snapshot (RollingRetention) or an earlier backup"
            ) from exc
        try:
            out = _read(prev, device)
        except _READ_ERRORS as prev_exc:
            raise RuntimeError(
                f"checkpoint at {path} AND its demoted twin {prev} are "
                f"both unreadable (primary: {type(exc).__name__}: {exc}; "
                f"twin: {type(prev_exc).__name__}: {prev_exc}); restore "
                "from a retained last-known-good snapshot "
                "(RollingRetention) or an earlier backup"
            ) from exc
        corrupt = path + ".corrupt"
        if os.path.exists(corrupt):
            shutil.rmtree(corrupt, ignore_errors=True)
        os.rename(path, corrupt)
        warnings.warn(
            f"checkpoint at {path} is unreadable (truncated or "
            f"corrupted): {type(exc).__name__}: {exc} — RECOVERED from "
            f"its demoted twin {prev}; up to one save interval of work "
            f"replays, and the corrupt primary was sidelined to "
            f"{corrupt} so the next save cannot demote it over the "
            "good twin",
            RuntimeWarning,
        )
        return out


def restore_with_fill(raw: Tensors, template: Tensors
                      ) -> Tuple[Tensors, List[str]]:
    """Forward-compatible restore: the tensors of a `peek` (`raw`)
    grafted onto `template` (a flat dict) by path. Returns (the
    template's paths filled from the snapshot on the template's devices,
    the template paths the snapshot lacks, which keep the template's
    values); the caller decides which fills it accepts. A path present in
    both with another shape or dtype raises ValueError: it is a layout
    change, not an added field. Snapshot paths without a template
    counterpart are ignored."""
    filled, missing = {}, []
    for name, tmpl in template.items():
        if name not in raw:
            missing.append(name)
            filled[name] = tmpl
            continue
        got = raw[name]
        if tuple(got.shape) != tuple(tmpl.shape) or got.dtype != tmpl.dtype:
            raise ValueError(
                f"snapshot leaf {name} is {got.dtype} {tuple(got.shape)}, "
                f"template wants {tmpl.dtype} {tuple(tmpl.shape)}")
        filled[name] = got.to(tmpl.device)
    return filled, missing


def restore(raw: Tensors, template: Tensors) -> Tensors:
    """The tensors of a `peek` (`raw`) grafted onto `template` exactly: a
    template path the snapshot lacks raises ValueError."""
    restored, missing = restore_with_fill(raw, template)
    if missing:
        raise ValueError(f"snapshot lacks leaves {missing}")
    return restored
