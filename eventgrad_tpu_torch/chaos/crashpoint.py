"""Crashpoint registry and graceful preemption: seeded kills, clean drains.

Port of `eventgrad_tpu/chaos/crashpoint.py`. The durability of a run
rests on a handful of state-mutating seams: `utils/checkpoint.save`'s
tmp-write / rename / fsync sequence, the `AsyncWriter` thread, the
epoch boundaries of `train/loop.py` and the integrity rollback-restore.
Each claims to survive a kill at any instant; this module kills there on
purpose.

  * crashpoints — a registry of named sites (`SITES`), each instrumented
    at exactly one `crashpoint.hit("<name>")` call (the lint rule
    `crashpoint-instrumented` holds it). Arm one with
    ``EG_CRASHPOINT=site[:hit_n]`` (or `arm()`): the n-th time execution
    reaches `hit(site)` the process dies at once through
    `os._exit(CRASHPOINT_EXIT)` — no unwind, no atexit, no flush, the
    model of SIGKILL or a power loss. Deterministic by hit count, so
    `utils/crash_matrix.py` kills at every site, resumes, and checks the
    resume bitwise against the run that never stopped. Unarmed, `hit()`
    is a dict lookup.

  * graceful preemption — `PreemptGuard` installs SIGTERM/SIGINT
    handlers that only set a flag; the training loop checks it at each
    epoch boundary (the port's dispatch block) and, when set, snapshots,
    writes a ``PREEMPTED`` marker into the checkpoint directory and
    raises `GracefulPreemption`, whose exit code is
    `exitcodes.PREEMPTED_EXIT`: a supervisor relaunches at once. A
    preemption so loses at most the epoch that was running when the
    notice came. A second signal while the drain still runs falls
    through to the previous handler: the way out of a wedged drain.

  * the process faults of `train(fault_inject="crash:N" | "hang:N")` —
    `inject_fault` exits with `exitcodes.FAULT_INJECT_EXIT` (13, the
    JAX loop's code) or sleeps without a heartbeat, at the end of epoch
    N after its snapshot: the drills a supervisor (`supervise.py`)
    recovers from.

The scheduled twin of the signal is the chaos clause
``preempt=EPOCH@STEP`` (`chaos/schedule.py`): a replayable notice that
arrives in that epoch and drains at its end.

`writer.bg_save` is instrumented inside `utils/checkpoint.AsyncWriter`,
which the loop does not use until the dispatch pipeline is ported
(ROADMAP queue 1, item 6, part 6e); `membership.bootstrap` sits in the
membership engine's bootstrap stream (`chaos/membership.py`), between a
join's on-disk commit of its neighbour's row and the newcomer's
restore.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

from eventgrad_tpu_torch.exitcodes import CRASHPOINT_EXIT, FAULT_INJECT_EXIT

#: environment variable arming one crashpoint for this process:
#: ``site`` or ``site:hit_n`` (1-based; default 1 = the first hit)
ENV_VAR = "EG_CRASHPOINT"

#: marker file a graceful drain leaves in the checkpoint directory: the
#: witness that the newest snapshot is a drained one, consumed by the
#: next incarnation's train()
PREEMPT_MARKER = "PREEMPTED"

#: every named crash site, and the seam it instruments (the JAX
#: package's names and descriptions)
SITES = {
    "ckpt.tmp_written": (
        "checkpoint.save: the tmp tree is fully serialized, BEFORE the "
        "fsync durability point — on disk: old snapshot intact, tmp "
        "complete but possibly volatile"
    ),
    "ckpt.mid_swap": (
        "checkpoint.save: the old snapshot was demoted to .prev and the "
        "new one is NOT yet promoted — the worst instant of the atomic "
        "swap (latest() must find the .prev)"
    ),
    "ckpt.post_promote": (
        "checkpoint.save: the new snapshot is promoted but .prev is not "
        "yet dropped and the parent dir not yet fsynced"
    ),
    "writer.bg_save": (
        "AsyncWriter: inside the background writer thread, before the "
        "serialization/swap starts — kills the whole process from the "
        "thread the pipeline hides checkpoint cost on"
    ),
    "loop.block_dispatched": (
        "train loop: a dispatch block was just enqueued on device; none "
        "of its host work (records, eval readback, checkpoint) has run"
    ),
    "loop.block_end": (
        "train loop: a block boundary fully processed — host work "
        "drained, any due checkpoint committed, transitions applied"
    ),
    "membership.bootstrap": (
        "membership join: the neighbor snapshot was committed to the "
        "on-disk bootstrap stream but the newcomer row is not yet "
        "restored/inserted"
    ),
    "integrity.rollback": (
        "integrity engine: mid rollback-restore — last-known-good state "
        "restored in memory, replay not yet re-dispatched"
    ),
}


class GracefulPreemption(RuntimeError):
    """Raised by train() once a graceful drain completed: the boundary
    snapshot (with a checkpoint_dir) and the PREEMPTED marker are on
    disk. `info` holds `reason`, `epoch`, `snapshot`, `drain_s` (and
    `marker`, the marker's path). A launcher exits
    `exitcodes.PREEMPTED_EXIT` on it."""

    def __init__(self, info: Dict[str, Any]):
        self.info = dict(info)
        super().__init__(
            f"graceful preemption ({info.get('reason')}) drained at "
            f"epoch {info.get('epoch')}"
        )


def parse_spec(spec: str) -> Tuple[str, int]:
    """``site`` or ``site:hit_n`` -> (site, hit_n); an unknown site or a
    hit count below 1 raises (an armed typo that never fires would read
    as a kill survived)."""
    site, _, n = spec.partition(":")
    site = site.strip()
    if site not in SITES:
        raise ValueError(
            f"unknown crashpoint {site!r}; registered sites: "
            f"{', '.join(sorted(SITES))}"
        )
    hit_n = int(n) if n else 1
    if hit_n < 1:
        raise ValueError(f"crashpoint hit count must be >= 1, got {hit_n}")
    return site, hit_n


_lock = threading.Lock()
_armed: Optional[Tuple[str, int]] = None
_hits: int = 0
_env_read = False


def _ensure_env() -> None:
    global _env_read, _armed, _hits
    if _env_read:
        return
    _env_read = True
    spec = os.environ.get(ENV_VAR)
    if spec:
        _armed = parse_spec(spec)
        _hits = 0


def arm(spec: Optional[str]) -> None:
    """Arm (or, with None, disarm) a crashpoint for this process: the
    in-process face of ``EG_CRASHPOINT``."""
    global _armed, _hits, _env_read
    with _lock:
        _env_read = True  # an explicit arm overrides the environment
        _armed = parse_spec(spec) if spec else None
        _hits = 0


def armed() -> Optional[Dict[str, Any]]:
    """The armed site as ``{"site": ..., "hit": n}``, or None: the rider
    train() puts on the run's first record."""
    with _lock:
        _ensure_env()
        if _armed is None:
            return None
        return {"site": _armed[0], "hit": _armed[1]}


def hit(site: str) -> None:
    """Execution reached the named seam. Unarmed: checks the name and
    returns. Armed at this site: counts the hit and, on the armed one,
    writes a one-line witness to stderr and dies through
    `os._exit(CRASHPOINT_EXIT)`."""
    if site not in SITES:
        raise KeyError(
            f"unregistered crashpoint {site!r} — add it to "
            "chaos.crashpoint.SITES (the instrumentation lint indexes "
            "the registry)"
        )
    global _hits
    with _lock:
        _ensure_env()
        if _armed is None or _armed[0] != site:
            return
        _hits += 1
        # read under the lock: an arm(None) racing the exit below must
        # not turn the kill into a TypeError
        hit_n = _armed[1]
        if _hits < hit_n:
            return
    os.write(
        2,
        f"crashpoint {site} hit {hit_n}: killing process "
        f"(exit {CRASHPOINT_EXIT})\n".encode(),
    )
    os._exit(CRASHPOINT_EXIT)


def inject_fault(mode: str) -> None:
    """The `fault_inject` drill at its epoch boundary (the loop calls it
    after that epoch's snapshot): "crash" dies at once through
    `os._exit(FAULT_INJECT_EXIT)`; "hang" stays alive without progress,
    so no heartbeat advances and a supervisor's timeout must fire."""
    if mode == "crash":
        os._exit(FAULT_INJECT_EXIT)
    while True:
        time.sleep(3600)


# --- graceful preemption ---------------------------------------------------


class PreemptGuard:
    """SIGTERM/SIGINT -> request-flag handlers for the length of a run (a
    context manager). The handler records the signal's name; the loop
    drains at its next epoch boundary. After the first signal the
    previous handlers are back, so a second one interrupts a wedged
    drain the platform's way; `__exit__` restores them in any case.

    Installs nothing with `enabled=False` or off the main thread
    (`signal.signal` is main-thread only); `requested` then stays None."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.requested: Optional[str] = None
        self._prev: Dict[int, Any] = {}

    def _handler(self, signum, frame):
        self.requested = signal.Signals(signum).name
        self._restore()

    def _restore(self) -> None:
        for signum, prev in self._prev.items():
            try:
                signal.signal(signum, prev)
            except (ValueError, OSError):  # pragma: no cover - teardown race
                pass
        self._prev = {}

    def __enter__(self) -> "PreemptGuard":
        if not self.enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for signum in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[signum] = signal.signal(signum, self._handler)
            except (ValueError, OSError):  # pragma: no cover - exotic host
                pass
        return self

    def __exit__(self, *exc) -> None:
        self._restore()


def marker_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, PREEMPT_MARKER)


def write_marker(checkpoint_dir: str, info: Dict[str, Any]) -> str:
    """Write the PREEMPTED witness beside the drained snapshot, fsynced,
    so whoever reads the directory can tell a drained stop from a
    crash."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = marker_path(checkpoint_dir)
    with open(path, "w") as f:
        json.dump(info, f, indent=1, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    return path


def consume_marker(checkpoint_dir: Optional[str]) -> Optional[Dict[str, Any]]:
    """Read and remove the PREEMPTED marker (train() calls this at
    start): the new incarnation supersedes the drained one."""
    if not checkpoint_dir:
        return None
    path = marker_path(checkpoint_dir)
    try:
        with open(path) as f:
            info = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, json.JSONDecodeError):
        info = None  # a torn marker is removed all the same
    try:
        os.remove(path)
    except FileNotFoundError:
        pass
    return info
