"""Elastic supervisor: failure detection and restart from the snapshot.

Port of `eventgrad_tpu/supervise.py`, launching the port's command line
(`python -m eventgrad_tpu_torch.cli`). The reference has no failure
story: a dead rank leaves its ring neighbours blocked in MPI_Recv forever
(decent.cpp:200-205). Here the training job runs under a supervisor that
detects both failure modes:

  * **crash** — the child exits nonzero;
  * **hang** — the child stays alive but its heartbeat (the metrics
    log, else the checkpoint dir) stops advancing for `--timeout`
    seconds, the moral equivalent of a wedged collective.

Either way the child is killed and relaunched with `--resume`, restoring
the whole train state (parameters, momentum trace, event thresholds,
stale neighbour buffers, the random stream) from the latest snapshot, so
recovery costs at most one `--save-every` interval of recomputation.
Pair with the loop's `fault_inject` ("crash:N" / "hang:N", the CLI's
`--fault-inject`) for drills, and with `--membership` schedules for
elastic soaks (`utils/soak.py`).

Exit codes (`exitcodes.py`): `PREEMPTED_EXIT` (a graceful drain)
relaunches at once without charging the budget or backing off;
`INTEGRITY_ABORT_EXIT` gives up without a restart (a relaunch would
replay the same divergence); anything else nonzero is a crash.

Built for long soaks, not just drills:

  * **sliding restart-budget window** (`--max-restarts N
    --restart-window SEC`) — give up only when more than N restarts land
    within any trailing SEC-second window (`--restart-window 0` keeps
    the lifetime budget);
  * **exponential backoff with jitter** between relaunches
    (`--backoff-base/--backoff-max/--backoff-jitter`), so a crash-looping
    child does not hammer the machine or its checkpoint store.

Usage:
    python -m eventgrad_tpu_torch.supervise --timeout 120 \
        --max-restarts 3 --restart-window 3600 -- \
        --algo eventgrad --mesh ring:8 --dataset cifar10 --data-dir DIR \
        --model resnet18 --checkpoint-dir /ckpt --save-every 1 \
        --log-file /logs/run.jsonl
"""

from __future__ import annotations

import argparse
import os
import random
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

from eventgrad_tpu_torch.exitcodes import INTEGRITY_ABORT_EXIT, PREEMPTED_EXIT


class RestartBudget:
    """Sliding-window restart budget: allow at most `max_restarts`
    restarts within any trailing `window_s` seconds. `window_s=0` means
    a lifetime budget (the legacy `--max-restarts` counter). `now` is
    injectable for tests."""

    def __init__(
        self, max_restarts: int, window_s: float = 0.0,
        now: Callable[[], float] = time.time,
    ):
        if max_restarts < 0 or window_s < 0:
            raise ValueError(
                f"budget must be >= 0 (got {max_restarts}, {window_s})"
            )
        self.max_restarts = max_restarts
        self.window_s = window_s
        self._now = now
        self._fails: List[float] = []

    def record_failure(self) -> bool:
        """Register one failure; True = a restart is still within budget.
        With a window, failures older than `window_s` roll off first."""
        t = self._now()
        if self.window_s:
            self._fails = [f for f in self._fails if t - f < self.window_s]
        self._fails.append(t)
        return len(self._fails) <= self.max_restarts


def backoff_delay(
    consecutive_failures: int,
    base: float = 1.0,
    cap: float = 30.0,
    jitter: float = 0.5,
    rng: Optional[random.Random] = None,
) -> float:
    """Exponential backoff with jitter: `min(cap, base * 2^(k-1))` for
    the k-th consecutive failure, scaled by `1 + jitter * U[0, 1)`.
    `base=0` disables backoff entirely."""
    if base <= 0 or consecutive_failures <= 0:
        return 0.0
    d = min(cap, base * (2.0 ** (consecutive_failures - 1)))
    if jitter:
        d *= 1.0 + jitter * (rng or random).random()
    return d


def _latest_mtime(path: str) -> float:
    """Newest mtime under `path` (file, or dir scanned recursively)."""
    if not os.path.exists(path):
        return 0.0
    newest = os.path.getmtime(path)
    if os.path.isdir(path):
        for root, _, files in os.walk(path):
            for f in files:
                try:
                    newest = max(newest, os.path.getmtime(os.path.join(root, f)))
                except OSError:
                    pass  # snapshot promotion may race the walk
    return newest


def _flag_value(args: Sequence[str], flag: str) -> Optional[str]:
    for i, a in enumerate(args):
        if a == flag and i + 1 < len(args):
            return args[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def _terminate(proc: subprocess.Popen, grace: float = 10.0) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=grace)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def supervise(
    child_args: List[str],
    timeout: float = 0.0,
    max_restarts: int = 3,
    heartbeat: Optional[str] = None,
    poll_s: float = 0.5,
    restart_window: float = 0.0,
    backoff_base: float = 1.0,
    backoff_max: float = 30.0,
    backoff_jitter: float = 0.5,
    _now: Callable[[], float] = time.time,
    _sleep: Callable[[float], None] = time.sleep,
) -> int:
    """Run the CLI under supervision; returns the final exit code (0 on
    eventual success). `child_args` are eventgrad_tpu_torch.cli flags and must
    include --checkpoint-dir (restarts would lose all progress otherwise).

    `restart_window` makes the budget sliding (`RestartBudget`): more
    than `max_restarts` failures within any trailing window escalate;
    0 keeps the lifetime counter. Between relaunches the supervisor
    sleeps `backoff_delay(consecutive failures in the window)` —
    exponential with jitter, capped; `backoff_base=0` disables. `_now`/
    `_sleep` are injectable for tests (backoff only — the liveness poll
    keeps real time)."""
    ckpt_dir = _flag_value(child_args, "--checkpoint-dir")
    if not ckpt_dir:
        raise SystemExit("supervise: child args must include --checkpoint-dir")
    heartbeat = heartbeat or _flag_value(child_args, "--log-file") or ckpt_dir

    budget = RestartBudget(max_restarts, restart_window, now=_now)
    attempt = 0
    # backoff exponent: CONSECUTIVE failures — a child that ran healthily
    # past every backoff scale resets it, so a service failing once a day
    # keeps restarting fast even under the lifetime (window=0) budget
    consecutive = 0
    backoff_reset_s = max(backoff_max, 60.0)
    while True:
        t_launch = _now()
        argv = list(child_args)
        if attempt > 0 and "--resume" not in argv:
            argv.append("--resume")
        cmd = [sys.executable, "-m", "eventgrad_tpu_torch.cli", *argv]
        started = time.time()
        proc = subprocess.Popen(cmd)
        reason = None
        # stat the heartbeat at a fraction of the timeout, not every poll —
        # a checkpoint-dir heartbeat on shared storage shouldn't see a
        # metadata storm from its own supervisor
        hb_every = max(poll_s, timeout / 4.0) if timeout else poll_s
        last_hb_check, last_hb = 0.0, 0.0
        while proc.poll() is None:
            time.sleep(poll_s)
            if not timeout:
                continue
            now = time.time()
            if now - last_hb_check >= hb_every:
                last_hb_check = now
                last_hb = _latest_mtime(heartbeat)
            if now - max(started, last_hb) > timeout:
                # the cached mtime may be up to hb_every stale — re-stat
                # before declaring a live child hung
                last_hb_check = now
                last_hb = _latest_mtime(heartbeat)
                if now - max(started, last_hb) <= timeout:
                    continue
                reason = f"no heartbeat on {heartbeat} for {timeout:.0f}s"
                _terminate(proc)
                break
        rc = proc.returncode
        if rc == 0:
            return 0
        if rc == PREEMPTED_EXIT and reason is None:
            # graceful preemption (chaos/crashpoint.py): the child
            # drained its pipeline, snapshotted at a block boundary, and
            # exited ON PURPOSE — the dominant healthy exit on spot/
            # preemptible capacity. Relaunch immediately: no restart-
            # budget charge (a once-an-hour preemption must never
            # exhaust a crash budget) and no backoff (at most one
            # dispatch block of work is waiting on the relaunch).
            # `reason is None` guards the hang path: a heartbeat-stalled
            # child that drains to 75 under the supervisor's OWN SIGTERM
            # was still a hang — it keeps charging the budget, or a
            # stall-loop would relaunch forever.
            attempt += 1
            consecutive = 0
            print(
                f"supervise: child preempted (exit {rc}); relaunching "
                "immediately from its drained snapshot (no budget "
                "charge, no backoff)",
                file=sys.stderr, flush=True,
            )
            continue
        if rc == INTEGRITY_ABORT_EXIT:
            # permanent escalation from the integrity engine: restarting
            # would restore the same last-known-good snapshot and replay
            # the same divergence — human (or policy) attention required
            print(
                f"supervise: child exited {rc} (integrity escalation); "
                "giving up without restart — a relaunch would replay "
                "the same divergence",
                file=sys.stderr, flush=True,
            )
            return rc
        attempt += 1
        if _now() - t_launch >= backoff_reset_s:
            consecutive = 0
        consecutive += 1
        allowed = budget.record_failure()
        desc = reason or f"exit code {rc}"
        print(
            f"supervise: attempt {attempt} failed ({desc}); "
            + ("restarting from latest snapshot" if allowed
               else "giving up"),
            file=sys.stderr, flush=True,
        )
        if not allowed:
            if rc is None:
                return 1
            # signal deaths (rc < 0) would wrap around in sys.exit; report
            # them the shell way
            return 128 + abs(rc) if rc < 0 else rc
        delay = backoff_delay(
            consecutive, base=backoff_base, cap=backoff_max,
            jitter=backoff_jitter,
        )
        if delay:
            print(
                f"supervise: backing off {delay:.1f}s before relaunch",
                file=sys.stderr, flush=True,
            )
            _sleep(delay)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="eventgrad-tpu-torch-supervise", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--timeout", type=float, default=0.0,
                   help="seconds without heartbeat progress before the child "
                        "is declared hung and killed (0 = crash detection only)")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--restart-window", type=float, default=0.0,
                   metavar="SEC",
                   help="sliding budget window: give up only when more "
                        "than --max-restarts failures land within any "
                        "trailing SEC seconds (0 = lifetime counter, the "
                        "legacy behavior)")
    p.add_argument("--backoff-base", type=float, default=1.0,
                   help="first-relaunch delay in seconds; doubles per "
                        "consecutive failure in the window (0 = no "
                        "backoff)")
    p.add_argument("--backoff-max", type=float, default=30.0,
                   help="backoff delay cap in seconds")
    p.add_argument("--backoff-jitter", type=float, default=0.5,
                   help="multiplicative jitter J: delays scale by "
                        "1 + J*U[0,1) to decorrelate fleet restarts")
    p.add_argument("--heartbeat", default=None,
                   help="file/dir whose mtime is the liveness signal "
                        "(default: the child's --log-file, else its "
                        "--checkpoint-dir)")
    p.add_argument("child", nargs=argparse.REMAINDER,
                   help="-- followed by eventgrad_tpu_torch.cli flags")
    args = p.parse_args(argv)
    child = args.child
    if child and child[0] == "--":
        child = child[1:]
    if not child:
        raise SystemExit("supervise: pass CLI flags after --")
    return supervise(
        child, timeout=args.timeout, max_restarts=args.max_restarts,
        heartbeat=args.heartbeat, restart_window=args.restart_window,
        backoff_base=args.backoff_base, backoff_max=args.backoff_max,
        backoff_jitter=args.backoff_jitter,
    )


if __name__ == "__main__":
    sys.exit(main())
