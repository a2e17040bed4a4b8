"""The crash-consistency matrix through the port: kill at every seam,
resume, compare with the run that never stopped.

The port's counterpart of the JAX package's `tools/crash_matrix.py`
(reference verdicts in `artifacts/crash_matrix_cpu.json`), for the
configurations whose durability machinery the port has: `arena_serial`
(`pipeline=False`: one epoch per block, synchronous saves),
`arena_pipe` (`pipeline=True`: block B's host work after block B+1's
launches, the saves on `utils/checkpoint.AsyncWriter`'s thread, where
the `writer.bg_save` site sits; run on `BarrierWriter`, below),
`membership`
(`leave=1@2,join=1@4`: the join at epoch 4 streams its neighbour row
through `<ck>/bootstrap`, where the `membership.bootstrap` site sits)
and `integrity` (the sentinel with rollback and escalation, checksums
and quarantine off so that the `nanstep=1@14` of
`drop=0,seed=3,nanstep=1@14` lands and trips it). Each crash site is armed at the artifact's hit count
(`EG_CRASHPOINT=site:n`), the child dies there with
`exitcodes.CRASHPOINT_EXIT`, a relaunch resumes, and the cell records:

  * crashed — the child died at the armed site (exit code and witness);
  * resumed — the relaunch found a loadable snapshot and completed;
  * final_state_bitwise — its final snapshot bitwise the uninterrupted
    run's;
  * history_bitwise — the last record of every epoch equal, key by key
    (the JAX matrix's keys);
  * lost_epochs — the epochs both the killed run and the relaunch
    logged (recomputed work).

Then the two graceful-preemption legs, on `arena_serial`: a scheduled
notice (`drop=0,seed=7,preempt=3@2`, against the run under
`drop=0,seed=7`) and a SIGTERM sent once the child logged its first
epoch (the child holds that epoch until train()'s handler has taken the
signal, so the signal lands mid-run however fast the epochs are). Each
must exit `exitcodes.PREEMPTED_EXIT` beside a PREEMPTED marker, resume
bitwise, and lose at most one block (`lost_blocks`).

The op-point is the artifact's: MLP, Ring(4), batch 8, 6 epochs of 192
synthetic MNIST-shaped samples, snapshots every 2 epochs, seed 0, with
the JAX launcher's defaults the JAX matrix ran (lr 0.1, the adaptive
trigger at horizon 0.95 with warmup 2, max_silence 8). Each child is
a process of its own running this module's `--child` entry, which
calls `train()`; the children are forked from one forkserver that has
imported torch and the port (`PRELOAD`), so each pays for its run and
its CUDA start, not for the imports. One child runs the five
uninterrupted baselines in turn, and the cells run beside it on
`WORKERS` threads (one a core), each a sequence of children. A cell is
held to its baseline once both have run.

    python -m eventgrad_tpu_torch.utils.crash_matrix --device cpu \\
        [--out artifacts/torch_crash_matrix_cpu.json]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import signal
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from eventgrad_tpu_torch.exitcodes import (
    CRASHPOINT_EXIT, INTEGRITY_ABORT_EXIT, PREEMPTED_EXIT,
)
from eventgrad_tpu_torch.utils import checkpoint

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the JAX matrix's op-point
OP = dict(ranks=4, epochs=6, n_synth=192, batch=8, save_every=2, seed=0)

#: history keys compared value for value (the JAX matrix's)
VALUE_KEYS = (
    "loss", "train_acc", "num_events", "num_deferred", "msgs_saved_pct",
    "fired_frac", "sent_bytes_per_step_per_chip",
    "sent_bytes_wire_real_per_step_per_chip", "active_ranks",
    "wire_rejects", "quarantined_steps", "integrity_rollbacks",
)

#: the sites and hit counts of every configuration (the JAX matrix's:
#: hit 2 puts mid-run progress on both sides of the kill)
COMMON_SITES = {
    "ckpt.tmp_written": 2,
    "ckpt.mid_swap": 1,
    "ckpt.post_promote": 2,
    "loop.block_dispatched": 2,
    "loop.block_end": 2,
}

#: config name -> (train() keywords, {site: hit})
CONFIGS: Dict[str, Tuple[Dict[str, str], Dict[str, int]]] = {
    "arena_serial": ({"pipeline": False}, dict(COMMON_SITES)),
    "arena_pipe": ({"pipeline": True},
                   {**COMMON_SITES, "writer.bg_save": 2}),
    "membership": (
        # leave at 2, join at 4: the join streams a neighbour row through
        # the bootstrap path (<ck>/bootstrap) mid-matrix
        {"membership": "leave=1@2,join=1@4"},
        {**COMMON_SITES, "membership.bootstrap": 1},
    ),
    "integrity": (
        {"integrity": "checksum=0,quarantine=0,sentinel=1,rollback=1,"
                      "escalate=1,max_rollbacks=1",
         "chaos": "drop=0,seed=3,nanstep=1@14"},
        {**COMMON_SITES, "integrity.rollback": 1},
    ),
}

#: the scheduled preemption leg's schedule and its baseline's
PREEMPT_CHAOS = "drop=0,seed=7,preempt=3@2"
PREEMPT_BASE_CHAOS = "drop=0,seed=7"

#: the uninterrupted runs: tag -> (config, chaos)
BASELINES = {
    "arena_serial": ("arena_serial", None),
    "arena_pipe": ("arena_pipe", None),
    "membership": ("membership", None),
    "integrity": ("integrity", None),
    "preempt": ("arena_serial", PREEMPT_BASE_CHAOS),
}

#: seconds a child may take
CHILD_TIMEOUT = 600.0

#: cells run side by side (each a sequence of child processes, each
#: child one host thread)
WORKERS = os.cpu_count() or 4


# --- the child: one train() run ------------------------------------------


class BarrierWriter(checkpoint.AsyncWriter):
    """`AsyncWriter` on the schedule the JAX artifact recorded: a disk
    slower than the next block, so a save's fsynced `<path>.tmp` is
    swapped in only at the writer's next barrier (the next save, a
    preemption drain, the end).

    A real run swaps as soon as the fsync returns, and whether that lands
    before or after the next block's host work is a race between two
    threads: a kill at `ckpt.tmp_written` or `ckpt.mid_swap` then
    recomputes 2 or 4 epochs, at `ckpt.post_promote` or
    `loop.block_end` 0 or 2. The JAX artifact's cells lie on the slow
    side (4, 4, 2 and 2);
    holding the swap to the barrier puts every run there, so each cell
    is one number."""

    def __init__(self) -> None:
        super().__init__()
        self._barrier = threading.Event()

    def _staged(self) -> None:
        self._barrier.wait()

    def _join(self) -> None:
        self._barrier.set()
        super()._join()
        self._barrier.clear()



def _child(args) -> int:
    """One run of the op-point (`--child CONFIG`), or the five
    uninterrupted baselines in turn (`--child baselines`, each under
    `<ck>/<tag>--base/`); the exit code tells a preemption and an
    integrity abort apart."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from eventgrad_tpu_torch.data.datasets import load_or_synthesize

    if torch.device(args.device).type == "cuda":
        torch.use_deterministic_algorithms(True)
    # the children run side by side: one host thread each keeps them from
    # oversubscribing the cores (every child of a matrix runs alike)
    torch.set_num_threads(1)
    x, y = load_or_synthesize("mnist", None, "train", OP["n_synth"],
                              OP["seed"])
    if args.child != "baselines":
        return _run(x, y, args.child, args.ck, args.log, args.device,
                    resume=args.resume, chaos=args.chaos,
                    wait_signal=args.wait_signal)
    for tag, (config, chaos) in BASELINES.items():
        tmp = os.path.join(args.ck, f"{tag}--base")
        os.makedirs(tmp, exist_ok=True)
        rc = _run(x, y, config, os.path.join(tmp, "ck"),
                  os.path.join(tmp, "base.jsonl"), args.device, chaos=chaos)
        if rc != 0:
            return rc
    return 0


def _run(x, y, config: str, ck: str, log_path: str, device: str, *,
         resume: bool = False, chaos: Optional[str] = None,
         wait_signal: bool = False) -> int:
    """One train() run of `config`, logging every record to `log_path`."""
    from eventgrad_tpu_torch.chaos.crashpoint import (
        GracefulPreemption, PreemptGuard,
    )
    from eventgrad_tpu_torch.chaos.integrity import IntegrityEscalation
    from eventgrad_tpu_torch.models import MLP
    from eventgrad_tpu_torch.parallel.events import EventConfig
    from eventgrad_tpu_torch.parallel.topology import Ring
    from eventgrad_tpu_torch.train.loop import train

    kw = dict(CONFIGS[config][0])
    if chaos is not None:
        kw["chaos"] = chaos
    log = open(log_path, "a")
    # the loop makes its writer as checkpoint.AsyncWriter
    writer_cls = checkpoint.AsyncWriter
    checkpoint.AsyncWriter = BarrierWriter

    def on_epoch(rec):
        log.write(json.dumps(rec) + "\n")
        log.flush()
        if wait_signal and rec["epoch"] == 1:
            # hold the first epoch until the parent's SIGTERM has been
            # taken: PreemptGuard puts the previous handler back then
            guard = signal.getsignal(signal.SIGTERM)
            if isinstance(getattr(guard, "__self__", None), PreemptGuard):
                deadline = time.monotonic() + CHILD_TIMEOUT
                while (signal.getsignal(signal.SIGTERM) == guard
                       and time.monotonic() < deadline):
                    time.sleep(0.02)

    try:
        train(MLP(), Ring(OP["ranks"]), x, y, algo="eventgrad",
              epochs=OP["epochs"], batch_size=OP["batch"],
              learning_rate=0.1,
              event_cfg=EventConfig(adaptive=True, horizon=0.95,
                                    warmup_passes=2, max_silence=8),
              seed=OP["seed"], checkpoint_dir=ck,
              save_every=OP["save_every"], resume=resume,
              on_epoch=on_epoch, device=device, **kw)
    except GracefulPreemption as e:
        log.write(json.dumps({"preempted": True, **e.info}) + "\n")
        return PREEMPTED_EXIT
    except IntegrityEscalation:
        return INTEGRITY_ABORT_EXIT
    finally:
        checkpoint.AsyncWriter = writer_cls
        log.close()
    return 0


# --- the parent: the matrix ------------------------------------------------


def _argv(device: str, config: str, tmp: str, tag: str, *,
          resume: bool = False, chaos: Optional[str] = None,
          wait_signal: bool = False) -> List[str]:
    """The `--child` arguments of one run of `config` under `tmp`,
    logging to `<tmp>/<tag>.jsonl`."""
    argv = ["--child", config, "--device", device,
            "--ck", os.path.join(tmp, "ck"),
            "--log", os.path.join(tmp, f"{tag}.jsonl")]
    if resume:
        argv.append("--resume")
    if chaos is not None:
        argv += ["--chaos", chaos]
    if wait_signal:
        argv.append("--wait-signal")
    return argv


#: what the forkserver imports once, before it forks any child: a fresh
#: interpreter spends ~20 s of CPU importing torch, the port's ops and
#: torch._dynamo (which the first `eg::` op call pulls in) on the card
#: machine, where every child would otherwise pay it
PRELOAD = ["eventgrad_tpu_torch.train.loop", "torch._dynamo"]


def _forked(fn, args, out_path: str, crash: Optional[str]) -> None:
    """A child's body: `fn(*args)`, its return the exit code, with stdout
    and stderr in `out_path`, armed at `crash` (``site:n``, as
    EG_CRASHPOINT) or disarmed."""
    from eventgrad_tpu_torch.chaos import crashpoint

    fd = os.open(out_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    crashpoint.arm(crash)
    sys.exit(fn(*args))


def start_process(fn, args, out_path: str, crash: Optional[str] = None):
    """Start `fn(*args)` (a module-level function) in a process of its
    own, forked from a forkserver that has imported `PRELOAD` (CUDA
    untouched there: each child initializes its own), its output in
    `out_path`, armed at `crash`. Returns the started
    `multiprocessing.Process`."""
    import multiprocessing

    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(PRELOAD)
    proc = ctx.Process(target=_forked, args=(fn, args, out_path, crash))
    proc.start()
    return proc


def stop_forkserver() -> None:
    """Stop the forkserver and the resource tracker `start_process`
    started, once no child of theirs runs (they would otherwise live
    until this process exits). `_stop` is the stdlib's own shutdown of
    both (Python 3.12)."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def start_child(argv: List[str], out_path: str,
                crash: Optional[str] = None):
    """Start one child: this module's `--child` entry with `argv` (see
    `start_process`)."""
    # the importable module, also when this file runs as __main__
    from eventgrad_tpu_torch.utils import crash_matrix

    return start_process(crash_matrix.main, (argv,), out_path, crash)


def finish_child(proc, out_path: str) -> Tuple[int, str]:
    """(exit code, output) of a started child, killed if it outlives
    `CHILD_TIMEOUT`."""
    proc.join(CHILD_TIMEOUT)
    if proc.is_alive():
        proc.kill()
        proc.join()
    with open(out_path) as f:
        return proc.exitcode, f.read()


def run_child(argv: List[str], out_path: str,
              crash: Optional[str] = None) -> Tuple[int, str]:
    """One child to its end: (exit code, output)."""
    return finish_child(start_child(argv, out_path, crash), out_path)


def records(tmp: str, *tags: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for tag in tags:
        path = os.path.join(tmp, f"{tag}.jsonl")
        if os.path.exists(path):
            with open(path) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def _epoch_recs(recs):
    """Training records only (the terminal `preempted` record carries an
    epoch too, but no metrics)."""
    return [r for r in recs if "epoch" in r and "loss" in r]


def _by_epoch(recs) -> Dict[int, Dict[str, Any]]:
    """The last record of each epoch: a rollback's replay and a resume
    log an epoch again, and the last word must match."""
    return {int(r["epoch"]): r for r in _epoch_recs(recs)}


def history_equal(ref, got) -> Tuple[bool, str]:
    a, b = _by_epoch(ref), _by_epoch(got)
    if set(a) != set(b):
        return False, f"epoch sets differ: {sorted(set(a) ^ set(b))}"
    for e in sorted(a):
        for k in VALUE_KEYS:
            if (k in a[e]) != (k in b[e]):
                return False, f"epoch {e}: key {k} presence differs"
            if k in a[e] and a[e][k] != b[e][k]:
                return False, f"epoch {e}: {k} {a[e][k]!r} != {b[e][k]!r}"
    return True, ""


def lost_epochs(first, resumed) -> int:
    """Epochs the recovery recomputed: logged by the killed run and again
    by the relaunch."""
    a = {int(r["epoch"]) for r in _epoch_recs(first)}
    b = {int(r["epoch"]) for r in _epoch_recs(resumed)}
    return len(a & b)


def final_state_equal(ck_ref: str, ck_got: str) -> bool:
    """The two runs' final snapshots (epoch and every tensor) bitwise."""
    import torch

    (ta, ma), (tb, mb) = (
        checkpoint.peek(checkpoint.latest(os.path.join(ck, "ckpt")), "cpu")
        for ck in (ck_ref, ck_got))
    if ma["epoch"] != mb["epoch"] or ta.keys() != tb.keys():
        return False
    as_bytes = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
    return all(ta[k].dtype == tb[k].dtype and ta[k].shape == tb[k].shape
               and torch.equal(as_bytes(ta[k]), as_bytes(tb[k]))
               for k in ta)


#: a baseline: (its records, its checkpoint directory)
Baseline = Tuple[List[Dict[str, Any]], str]


def crash_cell(root: str, device: str, config: str, site: str, hit: int,
               bases: "concurrent.futures.Future[Dict[str, Baseline]]"
               ) -> Dict[str, Any]:
    """Kill `config` at the `hit`-th hit of `site`, relaunch, and hold
    both to the baseline (`bases`: the baselines child's future, waited
    for once this cell's children have run)."""
    tmp = os.path.join(root, f"{config}--{site.replace('.', '_')}")
    os.makedirs(tmp, exist_ok=True)
    cell: Dict[str, Any] = {
        "config": config, "site": site, "hit": hit, "crashed": False,
        "resumed": False, "final_state_bitwise": False,
        "history_bitwise": False, "lost_epochs": -1,
    }
    rc, out = run_child(_argv(device, config, tmp, "crash"),
                        os.path.join(tmp, "crash.out"), crash=f"{site}:{hit}")
    cell["crash_exit"] = rc
    if rc != CRASHPOINT_EXIT or f"crashpoint {site} hit" not in out:
        cell["error"] = f"kill did not land: rc={rc} output={out[-500:]}"
        return cell
    cell["crashed"] = True
    rc, out = run_child(_argv(device, config, tmp, "resume", resume=True),
                        os.path.join(tmp, "resume.out"))
    if rc != 0:
        cell["error"] = f"resume failed: rc={rc} output={out[-500:]}"
        return cell
    cell["resumed"] = True
    first, again = records(tmp, "crash"), records(tmp, "resume")
    cell["lost_epochs"] = lost_epochs(first, again)
    base = bases.result()[config]
    ok, why = history_equal(base[0], first + again)
    cell["history_bitwise"] = ok
    if not ok:
        cell["error"] = f"history: {why}"
    cell["final_state_bitwise"] = final_state_equal(base[1],
                                                    os.path.join(tmp, "ck"))
    if not cell["final_state_bitwise"]:
        cell.setdefault("error", "final snapshot differs")
    return cell


def preempt_cell(root: str, device: str, kind: str,
                 bases: "concurrent.futures.Future[Dict[str, Baseline]]"
                 ) -> Dict[str, Any]:
    """One graceful-preemption leg: `kind` "schedule" (held to the
    baseline under the same chaos seed) or "signal" (held to the plain
    run)."""
    tmp = os.path.join(root, f"preempt--{kind}")
    os.makedirs(tmp, exist_ok=True)
    ck = os.path.join(tmp, "ck")
    chaos = PREEMPT_CHAOS if kind == "schedule" else None
    cell: Dict[str, Any] = {
        "kind": kind, "exit": None, "marker": False,
        "final_state_bitwise": False, "history_bitwise": False,
        "lost_blocks": -1,
    }
    out_path = os.path.join(tmp, "preempt.out")
    child = start_child(
        _argv(device, "arena_serial", tmp, "preempt", chaos=chaos,
              wait_signal=kind == "signal"), out_path)
    if kind == "signal":
        deadline = time.monotonic() + CHILD_TIMEOUT
        while (time.monotonic() < deadline and child.is_alive()
               and not _epoch_recs(records(tmp, "preempt"))):
            time.sleep(0.05)
        if child.is_alive():
            os.kill(child.pid, signal.SIGTERM)
    rc, _ = finish_child(child, out_path)
    cell["exit"] = rc
    if rc != PREEMPTED_EXIT:
        cell["error"] = f"expected exit {PREEMPTED_EXIT}, got {rc}"
        return cell
    cell["marker"] = os.path.exists(os.path.join(ck, "PREEMPTED"))
    first = records(tmp, "preempt")
    pre = next((r for r in first if r.get("preempted")), None)
    if pre is not None:
        cell.update(reason=pre.get("reason"), drain_epoch=pre.get("epoch"),
                    drain_s=pre.get("drain_s"))
    rc, out = run_child(_argv(device, "arena_serial", tmp, "resume",
                              resume=True, chaos=chaos),
                        os.path.join(tmp, "resume.out"))
    if rc != 0:
        cell["error"] = f"resume failed: rc={rc} output={out[-500:]}"
        return cell
    again = records(tmp, "resume")
    # one epoch per block: recomputed epochs are recomputed blocks
    cell["lost_blocks"] = lost_epochs(first, again)
    base = bases.result()["preempt" if kind == "schedule" else "arena_serial"]
    ok, why = history_equal(base[0], first + again)
    cell["history_bitwise"] = ok
    cell["final_state_bitwise"] = final_state_equal(base[1], ck)
    if not ok:
        cell["error"] = f"history: {why}"
    elif not cell["final_state_bitwise"]:
        cell["error"] = "final snapshot differs"
    return cell


def _baselines(root: str, device: str) -> Dict[str, Baseline]:
    """The uninterrupted runs of `BASELINES`, in one child."""
    rc, out = run_child(["--child", "baselines", "--device", device,
                         "--ck", root], os.path.join(root, "baselines.out"))
    if rc != 0:
        raise RuntimeError(f"uninterrupted baselines failed: rc={rc} "
                           f"{out[-1000:]}")
    return {tag: (records(os.path.join(root, f"{tag}--base"), "base"),
                  os.path.join(root, f"{tag}--base", "ck"))
            for tag in BASELINES}


def run_matrix(device: str, workers: int = WORKERS) -> Dict[str, Any]:
    """Every cell and both preemption legs, on `workers` threads; the
    record of the run."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root, \
            concurrent.futures.ThreadPoolExecutor(workers) as pool:
        # submitted first, so it runs before any cell waits for it
        bases = pool.submit(_baselines, root, device)
        cell_futs = [pool.submit(crash_cell, root, device, c, site, hit,
                                 bases)
                     for c, (_, sites) in CONFIGS.items()
                     for site, hit in sites.items()]
        pre_futs = [pool.submit(preempt_cell, root, device, kind, bases)
                    for kind in ("schedule", "signal")]
        cells = [f.result() for f in cell_futs]
        pre_cells = [f.result() for f in pre_futs]
    bound = 2 * OP["save_every"]
    return {
        "bench": "crash_matrix_torch", "device": device,
        "op_point": dict(OP, model="mlp", algo="eventgrad"),
        "configs": {k: v[0] for k, v in CONFIGS.items()},
        "exit_codes": {"crashpoint": CRASHPOINT_EXIT,
                       "preempted": PREEMPTED_EXIT},
        "n_cells": len(cells), "cells": cells,
        "unresumable": sum(1 for c in cells
                           if not (c["crashed"] and c["resumed"])),
        "silent_data_loss": sum(
            1 for c in cells if c["resumed"] and not (
                c["final_state_bitwise"] and c["history_bitwise"])),
        "recovery_bound_epochs": bound,
        "recovery_ok": bool(cells) and all(0 <= c["lost_epochs"] <= bound
                                           for c in cells),
        "preemption": {"cells": pre_cells},
        "workers": workers,
        "wall_s": time.perf_counter() - t0,
    }


#: the verdicts a cell is held to against its JAX twin
CELL_KEYS = ("crashed", "resumed", "final_state_bitwise", "history_bitwise",
             "hit", "lost_epochs")
PREEMPT_KEYS = ("exit", "marker", "final_state_bitwise", "history_bitwise",
                "lost_blocks")


def compare(ref: Dict[str, Any], got: Dict[str, Any]) -> List[str]:
    """Where `got` (a matrix's record) differs from the JAX artifact
    `ref` on the configurations `got` ran (its `configs`; a live run's
    are `CONFIGS`): each cell's verdicts, hit and lost epochs, each
    preemption leg's verdicts and lost blocks. Empty when every verdict
    agrees."""
    out = []
    ran = got.get("configs", CONFIGS)
    want = {(c["config"], c["site"]): c for c in ref["cells"]
            if c["config"] in ran}
    have = {(c["config"], c["site"]): c for c in got["cells"]}
    if set(want) != set(have):
        out.append(f"cells differ: {sorted(set(want) ^ set(have))}")
    for key in sorted(set(want) & set(have)):
        for k in CELL_KEYS:
            if want[key][k] != have[key][k]:
                out.append(f"{key}: {k} {have[key][k]!r} != the JAX "
                           f"artifact's {want[key][k]!r}")
    want_p = {c["kind"]: c for c in ref["preemption"]["cells"]}
    have_p = {c["kind"]: c for c in got["preemption"]["cells"]}
    if set(want_p) != set(have_p):
        out.append(f"preemption legs differ: {sorted(set(want_p))} vs "
                   f"{sorted(set(have_p))}")
    for kind in sorted(set(want_p) & set(have_p)):
        for k in PREEMPT_KEYS:
            if want_p[kind][k] != have_p[kind][k]:
                out.append(f"preempt {kind}: {k} {have_p[kind][k]!r} != "
                           f"the JAX artifact's {want_p[kind][k]!r}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda)")
    ap.add_argument("--out", default=None, help="write the record here")
    ap.add_argument("--child", default=None,
                    choices=sorted(CONFIGS) + ["baselines"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--ck", help=argparse.SUPPRESS)
    ap.add_argument("--log", help=argparse.SUPPRESS)
    ap.add_argument("--resume", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--chaos", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--wait-signal", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device is None:
        from eventgrad_tpu_torch.utils.devices import resolve_device

        args.device = str(resolve_device(None))
    if args.child is not None:
        return _child(args)
    try:
        out = run_matrix(args.device)
    finally:
        stop_forkserver()
    with open(os.path.join(_ROOT, "artifacts", "crash_matrix_cpu.json")) as f:
        diffs = compare(json.load(f), out)
    out["jax_artifact_mismatches"] = diffs
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("cells", "preemption")}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, sort_keys=True)
            f.write("\n")
    for d in diffs:
        print(f"crash_matrix: {d}", file=sys.stderr)
    return 1 if diffs else 0


if __name__ == "__main__":
    sys.exit(main())
