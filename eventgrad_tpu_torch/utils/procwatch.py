"""Deadlined subprocesses + accelerator liveness probing.

Port of `eventgrad_tpu/utils/procwatch.py`. A child stuck in a device op
may ignore every Python-level interrupt; a supervising parent with a
hard wall deadline is the only reliable watchdog. `run_deadlined` runs a
command under such a deadline; `probe_device_diag` / `probe_device`
start a staged child that imports torch, enumerates the CUDA devices and
EXECUTES one matmul on the card (a card that enumerates but cannot run
work is not alive), so "the card is up" means one thing repo-wide.
"""

from __future__ import annotations

import os
import subprocess
import sys


def run_deadlined(cmd, env, timeout_s, cwd=None, capture_stderr=False):
    """subprocess with a hard wall deadline that cannot hang the parent.

    On the deadline the child is killed and given a short grace to be
    reaped (anything it already printed is salvaged: a child that
    finished its measurement and then hung in teardown is a result);
    an unkillable child is abandoned unreaped.

    Returns (stdout_or_None, timed_out, returncode_or_None).
    """
    try:
        proc = subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, text=True,
            stderr=subprocess.STDOUT if capture_stderr else None,
            cwd=cwd or os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
        )
    except OSError:
        return None, False, None
    try:
        out, _ = proc.communicate(timeout=timeout_s)
        return out, False, proc.returncode
    except subprocess.TimeoutExpired:
        proc.kill()
        try:
            out, _ = proc.communicate(timeout=10)
            return out, True, None
        except (subprocess.TimeoutExpired, OSError):
            pass  # unkillable child; abandon without reaping
        return None, True, None
    except OSError:
        # the pipe read failed (a dying child): the contract is a result
        # tuple, never an exception
        return None, False, None


# Staged probe child: every phase is bracketed by flushed EG_STAGE
# markers, so the salvaged stdout of a killed child names WHERE it hung
# (import, device enumeration, the executed matmul).
_PROBE_CODE = (
    "print('EG_STAGE spawn', flush=True)\n"
    "import torch\n"
    "print('EG_STAGE import_ok', torch.__version__, flush=True)\n"
    "print('EG_STAGE enum_start', flush=True)\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "platform = 'gpu' if n else 'cpu'\n"
    "print('EG_STAGE enum_ok', platform, max(n, 1), flush=True)\n"
    "{gpu_assert}"
    "print('EG_STAGE run_start', flush=True)\n"
    "dev = 'cuda' if n else 'cpu'\n"
    "a = torch.ones((256, 256), device=dev)\n"
    "float((a @ a).sum())\n"
    "print('EG_STAGE run_ok', flush=True)\n"
    "kind = torch.cuda.get_device_name(0) if n else 'cpu'\n"
    "print('EG_PROBE_OK', platform, kind, flush=True)\n"
)


def probe_device_diag(env, timeout_s, require_gpu=False):
    """Diagnostic liveness probe. Returns a dict:

      verdict   'ok' | 'stalled' | 'crashed'
      platform  'gpu' | 'cpu' or None
      kind      `torch.cuda.get_device_name(0)` ('cpu' without a card),
                None unless ok
      stage     last marker the child reached ('spawn', 'import_ok',
                'enum_start', 'enum_ok', 'run_start', 'run_ok', or
                'probe_ok' on full success); None if none was salvaged
      tail      last chunk of combined stdout+stderr (exception text for
                crashes)
      rc        the child's exit code (None when killed)

    'ok' iff the child executes its matmul AND exits within the deadline.
    With require_gpu, a child that finds no card fails its assert:
    'crashed'."""
    code = _PROBE_CODE.format(
        gpu_assert=("assert n > 0, 'no CUDA device'\n"
                    if require_gpu else "")
    )
    out, timed_out, rc = run_deadlined(
        [sys.executable, "-c", code], env, timeout_s, capture_stderr=True
    )
    # markers are matched with `in`, not startswith: a library writing
    # unbuffered chunks to the same pipe can prepend a partial line
    stage, platform = None, None
    for line in (out or "").splitlines():
        if "EG_STAGE" in line:
            parts = line[line.index("EG_STAGE"):].split()
            stage = parts[1] if len(parts) > 1 else stage
            if stage == "enum_ok" and len(parts) > 2:
                platform = parts[2]
        elif "EG_PROBE_OK" in line and not timed_out and rc == 0:
            parts = line[line.index("EG_PROBE_OK"):].split(None, 2)
            return {"verdict": "ok", "stage": "probe_ok",
                    "platform": parts[1] if len(parts) > 1 else None,
                    "kind": parts[2] if len(parts) > 2 else None,
                    "tail": None, "rc": rc}
    verdict = "stalled" if timed_out else "crashed"
    return {"verdict": verdict, "stage": stage, "platform": platform,
            "kind": None, "tail": (out or "")[-1500:] or None, "rc": rc}


def probe_device(env, timeout_s, require_gpu=False):
    """(verdict, platform): the binary liveness answer over
    `probe_device_diag`. On failure the child's tail is re-emitted on
    this process's stderr, so the diagnosis stays in the caller's log."""
    d = probe_device_diag(env, timeout_s, require_gpu=require_gpu)
    if d["verdict"] != "ok" and d.get("tail"):
        print("[probe %s @%s] %s" % (d["verdict"], d.get("stage"),
                                     d["tail"][-400:]),
              file=sys.stderr)
    return d["verdict"], d["platform"]
