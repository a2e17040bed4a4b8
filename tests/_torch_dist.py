"""Process groups for the port's tests (not a test module).

`requires_gloo` is the one skip marker of every `tests/test_torch_*.py`
that starts a `torch.distributed` group (the lint's
`process-group-marker` rule holds them to it); `spawn` starts W worker
processes, each process p of a gloo group on a `file://` store, running
a function of a worker module with one torch thread. Run as a script,
this file is that worker's entry:

    python tests/_torch_dist.py MODULE:FUNCTION W P STORE [ARGS...]
"""

import os
import subprocess
import sys

import pytest
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

requires_gloo = pytest.mark.skipif(
    not (dist.is_available() and dist.is_gloo_available()),
    reason="needs torch.distributed with the gloo backend",
)


def start(target: str, world: int, store: str, *args: str):
    """Start `world` processes running `target` ("module:function",
    a module of tests/) as the processes of one gloo group on the file
    store `store` (a path that must not exist yet). Returns the Popens;
    `finish` waits for them."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), target, str(world),
         str(p), store, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=ROOT) for p in range(world)]


def finish(procs, timeout: float = 240.0):
    """Wait for every process (killing all at the timeout); each must exit
    0. Returns their outputs."""
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
    return outs


def stop(procs):
    """Kill every process of `procs` still running (a fixture's cleanup
    when its parent side fails before `finish`)."""
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _main(argv):
    import importlib

    import torch

    target, world, pid, store, *args = argv
    torch.set_num_threads(1)
    from eventgrad_tpu_torch.parallel import multihost

    multihost.init(f"file://{store}", int(world), int(pid), device="cpu")
    try:
        mod, fn = target.split(":")
        getattr(importlib.import_module(mod), fn)(*args)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    _main(sys.argv[1:])
