"""The port's supervisor (`eventgrad_tpu_torch/supervise.py`) and the
loop's `fault_inject` drills, against the JAX package's.

  * `RestartBudget` and `backoff_delay` give the JAX answers on the same
    inputs and the same seeded jitter;
  * `supervise` against scripted child exits (a fake `Popen`, injected
    `_now` / `_sleep`) makes the JAX supervisor's relaunch, give-up and
    sleep decisions: crashes with backoff, a window burst, preemptions
    (no charge, no backoff) and an integrity abort (give up at once);
  * `train(fault_inject="crash:1")` in a child process exits 13 after
    epoch 1's snapshot, a resume from that snapshot ends bitwise where the
    uninterrupted run ends, and `pipeline=True` with a fault refuses;
  * the drills on the CPU through the command line (MLP, Ring(4), 3
    epochs): a crash under `python -m eventgrad_tpu_torch.supervise` and
    a hang the supervisor kills, each resumed to a final snapshot bitwise
    the uninterrupted run's.
"""

import json
import os
import pathlib
import random
import subprocess
import sys

import pytest
import torch

from eventgrad_tpu import supervise as jax_sup
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch import cli, exitcodes
from eventgrad_tpu_torch import supervise as sup
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.utils import checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_exit_codes_match_jax():
    assert (sup.PREEMPTED_EXIT, sup.INTEGRITY_ABORT_EXIT) == (
        jax_sup.PREEMPTED_EXIT, jax_sup.INTEGRITY_ABORT_EXIT)
    assert exitcodes.FAULT_INJECT_EXIT == 13


@pytest.mark.parametrize("budget,times", [
    ((2, 0.0), [float(t) for t in range(6)]),
    ((2, 10.0), [0.0, 5.0, 100.0, 103.0, 106.0, 130.0]),
    ((0, 5.0), [0.0, 10.0]),
    ((3, 2.5), [0.0, 1.0, 2.0, 2.4, 2.6, 9.0, 9.1, 9.2, 9.3]),
])
def test_restart_budget_matches_jax(budget, times):
    mine = sup.RestartBudget(*budget, now=iter(times).__next__)
    theirs = jax_sup.RestartBudget(*budget, now=iter(times).__next__)
    assert [mine.record_failure() for _ in times] == [
        theirs.record_failure() for _ in times]
    for bad in ((-1,), (1, -1.0)):
        with pytest.raises(ValueError):
            sup.RestartBudget(*bad)


def test_backoff_delay_matches_jax():
    for k in range(0, 9):
        for kw in (dict(base=1.0, cap=8.0, jitter=0.0),
                   dict(base=0.5, cap=30.0, jitter=0.5),
                   dict(base=0.0), dict()):
            a = sup.backoff_delay(k, rng=random.Random(k), **kw)
            b = jax_sup.backoff_delay(k, rng=random.Random(k), **kw)
            assert a == b, (k, kw)


class _FakeProc:
    """A child that exits at once with a scripted return code."""

    def __init__(self, rc):
        self.returncode = rc

    def poll(self):
        return self.returncode


def _fake_supervise(module, monkeypatch, rcs, dt=1, **kw):
    """(final rc, the argv after `-m <module>` per launch, sleeps)."""
    codes = iter(rcs)
    launches, sleeps = [], []

    def fake_popen(cmd, *a, **k):
        launches.append(cmd[3:])
        return _FakeProc(next(codes))

    monkeypatch.setattr(module.subprocess, "Popen", fake_popen)
    clock = iter(float(t) for t in range(0, 10000, dt)).__next__
    random.seed(5)  # the module-level jitter draws
    rc = module.supervise(["--checkpoint-dir", "/nonexistent-ck"],
                          _now=clock, _sleep=sleeps.append, **kw)
    return rc, launches, sleeps


SCRIPTS = {
    "crash_backoff": ([7, 7, 0], dict(max_restarts=5, backoff_base=0.5,
                                      backoff_max=4.0)),
    "crash_jitter": ([7, 7, 7, 0], dict(max_restarts=5, backoff_base=0.5)),
    "window_outlives_lifetime": ([1, 1, 1, 0], dict(
        max_restarts=1, restart_window=2.0, dt=5, backoff_base=0.0)),
    "lifetime_gives_up": ([1, 1, 1, 0], dict(
        max_restarts=1, restart_window=0.0, dt=5, backoff_base=0.0)),
    "window_burst": ([9, 9, 9, 9], dict(max_restarts=2, restart_window=100.0,
                                         backoff_base=0.0)),
    "signal_death": ([-9, -9], dict(max_restarts=1, backoff_base=0.0)),
    "preemptions": ([75, 75, 75, 75, 0], dict(max_restarts=0,
                                              backoff_base=1.0,
                                              backoff_jitter=0.0)),
    "preemption_resets_backoff": ([7, 7, 75, 7, 0], dict(
        max_restarts=5, backoff_base=0.5, backoff_max=8.0,
        backoff_jitter=0.0)),
    "integrity_abort": ([77, 0], dict(max_restarts=5, backoff_base=0.0)),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_supervise_decisions_match_jax(name, monkeypatch):
    rcs, kw = SCRIPTS[name]
    mine = _fake_supervise(sup, monkeypatch, rcs, **dict(kw))
    theirs = _fake_supervise(jax_sup, monkeypatch, rcs, **dict(kw))
    assert mine == theirs
    assert all("--resume" in argv for argv in mine[1][1:])


def test_supervise_launches_the_port_cli(monkeypatch):
    cmds = []

    def fake_popen(cmd, *a, **k):
        cmds.append(cmd)
        return _FakeProc(0)

    monkeypatch.setattr(sup.subprocess, "Popen", fake_popen)
    assert sup.supervise(["--checkpoint-dir", "/ck", "--epochs", "1"]) == 0
    assert cmds == [[sys.executable, "-m", "eventgrad_tpu_torch.cli",
                     "--checkpoint-dir", "/ck", "--epochs", "1"]]
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        sup.supervise(["--algo", "dpsgd"])
    with pytest.raises(SystemExit, match="pass CLI flags after --"):
        sup.main(["--timeout", "1"])


# --- fault_inject through train() -----------------------------------------

TRAIN_KW = dict(algo="eventgrad", batch_size=8, learning_rate=0.1,
                event_cfg=egt.EventConfig(warmup_passes=2), device="cpu")


def _data():
    return synthetic_dataset(128, (8, 8, 1), seed=0)


def _model():
    return egt.MLP(hidden=16, input_shape=(8, 8, 1))


def _bits(flat):
    return {k: (v.view(torch.uint8) if v.is_floating_point() else v)
            for k, v in flat.items()}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(_bits({k: a[k]})[k], _bits({k: b[k]})[k]), k


def test_fault_inject_crash_then_resume_bitwise(tmp_path):
    ck = str(tmp_path / "ck")
    code = (
        "from eventgrad_tpu_torch.data.datasets import synthetic_dataset\n"
        "import eventgrad_tpu_torch as egt\n"
        "x, y = synthetic_dataset(128, (8, 8, 1), seed=0)\n"
        "egt.train(egt.MLP(hidden=16, input_shape=(8, 8, 1)), egt.Ring(4), "
        "x, y, epochs=3, algo='eventgrad', batch_size=8, learning_rate=0.1,"
        " event_cfg=egt.EventConfig(warmup_passes=2), device='cpu',"
        f" checkpoint_dir={ck!r}, save_every=1, fault_inject='crash:1')\n"
        "print('survived')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == exitcodes.FAULT_INJECT_EXIT, out.stderr[-2000:]
    assert "survived" not in out.stdout
    found = checkpoint.latest(os.path.join(ck, "ckpt"))
    assert checkpoint.peek(found)[1]["epoch"] == 1
    x, y = _data()
    resumed, hist = egt.train(_model(), egt.Ring(4), x, y, epochs=3,
                              checkpoint_dir=ck, save_every=1, resume=True,
                              **TRAIN_KW)
    assert [h["epoch"] for h in hist] == [2, 3]
    whole, _ = egt.train(_model(), egt.Ring(4), x, y, epochs=3, **TRAIN_KW)
    _assert_same(state_lib.to_flat(resumed), state_lib.to_flat(whole))


def test_fault_inject_guards():
    x, y = _data()
    with pytest.raises(ValueError, match="cannot honor fault_inject"):
        egt.train(_model(), egt.Ring(4), x, y, epochs=2, pipeline=True,
                  fault_inject="crash:1", **TRAIN_KW)
    for bad in ("crash", "boom:1", "hang:x"):
        with pytest.raises(ValueError, match="bad fault_inject spec"):
            egt.train(_model(), egt.Ring(4), x, y, epochs=2,
                      fault_inject=bad, **TRAIN_KW)


# --- the supervised drills through the command line ------------------------

DRILL = ["--algo", "eventgrad", "--mesh", "ring:4", "--dataset", "synthetic",
         "--model", "mlp", "--epochs", "3", "--batch-size", "8",
         "--n-synth", "128", "--warmup-passes", "2", "--save-every", "1",
         "--device", "cpu"]


def _child_env():
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def _final_snapshot(ck):
    raw, meta = checkpoint.peek(checkpoint.latest(os.path.join(ck, "ckpt")))
    assert meta["epoch"] == 3
    return raw


def _epochs(log):
    with open(log) as f:
        return [json.loads(line).get("epoch") for line in f]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("straight")
    assert cli.main(DRILL + ["--checkpoint-dir", str(d / "ck"),
                             "--log-file", str(d / "log.jsonl")]) == 0
    return _final_snapshot(str(d / "ck"))


@pytest.fixture(scope="module")
def crash_drill(tmp_path_factory):
    """The crash drill under `python -m eventgrad_tpu_torch.supervise`,
    started at once and read by its test, so it runs beside the hang
    drill (each child's torch import is most of a drill's time)."""
    d = tmp_path_factory.mktemp("crash")
    ck, log = str(d / "ck"), str(d / "log.jsonl")
    cmd = [sys.executable, "-m", "eventgrad_tpu_torch.supervise",
           "--timeout", "0", "--max-restarts", "2", "--backoff-base", "0",
           "--"] + DRILL + ["--checkpoint-dir", ck, "--log-file", log,
                            "--fault-inject", "crash:1"]
    proc = subprocess.Popen(cmd, env=_child_env(), cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, ck, log
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_supervised_hang_drill_resumes_bitwise(tmp_path, uninterrupted,
                                               crash_drill, monkeypatch,
                                               capfd):
    ck, log = str(tmp_path / "ck"), str(tmp_path / "log.jsonl")
    for k, v in _child_env().items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(ROOT)
    # the hung child sits in its SIGTERM drain guard, so only the SIGKILL
    # after the grace ends it: a short grace keeps the drill short. The
    # 20 s timeout leaves a child room for its torch import (the first
    # heartbeat) on a host loaded by the other test workers
    terminate = sup._terminate
    monkeypatch.setattr(sup, "_terminate",
                        lambda proc: terminate(proc, grace=1.0))
    rc = sup.supervise(DRILL + ["--checkpoint-dir", ck, "--log-file", log,
                                "--fault-inject", "hang:1"],
                       timeout=20.0, max_restarts=1, backoff_base=0.0)
    err = capfd.readouterr().err
    assert rc == 0, err[-3000:]
    assert "no heartbeat on" in err
    assert _epochs(log) == [1, 2, 3, None]
    _assert_same(_final_snapshot(ck), uninterrupted)


def test_supervised_crash_drill_resumes_bitwise(crash_drill, uninterrupted):
    proc, ck, log = crash_drill
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    assert "attempt 1 failed (exit code 13)" in err
    assert _epochs(log) == [1, 2, 3, None]
    _assert_same(_final_snapshot(ck), uninterrupted)
