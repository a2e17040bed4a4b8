"""The port's crash drills and graceful preemption (`chaos/crashpoint.py`,
the `preempt=` clause, `train()`'s drain and crash sites,
`utils/crash_matrix.py`) against the JAX package's.

  * the registry: `SITES` (names and seams), `parse_spec`, the arming and
    the exit codes equal the JAX package's; `preempt=` parses, prints
    and serializes as the JAX schedule does;
  * the drain: a scheduled `preempt=` and a SIGTERM (sent from the
    `on_epoch` callback) each snapshot the boundary, leave the PREEMPTED
    marker, raise `GracefulPreemption`, put the previous signal handler
    back, and resume bitwise the run never preempted; an armed site that
    never fires only adds the first record's rider;
  * one subprocess kill at `ckpt.mid_swap`: exit `CRASHPOINT_EXIT`, the
    witness on stderr, `ckpt.prev` left as the newest snapshot, the
    rider on the first record, and a bitwise resume;
  * the integrity rollback with a `checkpoint_dir` is bitwise the
    rollback without one, its retention at most `keep_good` snapshots;
  * the lint rules `exit-code-literals`, `os-exit-confined` and
    `crashpoint-instrumented` find seeded violations as the JAX rules do
    on their JAX twins, and the waiting site stays honest;
  * `artifacts/torch_crash_matrix_cpu.json` agrees with the JAX
    artifact, cell by cell.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from eventgrad_tpu import exitcodes as jax_exitcodes
from eventgrad_tpu.analysis import lint as jax_lint
from eventgrad_tpu.chaos import crashpoint as jax_crashpoint
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu_torch import exitcodes
from eventgrad_tpu_torch.analysis import lint
from eventgrad_tpu_torch.chaos import crashpoint
from eventgrad_tpu_torch.chaos.crashpoint import GracefulPreemption
from eventgrad_tpu_torch.chaos.integrity import IntegrityConfig
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.utils import checkpoint, crash_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IN_SHAPE = (8, 8, 1)


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test starts and ends disarmed: a leaked arming would kill a
    later test at its first save."""
    crashpoint.arm(None)
    yield
    crashpoint.arm(None)


def _run(ck=None, **kw):
    x, y = synthetic_dataset(128, IN_SHAPE, seed=3)
    return train(MLP(hidden=8, input_shape=IN_SHAPE), Ring(4), x, y,
                 algo="eventgrad", epochs=4, batch_size=8,
                 learning_rate=0.05,
                 event_cfg=EventConfig(adaptive=True, horizon=0.95,
                                       warmup_passes=2),
                 seed=5, checkpoint_dir=None if ck is None else str(ck),
                 save_every=2, device="cpu", **kw)


def _assert_bitwise(a, b):
    fa, fb = state_lib.to_flat(a), state_lib.to_flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k].reshape(-1).view(torch.uint8),
                           fb[k].reshape(-1).view(torch.uint8)), k


# --- the registry ------------------------------------------------------------


def test_sites_spec_and_exit_codes_match_jax():
    assert crashpoint.SITES == jax_crashpoint.SITES
    assert (crashpoint.ENV_VAR, crashpoint.PREEMPT_MARKER) == (
        jax_crashpoint.ENV_VAR, jax_crashpoint.PREEMPT_MARKER)
    for spec in ("ckpt.mid_swap", "loop.block_end:3",
                 " integrity.rollback:2"):
        assert crashpoint.parse_spec(spec) == jax_crashpoint.parse_spec(spec)
    for bad in ("ckpt.nope", "loop.block_end:0"):
        with pytest.raises(ValueError):
            jax_crashpoint.parse_spec(bad)
        with pytest.raises(ValueError):
            crashpoint.parse_spec(bad)
    for name in ("PREEMPTED_EXIT", "INTEGRITY_ABORT_EXIT", "CRASHPOINT_EXIT",
                 "EXIT_CODE_NAMES"):
        assert getattr(exitcodes, name) == getattr(jax_exitcodes, name)


def test_arming_counts_hits_and_unarmed_is_a_lookup():
    assert crashpoint.armed() is None
    crashpoint.hit("loop.block_end")  # unarmed: returns
    with pytest.raises(KeyError, match="unregistered crashpoint"):
        crashpoint.hit("loop.nope")
    crashpoint.arm("ckpt.mid_swap:3")
    assert crashpoint.armed() == {"site": "ckpt.mid_swap", "hit": 3}
    crashpoint.hit("ckpt.mid_swap")  # hits 1 and 2 return
    crashpoint.hit("ckpt.mid_swap")
    crashpoint.hit("ckpt.tmp_written")  # another site: no count
    crashpoint.arm(None)
    assert crashpoint.armed() is None


def test_preempt_clause_round_trips_like_jax():
    spec = "drop=0,seed=3,preempt=4@2,preempt=9"
    s, js = ChaosSchedule.parse(spec), JaxChaos.parse(spec)
    assert s.preempt == js.preempt == ((4, 2), (9, 1))
    assert s.to_spec() == js.to_spec() and s.to_dict() == js.to_dict()
    assert ChaosSchedule.parse(s.to_spec()) == s
    assert ChaosSchedule.from_dict(js.to_dict()) == s
    assert s.is_noop == js.is_noop is False
    assert "preempt" not in ChaosSchedule().to_dict()
    with pytest.raises(ValueError, match="preempt"):
        ChaosSchedule.parse("preempt=0@1")


def test_marker_write_and_consume(tmp_path):
    d = str(tmp_path / "ck")
    assert crashpoint.consume_marker(d) is None
    path = crashpoint.write_marker(d, {"reason": "x", "epoch": 2})
    assert path == crashpoint.marker_path(d) and os.path.exists(path)
    assert crashpoint.consume_marker(d) == {"reason": "x", "epoch": 2}
    assert not os.path.exists(path)
    with open(path, "w") as f:
        f.write("{torn")
    assert crashpoint.consume_marker(d) is None and not os.path.exists(path)


def test_preempt_guard_sets_a_flag_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    with crashpoint.PreemptGuard() as g:
        assert signal.getsignal(signal.SIGTERM) != before
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested == "SIGTERM"
        # after the first signal the previous handler is back
        assert signal.getsignal(signal.SIGTERM) == before
    assert signal.getsignal(signal.SIGTERM) == before
    with crashpoint.PreemptGuard(enabled=False) as g:
        assert signal.getsignal(signal.SIGTERM) == before
    assert g.requested is None


# --- the drain -----------------------------------------------------------------


def test_scheduled_preempt_drains_marks_and_resumes_bitwise(tmp_path):
    base, base_hist = _run(chaos="drop=0,seed=1")
    ck = tmp_path / "ck"
    with pytest.raises(GracefulPreemption) as ei:
        _run(ck, chaos="drop=0,seed=1,preempt=2@1")
    info = ei.value.info
    assert (info["reason"], info["epoch"], info["snapshot"]) == (
        "schedule:2@1", 2, True)
    assert info["marker"] == crashpoint.marker_path(str(ck))
    assert os.path.exists(info["marker"])
    _, meta = checkpoint.peek(checkpoint.latest(str(ck / "ckpt")))
    assert meta["epoch"] == 2
    st, hist = _run(ck, chaos="drop=0,seed=1,preempt=2@1", resume=True)
    assert not os.path.exists(info["marker"])  # consumed
    assert [h["epoch"] for h in hist] == [3, 4]  # nothing recomputed
    _assert_bitwise(base, st)
    for r in hist:
        want = base_hist[r["epoch"] - 1]
        assert (r["loss"], r["num_events"]) == (want["loss"],
                                                want["num_events"])


def test_sigterm_drains_at_the_epoch_end_and_resumes_bitwise(tmp_path):
    base, _ = _run()
    ck = tmp_path / "ck"

    def deliver(rec):
        if rec["epoch"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    before = signal.getsignal(signal.SIGTERM)
    # serial: a pipelined run logs epoch 1 once epoch 2 has launched, and
    # then drains at epoch 2's end
    with pytest.raises(GracefulPreemption) as ei:
        _run(ck, on_epoch=deliver, pipeline=False)
    assert ei.value.info["reason"] == "signal:SIGTERM"
    assert ei.value.info["epoch"] == 1  # no save was due: a forced one
    assert signal.getsignal(signal.SIGTERM) == before
    assert os.path.exists(crashpoint.marker_path(str(ck)))
    st, hist = _run(ck, resume=True)
    assert [h["epoch"] for h in hist] == [2, 3, 4]
    _assert_bitwise(base, st)


def test_unarmed_is_bitwise_and_an_armed_site_adds_its_rider():
    s0, h0 = _run()
    assert all("crashpoint" not in r for r in h0)
    crashpoint.arm("loop.block_end:999")  # never reached in 4 epochs
    s1, h1 = _run()
    assert h1[0]["crashpoint"] == {"site": "loop.block_end", "hit": 999}
    assert all("crashpoint" not in r for r in h1[1:])
    _assert_bitwise(s0, s1)
    assert [r["loss"] for r in h0] == [r["loss"] for r in h1]


def test_subprocess_kill_at_mid_swap_resumes_bitwise(tmp_path):
    """One cell of the crash matrix at the swap's worst instant: the old
    snapshot demoted, the new one not promoted."""
    tmp = str(tmp_path)
    try:
        _kill_and_resume(tmp)
    finally:
        crash_matrix.stop_forkserver()


def _kill_and_resume(tmp):
    base = crash_matrix._baselines(tmp, "cpu")["arena_serial"]
    rc, out = crash_matrix.run_child(
        crash_matrix._argv("cpu", "arena_serial", tmp, "crash"),
        os.path.join(tmp, "crash.out"), crash="ckpt.mid_swap")
    assert rc == exitcodes.CRASHPOINT_EXIT, out[-2000:]
    assert "crashpoint ckpt.mid_swap hit 1" in out
    ck = os.path.join(tmp, "ck")
    assert checkpoint.latest(os.path.join(ck, "ckpt")).endswith(".prev")
    first = crash_matrix.records(tmp, "crash")
    assert first[0]["crashpoint"] == {"site": "ckpt.mid_swap", "hit": 1}
    rc, out = crash_matrix.run_child(
        crash_matrix._argv("cpu", "arena_serial", tmp, "resume",
                           resume=True), os.path.join(tmp, "resume.out"))
    assert rc == 0, out[-2000:]
    again = crash_matrix.records(tmp, "resume")
    # the .prev of epoch 2 replays epochs 3 and 4
    assert crash_matrix.lost_epochs(first, again) == 2
    assert crash_matrix.history_equal(base[0], first + again) == (True, "")
    assert crash_matrix.final_state_equal(base[1], ck)


def test_integrity_rollback_with_a_checkpoint_dir_is_bitwise(tmp_path):
    x, y = synthetic_dataset(1024, IN_SHAPE, seed=1)
    integ = IntegrityConfig(checksum=True, quarantine=False, escalate=True,
                            max_rollbacks=1, keep_good=2)

    def run(ck=None):
        return train(MLP(hidden=16, input_shape=IN_SHAPE), Ring(4), x, y,
                     algo="eventgrad", epochs=4, batch_size=32,
                     learning_rate=0.1,
                     event_cfg=EventConfig(adaptive=True, horizon=0.95,
                                           warmup_passes=5, max_silence=5),
                     seed=0, chaos="seed=13,bitflip=3-9@0.2,nanstep=2@14",
                     integrity=integ, checkpoint_dir=ck, save_every=1,
                     device="cpu")

    sa, ha = run()
    ck = str(tmp_path / "ck")
    sb, hb = run(ck)
    assert [r["epoch"] for r in hb] == [1, 2, 2, 3, 4]  # one rollback
    _assert_bitwise(sa, sb)
    for ra, rb in zip(ha, hb):
        for k in ("loss", "wire_rejects", "quarantined_steps",
                  "integrity_rollbacks"):
            assert ra[k] == rb[k] or (np.isnan(ra[k]) and np.isnan(rb[k]))
    ret = checkpoint.RollingRetention(os.path.join(ck, "good"), keep=2)
    assert [e for e, _ in ret.snapshots()] == [3, 4]
    # the newest retained good state is the final state
    raw, meta = checkpoint.peek(ret.path_for(4))
    assert meta["epoch"] == 4
    assert torch.equal(raw["state/params"], sb.params)


# --- the lint ----------------------------------------------------------------


def _with_seed(module, subdir, rel, text, tmp_path):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return module.collect_sources(subdirs=(subdir,)) + [
        module.SourceFile(path=str(path), rel=rel, text=text)]


#: rule -> (seed source, violations each must report)
SEEDS = {
    "exit-code-literals": ("import sys\n\ndef f():\n    sys.exit(75)\n"
                           "    return 83\n", 2),
    "os-exit-confined": ("import os\n\ndef f():\n    os._exit(3)\n", 1),
    "crashpoint-instrumented": (
        "from x import crashpoint\n\ndef f(site):\n"
        "    crashpoint.hit('loop.block_end')\n"
        "    crashpoint.hit(site)\n    crashpoint.hit('loop.nope')\n", 3),
}


@pytest.mark.parametrize("rule", list(SEEDS))
def test_crash_rules_fire_like_their_jax_twins(rule, tmp_path):
    text, want = SEEDS[rule]
    port = lint.run([r for r in lint.RULES if r.name == rule],
                    files=_with_seed(lint, "eventgrad_tpu_torch",
                                     "eventgrad_tpu_torch/utils/seeded.py",
                                     text, tmp_path / "port"))
    jax_v = jax_lint.run([r for r in jax_lint.RULES if r.name == rule],
                         files=_with_seed(jax_lint, "eventgrad_tpu",
                                          "eventgrad_tpu/utils/seeded.py",
                                          text, tmp_path / "jax"))
    assert len(port) == len(jax_v) == want, (port, jax_v)


def test_waiting_crash_site_stays_honest(tmp_path, monkeypatch):
    rule = next(r for r in lint.RULES if r.name == "crashpoint-instrumented")
    # every registered site is instrumented now: the membership engine's
    # bootstrap stream holds `membership.bootstrap`
    assert rule.WAITING == {}
    assert lint.run([rule]) == []
    # declaring an instrumented site waiting, a second instrumentation,
    # or leaving a live one dead, flags
    monkeypatch.setattr(rule, "WAITING", {
        "membership.bootstrap": "the membership engine "
                                "(ROADMAP queue 1, item 6, part 6d)"})
    assert any("waiting crashpoints" in v.message for v in lint.run([rule]))
    monkeypatch.setattr(rule, "WAITING", {})
    seeded = _with_seed(lint, "eventgrad_tpu_torch",
                        "eventgrad_tpu_torch/chaos/seeded.py",
                        "def f(crashpoint):\n"
                        "    crashpoint.hit('membership.bootstrap')\n",
                        tmp_path)
    assert any("more than one site" in v.message
               for v in lint.run([rule], files=seeded))
    files = [sf for sf in lint.collect_sources()
             if sf.rel != "eventgrad_tpu_torch/utils/checkpoint.py"]
    (v,) = lint.run([rule], files=files)
    assert "NO instrumented site" in v.message and "ckpt.mid_swap" in v.message


# --- the artifact ---------------------------------------------------------------


def test_crash_matrix_artifact_matches_the_jax_artifact():
    with open(os.path.join(REPO, "artifacts", "crash_matrix_cpu.json")) as f:
        ref = json.load(f)
    with open(os.path.join(REPO, "artifacts",
                           "torch_crash_matrix_cpu.json")) as f:
        got = json.load(f)
    assert crash_matrix.compare(ref, got) == []
    # 5 cells of arena_serial, 6 of membership (with membership.bootstrap),
    # 6 of integrity (with integrity.rollback)
    assert got["n_cells"] == 17 and len(got["preemption"]["cells"]) == 2
    memb = {c["site"]: c["lost_epochs"] for c in got["cells"]
            if c["config"] == "membership"}
    assert memb == {"ckpt.tmp_written": 2, "ckpt.mid_swap": 2,
                    "ckpt.post_promote": 2, "loop.block_dispatched": 1,
                    "loop.block_end": 0, "membership.bootstrap": 2}
    assert got["unresumable"] == got["silent_data_loss"] == 0
    assert got["recovery_ok"] and got["device"] == "cpu"
    assert got["op_point"] == dict(crash_matrix.OP, model="mlp",
                                   algo="eventgrad")
    # the artifact predates the arena_pipe configuration, whose cells
    # tests/test_torch_dispatch.py runs live against the JAX artifact
    assert set(got["configs"]) == set(crash_matrix.CONFIGS) - {"arena_pipe"}
    assert {(c["config"], c["site"], c["hit"]) for c in got["cells"]} == {
        (c, s, h) for c, (_, sites) in crash_matrix.CONFIGS.items()
        if c in got["configs"] for s, h in sites.items()}
