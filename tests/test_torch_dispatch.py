"""The port's dispatch pipeline against its serial one-epoch loop and
against the JAX package's loop.

  * K-epoch blocks (`epochs_per_dispatch` 2 and 3), the pipeline on and
    off and the device-resident data on and off: the state bitwise the
    serial K = 1 run's, and every record value but `wall_s` and
    `dispatch_*` equal (the block-end riders, eval and consensus error,
    on each block's last epoch, equal the K = 1 run's there); the
    pipeline on and off at one K equal with the telemetry windows too;
  * `epoch`, `dispatch_block`, `dispatch_cold` and `steps` equal a JAX
    `train()` run's with the same epochs, K and `save_every`; the values
    within the tolerance of `tests/test_torch_checkpoint.py`'s carried
    resume (loss rel 1e-4; event counts, bytes and accuracies exact):
    the port starts from the JAX run's initial state, through a snapshot
    at epoch 0;
  * the resolution: `obs="epoch"` and membership pin K = 1, the host
    block cap, K a divisor of `save_every`; the JAX causes of the
    refusals (device data or the pipeline with membership, the pipeline
    with the integrity sentinel);
  * the counterparts of `tests/test_dispatch_pipeline.py`: a resume
    mid-pipeline bitwise the run that never stopped, a ^C joining the
    writer with a complete snapshot left, a kill mid-swap restorable, the
    writer's error at the barrier, a save promoted once its thread is
    done and the saves in order, the spans decomposed by `obs.bubble`;
  * the `arena_pipe` cells of the crash matrix (`utils/crash_matrix`,
    each a kill in a child process and a resume, the writer its
    `BarrierWriter`, which swaps a save in at the next barrier) held to
    the JAX artifact `artifacts/crash_matrix_cpu.json`: crashed,
    resumed, bitwise, hit and lost epochs at all six sites;
  * `DeviceEvaluator` against `evaluate`, and bench.py's op-point
    helpers against the JAX package's on a grid of environments.

MLP (hidden 16), Ring(4), 8 samples a rank a pass, 6 passes an epoch,
float32, the CPU.
"""

import concurrent.futures
import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.loop import train as jax_train
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.obs import Registry, bubble
from eventgrad_tpu_torch.parallel import events
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import (
    DeviceEvaluator, consensus_params, evaluate, rank0_slice, train,
)
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.utils import checkpoint, crash_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, IN_SHAPE, PER_RANK, HIDDEN, LR = 4, (8, 8, 1), 8, 16, 0.05
CFG = dict(adaptive=True, horizon=0.95, warmup_passes=3)
#: keys that differ between schedules by construction
TIMING = ("wall_s", "dispatch_block", "dispatch_cold")
#: the riders of a block's last record
BLOCK_END = ("test_accuracy", "test_loss", "consensus_err_max",
             "consensus_err_mean", "obs")


def _data(n_epochs_samples=R * PER_RANK * 6, seed=0):
    x, y = jax_synthetic(n_epochs_samples, IN_SHAPE, seed=seed)
    xt, yt = jax_synthetic(64, IN_SHAPE, seed=seed + 1)
    return x, y, xt, yt


def _run(ck=None, *, epochs=6, **kw):
    x, y, xt, yt = _data()
    kw.setdefault("momentum", 0.9)
    kw.setdefault("save_every", 2 if ck is not None else 0)
    return train(MLP(hidden=HIDDEN, input_shape=IN_SHAPE), Ring(R), x, y,
                 algo="eventgrad", epochs=epochs, batch_size=PER_RANK,
                 learning_rate=LR, event_cfg=EventConfig(**CFG),
                 random_sampler=True, seed=5, x_test=xt, y_test=yt,
                 chaos="drop=0,seed=1",
                 checkpoint_dir=None if ck is None else str(ck),
                 device="cpu", **kw)


def _bits(t):
    return t.contiguous().view({torch.float32: torch.int32}.get(
        t.dtype, t.dtype))


def _assert_bitwise(a, b):
    fa, fb = state_lib.to_flat(a), state_lib.to_flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(
            _bits(fa[k]), _bits(fb[k])), k


def _assert_records(ref, got, skip=TIMING):
    """`got`'s records equal `ref`'s, key by key, but `skip`; a block-end
    rider is compared where `got` has it (its block's last epoch)."""
    assert [r["epoch"] for r in ref] == [r["epoch"] for r in got]
    for a, b in zip(ref, got):
        for k in set(a) | set(b):
            if k in skip or (k in BLOCK_END and k not in b):
                continue
            assert k in a and k in b, (b["epoch"], k)
            assert a[k] == b[k], (b["epoch"], k, a[k], b[k])


@pytest.fixture(scope="module")
def serial():
    return _run(epochs_per_dispatch=1, pipeline=False, device_data=False)


@pytest.mark.parametrize("K,pipeline,device_data", [
    (2, True, False), (2, False, True), (2, True, True),
    (3, True, False), (3, False, False), (3, True, True),
])
def test_blocks_pipeline_device_data_bitwise_serial(serial, K, pipeline,
                                                    device_data):
    st, hist = _run(epochs_per_dispatch=K, pipeline=pipeline,
                    device_data=device_data)
    _assert_bitwise(serial[0], st)
    _assert_records(serial[1], hist)
    assert [r["dispatch_block"] for r in hist] == [e // K for e in range(6)]
    assert [r["dispatch_cold"] for r in hist] == [True] * K + [False] * (
        6 - K)
    ends = {r["epoch"] for r in hist if "test_accuracy" in r}
    assert ends == set(range(K, 7, K))
    assert all(("consensus_err_max" in r) == (r["epoch"] in ends)
               for r in hist)


def test_pipeline_on_and_off_equal_with_telemetry():
    """At one K the pipeline moves only the host schedule: with the
    telemetry on, every record (its windows and audits too) equal."""
    a = _run(epochs_per_dispatch=2, pipeline=False, obs="block")
    b = _run(epochs_per_dispatch=2, pipeline=True, obs="block")
    _assert_bitwise(a[0], b[0])
    _assert_records(a[1], b[1], skip=("wall_s",))
    assert sum("obs" in r for r in b[1]) == 3


# --- against the JAX loop --------------------------------------------------------


#: (epochs, epochs_per_dispatch, save_every)
JAX_CASES = [(6, 2, 0), (7, 3, 0), (8, 4, 2)]


@pytest.mark.parametrize("epochs,K,save_every", JAX_CASES)
def test_dispatch_tags_and_values_match_jax(epochs, K, save_every,
                                             tmp_path):
    x, y = jax_synthetic(R * PER_RANK * 6, IN_SHAPE, seed=0)
    jcfg = jax_events.EventConfig(**CFG)
    common = dict(algo="eventgrad", epochs=epochs, batch_size=PER_RANK,
                  learning_rate=LR, random_sampler=True, seed=5,
                  epochs_per_dispatch=K, save_every=save_every)
    _, jhist = jax_train(JaxMLP(hidden=HIDDEN), JaxRing(R), x, y,
                         event_cfg=jcfg, **common)
    # the port starts from the JAX run's initial state (a snapshot at
    # epoch 0): the two packages draw their weights differently
    js = jax.tree.map(np.asarray, jax_init_state(
        JaxMLP(hidden=HIDDEN), IN_SHAPE, optax.sgd(LR), JaxRing(R),
        "eventgrad", jcfg, seed=5, arena=True))
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE)
    spec = arena_spec(model)
    tmpl = init_train_state(model, IN_SHAPE, Ring(R), "eventgrad",
                            EventConfig(**CFG), seed=5, device="cpu")
    tp, _ = convert.params_from_jax(js.params, stacked=True)
    carried = tmpl.replace(params=spec.ravel(tp),
                           event=convert.event_state_from_jax(js.event,
                                                              spec))
    ck = tmp_path / "ck"
    checkpoint.save(str(ck / "ckpt"),
                    *state_lib.payload(carried, 0, "eventgrad"))
    _, hist = train(model, Ring(R), x, y, event_cfg=EventConfig(**CFG),
                    checkpoint_dir=str(ck), resume=True, device="cpu",
                    **common)
    for key in ("epoch", "dispatch_block", "dispatch_cold", "steps"):
        assert [h[key] for h in hist] == [h[key] for h in jhist], key
    for h, jh in zip(hist, jhist):
        w = f"epoch {h['epoch']}"
        assert h["loss"] == pytest.approx(jh["loss"], rel=1e-4), w
        for k in ("num_events", "num_deferred", "train_acc",
                  "msgs_saved_pct", "sent_bytes_per_step_per_chip",
                  "sent_bytes_wire_real_per_step_per_chip"):
            assert h[k] == pytest.approx(jh[k], rel=1e-6), (w, k)


def test_resolution_and_refusals(monkeypatch):
    # obs="epoch" pins K = 1: every epoch ends a block
    _, h = _run(epochs=4, epochs_per_dispatch=2, obs="epoch")
    assert [r["dispatch_block"] for r in h] == [0, 1, 2, 3]
    # at most total_epochs // 2
    _, h = _run(epochs=4, epochs_per_dispatch=8, device_data=True)
    assert [r["dispatch_block"] for r in h] == [0, 0, 1, 1]
    # the host path's block cap: two blocks of the dataset's bytes
    x_bytes = R * PER_RANK * 6 * int(np.prod(IN_SHAPE)) * 4
    monkeypatch.setenv("EG_HOST_BLOCK_MAX_BYTES", str(2 * x_bytes))
    _, h = _run(epochs=4, epochs_per_dispatch=2, device_data=False)
    assert [r["dispatch_block"] for r in h] == [0, 1, 2, 3]
    monkeypatch.delenv("EG_HOST_BLOCK_MAX_BYTES")
    # K a divisor of save_every, blocks split at its multiples
    _, h = _run(epochs=6, epochs_per_dispatch=3, device_data=True,
                save_every=4)
    assert [r["dispatch_block"] for r in h] == [0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError, match="device_data requires"):
        _run(device_data=True, membership="leave=1@2")
    with pytest.raises(ValueError, match="cannot honor membership"):
        _run(pipeline=True, membership="leave=1@2")
    with pytest.raises(ValueError, match="integrity sentinel"):
        _run(pipeline=True, integrity="checksum=0,quarantine=0,sentinel=1,"
                                      "rollback=0")


# --- the pipelined saves ------------------------------------------------------------


def test_resume_mid_pipeline_matches_uninterrupted(tmp_path):
    full = _run(tmp_path / "a", epochs_per_dispatch=2, pipeline=True)
    ck = tmp_path / "b"
    _run(ck, epochs=4, epochs_per_dispatch=2, pipeline=True)
    res = _run(ck, epochs_per_dispatch=2, pipeline=True, resume=True)
    assert [h["epoch"] for h in res[1]] == [5, 6]
    _assert_bitwise(full[0], res[0])
    # two epochs left: the resumed run's blocks are one epoch each, and
    # its first record carries the chaos schedule
    _assert_records(full[1][4:], res[1], skip=TIMING + BLOCK_END + (
        "chaos",))
    for k in BLOCK_END[:4]:
        assert res[1][-1][k] == full[1][-1][k], k


def test_interrupt_joins_the_writer_and_leaves_a_complete_snapshot(
        tmp_path):
    ck = tmp_path / "ck"

    def interrupt(rec):
        if rec["epoch"] == 4:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _run(ck, pipeline=True, on_epoch=interrupt)
    found = checkpoint.latest(str(ck / "ckpt"))
    assert found is not None
    _, meta = checkpoint.peek(found)  # a torn write would fail loudly
    assert meta["epoch"] in (2, 4)
    full = _run(tmp_path / "a", pipeline=True)
    st, hist = _run(ck, pipeline=True, resume=True)
    assert hist[-1]["epoch"] == 6
    _assert_bitwise(full[0], st)


def test_kill_mid_swap_leaves_a_restorable_snapshot(tmp_path):
    ck = tmp_path / "ck"
    _run(ck, epochs=4, pipeline=True)
    path = os.path.join(str(ck), "ckpt")
    # the writer killed after the old snapshot moved aside, before the
    # new one was promoted
    os.rename(path, path + ".prev")
    assert checkpoint.latest(path) == os.path.abspath(path) + ".prev"
    st, hist = _run(ck, pipeline=True, resume=True)
    assert [h["epoch"] for h in hist] == [5, 6]
    _assert_bitwise(_run(tmp_path / "a", pipeline=True)[0], st)


def test_async_writer_error_surfaces_at_the_barrier(tmp_path, monkeypatch):
    real = checkpoint._stage
    boom = {"armed": True}

    def flaky(path, tensors, meta):
        if boom.pop("armed", False):
            raise OSError("disk full")
        real(path, tensors, meta)

    monkeypatch.setattr(checkpoint, "_stage", flaky)
    w = checkpoint.AsyncWriter()
    t = {"state/x": torch.zeros(2)}
    w.save(str(tmp_path / "ck"), t, {"epoch": 1})
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        w.wait()
    # the barrier consumed the error; the writer is reusable
    w.save(str(tmp_path / "ck"), t, {"epoch": 2})
    w.close()
    assert checkpoint.peek(checkpoint.latest(str(tmp_path / "ck")))[1][
        "epoch"] == 2
    # a failed save in the loop raises at its barrier too
    boom["armed"] = True
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        _run(tmp_path / "run", pipeline=True)


def test_async_writer_promotes_once_written_in_order(tmp_path):
    w = checkpoint.AsyncWriter()
    p = str(tmp_path / "ck")
    w.save(p, {"state/x": torch.zeros(1)}, {"epoch": 0})
    # a save whose thread is done is the snapshot of record, before any
    # barrier
    w._thread.join()
    assert checkpoint.peek(checkpoint.latest(p))[1]["epoch"] == 0
    for i in range(1, 3):
        w.save(p, {"state/x": torch.full((1,), float(i))}, {"epoch": i})
    w.close()
    raw, meta = checkpoint.peek(checkpoint.latest(p))
    assert meta["epoch"] == 2 and float(raw["state/x"]) == 2.0


def test_barrier_writer_promotes_at_the_barrier_in_order(tmp_path):
    """The crash matrix's writer holds each fsynced save until the next
    barrier, then swaps it in."""
    w = crash_matrix.BarrierWriter()
    p = str(tmp_path / "ck")
    w.save(p, {"state/x": torch.zeros(1)}, {"epoch": 0})
    w._thread.join(0.5)
    assert w._thread.is_alive() and checkpoint.latest(p) is None
    assert os.path.isdir(p + ".tmp")
    w.save(p, {"state/x": torch.ones(1)}, {"epoch": 1})
    assert checkpoint.peek(checkpoint.latest(p))[1]["epoch"] == 0
    w.close()
    raw, meta = checkpoint.peek(checkpoint.latest(p))
    assert meta["epoch"] == 1 and float(raw["state/x"]) == 1.0


def test_pipeline_spans_decompose(tmp_path):
    for flag in (False, True):
        reg = Registry()
        _run(tmp_path / f"p{flag}", obs="block", pipeline=flag,
             epochs_per_dispatch=2, registry=reg)
        d = bubble.decompose(reg.spans)
        assert d["n_blocks"] == 3
        assert d["pipelined"] is flag
        assert 0.0 <= d["host_bubble_frac"] <= 1.0
        names = {s.name for s in reg.spans}
        assert {"train", "data", "dispatch_block", "block_ready",
                "obs_flush", "eval", "eval_readback"} <= names
        assert ({"ckpt_snapshot"} <= names) is flag
        assert ("checkpoint" in names) is not flag


def test_arena_pipe_cells_match_the_jax_artifact(tmp_path):
    """Each cell: a child killed at the site's hit, a child resumed, both
    held to the uninterrupted pipelined run (run here, in this process)."""
    from eventgrad_tpu_torch.data.datasets import load_or_synthesize

    x, y = load_or_synthesize("mnist", None, "train",
                              crash_matrix.OP["n_synth"],
                              crash_matrix.OP["seed"])
    base_dir = tmp_path / "arena_pipe--base"
    base_dir.mkdir()
    assert crash_matrix._run(x, y, "arena_pipe", str(base_dir / "ck"),
                             str(base_dir / "base.jsonl"), "cpu") == 0
    # the run was on BarrierWriter, and the real writer is back
    assert checkpoint.AsyncWriter is not crash_matrix.BarrierWriter
    bases = concurrent.futures.Future()
    bases.set_result({"arena_pipe": (
        crash_matrix.records(str(base_dir), "base"), str(base_dir / "ck"))})
    sites = crash_matrix.CONFIGS["arena_pipe"][1]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(sites)) as pool:
            cells = list(pool.map(
                lambda sh: crash_matrix.crash_cell(
                    str(tmp_path), "cpu", "arena_pipe", sh[0], sh[1], bases),
                sites.items()))
    finally:
        crash_matrix.stop_forkserver()
    with open(os.path.join(REPO, "artifacts", "crash_matrix_cpu.json")) as f:
        ref = json.load(f)
    got = {"configs": {"arena_pipe": {}}, "cells": cells,
           "preemption": ref["preemption"]}
    assert crash_matrix.compare(ref, got) == []
    lost = {c["site"]: c["lost_epochs"] for c in cells}
    assert lost == {"ckpt.tmp_written": 4, "ckpt.mid_swap": 4,
                    "ckpt.post_promote": 2, "loop.block_dispatched": 0,
                    "loop.block_end": 2, "writer.bg_save": 2}
    assert all(c["crashed"] and c["resumed"] and c["final_state_bitwise"]
               and c["history_bitwise"] for c in cells)


# --- the evaluator and bench.py's helpers -----------------------------------------


def test_device_evaluator_is_evaluate():
    x, y, xt, yt = _data()
    st, _ = _run(epochs=2)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE)
    params = consensus_params(st.params)
    stats = rank0_slice(st.batch_stats)
    ev = DeviceEvaluator(model, xt, yt, batch_size=24, device="cpu")
    a = ev.result(ev.dispatch(params, stats))
    b = ev.result(ev.dispatch(params, stats))  # reusable
    c = evaluate(model, params, stats, xt, yt, batch_size=24, device="cpu")
    assert a == b == c
    # whole batches only: 64 samples at 24 a batch score 48
    logits = torch.func.functional_call(
        model, arena_spec(model).unravel(params),
        (torch.from_numpy(np.ascontiguousarray(xt[:48], np.float32)), stats,
         False))
    want = 100.0 * int((logits.argmax(-1) == torch.from_numpy(
        np.asarray(yt[:48], np.int64))).sum()) / 48
    assert a["accuracy"] == want


ENVIRONS = [
    {}, {"EG_BENCH_HORIZON": "1.1"}, {"EG_BENCH_MAX_SILENCE": "0"},
    {"EG_BENCH_MAX_SILENCE": "0", "EG_BENCH_HORIZON": "1.05"},
    {"EG_BENCH_MAX_SILENCE": "20", "EG_BENCH_HORIZON": "0.95"},
    {"EG_BENCH_HORIZON_MNIST": "1.2"},
    {"EG_BENCH_HORIZON_MNIST": "1.2", "EG_BENCH_MAX_SILENCE": "0"},
]


@pytest.mark.parametrize("env", ENVIRONS)
def test_bench_op_point_helpers_match_jax(env):
    assert events.resolve_bench_trigger(env) == \
        jax_events.resolve_bench_trigger(env)
    for ms in (0, 50):
        assert events.resolve_bench_trigger_mnist(env, ms) == \
            jax_events.resolve_bench_trigger_mnist(env, ms)
    assert events.MNIST_FULLSCALE_OP_POINT == \
        jax_events.MNIST_FULLSCALE_OP_POINT
