"""The fault clauses on the device-mesh lift: the MLP on `Ring(8)` in the
two processes of a gloo group on the CPU, four rows a process, held
against the port's stacked simulator and the JAX package's step.

  * `train` under each case of `_torch_mesh_chaos_worker.CASES`
    (EventGraD at staleness 2 under drop, flaky, bitflip, nanstep, lag
    and slow with the in-step integrity riders and the recovery policy;
    D-PSGD under drop, flaky and die with the edge freeze; the bucketed
    schedule at K = 4): the gathered state (the peer health, the queues,
    the telemetry and its message ledger among it) and every record (the
    drops, rejections, quarantines and silence among them) bitwise the
    simulator's;
  * the ring's payload crosses the process boundary (`Mesh.crossed`);
  * single steps from the JAX package's state before each pass
    (`STEP_CASES`): the mesh's state and metrics bitwise the simulator
    step's, and against the JAX step with `tests/test_torch_chaos.py`'s
    tolerances: silence, drops, verdicts, quarantines and bytes equal,
    receive buffers (and queues) bitwise, parameters within rtol 1e-4,
    atol 1e-5;
  * the command line: `--chaos` with the riders and the policy through
    `--backend mesh` over two processes against `--backend sim`;
  * what a mesh still refuses, in the JAX loop's words.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_dist import ROOT, finish, requires_gloo, start, stop
import _torch_mesh_chaos_worker as W

from eventgrad_tpu.chaos import integrity as jax_integrity
from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos import policy as jax_policy
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.data.sharding import batched_epoch
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import cli, convert
from eventgrad_tpu_torch.chaos import monitor
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.state import TrainState

pytestmark = requires_gloo

#: record keys that differ between a mesh run and the simulator's
MESH_ONLY = ("wall_s", "ts", "transport", "mesh_processes")
#: `tests/test_torch_chaos.py`'s tolerance on the parameters
TOL = dict(rtol=1e-4, atol=1e-5)
#: the CLI leg's argv (both backends)
CLI_ARGV = ["--device", "cpu", "--algo", "eventgrad", "--mesh", "ring:8",
            "--model", "mlp", "--n-synth", "256", "--epochs", "2",
            "--batch-size", "8", "--warmup-passes", "2", "--max-silence",
            "4", "--chaos",
            "drop=0.2,seed=3,flaky=2-4@0.6,bitflip=2-6@0.5,nanstep=1@3",
            "--chaos-sync-after", "6", "--chaos-freeze-after", "9",
            "--integrity", "checksum=1,quarantine=1,sentinel=0,rollback=0"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_procs(tmp, port):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("EG_COORDINATOR", None)
    cmd = [sys.executable, "-m", "eventgrad_tpu_torch.cli", *CLI_ARGV,
           "--backend", "mesh", "--coordinator", f"127.0.0.1:{port}",
           "--num-processes", "2"]
    return [subprocess.Popen(
        cmd + ["--process-id", str(p), "--log-file",
               os.path.join(tmp, f"mesh{p}.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=tmp) for p in (0, 1)]


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


def _batches():
    x, y = jax_synthetic(W.R * W.PER_RANK * W.STEPS, W.IN_SHAPE, seed=3)
    xb, yb = batched_epoch(x, y, W.R, W.PER_RANK)
    return [(np.asarray(xb[:, s]), np.asarray(yb[:, s]))
            for s in range(W.STEPS)]


def _carry(js, spec):
    """The port's state carried from a (numpy) JAX state."""
    tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                     stacked=True)
    return TrainState(
        params=spec.ravel(tp), trace=None, batch_stats=ts,
        pass_num=int(js.pass_num[0]),
        event=(None if js.event is None
               else convert.event_state_from_jax(js.event, spec)),
        chaos=monitor.PeerHealth(
            silence=torch.from_numpy(np.array(js.chaos.silence)),
            sync_req=torch.from_numpy(np.array(js.chaos.sync_req)),
            drops=torch.from_numpy(np.array(js.chaos.drops))))


def _jax_passes(case):
    """The JAX step under the case's faults: per pass, (the port's state
    carried from the JAX state before it, the batch), and (the JAX state,
    metrics) after it."""
    kw = dict(W.STEP_CASES[case])
    algo, staleness = kw["algo"], kw.get("staleness", 0)
    jtopo = JaxRing(W.R)
    jmodel = JaxMLP(hidden=W.HIDDEN)
    spec = arena_spec(W.model())
    tx = optax.sgd(W.LR)
    jcfg = jax_events.EventConfig(**W.CFG)
    jstate = jax_init_state(jmodel, W.IN_SHAPE, tx, jtopo, algo, jcfg,
                            seed=0, arena=True, staleness=staleness)
    jstate = jstate.replace(chaos=stack_for_ranks(
        jax_monitor.PeerHealth.init(jtopo), jtopo))
    integ = kw.get("integrity")
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, algo, jcfg, arena=True, staleness=staleness,
        chaos=JaxChaos.parse(kw["chaos"]),
        chaos_policy=jax_policy.RecoveryPolicy(**kw["chaos_policy"]),
        integrity=None if integ is None
        else jax_integrity.IntegrityConfig(**integ)), jtopo))
    carried, after = [], []
    for x, y in _batches():
        js = jax.tree.map(np.array, jstate)
        carried.append((_carry(js, spec), (x, y)))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        after.append((jax.tree.map(np.array, jstate),
                      jax.tree.map(np.array, jm)))
    return spec, carried, after


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_chaos"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    groups = {}
    try:
        groups = {"chaos": start("_torch_mesh_chaos_worker:chaos", 2,
                                 os.path.join(tmp, "store"), tmp),
                  "cli": _cli_procs(tmp, _free_port())}
        sim = {"jax": {}, "carried": {}, "train": {}}
        carried = {}
        for case in W.STEP_CASES:
            spec, carried[case], sim["jax"][case] = _jax_passes(case)
        sim["spec"] = spec
        part = os.path.join(tmp, "carried.part")
        torch.save(carried, part)
        os.replace(part, os.path.join(tmp, "carried.pt"))
        for case in W.STEP_CASES:
            sim["carried"][case] = W.carried_run(case, carried, None)
        for case in W.CASES:
            sim["train"][case] = W.train_run(case, None)
        sim_log = os.path.join(tmp, "sim.jsonl")
        assert cli.main(CLI_ARGV + ["--backend", "sim", "--log-file",
                                    sim_log]) == 0
        sim["cli"] = _records(sim_log)
        for procs in groups.values():
            finish(procs)
    finally:
        torch.set_num_threads(threads)
        for procs in groups.values():
            stop(procs)
    out = torch.load(os.path.join(tmp, "chaos.pt"), weights_only=False)
    out["tmp"], out["sim"] = tmp, sim
    return out


def _assert_flat_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in MESH_ONLY}


@pytest.mark.parametrize("case", list(W.CASES))
def test_train_under_faults_bitwise_the_simulator(runs, case):
    """Two epochs under the case's faults on two processes: the gathered
    state (health, queues, telemetry and ledger included) and every record
    equal the simulator's, and the faults really met the run."""
    state, hist = runs["sim"]["train"][case]
    got_state, got_hist = runs["train"][case]
    _assert_flat_equal(state, got_state)
    assert any(k.startswith("state/chaos/") for k in state)
    assert any(k.startswith("state/telemetry/ledger/") for k in state)
    assert got_hist[0]["transport"] == "gloo"
    assert got_hist[0]["mesh_processes"] == 2
    assert len(got_hist) == len(hist) == 2
    assert [_strip(h) for h in got_hist] == [_strip(h) for h in hist]
    assert hist[-1]["chaos_drops"] > 0
    if "integrity" in W.CASES[case]:
        assert sum(h["wire_rejects"] for h in hist) > 0
        assert sum(h["quarantined_steps"] for h in hist) > 0
        assert hist[-1]["late_commits"] > 0


@pytest.mark.parametrize("case", list(W.CASES))
def test_ring_crosses_the_processes(runs, case):
    """Process 0 sent the ring's payloads (and the sync requests, the
    checksums, the fire bits) across the boundary, and nothing else."""
    crossed = runs["crossed"][case]
    assert set(crossed) == {("hop", "ring")} and crossed["hop", "ring"] > 0


@pytest.mark.parametrize("case", list(W.STEP_CASES))
def test_steps_from_jax_state_bitwise_sim_and_match_jax(runs, case):
    """Each pass from the JAX state before it: the mesh's gathered state
    and metrics equal the simulator step's bit for bit; against the JAX
    step the health, the drop and verdict counts and the bytes are equal,
    the receive buffers (and queues) bitwise, the parameters within
    rtol 1e-4, atol 1e-5."""
    got, want = runs["carried"][case], runs["sim"]["carried"][case]
    assert len(got) == len(want) == W.STEPS
    for (gs, gm), (ws, wm) in zip(got, want):
        _assert_flat_equal(state_lib.to_flat(ws), state_lib.to_flat(gs))
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)
    spec = runs["sim"]["spec"]
    exact = ("edge_silence", "chaos_drops", "sent_bytes",
             "sent_bytes_wire_real", "fired_elems", "num_events",
             "num_deferred", "fired_frac", "integrity_wire_reject",
             "integrity_quarantined", "edge_staleness", "late_commits")
    fields = ("bufs", "pending", "edge_clock", "late_commits")
    for p, ((js, jm), (ts, tm)) in enumerate(zip(runs["sim"]["jax"][case],
                                                 got), start=1):
        w = f"pass {p}"
        for k in exact:
            if k in jm:
                np.testing.assert_array_equal(tm[k], jm[k],
                                              err_msg=f"{w} {k}")
        tp, _ = convert.params_from_jax(js.params, stacked=True)
        np.testing.assert_allclose(ts.params.numpy(), spec.ravel(tp).numpy(),
                                   err_msg=w, equal_nan=True, **TOL)
        assert torch.equal(ts.chaos.silence,
                           torch.from_numpy(np.array(js.chaos.silence)))
        assert torch.equal(ts.chaos.sync_req,
                           torch.from_numpy(np.array(js.chaos.sync_req)))
        if js.event is not None:
            jev = convert.event_state_from_jax(js.event, spec)
            for f in fields:
                a, b = getattr(ts.event, f), getattr(jev, f)
                assert _same(a, b), f"{w} {f}"
    last = got[-1][1]
    assert last["chaos_drops"].sum() > 0
    if "integrity" in W.STEP_CASES[case]:
        assert sum(m["integrity_wire_reject"].sum() for _, m in got) > 0
        assert sum(m["integrity_quarantined"].sum() for _, m in got) > 0
    if W.STEP_CASES[case].get("staleness"):
        assert last["late_commits"].sum() > 0


def _same(a, b):
    """Nested tuples of tensors (or None) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and torch.equal(a, b)


def test_cli_chaos_mesh_matches_sim(runs):
    """`--chaos` with the riders and the policy through `--backend mesh`
    over two processes: the primary alone writes the log, whose records
    equal `--backend sim`'s but for the per-epoch consensus eval, which a
    multi-process run skips (the JAX loop's rule)."""
    tmp = runs["tmp"]
    assert not os.path.exists(os.path.join(tmp, "mesh1.jsonl"))
    mesh, sim = _records(os.path.join(tmp, "mesh0.jsonl")), runs["sim"]["cli"]
    assert len(mesh) == len(sim) == 3
    assert mesh[0]["transport"] == "gloo" and mesh[0]["mesh_processes"] == 2
    strip = lambda r: {k: v for k, v in _strip(r).items()
                       if not k.startswith("test_")}
    assert [strip(r) for r in mesh] == [strip(r) for r in sim]
    assert sum(r["wire_rejects"] for r in mesh[:-1]) > 0
    assert mesh[-1] == {**sim[-1], "ts": mesh[-1]["ts"]}


#: what a mesh refuses under the fault clauses, with the JAX loop's
#: words: the sentinel/rollback engine, and membership (the chaos spec's
#: leave=/join= clauses)
REFUSALS = [(dict(chaos="seed=1,drop=0.1", integrity="on"),
             "the integrity sentinel/rollback engine needs the single-"
             "process path"),
            (dict(chaos="seed=1,drop=0.1,leave=1@1"),
             "membership needs the single-process vmap path")]


@pytest.mark.parametrize("kw,words", REFUSALS,
                         ids=["sentinel", "membership"])
def test_mesh_refuses_with_jax_words(kw, words):
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel.topology import Ring
    from eventgrad_tpu_torch.train.loop import train

    x, y = synthetic_dataset(4 * W.PER_RANK * 2, W.IN_SHAPE, seed=1)
    with pytest.raises(ValueError, match=words):
        train(W.model(), Ring(4), x, y, algo="eventgrad", epochs=2,
              batch_size=W.PER_RANK, backend="mesh", device="cpu", **kw)
