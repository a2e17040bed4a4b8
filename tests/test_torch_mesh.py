"""The device-mesh lift (`parallel/spmd.py`, `parallel/multihost.py`):
ranks in the processes of a gloo group on the CPU, held against the
port's stacked simulator and the JAX loop.

  * the step-level matrix of `tests/test_mesh_parity.py` (`Ring(4)`,
    W = 4 processes, the MLP, five steps): dense/compact x f32/int8 x
    bucketed 1/4 x staleness 0/1, bounded asynchrony at D = 2, the
    int8/bf16 carriers x bucketed 1/4, the telemetry; every case's full
    state and metrics bitwise the simulator's;
  * the four families on `Torus(2, 2)` through `train`, W = 2, bitwise;
  * a narrow ResNet-18 with BatchNorm, augmentation and momentum on
    `Ring(8)`, W = 2, EventGraD and D-PSGD: state and records bitwise
    the simulator (one torch thread on both sides);
  * `tests/mh_worker.py`'s runs, W = 2 on `Ring(8)` (four rows a
    process): EventGraD on the MLP from the JAX run's initial state
    (carried through a snapshot) against `eventgrad_tpu`'s `train`
    (`tests/test_torch_dispatch.py`'s tolerances) and bitwise the port's
    simulator; the primary's snapshot at epoch 2 and a resume bitwise the
    uninterrupted run; a tiny `sp:2,dp:4` ring-attention LM, sp outer so
    every K/V hop crosses the process boundary, bitwise the simulator;
  * the scale leg (`Ring(16)`, W = 4), standing in for the JAX 64-rank
    smoke: per-edge telemetry bytes == steps x
    `wire_real_bytes_per_neighbor` == the step's metric per edge, on
    every rank;
  * the command line: `--backend mesh` over two processes (one through
    `--coordinator`, one through `EG_COORDINATOR`) against `--backend
    sim`, and in one process; the environment's guards; the "auto"
    divergence; a process count that does not divide the ranks; the JAX
    loop's refusals on a mesh.

The three groups start together when the module's fixture first runs
(eight processes of one torch thread each), and the parent computes the
simulator's and the JAX package's sides meanwhile.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_dist import ROOT, finish, requires_gloo, start
import _torch_mesh_worker as W

from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel import multihost as jax_multihost
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.loop import train as jax_train
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu_torch import cli, convert
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel import collectives, multihost, spmd
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.utils import checkpoint

pytestmark = requires_gloo

#: the CLI leg's argv (both backends)
CLI_ARGV = ["--device", "cpu", "--algo", "eventgrad", "--mesh", "ring:4",
            "--model", "mlp", "--epochs", "2", "--n-synth", "128",
            "--batch-size", "8"]
#: record keys that differ between a mesh run and the simulator's
MESH_ONLY = ("wall_s", "ts", "transport", "mesh_processes")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _carried_snapshot(ck):
    """The JAX run's initial `Ring(8)` state as the port's epoch-0
    snapshot in `ck` (the packages draw their weights differently)."""
    jcfg = jax_events.EventConfig(**W.CFG)
    js = jax.tree.map(np.asarray, jax_init_state(
        JaxMLP(hidden=16), W.IN_SHAPE, optax.sgd(0.05), JaxRing(8),
        "eventgrad", jcfg, seed=W.RING8["seed"], arena=True))
    model = MLP(hidden=16, input_shape=W.IN_SHAPE)
    spec = arena_spec(model)
    tmpl = state_lib.init_train_state(
        model, W.IN_SHAPE, Ring(8), "eventgrad", EventConfig(**W.CFG),
        seed=W.RING8["seed"], device="cpu")
    tp, _ = convert.params_from_jax(js.params, stacked=True)
    carried = tmpl.replace(params=spec.ravel(tp),
                           event=convert.event_state_from_jax(js.event, spec))
    checkpoint.save(os.path.join(ck, "ckpt"),
                    *state_lib.payload(carried, 0, "eventgrad"))


def _cli_procs(tmp, port):
    """The CLI leg: process 0 joins through the flags, process 1 through
    the environment."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("EG_COORDINATOR", None)
    cmd = [sys.executable, "-m", "eventgrad_tpu_torch.cli", *CLI_ARGV,
           "--backend", "mesh"]
    p0 = subprocess.Popen(
        cmd + ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
               "2", "--process-id", "0", "--log-file",
               os.path.join(tmp, "mesh0.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=tmp)
    p1 = subprocess.Popen(
        cmd + ["--log-file", os.path.join(tmp, "mesh1.jsonl")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, EG_COORDINATOR=f"127.0.0.1:{port}",
                 EG_NUM_PROCESSES="2", EG_PROCESS_ID="1"), cwd=tmp)
    return [p0, p1]


def _records(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    ck = os.path.join(tmp, "ck")
    for leg in ("a", "b"):
        _carried_snapshot(os.path.join(ck, leg))
    groups = {
        "matrix": start("_torch_mesh_worker:matrix", 4,
                        os.path.join(tmp, "store_matrix"), tmp),
        "pair": start("_torch_mesh_worker:pair", 2,
                      os.path.join(tmp, "store_pair"), tmp, ck),
        "cli": _cli_procs(tmp, _free_port()),
    }
    # the simulator's and the JAX package's sides, meanwhile
    sim = {"ring8": W.ring8_run(_seeded(tmp, "sim8"), 3, None),
           "lm": W.lm_run(None),
           "scale": W.run_steps(Ring(16), None, obs=True)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sim["cnn"] = {a: W.cnn_run(a, None) for a in W.CNN_ALGOS}
    finally:
        torch.set_num_threads(threads)
    x, y = jax_synthetic(8 * W.PER_RANK * 6, W.IN_SHAPE, seed=0)
    _, sim["jax_ring8"] = jax_train(
        JaxMLP(hidden=16), JaxRing(8), x, y, epochs=3,
        event_cfg=jax_events.EventConfig(**W.CFG), **W.RING8)
    cli_sim = os.path.join(tmp, "sim.jsonl")
    assert cli.main(CLI_ARGV + ["--backend", "sim", "--log-file",
                                cli_sim]) == 0
    sim["cli"] = _records(cli_sim)
    out = {name: finish(procs) for name, procs in groups.items()}
    out.update(torch.load(os.path.join(tmp, "matrix.pt"), weights_only=False))
    out.update(torch.load(os.path.join(tmp, "pair.pt"), weights_only=False))
    out["tmp"], out["ck"], out["sim"] = tmp, ck, sim
    return out


def _seeded(tmp, name):
    ck = os.path.join(tmp, name)
    _carried_snapshot(ck)
    return ck


def _assert_flat_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("case", list(W.MATRIX))
def test_matrix_bitwise_the_simulator(runs, case):
    """Every case's full state (parameters, trace, event state with its
    buffers, scales and queues, telemetry, the generator) and last
    metrics, gathered from the four processes, equal the simulator's."""
    state, metrics = W.run_steps(Ring(4), None, **W.MATRIX[case])
    got_state, got_metrics = runs["cases"][case]
    _assert_flat_equal(state, got_state)
    _assert_flat_equal(metrics, got_metrics)
    assert runs["n_local"] == 1 and runs["transport"] == "gloo"


@pytest.mark.parametrize("axis", W.GRID_TOPO.axes)
def test_grid_collectives_and_transposes_bitwise(runs, axis):
    """On `dp:2,sp:4`, two ranks a process: the chain sum, the mean and
    the all-to-all along either axis, and the gradient through the three
    (each backward its transpose, across processes), equal the
    simulator's."""
    want = W.grid_collectives(axis, None)
    for g, w in zip(runs["grid"][axis], want):
        assert torch.equal(g, w)


def test_matrix_exchanges_only_the_ring_offsets(runs):
    """The lift's record of its shifts names the ring's two offsets."""
    assert set(runs["exchange_log"]) == {("ring", -1), ("ring", 1)}


@pytest.mark.parametrize("algo", list(W.FAMILIES))
def test_families_on_torus_bitwise(runs, algo):
    """Torus(2, 2), two processes of two ranks: each family's final state
    and records equal the simulator's (the records but the mesh's
    first-record riders and the timing)."""
    state, hist = W.family_run(algo, None)
    got_state, got_hist = runs["families"][algo]
    _assert_flat_equal(state, got_state)
    assert got_hist[0]["transport"] == "gloo"
    assert got_hist[0]["mesh_processes"] == 2
    for a, b in zip(hist, got_hist):
        assert {k: v for k, v in a.items() if k not in MESH_ONLY} == {
            k: v for k, v in b.items() if k not in MESH_ONLY}


def test_ring8_matches_jax_loop(runs):
    """EventGraD on Ring(8), four rows a process, from the JAX run's
    initial state: the records against `eventgrad_tpu`'s train (loss rel
    1e-4; events, bytes, accuracy rel 1e-6) and the state bitwise the
    port's simulator."""
    x, _ = jax_synthetic(8 * W.PER_RANK * 6, W.IN_SHAPE, seed=0)
    np.testing.assert_array_equal(x, W.ring8_data()[0])
    state, hist = runs["ring8"]
    _assert_flat_equal(runs["sim"]["ring8"][0], state)
    jhist = runs["sim"]["jax_ring8"]
    assert [h["epoch"] for h in hist] == [h["epoch"] for h in jhist]
    for h, jh in zip(hist, jhist):
        assert h["loss"] == pytest.approx(jh["loss"], rel=1e-4)
        for k in ("num_events", "train_acc", "msgs_saved_pct",
                  "sent_bytes_per_step_per_chip",
                  "sent_bytes_wire_real_per_step_per_chip"):
            assert h[k] == pytest.approx(jh[k], rel=1e-6), k
    assert hist[-1]["msgs_saved_pct"] > 0


@pytest.mark.parametrize("algo", W.CNN_ALGOS)
def test_resnet_batchnorm_augment_bitwise(runs, algo):
    """The narrow ResNet-18 on Ring(8), four rows a process: BatchNorm's
    statistics, the augmentation's draws and the momentum trace through
    two epochs equal the simulator's bit for bit, state and records
    (each epoch's loss among them)."""
    state, hist = runs["sim"]["cnn"][algo]
    got_state, got_hist = runs["cnn"][algo]
    _assert_flat_equal(state, got_state)
    assert any(k.startswith("state/batch_stats/") for k in state)
    assert len(got_hist) == len(hist) == 2
    for a, b in zip(hist, got_hist):
        assert {k: v for k, v in a.items() if k not in MESH_ONLY} == {
            k: v for k, v in b.items() if k not in MESH_ONLY}


def test_snapshot_and_resume_bitwise(runs):
    """The interrupted run's primary wrote the gathered snapshot (all 8
    rows) at epochs 1 and 2; the resume from it runs epoch 3 alone and
    ends bitwise the uninterrupted run."""
    found = checkpoint.latest(os.path.join(runs["ck"], "b", "ckpt"))
    _, manifest = checkpoint.peek(found)
    assert manifest["epoch"] == 3
    assert manifest["layout"]["ranks"] == 8
    assert [h["epoch"] for h in runs["ring8_cut"][1]] == [1, 2]
    assert [h["epoch"] for h in runs["ring8_resumed"][1]] == [3]
    _assert_flat_equal(runs["ring8"][0], runs["ring8_resumed"][0])
    assert runs["ring8_resumed"][1][0]["num_events"] == \
        runs["ring8"][1][2]["num_events"]


def test_ring_attention_lm_sp_outer_bitwise(runs):
    """`sp:2,dp:4` with sp outer: process p holds sp index p, so every
    K/V hop (and its gradient, sent back along the inverse offset)
    crosses the process boundary; the state and records equal the
    simulator's."""
    state, hist = runs["sim"]["lm"]
    got_state, got_hist = runs["lm"]
    _assert_flat_equal(state, got_state)
    for a, b in zip(hist, got_hist):
        assert {k: v for k, v in a.items() if k not in MESH_ONLY} == {
            k: v for k, v in b.items() if k not in MESH_ONLY}


def test_scale_leg_edge_bytes(runs):
    """Ring(16), four ranks a process, telemetry on: on every rank and
    edge, the cumulative wire bytes equal steps x the per-neighbour
    formula, which equals the step's metric split over the edges; the
    state equals the simulator's."""
    state, metrics = runs["scale"]
    _assert_flat_equal(runs["sim"]["scale"][0], state)
    assert runs["scale_n_local"] == 4
    spec = arena_spec(MLP(hidden=W.HIDDEN, input_shape=W.IN_SHAPE))
    per_nb = collectives.wire_real_bytes_per_neighbor(
        spec.n_total, spec.n_leaves, None, fire_bits=True)
    edge = state["state/telemetry/edge_bytes"]
    assert edge.shape == (16, 2)
    assert torch.equal(edge, torch.full((16, 2), W.STEPS * per_nb))
    assert torch.equal(metrics["sent_bytes_wire_real"],
                       torch.full((16,), 2 * per_nb))


def test_cli_mesh_two_processes_matches_sim(runs):
    """`--backend mesh` over two processes (`--coordinator` and
    `EG_COORDINATOR`): the primary alone writes the log, whose records
    equal `--backend sim`'s but for the per-epoch consensus eval, which
    a multi-process run skips (the JAX loop's rule), and the final
    record evaluates the gathered consensus model."""
    tmp = runs["tmp"]
    assert not os.path.exists(os.path.join(tmp, "mesh1.jsonl"))
    mesh, sim = _records(os.path.join(tmp, "mesh0.jsonl")), runs["sim"]["cli"]
    assert len(mesh) == len(sim) == 3
    assert mesh[0]["transport"] == "gloo" and mesh[0]["mesh_processes"] == 2
    strip = lambda r: {k: v for k, v in r.items() if k not in MESH_ONLY
                       and not k.startswith("test_")}
    for a, b in zip(sim, mesh):
        assert strip(a) == strip(b)
    assert mesh[-1] == {**sim[-1], "ts": mesh[-1]["ts"]}


def test_auto_divergence_rows_and_refusals(runs):
    """'auto' is the simulator without a group (the JAX function counts
    devices; the port counts processes) and the mesh in a group of two;
    process 0 holds rows 0-3; a process count that does not divide the
    ranks and `pipeline=True` on several processes are refused."""
    assert spmd.resolve_backend("auto", Ring(8), "cpu") is None
    assert runs["auto"] == ("Mesh", 2, 0, 4, "gloo")
    assert runs["rows"] == ([0, 1, 2, 3], [0, 1, 2, 3])
    assert spmd.rank_index(Ring(8)).tolist() == list(range(8))
    assert "must divide the rank count" in runs["refusals"]["divides"]
    assert runs["refusals"]["pipeline"].startswith(
        "pipeline=True needs the single-process path")


def test_drift_tool_one_thread_bitwise_and_fault_seen(tmp_path):
    """`utils/mesh_drift.py` at 4 filters on the CPU, one torch thread a
    process: the mesh from the seed and from the simulator's pass-2 state
    equal the simulator's every pass, as does a second simulator run; a
    1e-7 perturbation of the parameters and an exchange with the +-2
    neighbours move them."""
    from eventgrad_tpu_torch.utils import mesh_drift

    out = tmp_path / "drift.json"
    assert mesh_drift.main(["--device", "cpu", "--num-filters", "4",
                            "--per-rank", "4", "--threads", "1", "--out",
                            str(out)]) == 0
    legs = json.loads(out.read_text())["legs"]
    assert set(legs) == {"eventgrad", "dpsgd"}
    for algo, leg in legs.items():
        for name in ("mesh_vs_sim", "mesh_from_sim_pass2_vs_sim",
                     "sim_vs_sim"):
            for d in leg[name]:
                assert d["params"] == d["trace"] == d["loss"] == [0.0, 0.0]
                assert d["batch_stats"] == 0.0
                assert d.get("fires_equal", True), (algo, name)
        assert len(leg["mesh_vs_sim"]) == 4
        assert len(leg["mesh_from_sim_pass2_vs_sim"]) == 2
        assert leg["sim_perturbed_1e-7_vs_sim"][0]["params"][1] > 0
        assert leg["wrong_exchange_from_pass2_vs_sim"][0]["params"][1] > 0


#: the backend decision: (each process's (host, cards on its host, NCCL
#: built in), the run's device, the backend, the local ranks)
PLANS = {
    "one-card-two-processes": ([("a", 1, True)] * 2, "cuda", "gloo",
                               [0, 1]),
    "two-hosts-one-card-each": ([("a", 1, True), ("b", 1, True)], "cuda",
                                "nccl", [0, 0]),
    "two-hosts-eight-cards": ([("a", 8, True)] * 8 + [("b", 8, True)] * 8,
                              "cuda", "nccl", list(range(8)) * 2),
    "a-host-short-of-cards": ([("a", 8, True)] * 8 + [("b", 4, True)] * 8,
                              "cuda", "gloo", list(range(8)) * 2),
    "interleaved-hosts": ([("a", 2, True), ("b", 2, True)] * 2, None,
                          "nccl", [0, 0, 1, 1]),
    "a-process-without-nccl": ([("a", 2, True), ("a", 2, False)], "cuda",
                               "gloo", [0, 1]),
    "cpu": ([("a", 8, True)] * 2, "cpu", "gloo", [0, 1]),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_backend_judges_each_host_by_its_cards(case):
    """NCCL only where every process has a card of its own on its host
    (two hosts of one card each take it; two processes on one card do
    not); a process's local rank counts its host's processes."""
    peers, device, backend, local = PLANS[case]
    assert multihost.plan_backend(device, peers) == (backend, local)


def _w1(**kw):
    x, y = synthetic_dataset(4 * W.PER_RANK * 2, W.IN_SHAPE, seed=1)
    return train(MLP(hidden=W.HIDDEN, input_shape=W.IN_SHAPE), Ring(4), x, y,
                 algo="eventgrad", epochs=2, batch_size=W.PER_RANK,
                 device="cpu", **kw)


def test_one_process_mesh_bitwise_sim(tmp_path, monkeypatch):
    """With no group, `backend="mesh"`, `mesh=build_mesh(topo)` and the
    CLI's `--backend mesh` run one process holding every rank, bitwise
    the simulator; "vmap" beside a mesh contradicts it."""
    ref_state, ref_hist = _w1()
    for kw in (dict(backend="mesh"),
               dict(mesh=spmd.build_mesh(Ring(4), "cpu"))):
        state, hist = _w1(**kw)
        _assert_flat_equal(state_lib.to_flat(ref_state),
                           state_lib.to_flat(state))
        assert hist[0]["transport"] == "local"
        assert [{k: v for k, v in h.items() if k not in MESH_ONLY}
                for h in hist] == [{k: v for k, v in h.items()
                                    if k not in MESH_ONLY} for h in ref_hist]
    with pytest.raises(ValueError, match="contradicts an explicit mesh"):
        _w1(backend="vmap", mesh=spmd.build_mesh(Ring(4), "cpu"))
    monkeypatch.chdir(tmp_path)
    for backend in ("sim", "mesh"):
        assert cli.main(CLI_ARGV + ["--backend", backend, "--log-file",
                                    f"{backend}.jsonl"]) == 0
    strip = lambda r: {k: v for k, v in r.items() if k not in MESH_ONLY}
    assert ([strip(r) for r in _records(tmp_path / "mesh.jsonl")]
            == [strip(r) for r in _records(tmp_path / "sim.jsonl")])


def test_env_coordinator_guards_match_jax(monkeypatch):
    """EG_COORDINATOR without its two companions raises the JAX
    function's words before joining anything; unset, nothing is
    joined."""
    monkeypatch.delenv("EG_COORDINATOR", raising=False)
    assert multihost.init_from_env() is False
    assert not multihost.is_initialized()
    monkeypatch.setenv("EG_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("EG_NUM_PROCESSES", "2")
    monkeypatch.delenv("EG_PROCESS_ID", raising=False)
    with pytest.raises(RuntimeError) as want:
        jax_multihost.init_from_env()
    with pytest.raises(RuntimeError) as got:
        multihost.init_from_env()
    assert str(got.value) == str(want.value)
    assert "EG_PROCESS_ID" in str(got.value)
    with pytest.raises(SystemExit, match="^EG_COORDINATOR requires "
                                         "--backend mesh$"):
        cli.main(CLI_ARGV + ["--backend", "auto"])


#: what a mesh refuses with the JAX loop's words: (train() options, words)
JAX_REFUSALS = [
    (dict(integrity="on"), "the integrity sentinel/rollback engine needs "
     "the single-process path"),
    (dict(membership="leave=1@1"), "membership needs the single-process "
     "vmap path"),
    (dict(device_data=True), "device_data requires the single-process, "
     "non-hybrid, mesh=None path"),
]


@pytest.mark.parametrize("kw,words", JAX_REFUSALS,
                         ids=["integrity", "membership", "device_data"])
def test_mesh_refuses_with_jax_words(kw, words):
    with pytest.raises(ValueError, match=words):
        _w1(backend="mesh", **kw)
