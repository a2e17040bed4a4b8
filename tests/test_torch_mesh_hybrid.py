"""The tensor-, pipeline- and expert-parallel transformers and Ulysses
attention on the device-mesh lift: ranks in the two processes of a gloo
group on the CPU, held against the port's stacked simulator and the JAX
package's step.

  * each family (`_torch_mesh_hybrid_worker.FAMILIES`: `tp:2,dp:4`,
    `pp:2,dp:4`, `ep:4,dp:2`, `sp:2,dp:4` with flash Ulysses) through
    `train` from the seed, two epochs of EventGraD with momentum: the
    gathered state (parameters, trace, event state, generator) and the
    records bitwise the simulator's;
  * the same runs' record of what crossed the processes
    (`spmd.Mesh.crossed`): the sharded axis's collectives, and nothing
    of the dp gossip, which stays inside a process;
  * two EventGraD passes of each family from the JAX package's initial
    state (`_torch_hybrid.carried_start`): every pass's state and metrics
    bitwise the simulator's step, and within `_torch_hybrid`'s
    tolerances of the JAX step (rtol 1e-4, atol 1e-5; fire bits, events,
    msgs-saved-% and bytes equal);
  * the command line: `--model transformer_tp --backend mesh` over two
    processes against `--backend sim`.

The group starts when the module's fixture first runs, once the JAX
initial states are written, and the parent computes the JAX steps and
the simulator's side meanwhile (one torch thread, as each process).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import ROOT, finish, requires_gloo, start, stop
import _torch_hybrid as H
import _torch_mesh_hybrid_worker as W

from eventgrad_tpu.models.moe import MoETransformerLM as JaxMoE
from eventgrad_tpu.models.pp import PPTransformerLM as JaxPP
from eventgrad_tpu.models.tp import TPTransformerLM as JaxTP
from eventgrad_tpu.models.transformer import TransformerLM as JaxLM
from eventgrad_tpu_torch import cli
from eventgrad_tpu_torch.train import state as state_lib

pytestmark = requires_gloo

#: record keys that differ between a mesh run and the simulator's
MESH_ONLY = ("wall_s", "ts", "transport", "mesh_processes")
#: the CLI leg's argv (both backends)
CLI_ARGV = ["--device", "cpu", "--algo", "eventgrad", "--mesh", "tp:2,dp:4",
            "--model", "transformer_tp", "--dim", "32", "--heads", "2",
            "--layers", "2", "--seq-len", "16", "--vocab", "32",
            "--n-synth", "96", "--epochs", "2", "--batch-size", "4",
            "--momentum", "0.9"]


def _jax_model(family, jtopo):
    lm = dict(W.LM)
    if family == "tp":
        return JaxTP(**lm, axis="tp", tp_size=2)
    if family == "pp":
        return JaxPP(**dict(lm, n_layers=2), axis="pp", pp_size=2,
                     n_micro=W.N_MICRO)
    if family == "moe":
        return JaxMoE(**lm, n_experts=W.N_EXPERTS, axis="ep", ep_size=4)
    return JaxLM(**lm, attn="ulysses", topo=jtopo, sp_axis="sp",
                 use_flash=True)


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_hybrid"))
    assert W.LM == dict(H.LM, n_layers=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    groups = {}
    try:
        carried = {"cfg": H.CFG, "sgd": (H.LR, H.MOM)}
        jax_side = {}
        for family, spec in W.FAMILIES.items():
            jtopo, _ = H.mesh(spec)
            jmodel = _jax_model(family, jtopo)
            tmodel = W.model(family, W.topology(family))
            jstate, tstate, arena = H.carried_start(
                jmodel, tmodel, spec, "eventgrad", (H.T // (
                    2 if family == "ulysses" else 1),), jit=True)
            batches = H.lm_batches(jtopo, 2)
            carried[family] = (tstate, batches)
            jax_side[family] = (jmodel, jstate, arena, batches)
        torch.save(carried, os.path.join(tmp, "carried.pt"))
        groups = {"hybrid": start("_torch_mesh_hybrid_worker:hybrid", 2,
                                  os.path.join(tmp, "store"), tmp),
                  "cli": _cli_procs(tmp, _free_port())}
        sim = {"train": {}, "carried": {}, "jax": {}}
        for family, (jmodel, jstate, arena, batches) in jax_side.items():
            sim["jax"][family] = H.jax_passes(
                jmodel, jstate, W.FAMILIES[family], "eventgrad", batches)
            sim["carried"][family] = W.carried_run(family, carried, None)
            sim["train"][family] = W.train_run(family, None)
            sim.setdefault("arena", {})[family] = arena
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
    out = torch.load(os.path.join(tmp, "hybrid.pt"), weights_only=False)
    out["tmp"], out["sim"] = tmp, sim
    return out


def _assert_flat_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in MESH_ONLY}


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_train_bitwise_the_simulator(runs, family):
    """Two epochs through `train` on two processes: the gathered state
    and every record equal the simulator's; the first record names the
    transport and the two processes."""
    state, hist = runs["sim"]["train"][family]
    got_state, got_hist = runs["train"][family]
    _assert_flat_equal(state, got_state)
    assert any(k.startswith("state/event/") for k in state)
    assert got_hist[0]["transport"] == "gloo"
    assert got_hist[0]["mesh_processes"] == 2
    assert len(got_hist) == len(hist) == 2
    assert [_strip(h) for h in got_hist] == [_strip(h) for h in hist]
    assert hist[-1]["msgs_saved_pct"] > 0


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_sharded_axis_crosses_the_processes(runs, family):
    """What process 0 sent to process 1: the family's collectives along
    its outer axis, each a positive byte count, and no dp gossip (each
    process holds whole dp rings)."""
    crossed = runs["crossed"][family]
    assert set(crossed) == W.CROSSED[family]
    assert all(v > 0 for v in crossed.values())
    assert runs["rows"] == (2, 0, 4)


@pytest.mark.parametrize("family", list(W.FAMILIES))
def test_carried_passes_bitwise_sim_and_match_jax(runs, family):
    """Two EventGraD passes from the JAX initial state: the mesh's
    gathered state and metrics equal the simulator step's bit for bit;
    parameters, trace and loss within rtol 1e-4, atol 1e-5 of the JAX
    step's, fire bits, events, msgs-saved-% and bytes equal, the gossip
    bytes those of the dp axis alone."""
    got, want = runs["carried"][family], runs["sim"]["carried"][family]
    assert len(got) == len(want) == 2
    for (gs, gm), (ws, wm) in zip(got, want):
        _assert_flat_equal(state_lib.to_flat(ws), state_lib.to_flat(gs))
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)
    jax_passes = runs["sim"]["jax"][family]
    passes = [(js, jm, gs, gm) for (js, jm), (gs, gm) in zip(jax_passes,
                                                               got)]
    arena = runs["sim"]["arena"][family]
    _, topo = H.mesh(W.FAMILIES[family])
    fired = H.check_passes("eventgrad", arena, topo, passes)
    H.assert_gossip_bytes("eventgrad", arena, topo, passes)
    assert 0 < fired


def test_cli_transformer_tp_mesh_matches_sim(runs):
    """`--model transformer_tp --backend mesh` over two processes: the
    primary alone writes the log, whose records equal `--backend sim`'s
    (the final record's train metrics, a hybrid mesh's, among them)."""
    tmp = runs["tmp"]
    assert not os.path.exists(os.path.join(tmp, "mesh1.jsonl"))
    mesh, sim = _records(os.path.join(tmp, "mesh0.jsonl")), runs["sim"]["cli"]
    assert len(mesh) == len(sim) == 3
    assert mesh[0]["transport"] == "gloo" and mesh[0]["mesh_processes"] == 2
    assert [_strip(r) for r in mesh] == [_strip(r) for r in sim]
    assert mesh[-1]["final"] and mesh[-1]["consensus_eval"] is False


def test_chip_smoke_legs_name_these_crossings():
    """`chip_smoke.py`'s legs (e)-(h) run these meshes, the sharded (or
    sequence) axis outer, and hold the card's runs to the collectives
    these tests see cross the processes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    legs = {kind: mesh for _, mesh, kind, _, _ in smoke.MESH_HYBRID_LEGS}
    assert legs == W.FAMILIES
    assert smoke.MESH_HYBRID_CROSSED == {
        family: {f"{kind}:{axis}" for kind, axis in crossed}
        for family, crossed in W.CROSSED.items()}
