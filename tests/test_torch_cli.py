"""The port's command line (`eventgrad_tpu_torch/cli.py`) against the JAX
package's (`eventgrad_tpu/cli.py`).

  * the parser: every JAX option string exists here with the same
    default, choices, type and action, and a table of argvs covering
    every flag group parses to the same namespace (the mesh compared by
    its axes and shape, the port's own `--device` aside);
  * the guards: a table of argvs that both `main`s refuse before any
    data is built raise `SystemExit` with the same words (no JAX step
    compiles: every guard fires first);
  * the refusals: the argvs the device-mesh lift once refused as
    ROADMAP item 8b (the fault clauses, the sharded transformers) run on
    a one-process mesh with `--backend sim`'s records, and
    EG_COORDINATOR without its companions raises the JAX words; `--arena
    off` the "not queued, by design" entry; the argvs once
    refused as item 7 (hybrid meshes, the tp/pp/moe transformers, ring /
    Ulysses attention) train, or are refused with the JAX launcher's
    words where it refuses them (a model without its axis);
  * the hybrid meshes end to end on the CPU: each argv the JAX launcher
    trains (`dp:2,sp:2` ring, `dp:2,tp:2`, `dp:2,pp:2`, `dp:2,ep:2`,
    `dp:2,ddp:2`) trains here and writes its records, gossip bytes
    counted on dp alone; with `--device cuda` and no CUDA it raises;
  * end to end on the CPU: `main([... --device cpu ...])` logs epoch
    records value for value those of a direct `train()` call on the same
    data, then a `final` record;
  * the trace file: the port's `_write_trace` writes the JAX writer's
    bytes from the same metric arrays and topology, and its loss stream
    the JAX loop's lines; a traced run resumed from its snapshot
    continues the uninterrupted trace byte for byte.
"""

import json
import os

import numpy as np
import pytest
import torch

from eventgrad_tpu import cli as jax_cli
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.parallel.topology import Torus as JaxTorus
from eventgrad_tpu.train import loop as jax_loop
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch import cli
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.train import loop


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    monkeypatch.setenv("EG_COMPILE_CACHE", "off")
    monkeypatch.delenv("EG_COORDINATOR", raising=False)


def _actions(parser):
    return {a.option_strings[0] if a.option_strings else a.dest: a
            for a in parser._actions}


def test_parser_options_match_jax():
    jax_acts, acts = _actions(jax_cli.build_parser()), _actions(
        cli.build_parser())
    assert set(acts) - set(jax_acts) == {"--device"}
    for key, ja in jax_acts.items():
        a = acts[key]
        assert a.option_strings == ja.option_strings, key
        assert type(a) is type(ja), key
        assert a.default == ja.default, key
        assert (list(a.choices) if a.choices else None) == (
            list(ja.choices) if ja.choices else None), key
        assert getattr(a.type, "__name__", a.type) == getattr(
            ja.type, "__name__", ja.type), key
    dev = acts["--device"]
    assert (dev.default, list(dev.choices)) == ("cuda", ["cuda", "cpu"])


#: argvs covering every flag group: topology, data, model, optimizer,
#: trigger, wire, schedule, chaos / integrity / membership, checkpoint,
#: observability, launch
PARSE_TABLE = [
    [],
    ["--algo", "dpsgd", "--mesh", "torus:2x4", "--backend", "auto"],
    ["--mesh", "dp:2,sp:2", "--model", "transformer", "--attn", "ring"],
    ["--dataset", "cifar10", "--data-dir", "/d", "--model", "resnet18",
     "--num-filters", "8", "--num-classes", "10", "--augment"],
    ["--dataset", "synthetic-imagenet", "--image-size", "48",
     "--num-classes", "16"],
    ["--model", "transformer_moe", "--seq-len", "64", "--vocab", "32",
     "--dim", "16", "--heads", "2", "--layers", "1", "--n-experts", "4"],
    ["--epochs", "3", "--batch-size", "8", "--global-batch", "64", "--lr",
     "0.1", "--momentum", "0.9", "--seed", "7", "--random-sampler",
     "--sync-bn", "--n-synth", "256"],
    ["--thres-mode", "constant", "--constant", "0.5", "--horizon", "0.9",
     "--warmup-passes", "4", "--history", "3", "--max-silence", "5"],
    ["--algo", "sp_eventgrad", "--topk-percent", "5",
     "--trigger-policy", "topk", "--gossip-wire", "compact"],
    ["--wire", "int8", "--carrier-resident", "--bucketed", "4",
     "--staleness", "2", "--compact-frac", "0.375", "--gossip-wire",
     "compact", "--trigger-policy", "hybrid"],
    ["--wire-bf16", "--arena", "on", "--pipeline", "off", "--fused"],
    ["--chaos", "drop=0.2,seed=3", "--chaos-sync-after", "9",
     "--chaos-freeze-after", "12", "--integrity", "on"],
    ["--membership", "leave=1@2,join=1@4", "--fault-inject", "crash:2"],
    ["--checkpoint-dir", "/c", "--save-every", "2", "--resume",
     "--log-file", "l.jsonl", "--trace-file", "t.jsonl", "--log-fsync"],
    ["--obs", "epoch", "--obs-dir", "/o", "--profile-dir", "/p",
     "--coordinator", "h:1", "--num-processes", "2", "--process-id", "1"],
]


def _mesh_key(m):
    return (tuple(m.axes), tuple(m.shape),
            tuple(getattr(m, "gossip_axes", m.axes)),
            tuple(getattr(m, "sharded_axes", ())),
            tuple(getattr(m, "data_aux_axes", ())))


@pytest.mark.parametrize("argv", PARSE_TABLE, ids=lambda a: " ".join(a)[:60]
                         or "defaults")
def test_argv_parses_as_jax_parses(argv):
    want = vars(jax_cli.build_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert _mesh_key(got.pop("mesh")) == _mesh_key(want.pop("mesh"))
    assert got == want


@pytest.mark.parametrize("spec", ["hypercube:3", "torus:8", "ring:x",
                                  "dp:2,zz:2", "dp:2,dp:2", "dp:0"])
def test_bad_mesh_spec_same_words(spec):
    import argparse

    with pytest.raises(argparse.ArgumentTypeError) as want:
        jax_cli.parse_mesh(spec)
    with pytest.raises(argparse.ArgumentTypeError) as got:
        cli.parse_mesh(spec)
    assert str(got.value) == str(want.value)


#: argvs both launchers refuse before building any data
GUARD_TABLE = [
    ["--model", "mlp", "--dataset", "synthetic-lm"],
    ["--model", "transformer", "--augment"],
    ["--mesh", "ddp:4", "--algo", "dpsgd"],
    ["--wire-bf16", "--wire", "int8"],
    ["--algo", "allreduce", "--wire", "bf16"],
    ["--algo", "dpsgd", "--trigger-policy", "micro"],
    ["--algo", "dpsgd", "--gossip-wire", "compact"],
    ["--compact-frac", "0.5"],
    ["--gossip-wire", "compact", "--compact-frac", "1.5"],
    ["--algo", "sp_eventgrad", "--gossip-wire", "compact",
     "--compact-frac", "0.5"],
    ["--max-silence", "-1"],
    ["--algo", "dpsgd", "--max-silence", "5"],
    ["--staleness", "-1"],
    ["--algo", "dpsgd", "--staleness", "1"],
    ["--staleness", "1", "--trace-file", "t.jsonl"],
    ["--membership", "leave=1@0"],
    ["--algo", "sp_eventgrad", "--membership", "leave=1@2"],
    ["--membership", "leave=1@2", "--pipeline", "on"],
    ["--algo", "allreduce", "--chaos", "drop=0.1"],
    ["--chaos", "drop=0.1", "--fused"],
    ["--chaos", "bogus=1"],
    ["--chaos", "drop=0,leave=1@2", "--membership", "join=1@3"],
    ["--chaos", "drop=0,leave=1@2", "--trace-file", "t.jsonl"],
    ["--algo", "dpsgd", "--chaos", "drop=0", "--chaos-sync-after", "5"],
    ["--chaos-freeze-after", "3"],
    ["--chaos", "drop=0", "--chaos-sync-after", "3", "--max-silence", "5"],
    ["--pipeline", "on", "--fault-inject", "crash:1"],
    ["--algo", "dpsgd", "--integrity", "on"],
    ["--integrity", "on", "--fused"],
    ["--integrity", "on", "--pipeline", "on"],
    ["--integrity", "nonsense=1"],
    ["--model", "cnn2", "--num-classes", "100"],
    ["--coordinator", "h:1"],
]


@pytest.mark.parametrize("argv", GUARD_TABLE, ids=lambda a: " ".join(a)[:60])
def test_guard_refuses_with_jax_words(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as want:
        jax_cli.main(argv)
    with pytest.raises(SystemExit) as got:
        cli.main(argv)
    assert isinstance(want.value.code, str)
    assert str(got.value) == str(want.value)


def test_env_coordinator_guard_matches_jax(monkeypatch):
    monkeypatch.setenv("EG_COORDINATOR", "h:1")
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit,
                           match="^EG_COORDINATOR requires --backend mesh$"):
            main([])


#: the small transformer of the end-to-end argvs, and the run's size
SMALL_LM = ["--dim", "32", "--heads", "2", "--layers", "2", "--seq-len",
            "16", "--vocab", "32"]
SMALL_RUN = ["--n-synth", "128", "--epochs", "2", "--batch-size", "4"]

#: the argvs once refused as ROADMAP item 7: the hybrid mesh trains; a
#: model whose axis the mesh lacks is refused as the JAX launcher refuses
#: it; those once refused on the device mesh as item 8b run there, their
#: records those of `--backend sim`
REFUSALS = [
    (["--mesh", "dp:2,sp:2", "--model", "transformer"], "runs"),
    (["--model", "transformer_tp"], "jax words"),
    (["--model", "transformer_moe"], "jax words"),
    (["--model", "transformer", "--attn", "ulysses"], "jax words"),
    (["--backend", "mesh", "--chaos", "drop=0.1"], "item 8b"),
    (["--backend", "mesh", "--mesh", "dp:2,tp:2", "--model",
      "transformer_tp"], "item 8b"),
]


@pytest.mark.parametrize("argv,item", REFUSALS,
                         ids=lambda a: " ".join(a) if isinstance(a, list)
                         else a)
def test_refusals_name_their_item(argv, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if item == "runs":
        assert cli.main(argv + SMALL_LM + SMALL_RUN + ["--device", "cpu"]) == 0
    elif item == "jax words":
        with pytest.raises(SystemExit) as want:
            jax_cli.main(argv + ["--n-synth", "64"])
        with pytest.raises(SystemExit) as got:
            cli.main(argv + ["--n-synth", "64", "--device", "cpu"])
        assert "axis in --mesh" in str(want.value)
        assert str(got.value) == str(want.value)
    else:
        small = SMALL_LM + SMALL_RUN + ["--device", "cpu"]
        sim = [a if a != "mesh" else "sim" for a in argv]
        assert cli.main(argv + small + ["--log-file", "mesh.jsonl"]) == 0
        assert cli.main(sim + small + ["--log-file", "sim.jsonl"]) == 0
        strip = lambda r: {k: v for k, v in r.items()
                           if k not in ("wall_s", "ts", "transport",
                                        "mesh_processes")}
        got, want = (
            [strip(json.loads(line)) for line in open(path)]
            for path in ("mesh.jsonl", "sim.jsonl"))
        assert len(got) == len(want) == 3 and got == want


#: the hybrid argvs the JAX launcher trains: (argv, gossip neighbours)
HYBRID_ARGVS = [
    ["--mesh", "dp:2,sp:2", "--model", "transformer", "--attn", "ring"]
    + SMALL_LM,
    ["--mesh", "dp:2,tp:2", "--model", "transformer_tp"] + SMALL_LM,
    ["--mesh", "dp:2,pp:2", "--model", "transformer_pp"] + SMALL_LM,
    ["--mesh", "dp:2,ep:2", "--model", "transformer_moe", "--n-experts",
     "4"] + SMALL_LM,
    ["--mesh", "dp:2,ddp:2", "--model", "cnn2", "--dataset", "synthetic"],
]


@pytest.mark.parametrize("argv", HYBRID_ARGVS,
                         ids=lambda a: " ".join(a[:4]))
def test_hybrid_argv_trains_on_cpu(argv, tmp_path):
    """Each argv trains on the CPU and writes its records: finite losses,
    msgs-saved-% in range, the dense wire-real bytes of the dp gossip
    (two neighbours), then the final record (a hybrid mesh reports its
    train metrics, `consensus_eval: false`; `dp:2,ddp:2` shards only data
    and evaluates its consensus model)."""
    log = tmp_path / "run.jsonl"
    assert cli.main(argv + SMALL_RUN + ["--device", "cpu", "--log-file",
                                        str(log)]) == 0
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    epochs, final = recs[:-1], recs[-1]
    args = cli.build_parser().parse_args(argv)
    model = (cli.build_lm_model(args, args.mesh)
             if args.model.startswith("transformer")
             else cli.build_image_model(args, (28, 28, 1)))
    spec = arena_spec(model)
    wire_real = float(np.float32(2) * np.float32(4 * spec.n_total
                                                 + spec.n_leaves))
    assert [r["epoch"] for r in epochs] == [1, 2]
    for r in epochs:
        assert np.isfinite(r["loss"]) and r["active_ranks"] == 4
        assert 0.0 <= r["msgs_saved_pct"] < 100.0
        assert r["n_params"] == spec.n_total
        assert r["sent_bytes_wire_real_per_step_per_chip"] == wire_real
    assert final["final"] is True
    if args.mesh.is_hybrid:
        assert final["consensus_eval"] is False
        assert final["loss"] == epochs[-1]["loss"]
    else:
        assert "accuracy" in final
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv + SMALL_RUN)


def test_arena_off_and_env_coordinator_refusals(monkeypatch):
    with pytest.raises(SystemExit, match="not queued, by design"):
        cli.main(["--arena", "off", "--device", "cpu"])
    monkeypatch.setenv("EG_COORDINATOR", "h:1")
    monkeypatch.delenv("EG_NUM_PROCESSES", raising=False)
    with pytest.raises(RuntimeError, match="EG_COORDINATOR='h:1' is set but "
                                           "EG_NUM_PROCESSES is not"):
        cli.main(["--backend", "mesh"])


def test_cuda_default_raises_without_cuda(monkeypatch, tmp_path):
    """Without `--device cpu` and without CUDA the launcher raises before
    building any data, rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--model", "mlp", "--dataset", "synthetic", "--epochs", "1",
                  "--log-file", str(tmp_path / "l.jsonl")])


E2E = ["--algo", "eventgrad", "--mesh", "ring:4", "--model", "mlp",
       "--dataset", "synthetic", "--epochs", "2", "--batch-size", "8",
       "--n-synth", "128", "--warmup-passes", "2", "--device", "cpu"]

#: record fields that are the host's clock, not the run's result
CLOCK = ("ts", "wall_s")


def _plain(rec):
    return {k: v for k, v in json.loads(json.dumps(rec)).items()
            if k not in CLOCK}


def test_main_records_match_direct_train(tmp_path, capsys):
    log = str(tmp_path / "run.jsonl")
    assert cli.main(E2E + ["--log-file", log]) == 0
    capsys.readouterr()
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [r.get("epoch") for r in recs] == [1, 2, None]
    x, y = synthetic_dataset(128, (28, 28, 1), seed=0)
    xt, yt = synthetic_dataset(512, (28, 28, 1), seed=0, split="test")
    state, hist = egt.train(
        egt.MLP(), egt.Ring(4), x, y, algo="eventgrad", epochs=2,
        batch_size=8, learning_rate=0.05,
        event_cfg=egt.EventConfig(warmup_passes=2), x_test=xt, y_test=yt,
        device="cpu")
    assert [_plain(r) for r in recs[:2]] == [_plain(h) for h in hist]
    final = recs[-1]
    assert final["final"] is True
    want = egt.evaluate(egt.MLP(), egt.consensus_params(state.params),
                        egt.rank0_slice(state.batch_stats), xt, yt,
                        device="cpu")
    assert (final["accuracy"], final["loss"]) == (want["accuracy"],
                                                  want["loss"])


def _trace_metrics(rng, steps, r, leaves):
    return {
        "trace_fired": (rng.random((steps, r, leaves)) < 0.5).astype(
            np.float32),
        "trace_norm": rng.random((steps, r, leaves)).astype(np.float32) * 9,
        "trace_thres": rng.random((steps, r, leaves)).astype(np.float32),
        "loss": rng.random((steps, r)).astype(np.float32) * 3,
    }


@pytest.mark.parametrize("shape", [(4,), (2, 3)], ids=["ring4", "torus2x3"])
def test_trace_writer_bytes_match_jax(tmp_path, shape):
    """Two epochs of metric arrays through both writers: the same bytes,
    the same receive-side carry."""
    import jax

    topo = egt.Ring(*shape) if len(shape) == 1 else egt.Torus(*shape)
    jtopo = JaxRing(*shape) if len(shape) == 1 else JaxTorus(*shape)
    r = topo.n_ranks
    spec = arena_spec(egt.MLP(hidden=16))
    names = [n.replace(".", "/") for n in spec.names]
    variables = JaxMLP(hidden=16).init(jax.random.PRNGKey(0),
                                       np.zeros((1, 28, 28, 1), np.float32))

    class _State:
        params = variables["params"]

    rng = np.random.default_rng(3)
    carries = [{"recv_norm": np.zeros((topo.n_neighbors, r,
                                       spec.n_leaves))} for _ in range(2)]
    paths = [str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")]
    for epoch in range(2):
        m = _trace_metrics(rng, 3, r, spec.n_leaves)
        jax_loop._write_trace(paths[0], m, 3 * epoch, jtopo, _State,
                              carries[0])
        loop._write_trace(paths[1], m, 3 * epoch, topo, names, carries[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    np.testing.assert_array_equal(carries[0]["recv_norm"],
                                  carries[1]["recv_norm"])


def test_loss_stream_matches_jax_lines(tmp_path):
    """The non-event algorithms' stream: the JAX loop's lines, built from
    its `_loss_record`."""
    loss = np.random.default_rng(5).random((3, 4)).astype(np.float32)
    path = str(tmp_path / "values.jsonl")
    loop._write_loss_stream(path, loss, 6, 4)
    want = "".join(json.dumps(jax_loop._loss_record(6, s, r, loss)) + "\n"
                   for s in range(3) for r in range(4))
    with open(path) as f:
        assert f.read() == want


def _traced(tmp_path, tag, algo="eventgrad", **kw):
    x, y = synthetic_dataset(64, (8, 8, 1), seed=0)
    path = str(tmp_path / f"{tag}.jsonl")
    _, hist = egt.train(
        egt.MLP(hidden=8, input_shape=(8, 8, 1)), egt.Ring(4), x, y,
        algo=algo, batch_size=4, event_cfg=egt.EventConfig(warmup_passes=1),
        trace_file=path, device="cpu", **kw)
    return path, hist


def test_traced_run_writes_the_reference_layout(tmp_path):
    """A traced EventGraD run: the JAX header, R send records and
    n_nb x R receive records a pass, and fire bits that add up to the
    run's events; D-PSGD's trace is the loss stream."""
    path, hist = _traced(tmp_path, "eg", epochs=2)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    spec = arena_spec(egt.MLP(hidden=8, input_shape=(8, 8, 1)))
    assert lines[0] == {
        "trace_params": [n.replace(".", "/") for n in spec.names],
        "trace_neighbors": ["ring_m1", "ring_p1"]}
    passes = sum(h["steps"] for h in hist)
    sends = [l for l in lines[1:] if "recv" not in l]
    recvs = [l for l in lines[1:] if "recv" in l]
    assert len(sends) == 4 * passes and len(recvs) == 2 * 4 * passes
    assert [s["pass"] for s in sends[::4]] == list(range(1, passes + 1))
    assert 2 * sum(sum(s["fired"]) for s in sends) == hist[-1]["num_events"]
    path, hist = _traced(tmp_path, "dp", algo="dpsgd", epochs=1)
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == 4 * hist[0]["steps"]
    assert set(lines[0]) == {"pass", "rank", "loss"}


def test_traced_resume_continues_the_trace(tmp_path):
    """The receive-side carry rides the snapshot: a traced run resumed
    after epoch 1 writes the trace of the run that never stopped."""
    whole, _ = _traced(tmp_path, "whole", epochs=3)
    ck = str(tmp_path / "ck")
    cut, _ = _traced(tmp_path, "cut", epochs=1, checkpoint_dir=ck,
                     save_every=1)
    _traced(tmp_path, "cut", epochs=3, checkpoint_dir=ck, save_every=1,
            resume=True)
    with open(whole, "rb") as f, open(cut, "rb") as g:
        assert f.read() == g.read()
