"""Port hygiene: the PyTorch package stands alone and runs on the card
unless told otherwise.

The import check is a scan of the source (AST), not of `sys.modules`:
JAX may already be imported in the test process before the port is.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models.resnet import ResNet

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sklearn", "eventgrad_tpu")

# The tier-1 command runs the suite in several xdist workers on one host,
# and each worker collects (imports) every test module before it runs any
# test, so this sets the whole session. Torch's intra-op pool, one thread
# per core in every worker, oversubscribed the cores: the port's files
# took 1,165 s under 6 workers with it and 312 s with one thread (all
# 376 cases passing both ways; CHANGES.md, PR 9).
torch.set_num_threads(1)


def _port_sources():
    files = sorted((ROOT / "eventgrad_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_import_scan_covers_the_cost_model_and_membership():
    """The scan reads the cost model, the device specs, the kernels' work,
    the FLOPs/MFU yardstick, the profiling and process-watch helpers and
    the membership engine."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("obs/costmodel.py", "obs/devicespec.py", "ops/work.py",
                "utils/flops.py", "utils/profiling.py", "utils/procwatch.py",
                "chaos/membership.py"):
        assert f"eventgrad_tpu_torch/{rel}" in scanned, rel


def test_import_scan_covers_the_cli_supervisor_and_loaders():
    """The scan reads the command line, the supervisor, the native data
    library's bindings and the soak."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for rel in ("cli.py", "supervise.py", "data/native.py", "utils/soak.py"):
        assert f"eventgrad_tpu_torch/{rel}" in scanned, rel


def test_import_scan_covers_the_analysis_subpackage():
    """The scan below reads every module of `eventgrad_tpu_torch/analysis/`
    (the auditor and the lint keep their own copies of what they need
    from the JAX package's analysis modules, which import no JAX
    themselves) and `chip_smoke.py`."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in ("__init__", "walker", "kernels", "rankflow", "audit",
                 "lint"):
        assert f"eventgrad_tpu_torch/analysis/{name}.py" in scanned
    assert "chip_smoke.py" in scanned


def test_import_scan_covers_the_obs_subpackage():
    """The scan reads every module of `eventgrad_tpu_torch/obs/` (the
    schema, bubble and report modules are copies of JAX modules that
    import no JAX themselves) and the telemetry's command-line tools."""
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in ("__init__", "schema", "ledger", "device", "registry",
                 "report", "bubble"):
        assert f"eventgrad_tpu_torch/obs/{name}.py" in scanned
    for name in ("metrics", "ledger_audit", "obs_report", "obs_overhead"):
        assert f"eventgrad_tpu_torch/utils/{name}.py" in scanned


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(mod, line) for mod, line in _imported_roots(tree)
           if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


#: packages of finished kernels the port must not come to need
KERNEL_PACKAGES = ("flash_attn", "xformers", "apex", "transformer_engine",
                   "cutlass", "cudnn")


@pytest.mark.parametrize(
    "path", sorted((ROOT / "eventgrad_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_kernel(path):
    """Every kernel of the port is written by hand: no module of the
    package calls `scaled_dot_product_attention` or `torch.compile`, or
    imports a package of finished kernels (`chip_smoke.py` alone times
    the library's attention, as a yardstick)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(mod, line) for mod, line in _imported_roots(tree)
           if mod in KERNEL_PACKAGES]
    for node in ast.walk(tree):
        name = getattr(node, "attr", getattr(node, "id", None))
        if name == "scaled_dot_product_attention" or (
                name == "compile" and isinstance(node, ast.Attribute)
                and getattr(node.value, "id", "") == "torch"):
            bad.append((name, node.lineno))
    assert not bad, f"{path.relative_to(ROOT)} uses {bad}"


def test_entry_points_default_to_cuda(monkeypatch):
    """`device=None` means the card and raises without CUDA — never a
    silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8)
    x, y = synthetic_dataset(64, (32, 32, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egt.train(model, egt.Ring(8), x, y, algo="eventgrad", epochs=1,
                  batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egt.init_train_state(model, (32, 32, 3), egt.Ring(8), "dpsgd")
    params, stats = model.init_variables(0)
    flat = torch.cat([v.reshape(-1) for v in params.values()])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egt.evaluate(model, flat, stats, x, y)
    from eventgrad_tpu_torch.utils import ledger_audit, obs_overhead

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ledger_audit.run(epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        obs_overhead.measure_pair(n_steps=1)
    from eventgrad_tpu_torch.utils import soak

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        soak.run_soak(None, mode="smoke")
    lm = egt.TransformerLM(vocab=16, dim=8, n_heads=2, n_layers=1, max_len=8,
                           attn="flash")
    tokens = np.zeros((16, 8), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        egt.train(lm, egt.Ring(4), tokens, tokens, algo="dpsgd", epochs=1,
                  batch_size=2)


def test_train_on_cpu_records():
    """A short CPU run of both algorithms through the public entry point:
    finite losses, the JAX records' keys, and msgs_saved_pct within its
    range."""
    model = ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8)
    x, y = synthetic_dataset(64, (32, 32, 3))
    xt, yt = synthetic_dataset(32, (32, 32, 3), split="test")
    for algo in ("eventgrad", "dpsgd"):
        state, hist = egt.train(
            model, egt.Ring(8), x, y, algo=algo, epochs=2, batch_size=4,
            learning_rate=0.01, momentum=0.9,
            event_cfg=egt.EventConfig(horizon=1.05, warmup_passes=1,
                                      max_silence=50),
            x_test=xt, y_test=yt, device="cpu",
        )
        assert len(hist) == 2 and state.pass_num == 4
        for rec in hist:
            for key in ("loss", "train_acc", "steps", "wall_s",
                        "sent_bytes_per_step_per_chip", "test_accuracy"):
                assert key in rec, key
            assert np.isfinite(rec["loss"])
        if algo == "eventgrad":
            assert 0.0 <= hist[-1]["msgs_saved_pct"] < 100.0
        assert torch.isfinite(state.params).all()


def test_refusals_name_their_roadmap_item(tmp_path):
    """Every feature the port refuses raises NotImplementedError naming
    the ROADMAP queue-1 item that ports it, and the command line refuses
    the same with SystemExit before building any data; the calls of items
    5, 6a, 6b, 6d, 6e, 6f, 7, 8, 10 and 12, once refused or missing, now
    run;
    what the JAX step refuses stays refused with its cause; the tree path
    (`arena=False`, `--arena off`) is refused as not queued, by design."""
    from eventgrad_tpu_torch import cli
    from eventgrad_tpu_torch.analysis import audit
    from eventgrad_tpu_torch.chaos.membership import MembershipSchedule
    from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
    from eventgrad_tpu_torch.data.datasets import load_or_synthesize
    from eventgrad_tpu_torch.ops import attention
    from eventgrad_tpu_torch.parallel import collectives, spmd
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.parallel.ring_attention import ring_attention
    from eventgrad_tpu_torch.parallel.sparsify import (
        SparseConfig, SparseState, sparse_exchange,
    )
    from eventgrad_tpu_torch.train.steps import make_train_step

    model = egt.MLP()
    spec = arena_spec(model)
    flat = torch.zeros((8, spec.n_total))
    fire = torch.ones((8, spec.n_leaves), dtype=torch.bool)
    q = torch.zeros((4, 1, 8, 2, 4))
    packed = torch.zeros((8, spec.floor))
    leaf_id = torch.zeros((8, spec.floor), dtype=torch.int64)
    compact = lambda **kw: collectives.compact_neighbor_vals_flat(
        flat, fire, packed, leaf_id, egt.Ring(8), spec.floor, spec, **kw)
    # item 5 (the bucketed schedule, staleness >= 2, the straggler
    # clauses) is ported: its calls, once refused, now run
    make_train_step(model, egt.Ring(8), "eventgrad", fused_sgd=(0.1, 0.0),
                    staleness=2, bucketed=4, chaos="seed=1,slow=1@3")
    sparse_exchange(flat, fire,
                    SparseState.init(flat, egt.Ring(8), SparseConfig(), spec,
                                     staleness=2),
                    egt.Ring(8), SparseConfig(), spec, staleness=2,
                    buckets=spec.buckets(2))
    for name in ("event_masked_f32_arena_b4", "sp_f32_tree_stale2"):
        assert audit.config_by_name(name).name == name
    for name in ("late_delivery_drift", "bucket_queue_skew",
                 "bucket_undeclared_offset"):
        assert callable(audit.oracle(name))
    # item 6a (the chaos fault clauses, the recovery policies and the
    # integrity engine) is ported: its calls, once refused, now run
    ChaosSchedule(seed=3, drop_p=0.4)
    for name in ("event_masked_f32_arena_stale2_chaos",
                 "event_masked_int8_tree_chaos",
                 "event_masked_f32_arena_integrity"):
        assert audit.config_by_name(name).name == name
    assert not audit.WAITING
    collectives.masked_neighbor_vals_flat(flat, fire, egt.Ring(8), spec,
                                          checksum=True)
    compact(deliver=torch.ones((8, 2), dtype=torch.bool))
    compact(checksum=True)
    compact(finite=True)
    compact(corrupt=lambda i, x: x)
    x, y = synthetic_dataset(32, (8, 8, 1))
    train_mlp = lambda **kw: egt.train(
        egt.MLP(input_shape=(8, 8, 1)), egt.Ring(4), x, y, algo="eventgrad",
        epochs=1, batch_size=8, device="cpu", **kw)
    # item 6b (checkpoints, resume, preemption, the integrity engine's
    # on-disk retention) is ported: its calls, once refused, now run
    assert ChaosSchedule.parse("seed=1,preempt=2@1").preempt == ((2, 1),)
    train_mlp(integrity="on", checkpoint_dir=str(tmp_path))
    assert (tmp_path / "ckpt").is_dir() and (tmp_path / "good").is_dir()
    # item 10 (flash attention above 128 head columns) is ported: the
    # CUDA kernels' check, once refused, now takes any width
    for d in (160, 256, 512):
        attention._check_cuda("flash_attention", torch.zeros((1, 8, 1, d)))
    # item 6d (the elastic membership: leave= / join=, the engine and
    # train(membership=)) is ported: its calls, once refused, now run
    assert len(ChaosSchedule.parse("seed=1,leave=1@3,join=1@3").membership) == 2
    sched = MembershipSchedule.parse("leave=1@1,join=1@1")
    assert sched.n_ranks_at(4, 1) == 4
    _, hist = train_mlp(membership="leave=1@1")
    assert hist[0]["membership"] == MembershipSchedule.parse(
        "leave=1@1").to_dict()
    # item 6e (K-epoch dispatch blocks, the prefetcher, the device data,
    # the deferred eval and the background saves) is ported
    _, hist = egt.train(egt.MLP(input_shape=(8, 8, 1)), egt.Ring(4), x, y,
                        algo="eventgrad", epochs=4, batch_size=8,
                        epochs_per_dispatch=2, pipeline=True,
                        device_data=True, x_test=x, y_test=y, device="cpu")
    assert [h["dispatch_block"] for h in hist] == [0, 0, 1, 1]
    assert "test_accuracy" in hist[-1]
    # item 12 (the bucketed schedule under the fault clauses) is ported:
    # its call, once refused, now runs; what the JAX step refuses there
    # stays refused with the JAX cause
    make_train_step(model, egt.Ring(8), "eventgrad", fused_sgd=(0.1, 0.0),
                    bucketed=4, chaos="seed=1,drop=0.2")
    for kw, cause in ((dict(chaos="seed=1,bitflip=0.1"), "bitflip"),
                      (dict(integrity="on"), "integrity defenses")):
        with pytest.raises(ValueError, match=rf"bucketed is not combinable"
                                             rf" with .*{cause}"):
            make_train_step(model, egt.Ring(8), "eventgrad",
                            fused_sgd=(0.1, 0.0), bucketed=4, **kw)
    # item 6f (the file loaders) is ported: a data_dir, once refused, is
    # read (here one without files: the synthetic stand-in, as in JAX)
    x_m, _ = load_or_synthesize("mnist", str(tmp_path / "none"), "train",
                                n_synth=16)
    assert x_m.shape == (16, 28, 28, 1)
    with pytest.raises(NotImplementedError, match="Not queued, by design"):
        train_mlp(arena=False)
    with pytest.raises(SystemExit, match="not queued, by design"):
        cli.main(["--arena", "off", "--device", "cpu"])
    # item 7 (hybrid meshes, the sharded transformers, ring and Ulysses
    # attention inside the model) is ported: its argvs, once refused, now
    # train, or are refused with the JAX launcher's words where it
    # refuses them (a model without its axis in the mesh); its calls run
    small = ["--dim", "8", "--heads", "2", "--layers", "1", "--seq-len",
             "8", "--vocab", "16", "--n-synth", "64", "--epochs", "1",
             "--batch-size", "4", "--device", "cpu"]
    assert cli.main(["--mesh", "dp:2,sp:2", "--model", "transformer"]
                    + small) == 0
    for argv, axis in ((["--model", "transformer_pp"], "pp"),
                       (["--model", "transformer", "--attn", "ring"], "sp")):
        with pytest.raises(SystemExit, match=(
                rf"^--model {argv[1]} needs a '{axis}' axis in --mesh "
                rf"\(e\.g\. --mesh dp:2,{axis}:2\); got \('ring',\)$")):
            cli.main(argv + small)
    ring_lm = egt.TransformerLM(vocab=16, dim=8, n_heads=2, n_layers=1,
                                max_len=8, attn="ring")
    assert ring_lm.rank_stacked
    # no axis named: along the topology's first, as the JAX function
    torus = egt.Torus(2, 2)
    assert torch.equal(ring_attention(q, q, q, torus),
                       ring_attention(q, q, q, torus, axis="x"))
    # item 8 (the device-mesh lift) is ported, and item 8b (the rest of
    # it: the fault clauses, the sharded transformers, Ulysses attention)
    # too: their calls, once refused, now run
    assert callable(audit.oracle("mesh_undeclared_offset"))
    _, hist = train_mlp(backend="mesh")
    assert hist[0]["transport"] == "local"
    cli_refusals = {
        "item 8b": [["--backend", "mesh", "--chaos", "drop=0.1"],
                    ["--backend", "mesh", "--mesh", "dp:2,tp:2", "--model",
                     "transformer_tp"]],
    }
    for item, argvs in cli_refusals.items():
        for argv in argvs:
            assert cli.main(argv + small) == 0, (item, argv)
    mesh4 = spmd.build_mesh(egt.Ring(4), "cpu")
    refusals = {
        # the fault clauses and Ulysses attention on the device mesh
        "item 8b": [lambda: train_mlp(backend="mesh",
                                      chaos="seed=1,drop=0.1")[1],
                    lambda: make_train_step(
                        egt.TransformerLM(vocab=16, dim=8, n_heads=2,
                                          n_layers=1, max_len=8,
                                          attn="ulysses"),
                        egt.Ring(4), "eventgrad", fused_sgd=(0.1, 0.0),
                        mesh=mesh4)],
    }
    for item, calls in refusals.items():
        hist, step = (call() for call in calls)
        assert hist[0]["transport"] == "local" and "chaos_drops" in hist[-1]
        assert callable(step), item
