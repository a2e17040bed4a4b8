"""The port's source lint against the JAX package's.

The port's sources lint clean; each ported rule fires on a seeded
violation written under `tmp_path`, with the same count as the JAX rule
on the JAX-spelled twin of that seed; the auditor's named exemption
(the seeded unregistered kernel in `analysis/audit.py`) stays honest;
and the wall-clock, ledger and process-group rules flag their stale
direction (an exempt file that no longer reads the clock, a
`ledger_update` that no longer adds to the counters, an exempt test file
that is gone or starts no group) as the JAX rules do. The three
process-group rules (the counterparts of the JAX lint's shard-map
rules) read the port's test files; their JAX twins' seeds spell the
transform's name in two pieces, so that the JAX lint's own scan of
`tests/` does not read this file as one touching it.
"""

import pytest

from eventgrad_tpu.analysis import lint as jax_lint
from eventgrad_tpu_torch.analysis import kernels, lint

RULES = {r.name: r for r in lint.RULES}
#: the JAX transform's name, in two pieces (see the module docstring)
SHARD_MAP = "shard" + "_map"
JAX_RULES = {r.name: r for r in jax_lint.RULES}

#: (port rule, JAX rule, port seed (path, source), JAX twin (path,
#: source), violations each must report)
SEEDS = {
    "host-sync": (
        "no-host-sync-in-traced", "no-host-sync-in-traced",
        ("eventgrad_tpu_torch/parallel/seeded.py",
         "def f(x):\n    a = x.sum().item()\n"
         "    torch.cuda.synchronize()\n    return a\n"),
        ("eventgrad_tpu/parallel/seeded.py",
         "def f(x):\n    a = x.sum().block_until_ready()\n"
         "    jax.device_get(a)\n    return a\n"),
        2,
    ),
    "host-sync-outside-scope": (
        "no-host-sync-in-traced", "no-host-sync-in-traced",
        ("eventgrad_tpu_torch/utils/seeded.py",
         "def f(x):\n    return x.sum().item()\n"),
        ("eventgrad_tpu/utils/seeded.py",
         "def f(x):\n    return x.sum().block_until_ready()\n"),
        0,
    ),
    "kernel-op": (
        "kernel-registered", "pallas-kernel-registered",
        ("eventgrad_tpu_torch/ops/seeded.py",
         "import torch\n\n"
         "@torch.library.custom_op('eg::rogue', mutates_args=())\n"
         "def rogue(x: torch.Tensor) -> torch.Tensor:\n"
         "    return x * 3.0\n"),
        ("eventgrad_tpu/ops/seeded.py",
         "from jax.experimental import pallas as pl\n\n"
         "def _rogue_kernel(x_ref, o_ref):\n"
         "    o_ref[...] = x_ref[...] * 3.0\n\n"
         "def rogue(x):\n"
         "    return pl.pallas_call(_rogue_kernel, out_shape=x)(x)\n"),
        1,
    ),
    "kernel-launch": (
        "kernel-registered", "pallas-kernel-registered",
        ("eventgrad_tpu_torch/ops/seeded.py",
         "def rogue(lib, x, o):\n"
         "    lib.eg_rogue(x.data_ptr(), o.data_ptr(), x.numel(), None)\n"),
        ("eventgrad_tpu/ops/seeded.py",
         "from jax.experimental import pallas as pl\n\n"
         "def rogue(x):\n"
         "    return pl.pallas_call(_rogue_kernel, out_shape=x)(x)\n"),
        1,
    ),
    "kernel-registered-elsewhere": (
        "kernel-registered", "pallas-kernel-registered",
        ("eventgrad_tpu_torch/ops/seeded.py",
         "import torch\n\n"
         "@torch.library.custom_op('eg::masked_wire', mutates_args=())\n"
         "def again(x: torch.Tensor) -> torch.Tensor:\n"
         "    return x\n"),
        ("eventgrad_tpu/ops/seeded.py",
         "from jax.experimental import pallas as pl\n\n"
         "def again(x):\n"
         "    return pl.pallas_call(_mask_kernel, out_shape=x)(x)\n"),
        1,
    ),
    "trigger-policy": (
        "trigger-policy-registered", "trigger-policy-registered",
        ("eventgrad_tpu_torch/train/seeded.py",
         "def f(train):\n"
         "    return train(trigger_policy='nope'), train(trigger_policy="
         "'micro')\n"),
        ("eventgrad_tpu/train/seeded.py",
         "def f(train):\n"
         "    return train(trigger_policy='nope'), train(trigger_policy="
         "'micro')\n"),
        1,
    ),
    "trigger-policy-cli": (
        "trigger-policy-registered", "trigger-policy-registered",
        ("eventgrad_tpu_torch/seeded_cli.py",
         "def parser(p):\n"
         "    p.add_argument('--trigger-policy',\n"
         "                   choices=['norm_delta', 'topk', 'nope'])\n"),
        ("eventgrad_tpu/seeded_cli.py",
         "def parser(p):\n"
         "    p.add_argument('--trigger-policy',\n"
         "                   choices=['norm_delta', 'topk', 'nope'])\n"),
        3,
    ),
    "carrier-dtype": (
        "carrier-dtype-declared", "carrier-dtype-declared",
        ("eventgrad_tpu_torch/train/seeded.py",
         "import torch\n\n"
         "def f(state, bufs):\n"
         "    return state.replace(bufs=tuple(b.to(torch.int8) "
         "for b in bufs))\n"),
        ("eventgrad_tpu/train/seeded.py",
         "import jax.numpy as jnp\n\n"
         "def f(state, bufs):\n"
         "    return state.replace(bufs=tuple(b.astype(jnp.int8) "
         "for b in bufs))\n"),
        1,
    ),
    "wall-clock": (
        "wall-clock-confined", "wall-clock-confined",
        ("eventgrad_tpu_torch/train/seeded.py",
         "import time as clock\nfrom time import perf_counter\n\n"
         "def f():\n    return clock.perf_counter(), clock.sleep(0)\n"),
        ("eventgrad_tpu/train/seeded.py",
         "import time as clock\nfrom time import perf_counter\n\n"
         "def f():\n    return clock.perf_counter(), clock.sleep(0)\n"),
        2,
    ),
    "wall-clock-in-obs": (
        "wall-clock-confined", "wall-clock-confined",
        ("eventgrad_tpu_torch/obs/seeded.py",
         "import time\n\ndef f():\n    return time.perf_counter()\n"),
        ("eventgrad_tpu/obs/seeded.py",
         "import time\n\ndef f():\n    return time.perf_counter()\n"),
        0,
    ),
    "ledger-mutation": (
        "telemetry-counter-ledgered", "telemetry-counter-ledgered",
        ("eventgrad_tpu_torch/train/seeded.py",
         "def f(tel, i, v, g):\n"
         "    tel.ledger.counts += 1\n"
         "    tel.ledger.queue.index_add_(0, i, v)\n"
         "    tel.ledger.late_queue[0] += 2\n"
         "    tel.fire_count += 1\n"
         "    return g(ledger=tel.ledger), g(ledger=tel.ledger + 1)\n"),
        ("eventgrad_tpu/train/seeded.py",
         "def f(tel, i, v, g):\n"
         "    a = tel.ledger.counts.at[0].add(1)\n"
         "    b = tel.ledger.queue.at[i].add(v)\n"
         "    c = tel.ledger.late_queue.at[0].add(2)\n"
         "    d = tel.fire_count + 1\n"
         "    return g(ledger=tel.ledger), g(ledger=tel.ledger + 1)\n"),
        4,
    ),
    "process-group-marker": (
        "process-group-marker", "shard-map-marker",
        ("tests/test_torch_seeded.py",
         "from _torch_dist import start\n\n"
         "def test_group(tmp_path):\n"
         "    start('_w:f', 2, str(tmp_path / 's'))\n"),
        ("tests/test_seeded.py",
         f"from jax import {SHARD_MAP}\n\n"
         f"def test_mesh():\n    {SHARD_MAP}(None)\n"),
        1,
    ),
    "process-group-respell": (
        "process-group-respell", "shard-map-respell",
        ("tests/test_torch_seeded.py",
         "import pytest\nimport torch.distributed as dist\n\n"
         "mark = pytest.mark.skipif(not dist.is_gloo_available(), "
         "reason='no gloo')\n"),
        ("tests/test_seeded.py",
         "import jax\nimport pytest\n\n"
         f"mark = pytest.mark.skipif(not hasattr(jax, '{SHARD_MAP}'), "
         f"reason='no {SHARD_MAP}')\n"),
        1,
    ),
}


def _source(tmp_path, rel, text, module):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return module.SourceFile(path=str(path), rel=rel, text=text)


def test_port_sources_lint_clean():
    assert lint.run() == []
    assert [r.name for r in lint.RULES] == [
        "no-host-sync-in-traced", "kernel-registered",
        "trigger-policy-registered", "carrier-dtype-declared",
        "exit-code-literals", "os-exit-confined", "crashpoint-instrumented",
        "wall-clock-confined", "telemetry-counter-ledgered",
        "process-group-marker", "process-group-respell",
        "process-group-exempt-honest"]


@pytest.mark.parametrize("seed", list(SEEDS))
def test_rule_fires_like_its_jax_twin(seed, tmp_path):
    rule, jax_rule, (rel, text), (jrel, jtext), want = SEEDS[seed]
    port = lint.run([RULES[rule]],
                    files=[_source(tmp_path / "port", rel, text, lint)])
    jax_v = jax_lint.run([JAX_RULES[jax_rule]],
                         files=[_source(tmp_path / "jax", jrel, jtext,
                                        jax_lint)])
    assert len(port) == len(jax_v) == want, (port, jax_v)
    assert all(v.rule == rule and v.path == rel for v in port)


def _package_files(drop=None, replace=None):
    """The port's sources, with one file's text edited."""
    files = lint.collect_sources()
    out = []
    for sf in files:
        if sf.rel == drop:
            text = sf.text.replace(*replace)
            assert text != sf.text
            sf = lint.SourceFile(path=sf.path, rel=sf.rel, text=text)
        out.append(sf)
    return out


def test_stale_registry_entry_flags_like_its_jax_twin():
    """A registry entry whose module no longer defines its op has gone
    stale, as a JAX entry whose module no longer calls its kernel."""
    port = lint.run([RULES["kernel-registered"]], files=_package_files(
        "eventgrad_tpu_torch/ops/fused_update.py",
        ('custom_op("eg::fused_mix_sgd"', 'custom_op("eg::renamed"')))
    # the renamed op is unregistered, and the entry stale
    assert sorted(v.message.split(" —")[0] for v in port) == [
        "kernel op 'eg::renamed' has no declared rank layout",
        "registered kernel 'eg::fused_mix_sgd' is not defined in "
        "eventgrad_tpu_torch/ops/fused_update.py",
    ]
    jfiles = [
        jax_lint.SourceFile(path=sf.path, rel=sf.rel,
                            text=sf.text.replace("partial(_kernel,",
                                                 "partial(_renamed,")
                            if sf.rel == "eventgrad_tpu/ops/fused_update.py"
                            else sf.text)
        for sf in jax_lint.collect_sources(subdirs=("eventgrad_tpu",))
    ]
    jax_v = jax_lint.run([JAX_RULES["pallas-kernel-registered"]],
                         files=jfiles)
    assert len(jax_v) == len(port) == 2, jax_v


def test_process_group_exemption_stays_honest(monkeypatch, tmp_path):
    """An exempt test file must still exist and still start a process
    group, as a JAX exempt file must still touch the transform: a missing
    file and one that starts no group flag twice in both lints."""
    rule = RULES["process-group-exempt-honest"]
    # the shipped list is empty, and the port's tests lint clean
    assert rule.EXEMPT == lint.DIST_EXEMPT == frozenset()
    assert lint.run([rule]) == []
    monkeypatch.setattr(rule, "EXEMPT", frozenset(
        {"test_torch_gone.py", "test_torch_seeded.py"}))
    port = lint.run([rule], files=[_source(
        tmp_path / "port", "tests/test_torch_seeded.py",
        "def test_nothing():\n    pass\n", lint)])
    monkeypatch.setattr(jax_lint, "SEED_EXEMPT", frozenset(
        {"test_gone.py", "test_seeded.py"}))
    jax_v = jax_lint.run([JAX_RULES["shard-map-exempt-honest"]], files=[
        _source(tmp_path / "jax", "tests/test_seeded.py",
                "def test_nothing():\n    pass\n", jax_lint)])
    assert len(port) == len(jax_v) == 2, (port, jax_v)


def test_leak_exemption_stays_honest(monkeypatch):
    """The auditor's seeded kernel is exempt only while it is what the
    exemption says: an unregistered op with an unregistered launch."""
    audit_rel = "eventgrad_tpu_torch/analysis/audit.py"
    rule = RULES["kernel-registered"]
    assert audit_rel in rule.EXEMPT
    # without the fixture's op the exemption has gone stale
    stale = lint.run([rule], files=_package_files(
        audit_rel, ('custom_op("eg::leak_kernel"', 'custom_op(None')))
    assert [v.path for v in stale] == [audit_rel]
    assert "no longer defines and launches" in stale[0].message
    # registering the fixture would let the oracle pass it
    monkeypatch.setitem(kernels.REGISTRY, "leak_kernel", kernels.KernelSig(
        "leak_kernel", audit_rel, "eg_leak_x2"))
    registered = lint.run([rule])
    assert any("is registered" in v.message for v in registered)
    # the JAX rule's exemption flags the same way when its seed is gone
    jfiles = [
        jax_lint.SourceFile(path=sf.path, rel=sf.rel,
                            text=sf.text.replace("pl.pallas_call(\n"
                                                 "            _leak_kernel",
                                                 "pl.pallas_kall(\n"
                                                 "            _leak_kernel")
                            if sf.rel == "eventgrad_tpu/analysis/audit.py"
                            else sf.text)
        for sf in jax_lint.collect_sources(subdirs=("eventgrad_tpu",))
    ]
    jax_v = jax_lint.run([JAX_RULES["pallas-kernel-registered"]],
                         files=jfiles)
    assert [v.path for v in jax_v] == ["eventgrad_tpu/analysis/audit.py"]


def test_wall_clock_exemption_stays_honest():
    """An exempt file that no longer reads the clock flags as stale, as
    the JAX rule's exemption does."""
    rel = "eventgrad_tpu_torch/utils/realdata.py"
    rule = RULES["wall-clock-confined"]
    assert rel in rule.EXEMPT
    stale = lint.run([rule], files=_package_files(
        rel, ("time.perf_counter()", "0.0")))
    assert [v.path for v in stale] == [rel]
    assert "no longer reads the wall clock" in stale[0].message
    jrel = "eventgrad_tpu/chaos/membership.py"
    jfiles = [
        jax_lint.SourceFile(path=sf.path, rel=sf.rel,
                            text=sf.text.replace("time.perf_counter()", "0.0")
                            if sf.rel == jrel else sf.text)
        for sf in jax_lint.collect_sources(subdirs=("eventgrad_tpu",))
    ]
    jax_v = jax_lint.run([JAX_RULES["wall-clock-confined"]], files=jfiles)
    assert [v.path for v in jax_v] == [jrel]


def test_ledger_helper_must_still_add_the_counters():
    """A `ledger_update` that no longer adds to the counters leaves the
    rule covering nothing: the owner flags."""
    owner = "eventgrad_tpu_torch/obs/ledger.py"
    stale = lint.run([RULES["telemetry-counter-ledgered"]],
                     files=_package_files(
                         owner, ("counts = counts + inc", "counts = inc")))
    assert [v.path for v in stale] == [owner]
    assert "no longer adds" in stale[0].message


def test_host_library_exemption_stays_honest():
    """The data library's `eg_` entries pass the kernel rule, but a
    registered kernel's entry called there flags, and so does the
    exemption once the file no longer calls its library."""
    rel = "eventgrad_tpu_torch/data/native.py"
    rule = RULES["kernel-registered"]
    assert rule.HOST_LIBRARIES.keys() == {rel}
    assert lint.run([rule]) == []
    files = _package_files(rel, ("lib.eg_version.restype",
                                 "lib.eg_masked_wire.restype"))
    got = lint.run([rule], files=files)
    assert [v.message.split(" —")[0] for v in got] == [
        "kernel launch 'eg_masked_wire' is registered for "
        "eventgrad_tpu_torch/ops/event_engine.py, launched from "
        "eventgrad_tpu_torch/data/native.py"]
    files = [lint.SourceFile(path=sf.path, rel=sf.rel,
                             text=sf.text.replace("lib.eg_", "lib.dataio_"))
             if sf.rel == rel else sf for sf in lint.collect_sources()]
    got = lint.run([rule], files=files)
    assert len(got) == 1 and "no longer calls its library" in got[0].message
