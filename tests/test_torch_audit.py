"""The port's trace auditor against the JAX package's, on the CPU.

The JAX auditor itself cannot run in this environment (the installed
jax has no `jax.core.Literal`, which its rank-flow analysis reads), so
the port is held to three things instead:
  * the JAX package's committed audit record, `artifacts/audit_cpu.json`:
    every ported cell's per-neighbour bytes derived from its traced
    exchange lanes and its executed `sent_bytes_wire_real`, exactly, and
    every oracle's key phrase;
  * for eight cells covering each algorithm, wire dtype, gossip wire,
    trigger policy and the carrier, the live JAX functions: the accounting
    formula (`audit._formula_bytes_per_neighbor`) and the metric of the
    JAX step run on the same cell (built once per module);
  * for TPU kernel 9 (the auditor's seeded `_leak_kernel`), the same
    `pallas_call` body run in JAX's interpret mode, bitwise.
The tolerance is exact throughout; the metric is a float32 scalar, so
the derived total is compared after the same quantization (JAX
audit.py:669-676). The ResNet18 and transformer cells are held to the
record only, so no JAX ResNet is built here.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.analysis import audit as jax_audit
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu_torch.analysis import audit, kernels, rankflow, walker

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECORD = json.loads((ROOT / "artifacts" / "audit_cpu.json").read_text())
RECORD_CELLS = {c["name"]: c for c in RECORD["configs"]}
RECORD_ORACLES = {o["name"]: o for o in RECORD["oracles"]}
CELLS = [c.name for c in audit.CONFIGS]

#: cells also held to the live JAX formula and step: dpsgd, eventgrad and
#: sp_eventgrad; f32, bf16 and int8 wires; dense and compact; the
#: norm_delta, micro and hybrid policies (and sp's top-k); the carrier
LIVE_JAX = (
    "dpsgd_int8_arena", "event_masked_f32_tree", "event_masked_bf16_arena",
    "event_compact_int8_arena_obs", "sp_f32_tree",
    "event_masked_int8_arena_carrier", "event_micro_compact_f32_arena",
    "event_hybrid_masked_f32_arena_obs",
)

#: a phrase of each JAX oracle's recorded reason that the port's reason
#: must carry too
ORACLE_PHRASES = {
    "rank_coupling_ppermute": "undeclared exchange offsets [2]",
    "rank_coupling_roll": "slice selects a subset of ranks (cross-rank read)",
    "wire_dtype_upcast": "missing expected lane 1210 elems of bfloat16",
    "extra_full_ravel": "2 full-model ravels > budget 1",
    "byte_formula_drift": "metric 9680.0 != derived wire truth",
    "host_callback": "host callbacks",
    "conv_rank_merge": "conv contracts the rank axis across feature groups",
    "unregistered_kernel": "an opaque kernel is legal only with a declared "
                           "rank-dim signature",
    "attention_cross_rank_gather": "sort along the rank axis",
    "partition_overlap": "partitions_ok=False (sizes [16, 1024, 10, 160])",
    "stale_scale_reuse": "clean carrier cell == f32-resident twin bitwise; "
                         "the scale-reuse commit diverges",
    "late_delivery_drift": "clean D=2 == D=1 bitwise",
    "bucket_queue_skew": "skewing one bucket's queue against its clock "
                         "diverges",
    "bucket_undeclared_offset": "undeclared exchange offsets [2]",
}


@functools.lru_cache(maxsize=None)
def _port(name):
    return audit.audit_config(audit.config_by_name(name), device="cpu")


@pytest.fixture(scope="module")
def jax_cells():
    """{cell: (formula bytes per neighbour, executed metric)} of the live
    JAX cells, each built and stepped once."""
    out = {}
    for name in LIVE_JAX:
        cfg = jax_audit.config_by_name(name)
        state, step, topo = jax_audit.build(cfg)
        n_params, n_leaves, k_total = jax_audit._meta(state)
        formula = jax_audit._formula_bytes_per_neighbor(
            cfg, n_params, n_leaves, k_total, None,
            jax_audit.resolved_capacity(cfg, state))
        _, m = spmd(step, topo)(state, jax_audit._batch(cfg))
        out[name] = (float(formula),
                     float(np.asarray(m["sent_bytes_wire_real"])[0]))
    return out


def test_leak_kernel_is_the_pallas_body_bitwise():
    """Kernel 9's plain version (the CPU implementation of
    `eg::leak_kernel`) against `o_ref[...] = x_ref[...] * 2.0` on an
    (8, 128) float32 block in interpret mode. The JAX fixture is a
    closure inside `oracle_unregistered_kernel` that no caller can reach
    on its own, so the call is rebuilt here as audit.py:1201-1212 makes
    it."""
    from jax.experimental import pallas as pl

    x = np.random.default_rng(9).standard_normal((8, 128)).astype(np.float32)

    def _leak_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    want = pl.pallas_call(
        _leak_kernel,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(x))
    got = audit.leak_kernel(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert torch.equal(got, audit.leak_reference(torch.from_numpy(x)))


def test_leak_kernel_is_an_unregistered_op():
    """The fixture traces as one `eg::leak_kernel` node, stays out of the
    registry, and the analysis refuses it even on a rank-free value."""
    x = torch.ones((8, 128))
    tr = walker.trace(lambda t: audit.leak_kernel(t) + 1.0, x)
    assert walker.count_ops(tr.graph, "eg::leak_kernel") == 1
    assert torch.equal(tr.out, x * 2.0 + 1.0)
    assert kernels.lookup("eg::leak_kernel") is None
    rep = rankflow.analyze(tr.graph, 4, stacked=[False])
    assert [f.reason.split(" —")[0] for f in rep.violations] == [
        "unregistered kernel 'eg::leak_kernel'"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_audits_clean_with_exact_bytes(name, jax_cells):
    """Each ported cell: clean (rank isolation, declared offsets, the
    expected lanes at the wire dtype, no host sync, ravel budget 1), and
    its bytes per neighbour derived from the traced lanes equal the
    port's formula, the JAX record's derived bytes and the metric of the
    traced run, exactly."""
    rep = _port(name)
    want = RECORD_CELLS[name]
    assert audit.clean(rep), {k: rep[k] for k in (
        "violation_details", "wire_problems", "undeclared_offsets",
        "missing_offsets", "metric_match", "ravel_count", "callbacks")}
    assert rep["ravel_budget"] == want["ravel_budget"] == 1
    assert rep["exchange_offsets"] == want["exchange_offsets"] == [-1, 1]
    assert (rep["n_params"], rep["n_leaves"]) == (want["n_params"],
                                                  want["n_leaves"])
    assert rep["capacity"] == want["capacity"]
    derived = rep["wire_bytes_per_neighbor_derived"]
    assert derived == rep["wire_bytes_per_neighbor_formula"]
    assert derived == want["wire_bytes_per_neighbor_derived"]
    assert rep["wire_metric_total"] == want["wire_metric_total"]
    assert rep["wire_metric_total"] == float(np.float32(2 * derived))
    assert rep["donation_ok"] is None
    if name in LIVE_JAX:
        formula, metric = jax_cells[name]
        assert formula == derived
        assert metric == rep["wire_metric_total"]


OBS_CELLS = [c.name for c in audit.CONFIGS if c.obs]


@pytest.mark.parametrize("name", OBS_CELLS)
def test_obs_cells_trace_the_telemetry(name):
    """The three `_obs` cells run their step with the telemetry and the
    message ledger on (no substitution), audit clean with exact bytes
    (`test_cell_audits_clean_with_exact_bytes`), and the traced step
    books one pass: every rank's census reached it through the exchange,
    so the ledger's receiver law holds on the one-pass window."""
    from eventgrad_tpu_torch.obs import ledger as obs_ledger

    assert len(OBS_CELLS) == 3
    rep = _port(name)
    assert rep["obs"] and rep["substitutions"] == []
    assert audit.clean(rep)
    cfg = audit.config_by_name(name)
    state, step, topo, _ = audit.build(cfg, "cpu")
    assert state.telemetry is not None
    new, _ = step(state, audit._batch(cfg, "cpu"))
    tel = new.telemetry
    assert tel.steps.tolist() == [1] * topo.n_ranks
    assert int(tel.ledger.counts.sum()) > 0
    verdict = obs_ledger.audit_window(tel.ledger, None, topo)
    assert verdict["ok"], verdict["violations"]


def test_traced_steps_show_the_kernel_ops():
    """On the CPU the kernels' plain versions run inside `eg::` ops, so
    the traced step carries one node per kernel: the masked EventGraD
    step its wire and commit, the flash transformer one forward, one dQ
    and one dK/dV per layer (the audit geometry has one), the carrier
    step the int8 wire and the carrier commit, D-PSGD the mix."""
    assert _port("event_masked_f32_tree")["kernel_ops"] == {
        "masked_wire": 1, "fused_mix_commit": 1}
    assert _port("xfmr_flash_masked_f32_tree")["kernel_ops"] == {
        "masked_wire": 1, "fused_mix_commit": 1, "flash_fwd": 1,
        "flash_dq": 1, "flash_dkv": 1}
    assert _port("event_masked_int8_arena_carrier")["kernel_ops"] == {
        "masked_wire_int8": 1, "fused_mix_commit_carrier": 1}
    assert _port("dpsgd_f32_tree")["kernel_ops"] == {"fused_mix_sgd": 1}
    # the plain versions count no launches
    assert _port("event_masked_f32_tree")["kernel_launches"] == {}


def test_audit_counts_a_gated_launch_once():
    """A gated launch counts in its kernel and again under
    `<kernel>_gated` in `ops.launch_counts()`; the audit matches launches
    to traced ops by kernel name, so it reads that launch once."""
    from eventgrad_tpu_torch import ops

    ops.reset_launch_counts()
    fn = ops._wrappers()["fused_mix_commit"]
    fn.launches += 1
    fn.gated_launches += 1
    try:
        assert ops.launch_counts()["fused_mix_commit_gated"] == 1
        got = audit._kernel_launches()
        assert got["fused_mix_commit"] == 1
        assert set(got) - {"leak_kernel"} <= set(kernels.registered_names())
    finally:
        ops.reset_launch_counts()


@pytest.mark.parametrize("name", list(audit.ORACLES))
def test_oracle_detected(name):
    """Each seeded violation is detected, with the key phrase of the JAX
    record's reason for the same oracle."""
    detected, reason = audit.oracle(name)(device="cpu")
    assert detected, reason
    assert RECORD_ORACLES[name]["detected"]
    phrase = ORACLE_PHRASES[name]
    assert phrase in RECORD_ORACLES[name]["reason"]
    assert phrase in reason, reason
    if name == "unregistered_kernel":
        assert "unregistered kernel 'eg::leak_kernel'" in reason


def test_mesh_oracle_detected_and_lift_clean():
    """The device-mesh lift's oracle (the JAX auditor's MESH_ORACLES): an
    undeclared +2 shift in the mesh step's metrics is detected in the
    lift's record of its shifts, with the JAX oracle's phrase, while the
    clean cells' lifted steps shift by the ring's offsets alone. With it
    the auditor runs 15 oracles."""
    detected, reason = audit.oracle("mesh_undeclared_offset")(device="cpu")
    assert detected and "undeclared mesh exchange offsets [2]" in reason
    for cell in ("event_masked_f32_arena_obs", "event_compact_int8_arena_b4",
                 "dpsgd_int8_arena"):
        rep = audit.mesh_lift_report(cell, device="cpu")
        assert rep["offsets_ok"], rep
        assert rep["exchange_offsets"] == [("ring", -1), ("ring", 1)]
    assert len(audit.ORACLES) + len(audit.MESH_ORACLES) == 15


def _stacked(fn, *args):
    tr = walker.trace(fn, *args)
    return rankflow.analyze(tr.graph, 4)


def test_rankflow_refuses_what_it_has_no_rule_for():
    """An op without a transfer rule is a violation, never a pass."""
    rep = _stacked(lambda x: torch.linalg.det(x), torch.eye(3).expand(4, 3, 3))
    assert len(rep.violations) == 1
    assert rep.violations[0].reason.startswith(
        "no rank-flow rule for aten::")


def test_rankflow_tracks_merged_ranks():
    """A rank-major merge (the ranks folded into a batch) and its split
    back are legal, and so are per-rank pieces cut from inside one rank's
    block and reassembled in rank order (the port's multi-tensor absmax);
    pieces reassembled out of order are a cross-rank read."""
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)

    def ok(x):
        folded = x.reshape(-1)  # [R * 6], rank-major
        pieces = folded.split([2, 4] * 4)
        maxes = torch._foreach_norm(pieces, float("inf"))
        return torch.stack(maxes).reshape(4, 2) + folded.reshape(4, 6)[:, :2]

    assert _stacked(ok, x).violations == []

    def bad(x):
        pieces = x.reshape(-1).split([6] * 4)
        return torch.stack([p.sum() for p in pieces[::-1]])

    assert [f.reason for f in _stacked(bad, x).violations] == [
        "stack reassembles ranks out of order (cross-rank read)"]


def test_rankflow_classifies_rolls_by_offset():
    """Rolls of the rank dimension are the exchanges, by ring offset
    (`collectives.recv_from`: a roll by -offset); a roll of another
    dimension is rank-local."""
    x = torch.ones((4, 5))
    rep = _stacked(lambda x: (torch.roll(x, 1, 0), torch.roll(x, -1, 0),
                              torch.roll(x, 2, 1)), x)
    assert rep.violations == []
    assert sorted((e.offset, e.lane_elems, e.dtype)
                  for e in rep.exchanges) == [(-1, 5, "float32"),
                                              (1, 5, "float32")]


def _jax_torus_exchanges(shape):
    """The JAX package's rank-flow analysis over its EventGraD step on a
    torus (the audit's MLP, masked f32 wire, arena), read one named vmap
    axis at a time: the step lifted by nested `vmap`s over `(nx, ny,
    ...)` arguments and analysed with that axis as the rank axis, so its
    ring gathers are that axis's exchanges. Two shims let the JAX
    auditor run on the installed jax (its rank-flow module reads
    `jax.core.Literal`, now under `jax.extend.core`, and names nested
    jits `pjit`, now `jit`): both only rename. Returns (violations,
    sorted (axis, offset, elements per rank, dtype))."""
    import jax.extend
    import optax
    from eventgrad_tpu.analysis import rankflow as jax_rankflow
    from eventgrad_tpu.models import MLP as JaxMLP
    from eventgrad_tpu.parallel.topology import Torus as JaxTorus
    from eventgrad_tpu.train.state import init_train_state as jax_init
    from eventgrad_tpu.train.steps import make_train_step as jax_step

    topo = JaxTorus(*shape)
    model, tx = JaxMLP(**jax_audit.MODEL), optax.sgd(0.05)
    state = jax_init(model, jax_audit.IN_SHAPE, tx, topo, "eventgrad",
                     jax_audit.CFG, seed=0, arena=True)
    step = jax_step(model, tx, topo, "eventgrad", event_cfg=jax_audit.CFG,
                    arena=True)
    n = topo.n_ranks
    x = jnp.zeros((n, jax_audit.PER_RANK) + tuple(jax_audit.IN_SHAPE))
    y = jnp.zeros((n, jax_audit.PER_RANK), jnp.int32)
    inner = step
    for ax in reversed(topo.axes):
        inner = jax.vmap(inner, axis_name=ax)
    grid = lambda t: jax.tree.map(
        lambda a: a.reshape(tuple(shape) + a.shape[1:]), t)
    closed = jax.make_jaxpr(inner)(grid(state), grid((x, y)))
    orig_apply, orig_lit = jax_rankflow._Flow._apply, getattr(
        jax.core, "Literal", None)

    def _apply(self, eqn, abs_in, path):
        if eqn.primitive.name == "jit":
            return self.run(eqn.params["jaxpr"], abs_in,
                            path + (eqn.params.get("name") or "jit",))
        return orig_apply(self, eqn, abs_in, path)

    jax_rankflow._Flow._apply = _apply
    jax.core.Literal = jax.extend.core.Literal
    try:
        violations, out = [], []
        for k, _ in enumerate(shape):
            in_axes = [k if tuple(v.aval.shape)[:len(shape)] == tuple(shape)
                       else None for v in closed.jaxpr.invars]
            rep = jax_rankflow.analyze(closed, shape[k], in_axes)
            violations += [v.reason for v in rep.violations + rep.psums]
            others = n // shape[k]
            out += [(k, e.offset, e.lane_elems // others, e.dtype)
                    for e in rep.exchanges]
    finally:
        jax_rankflow._Flow._apply = orig_apply
        if orig_lit is None:
            del jax.core.Literal
        else:
            jax.core.Literal = orig_lit
    return violations, sorted(out)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_rankflow_reads_the_torus_step(shape):
    """The port's EventGraD step on a torus (the audit's MLP) analyses
    with no violation: `collectives.recv_from` reshapes the rank
    dimension into the `(nx, ny)` grid, rolls one grid dimension and
    reshapes back, and each roll is an exchange of its axis. The
    exchanges — count, axis, offset, elements per rank and dtype — are
    the JAX rank-flow's over the JAX torus step, and the bytes per
    neighbour from the traced lanes are the step's own wire-real
    metric's share, exactly."""
    from eventgrad_tpu_torch.models import MLP as PortMLP
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.parallel.topology import Torus
    from eventgrad_tpu_torch.train.state import init_train_state
    from eventgrad_tpu_torch.train.steps import make_train_step

    topo = Torus(*shape)
    model = PortMLP(input_shape=audit.IN_SHAPE, **audit.MODEL)
    state = init_train_state(model, audit.IN_SHAPE, topo, "eventgrad",
                             audit.CFG, seed=0, device="cpu")
    step = make_train_step(model, topo, "eventgrad", audit.CFG,
                           fused_sgd=audit.SGD)
    n = topo.n_ranks
    x = torch.zeros((n, audit.PER_RANK) + audit.IN_SHAPE)
    y = torch.zeros((n, audit.PER_RANK), dtype=torch.long)
    tr = walker.trace(step, state, (x, y))
    rep = rankflow.analyze(tr.graph, n, grid=topo.shape)
    assert [f.reason for f in rep.violations] == []
    got = sorted((e.axis, e.offset, e.lane_elems, e.dtype)
                 for e in rep.exchanges)
    jax_violations, want = _jax_torus_exchanges(shape)
    assert jax_violations == []
    assert got == want
    assert len(got) == 2 * topo.n_neighbors  # payload + fire bits an edge
    itemsize = {"float32": 4, "bool": 1}
    total = sum(e[2] * itemsize[e[3]] for e in got)
    metric = float(tr.out[1]["sent_bytes_wire_real"][0])
    assert float(np.float32(total)) == metric
    spec = arena_spec(model)
    assert total / topo.n_neighbors == 4 * spec.n_total + spec.n_leaves


def test_rankflow_grid_moves_stay_violations():
    """On the rank grid only reshapes, rolls and pointwise ops pass: a
    slice of some grid positions and a reduction over a grid dimension
    are cross-rank reads, and so is a reshape that splits the grid."""
    x = torch.ones((4, 5))

    def analyze(fn):
        tr = walker.trace(fn, x)
        return [f.reason for f in rankflow.analyze(
            tr.graph, 4, grid=(2, 2)).violations]

    assert analyze(lambda x: torch.roll(
        x.reshape(2, 2, 5) * 2, 1, 1).reshape(4, 5)) == []
    assert analyze(lambda x: x.reshape(2, 2, 5)[:1].sum()) == [
        "aten::slice on the rank grid (only reshapes, rolls and pointwise "
        "ops keep it)"]
    assert analyze(lambda x: x.reshape(2, 2, 5).sum(dim=0)) == [
        "aten::sum on the rank grid (only reshapes, rolls and pointwise "
        "ops keep it)"]
    assert analyze(lambda x: x.reshape(2, 2, 5).reshape(2, 10)) == [
        "reshape splits the rank grid across dimensions"]
