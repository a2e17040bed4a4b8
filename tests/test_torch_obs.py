"""The port's telemetry (`eventgrad_tpu_torch/obs/`) against the JAX
package's.

  * every table of `obs/schema.py` equals the JAX table, key for key;
  * `silence_bucket` is bitwise JAX's for every s in 0..2^20, as float32
    and as int32;
  * `accumulate` on numpy-made inputs (vmapped on the JAX side) gives
    JAX's counters pass after pass: the integers exactly, the float32
    sums bitwise (elementwise adds in the same order); `window_record`
    of the same two snapshots is JAX's dict;
  * the step with `obs=True` from the carried JAX state (MLP, Ring(4),
    float32; EventGraD masked f32, compact, D = 2 under chaos and
    integrity, D-PSGD under drops), three passes, each from the JAX
    state of the pass before: first the fire vectors (the fire-count
    deltas) are equal, then every integer counter and the ledger exactly,
    the wire bytes bitwise, `thres_sum` / `drift_sum` within rtol=1e-5,
    atol=1e-6: the leaf norms reduce in another order, and the drift is a
    difference of two norms;
  * the loop: obs off and on give bitwise-identical trajectories, the
    per-leaf oracle (fire counts x neighbours = num_events), "block" and
    "epoch" give the same records, a resume continues the counters (and
    a snapshot without telemetry resumes with zeroed ones), the compact
    wire's deferrals are `num_deferred`;
  * the host side: the registry's spans nest under `train`, the Chrome
    trace loads, the Prometheus text and trace are JAX's for the same
    calls (timestamps aside); `JsonlLogger` writes non-finite values as
    valid JSON; `steady_records`, `collapse_verdict` and
    `msgs_saved_pct_per_leaf` equal JAX's; `build_report` on a JAX run's
    history equals JAX's report; `decompose` on the same spans equals
    JAX's, truncated-trace warning included.
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.chaos import integrity as jax_integrity
from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.data.sharding import batched_epoch
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.obs import bubble as jax_bubble
from eventgrad_tpu.obs import device as jax_device
from eventgrad_tpu.obs import registry as jax_registry
from eventgrad_tpu.obs import report as jax_report
from eventgrad_tpu.obs import schema as jax_schema
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.loop import train as jax_train
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu.utils import metrics as jax_metrics
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos import monitor
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.obs import OBS_SCHEMA_VERSION, Registry
from eventgrad_tpu_torch.obs import bubble, device, report, schema
from eventgrad_tpu_torch.parallel import events
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import TrainState
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils import metrics
from eventgrad_tpu_torch.utils import obs_report

R, L, E, K, D = 4, 6, 2, 3, 2
IN_SHAPE, PER_RANK, LR, HIDDEN, STEPS = (8, 8, 1), 8, 0.05, 8, 3
CFG = dict(adaptive=True, horizon=0.9, warmup_passes=1, max_silence=4)
#: the float telemetry of the carried steps: the leaf norms reduce in
#: another order than JAX's, and the drift is a difference of two norms
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)


# --- the schema -------------------------------------------------------------

TABLES = ("OBS_SCHEMA_VERSION", "SILENCE_BUCKETS", "PROM_PREFIX",
          "DISPOSITIONS", "LEDGER_COUNTER_ROWS", "TELEMETRY_FIELDS",
          "RECORD_FIELDS", "RECORD_META_FIELDS", "MEMBERSHIP_FIELDS",
          "INTEGRITY_FIELDS", "PREEMPTION_FIELDS", "PERF_FIELDS",
          "LEDGER_FIELDS", "PROM_EXPORTED", "PROM_EXCLUDED",
          "REPORT_FIELDS")


@pytest.mark.parametrize("name", TABLES + ("all_field_names",
                                           "field_groups"))
def test_schema_table_equals_jax(name):
    mine, theirs = getattr(schema, name), getattr(jax_schema, name)
    if callable(mine):
        mine, theirs = mine(), theirs()
    assert mine == theirs
    if isinstance(mine, dict):
        assert list(mine) == list(theirs)


# --- the accumulators -------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_silence_bucket_bitwise_jax(dtype):
    s = np.arange(0, 2 ** 20 + 1).astype(dtype)
    got = device.silence_bucket(torch.from_numpy(s))
    want = np.asarray(jax_device.silence_bucket(jnp.asarray(s)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _acc_inputs(rng):
    return {
        "fire_vec": rng.random((R, L)) < 0.5,
        "defer_vec": rng.random((R, L)) < 0.2,
        "thres": rng.random((R, L)).astype(np.float32),
        "drift": rng.random((R, L)).astype(np.float32) * 1e-3,
        "silence": rng.integers(0, 70000, (R, L)).astype(np.float32),
        "fired_elems": rng.integers(0, 900, (R,)).astype(np.float32),
        "edge_bytes": rng.random((R, E)).astype(np.float32) * 1e4,
        "wire_reject": rng.random((R, E)) < 0.3,
        "quarantined": rng.random((R,)) < 0.2,
        "bucket_bytes": rng.random((R, K)).astype(np.float32) * 1e3,
        "edge_staleness": rng.integers(0, 9, (R, E)).astype(np.int32),
        "late_commits": rng.integers(0, 3, (R,)).astype(np.int32),
    }


def _jax_tel():
    return jax.vmap(lambda _: jax_device.TelemetryState.init(
        L, E, n_buckets=K, queue_depth=D))(jnp.arange(R))


def _assert_tel_bitwise(t, j, what):
    for f in dataclasses.fields(device.TelemetryState):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if f.name == "ledger":
            for g in ("counts", "queue", "late_queue"):
                np.testing.assert_array_equal(
                    getattr(tv, g).numpy(), np.asarray(getattr(jv, g)),
                    err_msg=f"{what} ledger.{g}")
            continue
        jv = np.asarray(jv)
        assert tv.numpy().dtype == jv.dtype, (what, f.name)
        np.testing.assert_array_equal(tv.numpy(), jv,
                                      err_msg=f"{what} {f.name}")


def test_accumulate_and_window_record_match_jax():
    rng = np.random.default_rng(5)
    tel = device.TelemetryState.init(L, E, K, D, n_ranks=R)
    jtel = _jax_tel()
    jacc = jax.vmap(lambda t, i: jax_device.accumulate(t, **i))
    snaps = []
    for p in range(5):
        inp = _acc_inputs(rng)
        tel = device.accumulate(
            tel, **{k: torch.from_numpy(v) for k, v in inp.items()})
        jtel = jacc(jtel, {k: jnp.asarray(v) for k, v in inp.items()})
        _assert_tel_bitwise(tel, jtel, f"pass {p + 1}")
        if p in (1, 4):
            snaps.append((tel, jax.tree.map(np.asarray, jtel)))
    (t1, j1), (t2, j2) = snaps
    assert device.window_record(t1) == jax_device.window_record(j1)
    assert device.window_record(t2, t1) == jax_device.window_record(j2, j1)
    # the flush's one-buffer read gives the same snapshot
    host = device.unpack(device.pack(t2).numpy(), t2)
    assert device.window_record(host, t1) == device.window_record(t2, t1)


# --- the step from the carried JAX state -------------------------------------


def _batches(steps, seed=3):
    x, y = jax_synthetic(R * PER_RANK * steps, IN_SHAPE, seed=seed)
    xb, yb = batched_epoch(x, y, R, PER_RANK)
    return [(np.asarray(xb[:, s]), np.asarray(yb[:, s]))
            for s in range(steps)]


STEP_CASES = {
    "masked_f32": dict(algo="eventgrad"),
    "compact": dict(algo="eventgrad", gossip_wire="compact",
                    capacity=540),
    "d2_chaos_integrity": dict(
        algo="eventgrad", staleness=2, gossip_wire="compact", capacity=540,
        chaos="seed=7,drop=0.3,bitflip=1-3@0.4,lag=0-3@2,nanstep=1@2",
        integrity="on"),
    "dpsgd": dict(algo="dpsgd", chaos="seed=5,drop=0.3"),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_telemetry_matches_jax(case):
    c = STEP_CASES[case]
    algo, staleness = c["algo"], c.get("staleness", 0)
    jtopo, topo = JaxRing(R), Ring(R)
    jmodel = JaxMLP(hidden=HIDDEN)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    spec = arena_spec(model)
    tx = optax.sgd(LR)
    ev = algo == "eventgrad"
    jcfg, cfg = jax_events.EventConfig(**CFG), events.EventConfig(**CFG)
    jstate = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, algo,
                            jcfg if ev else None, seed=0, arena=True,
                            staleness=staleness)
    jstate = jstate.replace(telemetry=stack_for_ranks(
        jax_device.TelemetryState.init(
            spec.n_leaves, 2, queue_depth=staleness if staleness >= 2
            else 0), jtopo))
    if "chaos" in c:
        jstate = jstate.replace(chaos=stack_for_ranks(
            jax_monitor.PeerHealth.init(jtopo), jtopo))
    integ = c.get("integrity")
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, algo, jcfg if ev else None, arena=True, obs=True,
        chaos=JaxChaos.parse(c["chaos"]) if "chaos" in c else None,
        gossip_wire=c.get("gossip_wire", "dense"),
        compact_capacity=c.get("capacity"), staleness=staleness,
        integrity=(jax_integrity.IntegrityConfig.parse(integ) if integ
                   else None)), jtopo))
    tstep = make_train_step(
        model, topo, algo, cfg if ev else None, fused_sgd=(LR, 0.0),
        chaos=c.get("chaos"), gossip_wire=c.get("gossip_wire", "dense"),
        compact_capacity=c.get("capacity"), integrity=integ,
        staleness=staleness, n_passes=STEPS, obs=True)
    for p, (x, y) in enumerate(_batches(STEPS), start=1):
        js = jax.tree.map(np.array, jstate)
        tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                         stacked=True)
        tstate = TrainState(
            params=spec.ravel(tp), trace=None, batch_stats=ts,
            pass_num=int(js.pass_num[0]),
            event=convert.event_state_from_jax(js.event, spec) if ev
            else None,
            chaos=None if js.chaos is None else monitor.PeerHealth(
                silence=torch.from_numpy(js.chaos.silence),
                sync_req=torch.from_numpy(js.chaos.sync_req),
                drops=torch.from_numpy(js.chaos.drops)),
            telemetry=convert.telemetry_from_jax(js.telemetry))
        jstate, _ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, _ = tstep(tstate, (torch.from_numpy(x),
                                   torch.from_numpy(y).long()))
        jt = jax.tree.map(np.asarray, jstate.telemetry)
        tt, w = tstate.telemetry, f"{case} pass {p}"
        # the fire vectors first: every other counter follows from them
        np.testing.assert_array_equal(tt.fire_count.numpy(), jt.fire_count,
                                      err_msg=w)
        for f in dataclasses.fields(device.TelemetryState):
            tv, jv = getattr(tt, f.name), getattr(jt, f.name)
            if f.name == "ledger":
                for g in ("counts", "queue", "late_queue"):
                    a, b = getattr(tv, g), getattr(jv, g)
                    assert (a is None) == (b is None), (w, g)
                    if a is not None:
                        np.testing.assert_array_equal(
                            a.numpy(), b, err_msg=f"{w} ledger.{g}")
            elif f.name in ("thres_sum", "drift_sum"):
                np.testing.assert_allclose(tv.numpy(), jv, err_msg=w,
                                           **FLOAT_TOL)
            else:
                assert tv.numpy().dtype == jv.dtype, (w, f.name)
                np.testing.assert_array_equal(tv.numpy(), jv,
                                              err_msg=f"{w} {f.name}")
    # the rows the case exercises are live (JAX's order: proposed,
    # suppressed, deferred, fired, delivered, dropped, rejected, late)
    led = tstate.telemetry.ledger.counts.sum((0, 2)).tolist()
    assert led[3] > 0 and led[4] > 0, led
    if "capacity" in c:
        assert led[2] > 0, led
    if "chaos" in c:
        assert led[5] > 0, led
    if integ:
        assert led[1] > 0 and led[6] > 0, led


# --- the loop -----------------------------------------------------------------

_KW = dict(algo="eventgrad", epochs=4, batch_size=8, learning_rate=0.1,
           event_cfg=events.EventConfig(adaptive=True, horizon=0.95,
                                        warmup_passes=3),
           seed=0, log_every_epoch=False, device="cpu")


def _data():
    return synthetic_dataset(256, (8, 8, 1), seed=1)


def _model():
    return MLP(hidden=16, input_shape=(8, 8, 1), device="cpu")


_TIMINGS = ("wall_s",)


def _core(rec):
    return {k: v for k, v in rec.items() if k not in _TIMINGS + ("obs",)}


@pytest.fixture(scope="module")
def obs_run():
    """(state, history, registry) of one `obs="block"` run with a
    registry and a test set."""
    x, y = _data()
    xt, yt = synthetic_dataset(64, (8, 8, 1), seed=1, split="test")
    reg = Registry()
    kw = dict(_KW, log_every_epoch=True)
    state, hist = train(_model(), Ring(4), x, y, obs="block", registry=reg,
                        x_test=xt, y_test=yt, **kw)
    return state, hist, reg


def test_obs_off_and_on_trajectories_bitwise_identical(obs_run):
    x, y = _data()
    xt, yt = synthetic_dataset(64, (8, 8, 1), seed=1, split="test")
    s_off, h_off = train(_model(), Ring(4), x, y, x_test=xt, y_test=yt,
                         **dict(_KW, log_every_epoch=True))
    s_on, h_on, _ = obs_run
    assert torch.equal(s_off.params, s_on.params)
    for f in ("thres", "last_sent_norm", "num_events"):
        assert torch.equal(getattr(s_off.event, f), getattr(s_on.event, f))
    for a, b in zip(s_off.event.bufs, s_on.event.bufs):
        assert torch.equal(a, b)
    # the records are the same but for `obs`, the probe and the timings
    probe = ("consensus_err_max", "consensus_err_mean")
    for r_off, r_on in zip(h_off, h_on):
        assert _core(r_off) == {k: v for k, v in _core(r_on).items()
                                if k not in probe}
    assert s_off.telemetry is None
    assert not any("obs" in h for h in h_off)


def test_obs_per_leaf_oracle_against_num_events(obs_run):
    state, hist, _ = obs_run
    obs_recs = [h["obs"] for h in hist]
    total_fires = sum(sum(o["fire_count"]) for o in obs_recs)
    assert total_fires * 2 == int(state.event.num_events.sum())
    passes = sum(o["steps"] for o in obs_recs)
    fire_total = np.sum([o["fire_count"] for o in obs_recs], axis=0)
    per_leaf = metrics.msgs_saved_pct_per_leaf(fire_total, passes, 2, 4)
    agg = metrics.msgs_saved_pct(int(total_fires) * 2, passes,
                                 len(fire_total), 2, 4)
    assert abs(np.mean(per_leaf) - agg) < 1e-9
    assert obs_recs[0]["meta"] == {
        "leaves": ["Dense_0/bias", "Dense_0/kernel", "Dense_1/bias",
                   "Dense_1/kernel"],
        "edges": ["ring_m1", "ring_p1"], "silence_buckets": 16,
        "n_ranks": 4, "n_neighbors": 2, "wire": None,
    }
    assert all("meta" not in o for o in obs_recs[1:])
    assert all("consensus_err_max" in h for h in hist)
    assert obs_recs[0]["schema"] == OBS_SCHEMA_VERSION
    assert sum(obs_recs[0]["silence_hist"]) == obs_recs[0]["steps"] * 4 * 4
    assert all(o["ledger_audit"]["ok"] for o in obs_recs)
    assert all(o["steps"] == h["steps"] for o, h in zip(obs_recs, hist))


def test_obs_block_and_epoch_give_the_same_records(obs_run):
    x, y = _data()
    xt, yt = synthetic_dataset(64, (8, 8, 1), seed=1, split="test")
    _, h_epoch = train(_model(), Ring(4), x, y, obs="epoch", x_test=xt,
                       y_test=yt, **dict(_KW, log_every_epoch=True))
    _, h_block, _ = obs_run
    assert [{k: v for k, v in h.items() if k not in _TIMINGS}
            for h in h_epoch] == [
        {k: v for k, v in h.items() if k not in _TIMINGS} for h in h_block]


def test_obs_resume_continues_counters(tmp_path):
    x, y = _data()
    kw = dict(_KW, epochs=2)
    s_full, h_full = train(_model(), Ring(4), x, y, obs="epoch", **kw)
    train(_model(), Ring(4), x, y, obs="epoch",
          **dict(kw, epochs=1), checkpoint_dir=str(tmp_path / "a"))
    s_res, h_res = train(_model(), Ring(4), x, y, obs="epoch", resume=True,
                         checkpoint_dir=str(tmp_path / "a"), **kw)
    assert [h["epoch"] for h in h_res] == [2]
    for a, b in zip(device._fields(s_full.telemetry),
                    device._fields(s_res.telemetry)):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    # a snapshot written without telemetry resumes with zeroed counters
    train(_model(), Ring(4), x, y, **dict(kw, epochs=1),
          checkpoint_dir=str(tmp_path / "b"))
    with pytest.warns(UserWarning, match="state/telemetry"):
        s_b, h_b = train(_model(), Ring(4), x, y, obs="epoch", resume=True,
                         checkpoint_dir=str(tmp_path / "b"), **kw)
    assert torch.equal(s_b.params, s_full.params)
    assert int(s_b.telemetry.steps[0]) == h_b[0]["steps"]
    assert h_b[0]["obs"]["fire_count"] == h_full[1]["obs"]["fire_count"]


def test_obs_compact_wire_utilization_and_deferrals():
    x, y = _data()
    kw = dict(_KW, event_cfg=events.EventConfig(
        adaptive=True, horizon=0.95, warmup_passes=2, max_silence=20))
    state, hist = train(_model(), Ring(4), x, y, obs="block",
                        gossip_wire="compact", compact_frac=0.6, **kw)
    cap_recs = [h for h in hist if h.get("compact_capacity")]
    assert cap_recs
    cap = cap_recs[-1]["compact_capacity"]
    defer_total = sum(sum(h["obs"]["defer_count"]) for h in hist)
    assert defer_total == int(state.event.num_deferred.sum())
    assert defer_total > 0
    for h in cap_recs:
        assert h["obs"]["fired_elems_mean"] <= cap + 1e-6
    cu = report.build_report(hist)["capacity_utilization"]
    assert cu["compact_capacity"] == cap
    assert 0.0 < cu["deferral_rate"] <= 1.0 and cu["per_window"]


# --- the host side ----------------------------------------------------------


def test_loop_spans_nest_under_train_root(obs_run, tmp_path):
    _, hist, reg = obs_run
    by_name = {}
    for s in reg.spans:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["train"]) == 1
    root = by_name["train"][0]
    assert root.depth == 0
    for name in ("data", "dispatch_block", "block_ready", "obs_flush",
                 "eval"):
        assert len(by_name[name]) == len(hist), name
    for s in reg.spans:
        if s.name == "train":
            continue
        assert s.depth >= 1
        assert s.ts_us >= root.ts_us - 1
        assert s.ts_us + s.dur_us <= root.ts_us + root.dur_us + 1
    path = tmp_path / "trace.json"
    reg.write_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    ev = trace["traceEvents"]
    assert {e["name"] for e in ev} == set(by_name)
    assert trace["otherData"]["obs_schema"] == OBS_SCHEMA_VERSION
    assert "eventgrad_ledger_disposition_total" in reg.prometheus_text()
    d = bubble.decompose(ev)
    assert d["n_blocks"] == len(hist) and "missing_spans" not in d
    assert 0.0 <= d["host_bubble_frac"] <= 1.0


def _registry_calls(reg):
    reg.gauge("active_ranks", 4)
    reg.gauge("edge_staleness", 2.0, labels={"edge": "ring_m1"})
    reg.gauge("edge_staleness", 1.0, labels={"edge": 'we"ird\\'})
    reg.observe_latency({"step_ms_mean": 1.5, "step_ms_p50": 1.25,
                         "step_ms_p95": 2.0, "compile_s": 3.0})
    rec = reg.observe_health(np.array([[3, 0], [1, 9]]), np.array([2, 5]),
                             4, edges=["ring_m1", "ring_p1"])
    with reg.span("train", algo="eventgrad"):
        with reg.span("data", block=0):
            pass
        with reg.span("obs_flush", cat="obs", block=0):
            pass
    reg.record({"epoch": 1, "loss": 0.5})
    return rec


def test_registry_matches_jax(tmp_path):
    mine = Registry(jsonl_path=str(tmp_path / "a.jsonl"),
                    run_meta={"algo": "eventgrad"})
    theirs = jax_registry.Registry(jsonl_path=str(tmp_path / "b.jsonl"),
                                   run_meta={"algo": "eventgrad"})
    with mine, theirs:
        assert _registry_calls(mine) == _registry_calls(theirs)
        assert mine.prometheus_text() == theirs.prometheus_text()
        a, b = mine.chrome_trace(), theirs.chrome_trace()
        strip = lambda t: [{k: v for k, v in e.items()
                            if k not in ("ts", "dur")}
                           for e in t["traceEvents"]]
        assert strip(a) == strip(b)
        assert a["otherData"] == b["otherData"]
        assert [s.depth for s in mine.spans] == [s.depth for s in theirs.spans]
    ra = json.loads((tmp_path / "a.jsonl").read_text())
    rb = json.loads((tmp_path / "b.jsonl").read_text())
    ra.pop("ts"), rb.pop("ts")
    assert ra == rb == {"obs_schema": 1, "epoch": 1, "loss": 0.5}


def test_jsonl_logger_nonfinite_values_stay_valid_json(tmp_path):
    rec = {"epoch": 3, "loss": float("nan"), "acc": 50.0,
           "obs": {"drift_mean": [1.0, float("inf")],
                   "peak": np.float32("-inf")}}
    lines = []
    for mod, name in ((metrics, "a"), (jax_metrics, "b")):
        path = tmp_path / f"{name}.jsonl"
        with mod.JsonlLogger(str(path), echo=False, fsync=True) as log:
            log.log(rec)
            log.log({"epoch": 4, "loss": 0.25})
        got = [json.loads(ln) for ln in path.read_text().splitlines()]
        for g in got:
            g.pop("ts")
        lines.append(got)
    assert lines[0] == lines[1]
    first = lines[0][0]
    assert first["loss"] is None and first["obs"]["drift_mean"] == [1.0, None]
    assert sorted(first["nonfinite_fields"]) == [
        "loss", "obs.drift_mean[1]", "obs.peak"]
    assert "nonfinite_fields" not in lines[0][1]


def test_metrics_helpers_match_jax():
    rng = np.random.default_rng(2)
    hist = [{"epoch": e, "loss": float(l)} for e, l in
            zip(range(1, 6), rng.random(5) + 0.2)]
    tagged = [dict(h, dispatch_block=(h["epoch"] - 1) // 2,
                   dispatch_cold=h["epoch"] <= 2) for h in hist]
    for h in (hist, tagged, hist[:1], [dict(h, dispatch_cold=True)
                                       for h in hist]):
        assert metrics.steady_records(h) == jax_metrics.steady_records(h)
    for losses, twin in (([2.0, 1.0, 0.4], None), ([2.0, 0.3, 0.9], None),
                         ([2.0, 0.3, 0.9], 0.8), ([1.0, float("nan")], None),
                         (2.5, None), ([1.0, 0.6], 0.2)):
        assert (metrics.collapse_verdict(losses, twin)
                == jax_metrics.collapse_verdict(losses, twin))
    for args in (([3, 0, 12], 4, 2, 3), ([1, 2], 0, 2, 4), ([5], 7, 0, 2)):
        assert (metrics.msgs_saved_pct_per_leaf(*args)
                == jax_metrics.msgs_saved_pct_per_leaf(*args))
    vals = rng.random(7).tolist()
    assert metrics.median(vals) == jax_metrics.median(vals)
    assert metrics.median(vals[:4]) == jax_metrics.median(vals[:4])


@pytest.fixture(scope="module")
def jax_history():
    """A JAX `train(obs="epoch")` history on the compact wire under drops
    and a straggler at D = 2 (so every report section has input), as its
    JSONL round trip would give it."""
    x, y = jax_synthetic(128, (8, 8, 1), seed=1)
    _, hist = jax_train(
        JaxMLP(hidden=8), JaxRing(4), x, y, algo="eventgrad", epochs=3,
        batch_size=8, learning_rate=0.1, obs="epoch", seed=0, staleness=2,
        gossip_wire="compact", compact_frac=0.5,
        chaos=JaxChaos.parse("seed=7,drop=0.2,slow=1@3"),
        event_cfg=jax_events.EventConfig(adaptive=True, horizon=0.95,
                                         warmup_passes=2, max_silence=4),
        log_every_epoch=False)
    return json.loads(json.dumps(hist, default=float))


def test_build_report_on_a_jax_history_equals_jax(jax_history, tmp_path):
    mine = report.build_report(jax_history)
    assert mine == jax_report.build_report(jax_history)
    assert report.render_text(mine) == jax_report.render_text(mine)
    for key in ("msgs_saved_pct_per_leaf", "capacity_utilization",
                "edge_staleness", "message_lifecycle", "consensus_error"):
        assert mine[key], key
    path = tmp_path / "h.jsonl"
    with metrics.JsonlLogger(str(path), echo=False) as log:
        for rec in jax_history:
            log.log(rec)
    out = tmp_path / "report.json"
    assert obs_report.main([str(path), "--out", str(out), "--quiet"]) == 0
    assert json.loads(out.read_text())["message_lifecycle"] == json.loads(
        json.dumps(mine["message_lifecycle"]))


def _spans():
    return [
        {"name": "train", "ph": "X", "ts": 0.0, "dur": 1e6, "args": {}},
        {"name": "data", "ph": "X", "ts": 10.0, "dur": 80.0,
         "args": {"block": 0}},
        {"name": "dispatch_block", "ph": "X", "ts": 100.0, "dur": 1000.0,
         "args": {"block": 0, "pipelined": True}},
        {"name": "obs_flush", "ph": "X", "ts": 1200.0, "dur": 300.0,
         "args": {"block": 0}},
        {"name": "dispatch_block", "ph": "X", "ts": 2e5, "dur": 1000.0,
         "args": {"block": 1, "pipelined": True}},
        {"name": "block_ready", "ph": "X", "ts": 3e5, "dur": 50.0,
         "args": {"block": 1}},
        {"name": "checkpoint", "ph": "X", "ts": 4e5, "dur": 2e4,
         "args": {}},
    ]


def test_bubble_decompose_matches_jax(tmp_path):
    spans = _spans()
    for part in (spans, spans[1:]):
        with pytest.warns(bubble.IncompleteTraceWarning) as w1:
            mine = bubble.decompose(part)
        with pytest.warns(jax_bubble.IncompleteTraceWarning) as w2:
            theirs = jax_bubble.decompose(part)
        assert mine == theirs
        assert [str(w.message) for w in w1] == [str(w.message) for w in w2]
        assert bubble.render_text(mine) == jax_bubble.render_text(theirs)
    serial = [dict(s, args=dict(s["args"], pipelined=False))
              if s["name"] == "dispatch_block" else s for s in spans]
    with warnings.catch_warnings():
        warnings.simplefilter("error", bubble.IncompleteTraceWarning)
        assert bubble.decompose(serial) == jax_bubble.decompose(serial)
    assert (bubble.train_windows(spans + spans)
            == jax_bubble.train_windows(spans + spans))
    # the command degrades on a broken trace file
    hist = tmp_path / "h.jsonl"
    hist.write_text('{"epoch": 1, "loss": 1.0}\n')
    broken = tmp_path / "broken.json"
    broken.write_text('{"traceEvents": [')
    with pytest.warns(bubble.IncompleteTraceWarning, match="unreadable"):
        assert obs_report.main([str(hist), "--trace", str(broken),
                                "--quiet"]) == 0
