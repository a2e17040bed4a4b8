"""The port's integrity engine against the JAX package's.

  * `IntegrityConfig` parse, resolve and dict round trip, and the
    `DivergenceSentinel`'s trips, baselines and rewind, against the JAX
    ones on the same inputs;
  * `wire_checksum` and `flip_one_bit` bitwise per wire dtype (f32,
    bf16, int8), row by row against the JAX functions;
  * a rejected payload is bitwise a dropped one (the exchange's effective
    bits and the committed buffers);
  * EventGraD steps under `bitflip=` and `nanstep=` with the checksums
    and the quarantine on, from the carried JAX state (MLP, Ring(4),
    float32; staleness 0, 1 and 2 on the masked f32 wire, the masked
    int8 and bf16 wires, the compact int8 wire): the per-edge
    rejections and the quarantine verdicts exact, the receive buffers
    bitwise, the parameters within rtol=1e-4, atol=1e-5 (the MLP's sums
    reduce in another order);
  * the rejections count position only: with the checksums on, the
    rejections of a run are its `corruption_table`, exactly;
  * integrity on without faults is bitwise integrity off;
  * the rollback: the sentinel trips on the nanstep the quarantine-off
    step lets through, the loop restores the last-known-good epoch,
    hardens the step and replays; two runs agree bitwise, and with the
    budget spent `IntegrityEscalation` is raised.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.chaos import inject as jax_inject
from eventgrad_tpu.chaos import integrity as jax_integrity
from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.data.sharding import batched_epoch
from eventgrad_tpu.exitcodes import INTEGRITY_ABORT_EXIT as JAX_ABORT
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import collectives as jax_coll
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos import inject, integrity, monitor
from eventgrad_tpu_torch.chaos.integrity import (
    INTEGRITY_ABORT_EXIT, DivergenceSentinel, IntegrityConfig,
    IntegrityEscalation,
)
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel import collectives, events
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import TrainState
from eventgrad_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
R, IN_SHAPE, PER_RANK, LR = 4, (8, 8, 1), 8, 0.05
CFG = dict(adaptive=True, horizon=0.9, warmup_passes=2, max_silence=4)
HIDDEN = 8
STEPS = 8


def _bits(t):
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.bfloat16: torch.int16}.get(
                                    t.dtype, t.dtype))


def _assert_same(a, b, what):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


# --- the config and the sentinel -------------------------------------------


@pytest.mark.parametrize("spec", [
    "on", "off", "checksum=0,quarantine=1,max_rollbacks=2",
    "sentinel=false,rollback=0", "loss_spike=8,consensus_floor=2.5",
    "escalate=0,keep_good=3",
])
def test_config_parse_resolve_round_trip(spec):
    c, jc = IntegrityConfig.parse(spec), jax_integrity.IntegrityConfig.parse(
        spec)
    assert c.to_dict() == jc.to_dict()
    assert c.is_noop == jc.is_noop
    assert c.hardened().to_dict() == jc.hardened().to_dict()
    assert IntegrityConfig.from_dict(jc.to_dict()) == c
    r, jr = integrity.resolve(spec), jax_integrity.resolve(spec)
    assert (r is None) == (jr is None)
    if r is not None:
        assert r.to_dict() == jr.to_dict()
    assert integrity.resolve(c.to_dict()) == r
    assert INTEGRITY_ABORT_EXIT == JAX_ABORT


def test_config_refusals_match_jax():
    for bad in ("checksum=2", "nope=1", "max_rollbacks=-1",
                "loss_spike=1.0"):
        with pytest.raises(ValueError):
            jax_integrity.IntegrityConfig.parse(bad)
        with pytest.raises(ValueError):
            IntegrityConfig.parse(bad)
    with pytest.raises(TypeError):
        integrity.resolve(3)


def test_sentinel_trips_and_rewinds_like_jax():
    cfg = dict(loss_spike=3.0, loss_floor=0.5, consensus_spike=10.0,
               consensus_floor=1.0)
    seq = [(2.0, 0.5), (1.2, 0.3), (1.0, 0.2), (3.5, 0.25), (0.9, 0.25),
           (float("nan"), 0.1), (0.8, 5.0), (0.7, float("inf")),
           (0.7, None), (0.6, 0.21)]
    s = DivergenceSentinel(IntegrityConfig(**cfg))
    js = jax_integrity.DivergenceSentinel(jax_integrity.IntegrityConfig(**cfg))
    snap = jsnap = None
    for i, (loss, cerr) in enumerate(seq):
        got, want = s.observe(loss, cerr), js.observe(loss, cerr)
        assert got == want, i
        assert s.snapshot() == js.snapshot() and s.trips == js.trips
        if i == 2:
            snap, jsnap = s.snapshot(), js.snapshot()
    s.rewind(snap)
    js.rewind(jsnap)
    assert s.snapshot() == js.snapshot()
    assert s.observe(2.9, 0.2) == js.observe(2.9, 0.2)
    assert s.trips >= 3


@pytest.mark.parametrize("cfg", [
    dict(adaptive=True), dict(adaptive=False, constant=0.5),
    dict(adaptive=False, constant=0.0),
])
def test_force_refresh_arms_like_jax(cfg):
    """The rollback's re-arm: thresholds to 0 (adaptive), the last sent
    norms to -1e30 (a positive constant), nothing with constant 0."""
    from eventgrad_tpu.chaos import membership as jax_membership
    from eventgrad_tpu_torch.chaos.membership import force_refresh

    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    jcfg, tcfg = jax_events.EventConfig(**cfg), events.EventConfig(**cfg)
    jstate = jax_init_state(JaxMLP(hidden=HIDDEN), IN_SHAPE, optax.sgd(LR),
                            JaxRing(R), "eventgrad", jcfg, seed=0, arena=True)
    from eventgrad_tpu_torch.train.state import init_train_state
    tstate = init_train_state(model, IN_SHAPE, Ring(R), "eventgrad", tcfg,
                              seed=0, device="cpu")
    ev = jstate.event.replace(thres=jnp.full_like(jstate.event.thres, 0.3),
                              last_sent_norm=jnp.full_like(
                                  jstate.event.last_sent_norm, 2.0))
    tev = tstate.event.replace(thres=torch.full_like(tstate.event.thres, 0.3),
                               last_sent_norm=torch.full_like(
                                   tstate.event.last_sent_norm, 2.0))
    jout = jax_membership.force_refresh(jstate.replace(event=ev), jcfg)
    tout = force_refresh(tstate.replace(event=tev), tcfg)
    for f in ("thres", "last_sent_norm"):
        np.testing.assert_array_equal(getattr(tout.event, f).numpy(),
                                      np.asarray(getattr(jout.event, f)))


# --- the wire riders ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_checksum_and_flip_bitwise_per_dtype(dtype):
    rng = np.random.default_rng(4)
    n = 97
    if dtype == "int8":
        a = rng.integers(-127, 128, (R, n)).astype(np.int8)
        t = torch.from_numpy(a)
        j = jnp.asarray(a)
    else:
        a = (rng.standard_normal((R, n)) * 1e3).astype(np.float32)
        a[0, :5] = 0.0
        t = torch.from_numpy(a).to(getattr(torch, dtype))
        j = jnp.asarray(a).astype(getattr(jnp, dtype))
    want = np.asarray(jax.vmap(jax_coll.wire_checksum)(j))
    got = collectives.wire_checksum(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    do = np.array([True, False, True, True])
    salt = np.array([5, 77, 2**31 - 2, 96], np.int32)
    jflip = jax.vmap(jax_inject.flip_one_bit)(j, jnp.asarray(do),
                                              jnp.asarray(salt))
    tflip = inject.flip_one_bit(t.clone(), torch.from_numpy(do),
                                torch.from_numpy(salt.astype(np.int64)))
    jf = np.asarray(jflip)
    tf = tflip.float().numpy() if dtype == "bfloat16" else tflip.numpy()
    if dtype == "bfloat16":
        jf = np.asarray(jflip.astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(tf).view(np.uint8),
                                  np.asarray(jf).view(np.uint8))
    # a flipped bit always changes the checksum, even of a zero word
    csum = collectives.wire_checksum(tflip)
    assert torch.equal(csum != got, torch.from_numpy(do))


def test_rejected_payload_is_a_dropped_one_bitwise():
    """The masked exchange with a corrupted, checksummed payload on some
    edges gives the same effective bits, and so the same committed
    buffers, as the clean exchange with those edges dropped."""
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    spec = arena_spec(model)
    g = torch.Generator().manual_seed(2)
    flat = torch.randn((R, spec.n_total), generator=g)
    fire = torch.rand((R, spec.n_leaves), generator=g) < 0.6
    lasts = tuple(torch.randn((R, spec.n_total), generator=g)
                  for _ in range(2))
    bits = torch.tensor([[1, 0], [0, 0], [1, 1], [0, 1]], dtype=torch.bool)
    salt = torch.randint(0, 2**31 - 1, (R, 2), generator=g)
    for wire in (None, "bf16", "int8"):
        cands, effs, raws, oks = collectives.masked_neighbor_vals_flat(
            flat, fire, Ring(R), spec, wire, checksum=True, finite=True,
            corrupt=lambda i, b: inject.flip_one_bit(b, bits[:, i],
                                                     salt[:, i]))
        assert torch.equal(oks, ~bits)
        c2, e2, r2 = collectives.masked_neighbor_vals_flat(
            flat, fire, Ring(R), spec, wire, deliver=~bits)
        _assert_same(effs, e2, f"{wire} effs")
        _assert_same(raws, r2, f"{wire} raws")
        _assert_same(collectives.commit_bufs_flat(cands, effs, lasts, spec),
                     collectives.commit_bufs_flat(c2, e2, lasts, spec),
                     f"{wire} committed buffers")


# --- steps from the carried JAX state -----------------------------------------


def _batches(steps, seed=3):
    x, y = jax_synthetic(R * PER_RANK * STEPS, IN_SHAPE, seed=seed)
    xb, yb = batched_epoch(x, y, R, PER_RANK)
    return [(np.asarray(xb[:, s]), np.asarray(yb[:, s]))
            for s in range(steps)]


def _carried(spec_str, integ, *, wire=None, gossip_wire="dense",
             capacity=None, staleness=0):
    jtopo, topo = JaxRing(R), Ring(R)
    jmodel = JaxMLP(hidden=HIDDEN)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    spec = arena_spec(model)
    tx = optax.sgd(LR)
    jcfg, cfg = jax_events.EventConfig(**CFG), events.EventConfig(**CFG)
    jstate = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, "eventgrad", jcfg,
                            seed=0, arena=True, staleness=staleness)
    jstate = jstate.replace(chaos=stack_for_ranks(
        jax_monitor.PeerHealth.init(jtopo), jtopo))
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, "eventgrad", jcfg, arena=True,
        chaos=JaxChaos.parse(spec_str), wire=wire, gossip_wire=gossip_wire,
        compact_capacity=capacity, staleness=staleness,
        integrity=jax_integrity.IntegrityConfig.parse(integ)), jtopo))
    tstep = make_train_step(model, topo, "eventgrad", cfg, fused_sgd=(LR, 0.0),
                            chaos=spec_str, wire=wire,
                            gossip_wire=gossip_wire,
                            compact_capacity=capacity, integrity=integ,
                            staleness=staleness, n_passes=STEPS)
    out = []
    for x, y in _batches(STEPS):
        js = jax.tree.map(np.array, jstate)
        tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                         stacked=True)
        tstate = TrainState(
            params=spec.ravel(tp), trace=None, batch_stats=ts,
            pass_num=int(js.pass_num[0]),
            event=convert.event_state_from_jax(js.event, spec),
            chaos=monitor.PeerHealth(
                silence=torch.from_numpy(js.chaos.silence),
                sync_req=torch.from_numpy(js.chaos.sync_req),
                drops=torch.from_numpy(js.chaos.drops)))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        out.append((jax.tree.map(np.array, jstate),
                    jax.tree.map(np.array, jm), tstate,
                    {k: v.numpy() for k, v in tm.items()}))
    return spec, out


def _check(spec, passes, event_fields=("bufs",)):
    for p, (js, jm, ts, tm) in enumerate(passes, start=1):
        w = f"pass {p}"
        assert set(tm) == set(jm), (w, set(tm) ^ set(jm))
        for k in ("integrity_wire_reject", "integrity_quarantined",
                  "edge_silence", "chaos_drops", "sent_bytes",
                  "sent_bytes_wire_real", "num_events", "fired_frac"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{w} {k}")
        tp, _ = convert.params_from_jax(js.params, stacked=True)
        np.testing.assert_allclose(ts.params.numpy(), spec.ravel(tp).numpy(),
                                   err_msg=w, **TOL)
        jev = convert.event_state_from_jax(js.event, spec)
        for f in event_fields:
            _assert_same(getattr(ts.event, f), getattr(jev, f), f"{w} {f}")
        np.testing.assert_allclose(ts.event.thres.numpy(), jev.thres.numpy(),
                                   err_msg=f"{w} thres", **TOL)


FAULTS = "seed=5,bitflip=2-7@0.4,nanstep=1@4,nanstep=3@6,drop=0.1"


@pytest.mark.parametrize("staleness", [0, 1, 2])
def test_quarantine_and_rejections_match_jax(staleness):
    """At D = 2 the rejected and dropped messages never enter the
    queues: the delivered bits carry the verdicts."""
    spec, passes = _carried(FAULTS, "on", staleness=staleness)
    _check(spec, passes, ("bufs", "pending", "edge_clock", "late_commits")
           if staleness >= 2 else ("bufs",))
    rejects = sum(int(tm["integrity_wire_reject"].sum())
                  for _, _, _, tm in passes)
    quar = [np.nonzero(tm["integrity_quarantined"])[0].tolist()
            for _, _, _, tm in passes]
    assert rejects > 0 and quar[3] == [1] and quar[5] == [3]
    for _, _, ts, _ in passes:
        assert torch.isfinite(ts.params).all()


@pytest.mark.parametrize("wire,gossip_wire", [
    ("int8", "compact"), ("int8", "dense"), ("bf16", "dense"),
])
def test_wire_integrity_matches_jax(wire, gossip_wire):
    """The checksums over the int8 and bf16 wires, masked and compact (the
    compact int8 finite check reads the received scales)."""
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    cap = None
    if gossip_wire == "compact":
        cap = collectives.compact_capacity_floor(arena_spec(model).sizes) + 40
    spec, passes = _carried(FAULTS, "on", wire=wire, gossip_wire=gossip_wire,
                            capacity=cap)
    _check(spec, passes)


def test_rejections_are_the_corruption_table():
    """With the checksums on every corrupted payload is rejected, fired
    or not (a flipped bit changes the sum even of a zero payload), so the
    count is position only."""
    x, y = jax_synthetic(R * PER_RANK * STEPS, IN_SHAPE, seed=3)
    sched = "seed=13,bitflip=2-8@0.3"
    table = inject.corruption_table(ChaosSchedule.parse(sched), Ring(R),
                                    STEPS)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    for integ in ("checksum=1,quarantine=0,sentinel=0,rollback=0", "on"):
        _, h = train(model, Ring(R), x, y, algo="eventgrad", epochs=1,
                     batch_size=PER_RANK, learning_rate=LR,
                     event_cfg=events.EventConfig(**CFG), seed=0,
                     chaos=sched, integrity=integ, device="cpu")
        assert h[-1]["wire_rejects"] == int(table.sum()) > 0
        assert h[-1]["quarantined_steps"] == 0


def test_integrity_without_faults_is_bitwise_off():
    x, y = jax_synthetic(R * PER_RANK * STEPS, IN_SHAPE, seed=3)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    common = dict(algo="eventgrad", epochs=2, batch_size=PER_RANK // 2,
                  learning_rate=LR, momentum=0.9,
                  event_cfg=events.EventConfig(**CFG), seed=0, device="cpu")
    sa, ha = train(model, Ring(R), x, y, **common)
    sb, hb = train(model, Ring(R), x, y, integrity="on", **common)
    sc, hc = train(model, Ring(R), x, y, integrity="off", **common)
    for s in (sb, sc):
        _assert_same(sa.params, s.params, "params")
        _assert_same(sa.trace, s.trace, "trace")
        _assert_same(sa.event.bufs, s.event.bufs, "bufs")
    assert [r["loss"] for r in ha] == [r["loss"] for r in hb]
    assert hb[0]["integrity"] == IntegrityConfig().to_dict()
    assert sum(r["wire_rejects"] + r["quarantined_steps"] for r in hb) == 0
    assert "integrity" not in hc[0]


# --- the rollback ---------------------------------------------------------------


#: the JAX integrity sweep's leg in miniature: checksums on, quarantine
#: off, so the nanstep lands and the sentinel must catch it
ROLLBACK = IntegrityConfig(checksum=True, quarantine=False, escalate=True,
                           max_rollbacks=1)


def _rollback_run(integ=ROLLBACK, sched="seed=13,bitflip=3-9@0.2,nanstep=2@14"):
    x, y = jax_synthetic(1024, IN_SHAPE, seed=1)
    model = MLP(hidden=16, input_shape=IN_SHAPE, device="cpu")
    return train(model, Ring(R), x, y, algo="eventgrad", epochs=4,
                 batch_size=32, learning_rate=0.1,
                 event_cfg=events.EventConfig(adaptive=True, horizon=0.95,
                                              warmup_passes=5,
                                              max_silence=5),
                 seed=0, chaos=sched, integrity=integ, device="cpu")


def test_rollback_hardens_and_replays_bitwise():
    sa, ha = _rollback_run()
    rb = [r["integrity_rollback"] for r in ha if "integrity_rollback" in r]
    assert len(rb) == 1
    assert rb[0]["reason"].startswith("non-finite block loss")
    # 8 passes an epoch: the nanstep at pass 14 lands in epoch 2
    assert (rb[0]["tripped_epoch"], rb[0]["restored_epoch"]) == (2, 1)
    assert rb[0]["hardened"]
    assert [r["epoch"] for r in ha] == [1, 2, 2, 3, 4]
    assert ha[-1]["integrity_rollbacks"] == 1
    # the replayed epoch quarantines the same nanstep, hardened
    assert ha[2]["quarantined_steps"] == 1 and ha[1]["quarantined_steps"] == 0
    assert torch.isfinite(sa.params).all() and math.isfinite(ha[-1]["loss"])
    assert sa.pass_num == 4 * 8
    sb, hb = _rollback_run()
    _assert_same(sa.params, sb.params, "replay params")
    _assert_same(sa.event.bufs, sb.event.bufs, "replay bufs")
    for ra, rb_ in zip(ha, hb):
        for k in ("loss", "wire_rejects", "quarantined_steps",
                  "msgs_saved_pct", "consensus_err_max"):
            assert ra[k] == rb_[k] or (math.isnan(ra[k]) and math.isnan(
                rb_[k])), k


def test_escalation_once_the_budget_is_spent():
    with pytest.raises(IntegrityEscalation, match="rollback budget spent"):
        _rollback_run(IntegrityConfig(checksum=True, quarantine=False,
                                      escalate=False, max_rollbacks=1))
    with pytest.raises(IntegrityEscalation, match="rollback disarmed"):
        _rollback_run(IntegrityConfig(checksum=True, quarantine=False,
                                      rollback=False))


def test_integrity_guards():
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    x, y = jax_synthetic(64, IN_SHAPE, seed=1)
    with pytest.raises(ValueError, match="algo='eventgrad'"):
        make_train_step(model, Ring(R), "dpsgd", fused_sgd=(LR, 0.0),
                        integrity="on")
    with pytest.raises(ValueError, match="escalate"):
        train(model, Ring(R), x, y, algo="dpsgd", epochs=1, batch_size=8,
              integrity="checksum=0,quarantine=0", device="cpu")
    with pytest.raises(ValueError, match="carrier_resident"):
        make_train_step(model, Ring(R), "eventgrad", fused_sgd=(LR, 0.0),
                        wire="int8", carrier_resident=True, integrity="on")
    # the sentinel alone rides D-PSGD (no in-step defenses)
    _, h = train(model, Ring(R), x, y, algo="dpsgd", epochs=1, batch_size=8,
                 integrity="checksum=0,quarantine=0,escalate=0",
                 device="cpu")
    assert h[-1]["integrity_rollbacks"] == 0
