"""The port's chaos fault clauses, recovery policies and gated tail
against the JAX package's.

  * `chaos.prng` against `jax.random`: `uniform` and `randint` bitwise
    over (seed, tag, pass, rank) chains, in both of JAX's counter
    layouts (`jax_threefry_partitionable` True, the installed JAX's
    default, and False, the layout the committed artifacts were drawn
    with);
  * `delivery_table` and `corruption_table` bitwise the JAX ones for
    drop, flaky, delay, die and bitflip schedules on Ring(4) and
    Torus(2, 2);
  * the schedule's spec and dict round trips against the JAX schedule,
    and the refusals of the clauses still to port;
  * `mix_weighted` bitwise; `heal_ring` and `apply_ring_heal` against
    the JAX ones;
  * the gated plain versions of kernels 1, 4 and 5: bitwise the ungated
    ones with every gate open, and within rtol=1e-6, atol=1e-7 of
    `mix_weighted` + optax's SGD tail (the fused mix multiplies the sum
    where optax adds the update: one rounding apart);
  * single steps of EventGraD (f32 masked, int8 carrier, D = 2 under a
    straggler) and D-PSGD under drops, death, flaky windows, delay
    phases, the forced sync and the edge freeze, from the carried JAX
    state (MLP, Ring(4), float32): silence, drops and the byte counts
    exact, receive buffers and queues bitwise, parameters within
    rtol=1e-4, atol=1e-5 (the MLP's sums reduce in another order; D-PSGD
    also adds its gated `buf_sum` first);
  * drop 0 bitwise `chaos=None` for both algorithms; the drop-count
    rules (D-PSGD counts every undelivered edge, EventGraD an
    undelivered edge whose sender fired; during warmup every edge sends,
    so the count is the table's);
  * the guards: the bucketed schedule under the fault clauses builds
    (held to the monolithic and JAX steps in `test_torch_bucketed.py`),
    and with `bitflip=` or the integrity riders refuses as the JAX step
    does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.chaos import inject as jax_inject
from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos import policy as jax_policy
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.data.sharding import batched_epoch
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import collectives as jax_coll
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.parallel.topology import Torus as JaxTorus
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos import inject, monitor, policy, prng
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.ops import arena_update, fused_update
from eventgrad_tpu_torch.parallel import collectives, events
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.topology import Ring, Torus
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
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


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [] if x is None else [x]


def _assert_same(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(_bits(x), _bits(y)), (what, i)


# --- the draws ------------------------------------------------------------


@pytest.mark.parametrize("partitionable", [True, False])
def test_prng_bitwise_jax_random(partitionable):
    """`uniform` and `randint` over many (seed, tag, pass, rank) chains,
    vectorised on the port's side, against `jax.random` key by key."""
    was = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        with prng.threefry_partitionable(partitionable):
            for seed in (0, 5, 13, 2**20 + 7):
                for tag in (0x5EED, 0x9A5E, 0xB17F, 0xB170):
                    passes = np.array([1, 2, 17, 64, 191, 5000])
                    k = prng.fold_in(prng.PRNGKey(seed), tag)
                    kpr = prng.fold_in(prng.fold_in(k, passes[:, None]),
                                       np.arange(R)[None, :])
                    for n in (1, 2, 3, 4):
                        u = prng.uniform(kpr, n)
                        ri = prng.randint(kpr, n, 0, 2**31 - 1)
                        ph = prng.randint(kpr, n, 0, 3)
                        jk0 = jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 tag)
                        for i, p in enumerate(passes):
                            for r in range(R):
                                jk = jax.random.fold_in(
                                    jax.random.fold_in(jk0, int(p)), r)
                                np.testing.assert_array_equal(
                                    u[i, r].view(np.uint32), np.asarray(
                                        jax.random.uniform(jk, (n,))
                                    ).view(np.uint32))
                                np.testing.assert_array_equal(
                                    ri[i, r], jax.random.randint(
                                        jk, (n,), 0, 2**31 - 1))
                                np.testing.assert_array_equal(
                                    ph[i, r], jax.random.randint(
                                        jk, (n,), 0, 3))
    finally:
        jax.config.update("jax_threefry_partitionable", was)


SCHEDULES = (
    "drop=0.3,seed=4",
    "drop=0.1,seed=2,flaky=3-9@0.8,flaky=11-12@1.0",
    "delay=3,seed=5",
    "drop=0.2,seed=1,die=2@4",
    "bitflip=2-12@0.4,seed=13",
    "bitflip=0.25,seed=7,drop=0.05",
)


@pytest.mark.parametrize("spec", SCHEDULES)
def test_tables_bitwise_jax(spec):
    for jtopo, topo in ((JaxRing(4), Ring(4)), (JaxTorus(2, 2), Torus(2, 2))):
        js, s = JaxChaos.parse(spec), ChaosSchedule.parse(spec)
        np.testing.assert_array_equal(
            inject.delivery_table(s, topo, 16, start_pass=1),
            jax_inject.delivery_table(js, jtopo, 16, start_pass=1))
        np.testing.assert_array_equal(
            inject.corruption_table(s, topo, 16, start_pass=3),
            jax_inject.corruption_table(js, jtopo, 16, start_pass=3))
        # the salts, the per-pass device view and the nanstep events
        c, salt = inject.corruption_tables(s, topo, 4, start_pass=6)
        for i in range(4):
            jc, jsalt = jax.vmap(
                lambda r: jax_inject.corrupt_mask(js, jtopo, jnp.int32(6 + i),
                                                  rank=r))(jnp.arange(4))
            np.testing.assert_array_equal(c[i], np.asarray(jc))
            np.testing.assert_array_equal(salt[i], np.asarray(jsalt))
        # one pass's row: the JAX step's per-pass masks
        srcs = jnp.asarray(inject.host_source_table(topo))
        jd = jax.vmap(lambda r, sr: jax_inject.delivery_mask(
            js, jtopo, jnp.int32(7), rank=r, srcs=sr))(jnp.arange(4), srcs)
        np.testing.assert_array_equal(
            inject.delivery_table(s, topo, 1, start_pass=7)[0],
            np.asarray(jd))
        tc, tsalt = inject.corruption_tables(s, topo, 1, start_pass=7)
        np.testing.assert_array_equal(tc[0], c[1])
        np.testing.assert_array_equal(tsalt[0], salt[1])
        tabs = inject.FaultTables(s, topo, 3, "cpu")
        d, _, _, _ = tabs.at(9)  # past the tables: they grow
        assert tabs.n_passes >= 9
        np.testing.assert_array_equal(
            d.numpy(), inject.delivery_table(s, topo, 1, start_pass=9)[0])
    assert inject.reverse_edge_index(Ring(4)) == jax_inject.reverse_edge_index(
        JaxRing(4))
    assert inject.reverse_edge_index(Torus(2, 2)) == \
        jax_inject.reverse_edge_index(JaxTorus(2, 2))


def test_nanstep_table_and_range():
    s = ChaosSchedule.parse("seed=1,nanstep=2@5,nanstep=0@9,nanstep=3@40")
    js = JaxChaos.parse("seed=1,nanstep=2@5,nanstep=0@9,nanstep=3@40")
    tab = inject.nanstep_table(s, Ring(4), 12)
    for p in range(1, 13):
        want = np.asarray(jax.vmap(lambda r: jax_inject.nanstep_mask(
            js, JaxRing(4), jnp.int32(p), rank=r))(jnp.arange(4)))
        np.testing.assert_array_equal(tab[p - 1], want)
    for p in (5, 9, 10):
        np.testing.assert_array_equal(
            inject.nanstep_table(s, Ring(4), 1, start_pass=p)[0], tab[p - 1])
    assert inject.nansteps_in_range(s, 4, 12) == \
        jax_inject.nansteps_in_range(js, 4, 12) == 2


@pytest.mark.parametrize("spec", SCHEDULES + (
    "drop=0,seed=5,lag=3-9@2,slow=1@7",
    "seed=3,die=1@2,die=3@8,nanstep=2@6,delay=2",
))
def test_schedule_round_trips_against_jax(spec):
    s, js = ChaosSchedule.parse(spec), JaxChaos.parse(spec)
    assert s.to_spec() == js.to_spec()
    assert s.to_dict() == js.to_dict()
    assert ChaosSchedule.from_dict(js.to_dict()) == s
    assert ChaosSchedule.parse(js.to_spec()) == s
    for f in ("is_noop", "has_lags", "has_bitflips", "has_nansteps"):
        assert getattr(s, f) == getattr(js, f), f
    assert s.dead_ranks(5) == js.dead_ranks(5)


def test_consensus_error_and_sync_requests_against_jax():
    rng = np.random.default_rng(5)
    p = rng.standard_normal((R, 301)).astype(np.float32)
    want = np.asarray(jax_monitor.consensus_error({"a": jnp.asarray(p)}))
    got = monitor.consensus_error(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    need = np.array([[1, 0], [0, 0], [0, 1], [0, 0]], bool)
    want = np.asarray(jax.vmap(
        lambda n: jax_monitor.sync_requests(n, JaxRing(R)),
        axis_name="ring")(jnp.asarray(need)))
    got = monitor.sync_requests(torch.from_numpy(need), Ring(R)).numpy()
    np.testing.assert_array_equal(got, want)


# --- the gated mix and the gated plain versions -----------------------------


def test_mix_weighted_bitwise_jax():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((R, 37)).astype(np.float32)
    bufs = [rng.standard_normal((R, 37)).astype(np.float32) for _ in range(2)]
    p[0, :3] = -0.0  # a gated-off edge adds +0.0: -0.0 turns +0.0
    bufs[0][0, :3] = -0.0
    for gate in (np.array([[0, 1], [1, 1], [0, 0], [1, 0]], bool),
                 np.ones((R, 2), bool)):
        want = jax.vmap(jax_coll.mix_weighted)(
            jnp.asarray(p), tuple(jnp.asarray(b) for b in bufs),
            jnp.asarray(gate))
        got = collectives.mix_weighted(
            torch.from_numpy(p), tuple(torch.from_numpy(b) for b in bufs),
            torch.from_numpy(gate))
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    # every gate open: the uniform mix, and f32(1/3) as the weight
    w = collectives.mix_weights(torch.ones((R, 2), dtype=torch.bool))
    assert float(w[0]) == float(np.float32(Ring(4).mix_weight))


def _gated_args(seed=1, n=53):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda: torch.randn((R, n), generator=g)
    keep = lambda: (torch.rand((R, n), generator=g) < 0.5).float()
    return (rnd(), (rnd(), rnd()), (keep(), keep()), (rnd(), rnd()), rnd(),
            rnd(), 0.1, 0.9, 1.0 / 3.0)


def test_gated_plain_versions_open_gates_are_ungated_bitwise():
    args = _gated_args()
    gate = torch.ones((R, 2), dtype=torch.bool)
    open_kw = dict(w_rows=collectives.mix_weights(gate), gate=gate,
                   poison=torch.ones(R), quar=torch.zeros(R, dtype=torch.bool))
    _assert_same(arena_update.fused_mix_commit(*args, **open_kw),
                 arena_update.fused_mix_commit(*args), "kernel 1")
    p, cands, keeps, lasts, g, t = args[:6]
    q = tuple(torch.clamp(torch.round(c * 40), -127, 127).to(torch.int8)
              for c in cands)
    ql = tuple(torch.clamp(torch.round(c * 40), -127, 127).to(torch.int8)
               for c in lasts)
    sc = (torch.full_like(p, 0.025), torch.full_like(p, 0.0125))
    cargs = (p, q, keeps, ql, g, t, 0.1, 0.9, 1.0 / 3.0)
    _assert_same(arena_update.fused_mix_commit_carrier(
        *cargs, mix_scales=sc, w_rows=open_kw["w_rows"], gate=gate),
        arena_update.fused_mix_commit_carrier(*cargs, mix_scales=sc),
        "kernel 5")
    _assert_same(fused_update.fused_mix_sgd(p, cands[0], g, t, 0.1, 0.9,
                                            1.0 / 3.0,
                                            w_rows=open_kw["w_rows"]),
                 fused_update.fused_mix_sgd(p, cands[0], g, t, 0.1, 0.9,
                                            1.0 / 3.0), "kernel 4")


def test_gated_kernel1_against_mix_weighted_and_optax():
    """The gated plain version of kernel 1 (a rank with an edge off, one
    poisoned, one quarantined) against the JAX package's optax tail on
    `mix_weighted` of the committed buffers."""
    p, cands, keeps, lasts, g, t, lr, mom, w = _gated_args(seed=3)
    gate = torch.tensor([[1, 1], [0, 1], [1, 1], [1, 0]], dtype=torch.bool)
    poison = torch.tensor([1.0, 1.0, float("nan"), 1.0])
    quar = torch.tensor([False, False, False, True])
    got_p, got_t, bufs = arena_update.fused_mix_commit(
        p, cands, keeps, lasts, g, t, lr, mom, w,
        w_rows=collectives.mix_weights(gate), gate=gate, poison=poison,
        quar=quar)
    jn = lambda x: jnp.asarray(x.numpy())
    mixed = jax.vmap(jax_coll.mix_weighted)(
        jn(p), tuple(jn(b) for b in bufs), jn(gate))
    tx = optax.sgd(lr, momentum=mom)
    st = (optax.TraceState(trace=jn(t)),) + tuple(tx.init(jn(p))[1:])
    upd, st2 = tx.update(jn(g), st, mixed)
    bad = jn(poison)[:, None]
    upd, new_t = upd * bad, st2[0].trace * bad
    want_p = jnp.where(jn(quar)[:, None], mixed, mixed + upd)
    want_t = jnp.where(jn(quar)[:, None], jn(t), new_t)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-6,
                               atol=1e-7, equal_nan=True)
    assert torch.isnan(got_p[2]).all() and torch.isfinite(got_p[[0, 1, 3]]).all()
    # the quarantined row is the mixed row exactly, its trace the old one
    _assert_same(got_p[3], collectives.mix_weighted(p, bufs, gate)[3], "quar")
    _assert_same(got_t[3], t[3], "quar trace")


# --- the ring heal -------------------------------------------------------------


def test_heal_ring_and_apply_against_jax():
    for dead in ({2}, {0, 3}):
        jt, js = jax_policy.heal_ring(JaxRing(5), dead)
        t, s = policy.heal_ring(Ring(5), dead)
        assert s == js and t.shape == jt.shape and t.axes == jt.axes
        for r in range(t.n_ranks):
            assert [t.neighbor_source(r, nb) for nb in t.neighbors] == [
                jt.neighbor_source(r, nb) for nb in jt.neighbors]
    with pytest.raises(ValueError):
        policy.heal_ring(Ring(3), {0, 1})
    jtopo, topo = JaxRing(R), Ring(R)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    st = init_train_state(model, IN_SHAPE, topo, "eventgrad",
                          events.EventConfig(**CFG), seed=0, device="cpu")
    st = st.replace(chaos=monitor.PeerHealth(
        silence=torch.arange(R * 2, dtype=torch.int32).reshape(R, 2),
        sync_req=torch.tensor([True, False, True, False]),
        drops=torch.arange(R, dtype=torch.int32)))
    healed, htopo, surv = policy.apply_ring_heal(st, topo, {2})
    assert surv == (0, 1, 3) and htopo.n_ranks == 3
    _assert_same(healed.params, st.params[[0, 1, 3]], "params")
    _assert_same(healed.event.bufs, tuple(b[[0, 1, 3]] for b in st.event.bufs),
                 "bufs")
    assert not healed.chaos.silence.any() and not healed.chaos.sync_req.any()
    _assert_same(healed.chaos.drops, st.chaos.drops[[0, 1, 3]], "drops")
    jstate = jax_init_state(JaxMLP(hidden=HIDDEN), IN_SHAPE, optax.sgd(LR),
                            jtopo, "eventgrad", jax_events.EventConfig(**CFG),
                            seed=0, arena=True)
    jstate = jstate.replace(chaos=stack_for_ranks(
        jax_monitor.PeerHealth.init(jtopo), jtopo))
    jh, jht, jsurv = jax_policy.apply_ring_heal(jstate, jtopo, {2})
    assert jsurv == surv and jht.shape == htopo.shape
    assert jh.event.thres.shape == tuple(healed.event.thres.shape)


# --- steps from the carried JAX state -----------------------------------------


def _batches(steps, seed=3):
    x, y = jax_synthetic(R * PER_RANK * STEPS, IN_SHAPE, seed=seed)
    xb, yb = batched_epoch(x, y, R, PER_RANK)
    return [(np.asarray(xb[:, s]), np.asarray(yb[:, s]))
            for s in range(steps)]


def _health(js):
    return monitor.PeerHealth(
        silence=torch.from_numpy(np.array(js.chaos.silence)),
        sync_req=torch.from_numpy(np.array(js.chaos.sync_req)),
        drops=torch.from_numpy(np.array(js.chaos.drops)))


def carried_passes(algo, spec, pol=None, *, wire=None, carrier=False,
                   staleness=0, integrity=None, steps=STEPS,
                   jintegrity=None):
    """Per pass: the JAX state and metrics after it, and the port's step
    from the carried JAX state before it (the same batch)."""
    jtopo, topo = JaxRing(R), Ring(R)
    jsched, sched = JaxChaos.parse(spec), ChaosSchedule.parse(spec)
    jpol = None if pol is None else jax_policy.RecoveryPolicy(**pol)
    tpol = None if pol is None else RecoveryPolicy(**pol)
    jmodel = JaxMLP(hidden=HIDDEN)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    spec_ = arena_spec(model)
    tx = optax.sgd(LR)
    jcfg, cfg = jax_events.EventConfig(**CFG), events.EventConfig(**CFG)
    resident = wire if carrier else None
    jstate = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, algo, jcfg, seed=0,
                            arena=True, staleness=staleness,
                            resident_wire=resident)
    jstate = jstate.replace(chaos=stack_for_ranks(
        jax_monitor.PeerHealth.init(jtopo), jtopo))
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, algo, jcfg, arena=True, staleness=staleness,
        chaos=jsched, chaos_policy=jpol, wire=wire, carrier_resident=carrier,
        integrity=jintegrity), jtopo))
    tstep = make_train_step(model, topo, algo, cfg, fused_sgd=(LR, 0.0),
                            staleness=staleness, chaos=sched,
                            chaos_policy=tpol, wire=wire,
                            carrier_resident=carrier, integrity=integrity,
                            n_passes=steps)
    out = []
    for x, y in _batches(steps):
        js = jax.tree.map(np.asarray, jstate)
        tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                         stacked=True)
        tstate = TrainState(
            params=spec_.ravel(tp), trace=None, batch_stats=ts,
            pass_num=int(js.pass_num[0]),
            event=(None if js.event is None
                   else convert.event_state_from_jax(js.event, spec_)),
            chaos=_health(js))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        out.append((jax.tree.map(np.asarray, jstate),
                    jax.tree.map(np.asarray, jm), tstate,
                    {k: v.numpy() for k, v in tm.items()}))
    return spec_, out


EXACT = ("edge_silence", "chaos_drops", "sent_bytes", "sent_bytes_wire_real",
         "fired_elems", "num_events", "num_deferred", "fired_frac")


def check_passes(spec, passes, exact=EXACT, event_fields=("bufs",)):
    for p, (js, jm, ts, tm) in enumerate(passes, start=1):
        w = f"pass {p}"
        for k in exact:
            if k in jm:
                np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{w} {k}")
        tp, _ = convert.params_from_jax(js.params, stacked=True)
        np.testing.assert_allclose(ts.params.numpy(), spec.ravel(tp).numpy(),
                                   err_msg=w, equal_nan=True, **TOL)
        jh = _health(js)
        _assert_same(ts.chaos.silence, jh.silence, w)
        _assert_same(ts.chaos.sync_req, jh.sync_req, w)
        if js.event is not None:
            jev = convert.event_state_from_jax(js.event, spec)
            for f in event_fields:
                _assert_same(getattr(ts.event, f), getattr(jev, f),
                             f"{w} {f}")


#: drops, a flaky window, a death early enough to freeze its edges
#: (silence >= 6 by pass 8), the forced sync after 5 quiet passes
FAULTS = "drop=0.3,seed=2,flaky=3-5@0.9,die=2@2"
POLICY = dict(sync_after=5, freeze_after=6)


def test_eventgrad_step_under_faults_matches_jax():
    spec, passes = carried_passes("eventgrad", FAULTS, POLICY)
    check_passes(spec, passes)
    last = passes[-1][3]
    # the freeze reached the dead rank's neighbours, and drops were counted
    assert last["edge_silence"].max() >= POLICY["freeze_after"]
    assert last["chaos_drops"].sum() > 0
    assert any(ts.chaos.sync_req.any() for _, _, ts, _ in passes)


def test_dpsgd_step_under_faults_matches_jax():
    spec, passes = carried_passes("dpsgd", FAULTS + ",delay=2",
                                  dict(freeze_after=6))
    check_passes(spec, passes)
    assert passes[-1][3]["edge_silence"].max() >= 6


def test_int8_carrier_step_under_drops_matches_jax():
    spec, passes = carried_passes("eventgrad", "drop=0.4,seed=9,delay=2",
                                  POLICY, wire="int8", carrier=True)
    check_passes(spec, passes, event_fields=("bufs", "buf_scales"))


def test_bounded_async_step_under_drops_matches_jax():
    """D = 2 with the audit cell's drop 0.4 beside a straggler: the
    dropped messages never enter the queues."""
    spec, passes = carried_passes("eventgrad", "drop=0.4,seed=3,slow=1@3",
                                  POLICY, staleness=2)
    check_passes(spec, passes, exact=EXACT + ("edge_staleness",
                                                    "late_commits"),
                 event_fields=("bufs", "pending", "edge_clock",
                               "late_commits"))


def test_drop_counting_rules():
    """D-PSGD counts every undelivered edge; EventGraD an undelivered edge
    whose sender fired. Through warmup every edge sends, so EventGraD's
    count is the table's too; past it, at most the table's."""
    x, y = jax_synthetic(R * PER_RANK * STEPS, IN_SHAPE, seed=3)
    spec = "drop=0.35,seed=11"
    table = inject.delivery_table(ChaosSchedule.parse(spec), Ring(R), STEPS)
    undelivered = int((~table).sum())
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    common = dict(epochs=1, batch_size=PER_RANK, learning_rate=LR,
                  seed=0, chaos=spec, device="cpu")
    _, hd = train(model, Ring(R), x, y, algo="dpsgd", **common)
    assert hd[-1]["chaos_drops"] == undelivered
    warm = events.EventConfig(adaptive=True, horizon=0.9,
                              warmup_passes=STEPS + 1, max_silence=4)
    _, he = train(model, Ring(R), x, y, algo="eventgrad", event_cfg=warm,
                  **common)
    assert he[-1]["chaos_drops"] == undelivered
    _, he = train(model, Ring(R), x, y, algo="eventgrad",
                  event_cfg=events.EventConfig(**CFG), **common)
    assert 0 < he[-1]["chaos_drops"] <= undelivered


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_drop_zero_is_bitwise_no_chaos(algo):
    x, y = jax_synthetic(R * PER_RANK * STEPS, IN_SHAPE, seed=3)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    common = dict(algo=algo, epochs=2, batch_size=PER_RANK // 2,
                  learning_rate=LR, momentum=0.9, seed=0, device="cpu",
                  event_cfg=events.EventConfig(**CFG)
                  if algo == "eventgrad" else None)
    sa, ha = train(model, Ring(R), x, y, **common)
    sb, hb = train(model, Ring(R), x, y, chaos=ChaosSchedule(),
                   chaos_policy=RecoveryPolicy(freeze_after=5), **common)
    _assert_same(sa.params, sb.params, "params")
    _assert_same(sa.trace, sb.trace, "trace")
    for ra, rb in zip(ha, hb):
        for k in ("loss", "train_acc", "sent_bytes_per_step_per_chip"):
            assert ra[k] == rb[k], k
    assert hb[0]["chaos"] == ChaosSchedule().to_dict()
    assert hb[-1]["chaos_drops"] == 0


def test_fault_guards():
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    topo = Ring(R)
    mk = lambda algo="eventgrad", **kw: make_train_step(
        model, topo, algo, events.EventConfig(**CFG), fused_sgd=(LR, 0.0),
        **kw)
    for chaos, pol in (("drop=0.2", None), ("die=1@3", None),
                       ("delay=2", None), ("flaky=1-3@0.5", None),
                       ("nanstep=1@3", None),
                       ("seed=1", RecoveryPolicy(freeze_after=8))):
        # the bucketed schedule under the fault clauses runs (item 12)
        mk(bucketed=2, chaos=chaos, chaos_policy=pol)
    # the straggler clauses run bucketed too
    mk(bucketed=2, staleness=2, chaos="seed=1,slow=1@3")
    with pytest.raises(ValueError, match="bitflip"):
        mk(bucketed=2, chaos="bitflip=0.1")
    with pytest.raises(ValueError, match="integrity"):
        mk(bucketed=2, integrity="on")
    with pytest.raises(ValueError, match="chaos_policy requires chaos"):
        mk(chaos_policy=RecoveryPolicy(sync_after=8))
    with pytest.raises(ValueError, match="sync_after"):
        mk("dpsgd", chaos="seed=1", chaos_policy=RecoveryPolicy(sync_after=8))
    with pytest.raises(ValueError, match="max_silence"):
        mk(chaos="seed=1", chaos_policy=RecoveryPolicy(freeze_after=3))
    with pytest.raises(ValueError, match="event exchange"):
        mk("dpsgd", chaos="nanstep=1@2")
    with pytest.raises(ValueError, match="gossip exchange"):
        mk("sp_eventgrad", chaos="seed=1")
    with pytest.raises(ValueError, match="carrier_resident"):
        mk(wire="int8", carrier_resident=True, chaos="bitflip=0.1")
