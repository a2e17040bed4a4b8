"""The port's elastic membership (`chaos/membership.py`, the `leave=` /
`join=` clauses, `train(membership=...)`) against the JAX package's.

  * the transitions on carried state: the JAX package's state after a
    few passes (MLP, Ring(4), flat arena, EventGraD on the masked f32
    wire and on the int8 wire with carrier-resident buffers, with peer
    health) moved into the port; a leave and a join (default and
    explicit source) applied by both engines must agree BITWISE —
    parameters, trigger state, receive buffers and scales, counters,
    peer health;
  * a leave -> join round trip (Ring(4), and through Ring(2)) is bitwise
    the run that never transitioned, once the forced fire refreshed the
    buffers (fire-always trigger, identical batches on every rank);
  * a join copies the source row and zeroes the newcomer's counters,
    telemetry and ledger rows; the on-disk bootstrap stream is bitwise
    the in-memory one; a leave is `apply_ring_heal` + `force_refresh`;
    `force_refresh` arms a full fire;
  * schedule parsing and validation raise as the JAX schedule does, and
    the chaos spec's inline clauses round-trip;
  * `train(membership=...)`: the rank and step counts per epoch and the
    transition records equal the JAX run's; the logged schedule replays
    bitwise; a resume across a transition is bitwise; the inline chaos
    rider replays from both riders; the ledger's conservation audit
    stays clean through a join; the guards refuse with the JAX loop's
    messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.chaos import membership as jax_memb
from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.data.datasets import synthetic_dataset
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.loop import train as jax_train
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos import membership, monitor
from eventgrad_tpu_torch.chaos.membership import (
    MembershipEngine, MembershipEvent, MembershipSchedule, force_refresh,
)
from eventgrad_tpu_torch.chaos.policy import apply_ring_heal
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel import events
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.topology import Ring, Torus
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step

R, IN_SHAPE, PER_RANK, LR, HIDDEN = 4, (8, 8, 1), 4, 0.1, 8
CFG = dict(adaptive=True, horizon=0.95, warmup_passes=1, max_silence=4)


def _bits(t):
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


# --- the transitions on carried state ---------------------------------------


def _health_from_jax(js):
    return monitor.PeerHealth(
        silence=torch.from_numpy(np.array(js.chaos.silence)),
        sync_req=torch.from_numpy(np.array(js.chaos.sync_req)),
        drops=torch.from_numpy(np.array(js.chaos.drops)))


def _port_of(js, spec):
    """The port's TrainState holding a rank-stacked JAX state's values."""
    js = jax.tree.map(np.asarray, js)
    tp, ts = convert.params_from_jax(js.params, js.batch_stats, stacked=True)
    return TrainState(
        params=spec.ravel(tp), trace=None, batch_stats=ts,
        pass_num=int(js.pass_num[0]),
        event=convert.event_state_from_jax(js.event, spec),
        chaos=_health_from_jax(js))


def _carried(wire):
    """(JAX state, spec) after 3 EventGraD passes on distinct per-rank
    batches (rows differ), with peer health whose silence, sync requests
    and drops are non-zero."""
    carrier = wire is not None
    jtopo = JaxRing(R)
    jmodel = JaxMLP(hidden=HIDDEN)
    tx = optax.sgd(LR)
    jcfg = jax_events.EventConfig(**CFG)
    js = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, "eventgrad", jcfg,
                        seed=0, arena=True,
                        resident_wire=wire if carrier else None)
    step = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, "eventgrad", jcfg, arena=True, wire=wire,
        carrier_resident=carrier), jtopo))
    rng = np.random.default_rng(3)
    for _ in range(3):
        xb = rng.standard_normal((R, PER_RANK) + IN_SHAPE).astype(np.float32)
        yb = rng.integers(0, 10, (R, PER_RANK)).astype(np.int32)
        js, _ = step(js, (jnp.asarray(xb), jnp.asarray(yb)))
    h = stack_for_ranks(jax_monitor.PeerHealth.init(jtopo), jtopo)
    h = h.replace(silence=jnp.arange(R * 2, dtype=jnp.int32).reshape(R, 2),
                  sync_req=jnp.asarray([True, False, True, False]),
                  drops=jnp.arange(1, R + 1, dtype=jnp.int32))
    js = js.replace(chaos=h)
    spec = arena_spec(MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu"))
    return js, spec


@pytest.fixture(scope="module", params=[None, "int8"], ids=["f32", "int8"])
def carried(request):
    return _carried(request.param)


def _check_against_jax(js, jt, st, t, spec):
    assert t.n_ranks == jt.n_ranks
    want = _port_of(js, spec)
    _assert_same(st.params, want.params, "params")
    for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes", "bufs",
              "num_events", "num_deferred", "buf_scales"):
        _assert_same(getattr(st.event, f), getattr(want.event, f), f)
    for f in ("silence", "sync_req", "drops"):
        _assert_same(getattr(st.chaos, f), getattr(want.chaos, f), f)
    assert st.pass_num == want.pass_num


EVENTS = [
    MembershipEvent(epoch=3, kind="leave", index=1),
    MembershipEvent(epoch=3, kind="leave", index=3),
    MembershipEvent(epoch=3, kind="join", index=1),
    MembershipEvent(epoch=3, kind="join", index=4, src=2),
    MembershipEvent(epoch=3, kind="join", index=0),
]


@pytest.mark.parametrize("ev", EVENTS, ids=lambda e: f"{e.kind}{e.index}")
def test_transition_bitwise_the_jax_engine(carried, ev):
    js0, spec = carried
    st0 = _port_of(js0, spec)
    jev = jax_memb.MembershipEvent(epoch=ev.epoch, kind=ev.kind,
                                   index=ev.index, src=ev.src)
    cfg = events.EventConfig(**CFG)
    jeng = jax_memb.MembershipEngine(jax_memb.MembershipSchedule(),
                                     event_cfg=jax_events.EventConfig(**CFG))
    js, jt, jinfo = jeng.apply(js0, JaxRing(R), jev)
    eng = MembershipEngine(MembershipSchedule(), event_cfg=cfg)
    st, t, info = eng.apply(st0, Ring(R), ev)
    _check_against_jax(js, jt, st, t, spec)
    drop = ("apply_s",)
    assert ({k: v for k, v in info.items() if k not in drop}
            == {k: v for k, v in jinfo.items() if k not in drop})


def test_leave_then_join_bitwise_the_jax_engine(carried):
    """Two transitions in a row (Ring(4) -> Ring(3) -> Ring(4))."""
    js, spec = carried
    st, t = _port_of(js, spec), Ring(R)
    jt = JaxRing(R)
    jeng = jax_memb.MembershipEngine(jax_memb.MembershipSchedule(),
                                     event_cfg=jax_events.EventConfig(**CFG))
    eng = MembershipEngine(MembershipSchedule(),
                           event_cfg=events.EventConfig(**CFG))
    for kind, idx in (("leave", 2), ("join", 2)):
        js, jt, _ = jeng.apply(js, jt, jax_memb.MembershipEvent(
            epoch=1, kind=kind, index=idx))
        st, t, _ = eng.apply(st, t, MembershipEvent(epoch=1, kind=kind,
                                                    index=idx))
    _check_against_jax(js, jt, st, t, spec)


# --- round trips (the port alone) -------------------------------------------

#: the fire-always trigger (constant threshold 0): one force-fire cycle
#: holds on every pass
FIRE_ALWAYS = events.EventConfig(adaptive=False, constant=0.0,
                                 warmup_passes=0)


def _fire_always_run(n):
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    state = init_train_state(model, IN_SHAPE, Ring(n), "eventgrad",
                             FIRE_ALWAYS, device="cpu")
    step = make_train_step(model, Ring(n), "eventgrad", FIRE_ALWAYS,
                           fused_sgd=(LR, 0.0))
    return state, step


def _identical_batches(n, steps, seed=0):
    """Per-step batches with the same content on every rank: with the
    identical init, every rank's row stays bitwise equal, so a leave ->
    join round trip restores the content."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        xb = rng.standard_normal((PER_RANK,) + IN_SHAPE).astype(np.float32)
        yb = rng.integers(0, 10, (PER_RANK,))
        out.append((torch.from_numpy(np.broadcast_to(
            xb[None], (n,) + xb.shape).copy()),
            torch.from_numpy(np.broadcast_to(yb[None], (n,) + yb.shape)
                             .copy()).long()))
    return out


def _run(step, state, batches):
    for b in batches:
        state, _ = step(state, b)
    return state


def _same_but_counters(a, b):
    for f in ("params", "batch_stats"):
        _assert_same(list(getattr(a, f).values()) if f == "batch_stats"
                     else getattr(a, f),
                     list(getattr(b, f).values()) if f == "batch_stats"
                     else getattr(b, f), f)
    for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes", "bufs"):
        _assert_same(getattr(a.event, f), getattr(b.event, f), f)
    assert a.pass_num == b.pass_num


@pytest.mark.parametrize("n,pos", [(4, 1), (3, 2)], ids=["ring4", "ring2"])
def test_leave_join_round_trip_bitwise(n, pos):
    """Ring(n) -> leave -> join -> Ring(n) is bitwise the run that never
    transitioned (Ring(3) passes through the degenerate Ring(2))."""
    state, step = _fire_always_run(n)
    batches = _identical_batches(n, 5)
    state = _run(step, state, batches[:3])
    baseline = _run(step, state, batches[3:])
    eng = MembershipEngine(MembershipSchedule(), event_cfg=FIRE_ALWAYS)
    st, t2, _ = eng.apply(state, Ring(n),
                          MembershipEvent(epoch=1, kind="leave", index=pos))
    assert t2.n_ranks == n - 1
    st, t3, info = eng.apply(st, t2,
                             MembershipEvent(epoch=1, kind="join", index=pos))
    assert t3.n_ranks == n and info["src"] == (pos - 1) % (n - 1)
    _same_but_counters(baseline, _run(step, st, batches[3:]))


def test_join_bootstraps_src_row_and_zeroes_counters():
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    cfg = events.EventConfig(**CFG)
    topo = Ring(R)
    state = init_train_state(model, IN_SHAPE, topo, "eventgrad", cfg,
                             momentum=0.9, obs=True, device="cpu")
    step = make_train_step(model, topo, "eventgrad", cfg,
                           fused_sgd=(LR, 0.9), obs=True)
    rng = np.random.default_rng(3)
    for _ in range(3):
        state, _ = step(state, (
            torch.from_numpy(rng.standard_normal(
                (R, PER_RANK) + IN_SHAPE).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, (R, PER_RANK)))))
    state = state.replace(chaos=monitor.PeerHealth(
        silence=torch.ones((R, 2), dtype=torch.int32),
        sync_req=torch.ones((R,), dtype=torch.bool),
        drops=torch.arange(1, R + 1, dtype=torch.int32)))
    gen = state.rng.get_state()
    eng = MembershipEngine(MembershipSchedule(), event_cfg=cfg)
    st, t2, info = eng.apply(
        state, topo, MembershipEvent(epoch=3, kind="join", index=2, src=0))
    assert t2.n_ranks == 5 and info["src"] == 0
    for new, old in ((st.params, state.params), (st.trace, state.trace),
                     (st.event.slopes, state.event.slopes),
                     (st.event.bufs[1], state.event.bufs[1])):
        assert torch.equal(new[2], old[0])    # the bootstrap copy
        assert torch.equal(new[:2], old[:2])  # rows below keep
        assert torch.equal(new[3:], old[2:])  # rows above shift up
    assert float(st.event.thres.abs().sum()) == 0.0  # force-refreshed
    assert int(st.event.num_events[2]) == 0
    assert int(st.event.num_deferred[2]) == 0
    assert torch.equal(st.event.num_events[[0, 1, 3, 4]],
                       state.event.num_events)
    tel = st.telemetry
    assert int(tel.steps[2]) == 0 and int(tel.fire_count[2].sum()) == 0
    assert int(tel.ledger.counts[2].sum()) == 0
    assert torch.equal(tel.fire_count[[0, 1, 3, 4]],
                       state.telemetry.fire_count)
    assert not st.chaos.silence.any() and not st.chaos.sync_req.any()
    assert st.chaos.drops.tolist() == [1, 2, 0, 3, 4]
    # one random stream for the rank stack: a transition leaves it alone
    assert torch.equal(st.rng.get_state(), gen)


def test_join_streams_through_checkpoint(tmp_path, carried):
    """bootstrap_dir routes the neighbour row through checkpoint.save and
    its read back: bitwise the in-memory handoff."""
    js, spec = carried
    state = _port_of(js, spec)
    ev = MembershipEvent(epoch=3, kind="join", index=1)
    cfg = events.EventConfig(**CFG)
    st_mem, _, info_mem = MembershipEngine(
        MembershipSchedule(), event_cfg=cfg).apply(state, Ring(R), ev)
    st_disk, _, info_disk = MembershipEngine(
        MembershipSchedule(), event_cfg=cfg,
        bootstrap_dir=str(tmp_path)).apply(state, Ring(R), ev)
    assert not info_mem["bootstrap_streamed"]
    assert info_disk["bootstrap_streamed"]
    assert (tmp_path / "bootstrap" / "state.pt").exists()
    for f in ("params", "batch_stats", "event", "chaos"):
        a, b = getattr(st_mem, f), getattr(st_disk, f)
        if f == "event":
            a, b = [getattr(a, g) for g in ("thres", "bufs", "buf_scales",
                                            "slopes", "num_events")], \
                [getattr(b, g) for g in ("thres", "bufs", "buf_scales",
                                         "slopes", "num_events")]
        elif f == "chaos":
            a, b = [a.silence, a.drops], [b.silence, b.drops]
        elif f == "batch_stats":
            a, b = list(a.values()), list(b.values())
        _assert_same(a, b, f)


def test_leave_is_apply_ring_heal_then_force_refresh(carried):
    js, spec = carried
    state = _port_of(js, spec)
    st, t2, info = MembershipEngine(MembershipSchedule(), event_cfg=None
                                    ).apply(state, Ring(R),
                                            MembershipEvent(epoch=1,
                                                            kind="leave",
                                                            index=1))
    ref, ref_topo, survivors = apply_ring_heal(state, Ring(R), {1})
    ref = force_refresh(ref, None)
    assert info["survivors"] == list(survivors) == [0, 2, 3]
    assert t2.n_ranks == ref_topo.n_ranks == 3
    _assert_same(st.params, ref.params, "params")
    for f in ("thres", "bufs", "buf_scales", "num_events"):
        _assert_same(getattr(st.event, f), getattr(ref.event, f), f)
    _assert_same(st.chaos.drops, ref.chaos.drops, "drops")


def test_force_refresh_arms_full_fire():
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    spec = arena_spec(model)
    cfg = events.EventConfig(adaptive=True, horizon=1.0, warmup_passes=0)
    st = init_train_state(model, IN_SHAPE, Ring(2), "eventgrad", cfg,
                          device="cpu")
    ev = st.event.replace(thres=torch.full_like(st.event.thres, 1e9))
    assert not bool(events.propose(st.params, ev, 5, cfg, spec).fire_vec.any())
    armed = force_refresh(st.replace(event=ev), cfg).event
    assert bool(events.propose(st.params, armed, 5, cfg, spec).fire_vec.all())
    # constant mode arms through last_sent_norm; constant 0 fires already
    ccfg = events.EventConfig(adaptive=False, constant=1e9, warmup_passes=0)
    assert bool(events.propose(
        st.params, force_refresh(st, ccfg).event, 5, ccfg, spec).fire_vec.all())
    zero = events.EventConfig(adaptive=False, constant=0.0)
    assert force_refresh(st, zero) is st
    assert force_refresh(st.replace(event=None), cfg).event is None


# --- schedules --------------------------------------------------------------

BAD_SPECS = ["leave=1", "die=1@2", "leave=1@0", "join=1@2:x", "leave=1@2:0",
             "join=-1@2", "kick=1@2", "join"]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_schedule_parse_errors_as_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jax_memb.MembershipSchedule.parse(spec)
    with pytest.raises(ValueError) as err:
        MembershipSchedule.parse(spec)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("spec,base", [
    ("leave=0@1,leave=0@2", 3), ("leave=5@1", 4), ("join=6@1", 4),
    ("join=1@1:7", 4), ("leave=1@2,join=1@4", 4),
    ("seed=5,join=4@1:3,leave=0@2", 4)])
def test_schedule_validation_as_jax(spec, base):
    j, t = jax_memb.MembershipSchedule.parse(spec), \
        MembershipSchedule.parse(spec)
    assert t.to_dict() == j.to_dict() and t.to_spec() == j.to_spec()
    assert MembershipSchedule.from_dict(j.to_dict()) == t
    try:
        j.validate(base)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" at ")[0]):
            t.validate(base)
    else:
        t.validate(base)
        for e in range(6):
            assert t.n_ranks_at(base, e) == j.n_ranks_at(base, e)
            assert (t.topology_at(Ring(base), e).n_ranks
                    == j.topology_at(JaxRing(base), e).n_ranks)
    with pytest.raises(ValueError):
        MembershipEvent(epoch=1, kind="leave", index=1, src=0)
    with pytest.raises(TypeError):
        membership.resolve(3)


def test_chaos_inline_clauses_round_trip_as_jax():
    spec = "drop=0,seed=3,leave=1@1,join=1@2:0"
    j, t = JaxChaos.parse(spec), ChaosSchedule.parse(spec)
    assert t.to_dict() == j.to_dict() and t.to_spec() == j.to_spec()
    assert ChaosSchedule.from_dict(j.to_dict()) == t
    assert not t.is_noop
    assert t.membership_schedule().to_dict() == \
        j.membership_schedule().to_dict()


def test_engine_guards():
    eng = MembershipEngine(MembershipSchedule(), event_cfg=None)
    model = MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")
    state = init_train_state(model, IN_SHAPE, Ring(4), "dpsgd",
                             device="cpu")
    with pytest.raises(ValueError, match="outside"):
        eng.apply(state, Ring(4), MembershipEvent(epoch=1, kind="join",
                                                  index=9))
    with pytest.raises(ValueError, match="single-axis"):
        eng.apply(state, Torus(2, 2), MembershipEvent(epoch=1, kind="leave",
                                                      index=0))
    small = init_train_state(model, IN_SHAPE, Ring(2), "dpsgd", device="cpu")
    with pytest.raises(ValueError, match="a ring needs >= 2"):
        eng.apply(small, Ring(2), MembershipEvent(epoch=1, kind="leave",
                                                  index=0))


# --- train(membership=...) ---------------------------------------------------

TRAIN_CFG = dict(adaptive=True, horizon=0.95, warmup_passes=2, max_silence=5)
MEMB = "leave=1@2,join=1@4"


def _data(n=256):
    return synthetic_dataset(n, IN_SHAPE, seed=1)


def _train(epochs=6, n=256, ranks=4, algo="eventgrad", **kw):
    x, y = _data(n)
    return train(MLP(hidden=16, input_shape=IN_SHAPE, device="cpu"),
                 Ring(ranks), x, y, algo=algo, epochs=epochs, batch_size=8,
                 learning_rate=0.1,
                 event_cfg=events.EventConfig(**TRAIN_CFG), device="cpu",
                 **kw)


def _state_bitwise(a, b):
    _assert_same(a.params, b.params, "params")
    for f in ("thres", "last_sent_norm", "slopes", "bufs", "num_events"):
        _assert_same(getattr(a.event, f), getattr(b.event, f), f)
    assert a.pass_num == b.pass_num
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.fixture(scope="module")
def memb_run():
    return _train(membership=MEMB)


def test_train_counts_and_transitions_as_jax(memb_run):
    """Ranks and steps per epoch, the transitions, the schedule rider: as
    the JAX run of the same schedule reports them."""
    _, hist = memb_run
    x, y = _data()
    _, jhist = jax_train(JaxMLP(hidden=16), JaxRing(4), x, y,
                         algo="eventgrad", epochs=6, batch_size=8,
                         learning_rate=0.1,
                         event_cfg=jax_events.EventConfig(**TRAIN_CFG),
                         membership=MEMB)
    for key in ("epoch", "active_ranks", "steps"):
        assert [h[key] for h in hist] == [h[key] for h in jhist], key
    assert [h["active_ranks"] for h in hist] == [4, 4, 3, 3, 4, 4]
    assert hist[0]["membership"] == jhist[0]["membership"]
    drop = ("apply_s",)
    for h, jh in zip(hist, jhist):
        assert ("membership_transitions" in h) == (
            "membership_transitions" in jh)
        for a, b in zip(h.get("membership_transitions", ()),
                        jh.get("membership_transitions", ())):
            assert ({k: v for k, v in a.items() if k not in drop}
                    == {k: v for k, v in b.items() if k not in drop})
    assert [h.get("membership_transitions", [{}])[0].get("kind")
            for h in hist] == [None, None, "leave", None, "join", None]
    for h in hist:
        assert 0.0 < h["msgs_saved_pct"] < 100.0 and np.isfinite(h["loss"])


def test_train_membership_replays_bitwise(memb_run):
    st1, hist = memb_run
    assert st1.params.shape[0] == 4
    st2, hist2 = _train(membership=hist[0]["membership"])
    _state_bitwise(st1, st2)
    for a, b in zip(hist, hist2):
        for k in ("loss", "train_acc", "num_events", "msgs_saved_pct",
                  "sent_bytes_per_step_per_chip"):
            assert a[k] == b[k], k


def test_train_membership_resume_bitwise(tmp_path, memb_run):
    """Interrupted at epoch 3, where the ring had shrunk: the resume
    rebuilds Ring(3) from the schedule and finishes bitwise the run that
    never stopped."""
    st_ref, hist_ref = memb_run
    ck = str(tmp_path / "ck")
    _train(epochs=3, membership=MEMB, checkpoint_dir=ck)
    st_res, hist = _train(membership=MEMB, checkpoint_dir=ck, resume=True)
    assert [h["active_ranks"] for h in hist] == [3, 4, 4]
    _state_bitwise(st_ref, st_res)
    for a, b in zip(hist_ref[3:], hist):
        for k in ("loss", "num_events", "msgs_saved_pct"):
            assert a[k] == b[k], k


def test_train_chaos_inline_membership_replays_from_both_riders():
    chaos = "drop=0.0,seed=3,leave=1@1,join=1@2"
    st1, hist = _train(epochs=3, n=96, ranks=3, chaos=chaos)
    assert hist[0]["chaos"]["membership"]
    assert [h["active_ranks"] for h in hist] == [3, 2, 3]
    st2, _ = _train(epochs=3, n=96, ranks=3, chaos=hist[0]["chaos"],
                    membership=hist[0]["membership"])
    _state_bitwise(st1, st2)
    with pytest.raises(ValueError, match="disagree"):
        _train(epochs=3, n=96, ranks=3, chaos=chaos, membership="leave=0@1")


def test_train_membership_ledger_audit_clean_and_dpsgd():
    """Telemetry on through a leave and a join: every window's ledger
    audit is clean (the newcomer's rows start at zero on the device and
    in the diff base); D-PSGD runs the same schedule with a bootstrap
    dir."""
    _, hist = _train(epochs=5, n=128, membership=MEMB, obs="epoch")
    assert [h["active_ranks"] for h in hist] == [4, 4, 3, 3, 4]
    for h in hist:
        assert h["obs"]["ledger_audit"]["ok"], h["obs"]["ledger_audit"]
    _, hist = _train(epochs=5, n=128, algo="dpsgd", membership=MEMB,
                     checkpoint_dir=None)
    assert [h["steps"] for h in hist] == [4, 4, 5, 5, 4]


GUARDS = [
    (dict(algo="allreduce", membership="leave=1@1"), "gossip"),
    (dict(algo="dpsgd", membership="leave=1@1", chaos="drop=0,die=2@3"),
     "die="),
    (dict(algo="eventgrad", membership="leave=1@1", staleness=2),
     "staleness=2"),
    (dict(algo="dpsgd", membership="leave=0@1,leave=0@2,leave=0@3"),
     "below 2"),
    (dict(algo="dpsgd", membership="leave=1@1", chaos="drop=0,leave=2@1"),
     "disagree"),
]


@pytest.mark.parametrize("kw,what", GUARDS, ids=[g[1] for g in GUARDS])
def test_train_guards_refuse_as_jax(kw, what):
    x, y = _data(64)
    with pytest.raises(ValueError) as jerr:
        jax_train(JaxMLP(hidden=8), JaxRing(4), x, y, epochs=2, batch_size=8,
                  **kw)
    with pytest.raises(ValueError) as err:
        train(MLP(hidden=8, input_shape=IN_SHAPE, device="cpu"), Ring(4), x,
              y, epochs=2, batch_size=8, device="cpu", **kw)
    assert what in str(err.value)
    assert str(err.value) == str(jerr.value)


def test_train_guards_refuse_rollback_and_torus():
    x, y = _data(64)
    with pytest.raises(ValueError, match="integrity rollback"):
        train(MLP(hidden=8, input_shape=IN_SHAPE, device="cpu"), Ring(4), x,
              y, algo="eventgrad", epochs=2, batch_size=8, device="cpu",
              membership="leave=1@1", integrity="sentinel=1,rollback=1,"
              "checksum=0,quarantine=0")
    with pytest.raises(ValueError, match="single-axis"):
        train(MLP(hidden=8, input_shape=IN_SHAPE, device="cpu"), Torus(2, 2),
              x, y, algo="dpsgd", epochs=2, batch_size=8, device="cpu",
              membership="leave=1@1")
    with pytest.warns(RuntimeWarning, match="beyond"):
        train(MLP(hidden=8, input_shape=IN_SHAPE, device="cpu"), Ring(4), x,
              y, algo="dpsgd", epochs=1, batch_size=8, device="cpu",
              membership="leave=1@3")
