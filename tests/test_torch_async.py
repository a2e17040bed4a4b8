"""The port's bounded-async engine (staleness D >= 2) and straggler
clauses against the JAX package's.

The contracts, as `tests/test_bounded_async.py` states them for the JAX
package:

  * the delivery queue on hand-built states, bitwise against the JAX
    `async_delivery_commit`: a late delivery is a deferred fire, the
    edge clock and the staleness gauge, a same-pass merge won by the
    later send, and the int8 carrier's per-slot scales;
  * `lag_vector` and `lag_table` clamp at the bound, equal to JAX's;
  * D = 2 and D = 4 at the baseline lag reproduce staleness 1 bitwise,
    port against port, over the composed parametrisation (per-bucket
    queues, the compact and masked wires, the int8 carrier), and
    sparsified EventGraD's payload queue at D = 2 likewise;
  * the straggler `slow=(1, 7)` at D = 4 on the composed stack, against
    the JAX step: before every pass the JAX state — queues, clocks,
    carrier buffers and scales, peer health — is carried into the port
    (`convert.event_state_from_jax`), both steps take the same batch,
    and `edge_staleness` and `late_commits` are exactly equal (they
    depend only on position), the receive buffers, queue slots and
    scales bitwise (wires built from equal parameters), the parameters
    within rtol=1e-4, atol=1e-5 (float32; the MLP's sums reduce in
    another order, and the JAX step's tail is optax's, the port's kernel
    1/5, documented bitwise equal); the gauge clamps at 4 on the edges
    fed by rank 1, and a rerun replays bitwise;
  * the guards of the JAX step and loop that concern D >= 2 raise
    ValueError in the port too.

The MLP (hidden 8, 8x8 inputs, Ring(4), 8 samples per rank, SGD 0.05)
computes in float32 on both sides, as `tests/test_torch_algos.py`'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.chaos import inject as jax_inject
from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.chaos.schedule import LagWindow as JaxLagWindow
from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.data.sharding import batched_epoch
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import arena as jax_arena
from eventgrad_tpu.parallel import collectives as jax_coll
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos import inject, monitor
from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule, LagWindow
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel import collectives, events
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
R, IN_SHAPE, PER_RANK, LR = 4, (8, 8, 1), 8, 0.05
CFG = dict(adaptive=True, horizon=0.9, warmup_passes=2, max_silence=4)
HIDDEN = 8


def _port_model():
    return MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")


#: one fixed stream of batches: a run of n steps takes its first n
MAX_STEPS = 8


def _batches(steps, seed=3):
    x, y = jax_synthetic(R * PER_RANK * MAX_STEPS, IN_SHAPE, seed=seed)
    xb, yb = batched_epoch(x, y, R, PER_RANK)
    return [(np.asarray(xb[:, s]), np.asarray(yb[:, s]))
            for s in range(steps)]


def _bits(t):
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.bfloat16: torch.int16}.get(
                                    t.dtype, t.dtype))


def _leaves(x):
    """Tensors of a nested tuple structure, in order."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [] if x is None else [x]


def _assert_same(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, i)
        assert torch.equal(_bits(x), _bits(y)), (what, i)


# --- unit level: the delivery queue against JAX, bitwise -------------------


def _unit_pair(D, wire=None):
    """The JAX and port states of a 1-neighbour queue over a 2-leaf arena
    ([4] + [2]), two ranks; the JAX one stacked under vmap."""
    params = {"a": jnp.zeros((4,)), "b": jnp.zeros((2,))}
    jspec = jax_arena.arena_spec(params)
    js = jax_events.EventState.init(params, JaxRing(2), jax_events.EventConfig(),
                                    arena=True, staleness=D,
                                    resident_wire=wire)
    js = js.replace(bufs=js.bufs[:1], pending=js.pending[:1],
                    edge_clock=js.edge_clock[:1],
                    buf_scales=None if js.buf_scales is None
                    else js.buf_scales[:1])
    js = jax.tree.map(lambda a: jnp.stack([a, a]), js)
    spec = arena_spec({"a": (4,), "b": (2,)})
    ts = convert.event_state_from_jax(jax.tree.map(np.asarray, js), spec)
    return js, jspec, ts, spec


def _commit_both(js, jspec, ts, spec, D, pass_num, cand, eff, lag,
                 delivered=True, scales=None):
    cand = np.asarray(cand)
    cand2 = np.stack([cand, cand[::-1].copy()])
    eff2 = np.stack([np.asarray(eff, bool)] * 2)
    lag2 = np.asarray([[lag], [lag]], np.int32)
    dl2 = np.asarray([[delivered], [delivered]], bool)
    sc2 = None if scales is None else np.stack([np.asarray(scales,
                                                           np.float32)] * 2)
    jfn = jax.vmap(lambda st, c, e, d, l, s: jax_events.async_delivery_commit(
        st, (c,), (e,), d, l, jnp.int32(pass_num), jspec, D,
        cand_scales=None if s is None else (s,)))
    jout = jfn(js, jnp.asarray(cand2), jnp.asarray(eff2), jnp.asarray(dl2),
               jnp.asarray(lag2), None if sc2 is None else jnp.asarray(sc2))
    tout = events.async_delivery_commit(
        ts, (torch.from_numpy(cand2),), (torch.from_numpy(eff2),),
        torch.from_numpy(dl2), torch.from_numpy(lag2), pass_num, spec, D,
        cand_scales=None if sc2 is None else (torch.from_numpy(sc2),))
    jnew, jbufs, jstale, jlate = jax.tree.map(np.asarray, jout)
    tnew, tbufs, tstale, tlate = tout
    assert np.array_equal(tstale.numpy(), jstale)
    assert np.array_equal(tlate.numpy(), jlate)
    jcarried = convert.event_state_from_jax(jnew, spec)
    for f in ("bufs", "pending", "edge_clock", "late_commits", "buf_scales"):
        _assert_same(getattr(tnew, f), getattr(jcarried, f), f)
    _assert_same(tbufs, tuple(convert.arena_from_jax(b, spec) for b in jbufs),
                 "visible bufs")
    return jout[0], tnew, tbufs, tstale, tlate


def test_commit_on_arrival_is_deferred_fire_bitwise():
    """A lag-3 message leaves the buffer untouched for two passes and
    commits at pass 4 as where(eff, payload, stale) — the JAX bits."""
    D = 3
    js, jspec, ts, spec = _unit_pair(D)
    payload = np.arange(6, dtype=np.float32) + 1.0
    js, ts, bufs, _, _ = _commit_both(js, jspec, ts, spec, D, 1, payload,
                                      [True, False], 3)
    assert not bufs[0].any()
    for p in (2, 3, 4):
        js, ts, bufs, _, late = _commit_both(js, jspec, ts, spec, D, p,
                                             np.zeros(6, np.float32),
                                             [False, False], 1)
    seg = spec.seg_expand()
    want = torch.where(torch.tensor([True, False])[seg],
                       torch.from_numpy(payload), torch.zeros(6))
    assert torch.equal(bufs[0][0], want)
    assert late.tolist() == [1, 1] and ts.late_commits.tolist() == [1, 1]


def test_clock_advance_and_staleness_gauge():
    D = 2
    js, jspec, ts, spec = _unit_pair(D)
    gauges = []
    for p in range(1, 6):
        js, ts, _, stale, _ = _commit_both(
            js, jspec, ts, spec, D, p, np.zeros(6, np.float32),
            [False, False], 1, delivered=p != 3)
        gauges.append(int(stale[0, 0]))
    assert gauges == [1, 1, 1, 2, 1]


def test_same_pass_merge_later_sent_wins():
    D = 2
    js, jspec, ts, spec = _unit_pair(D)
    old, new = np.full(6, 5.0, np.float32), np.full(6, 9.0, np.float32)
    js, ts, *_ = _commit_both(js, jspec, ts, spec, D, 1, old, [True, True], 2)
    js, ts, *_ = _commit_both(js, jspec, ts, spec, D, 2, new, [False, True], 1)
    js, ts, bufs, _, _ = _commit_both(js, jspec, ts, spec, D, 3,
                                      np.zeros(6, np.float32),
                                      [False, False], 1)
    assert bufs[0][0, :4].tolist() == [5.0] * 4
    assert bufs[0][0, 4:].tolist() == [9.0] * 2
    assert ts.late_commits.tolist() == [1, 1]


def test_int8_carrier_queue_scales_bitwise():
    """The int8 carrier's queue: per-slot scales ride with their payload
    and land beside it on arrival, bitwise JAX's."""
    D = 3
    js, jspec, ts, spec = _unit_pair(D, wire="int8")
    q = np.array([3, -7, 11, 127, -127, 5], np.int8)
    js, ts, *_ = _commit_both(js, jspec, ts, spec, D, 1, q, [True, True], 3,
                              scales=[0.25, 0.5])
    js, ts, *_ = _commit_both(js, jspec, ts, spec, D, 2, q[::-1].copy(),
                              [False, True], 1, scales=[0.125, 0.75])
    got = []
    for p in (3, 4):
        js, ts, bufs, _, _ = _commit_both(
            js, jspec, ts, spec, D, p, np.zeros(6, np.int8), [False, False],
            1, scales=[1.0, 1.0])
        got.append(ts.buf_scales[0][0].tolist())
    # pass 3 lands the pass-2 message (leaf b only), pass 4 the pass-1
    # message (both leaves), each with the scales it was sent with
    assert got == [[1.0, 0.75], [0.25, 0.5]]
    assert bufs[0].dtype == torch.int8


def test_lag_vector_and_table_clamp_at_the_bound():
    """lag_vector and lag_table equal the JAX ones, clamped to D; the
    unclamped table shows the raw f."""
    topo, jtopo = Ring(R), JaxRing(R)
    sched = ChaosSchedule(seed=0, slow=((2, 9),), lag=(LagWindow(5, 8, 3),))
    jsched = JaxChaos(seed=0, slow=((2, 9),), lag=(JaxLagWindow(5, 8, 3),))
    srcs = inject.rank_and_sources(topo)[1].numpy()
    for D in (2, 4):
        tab = inject.lag_table(sched, topo, 10, bound=D)
        assert np.array_equal(tab, jax_inject.lag_table(jsched, jtopo, 10,
                                                        bound=D))
        for p in range(1, 11):
            vec = inject.lag_vector(sched, topo, p, D).numpy()
            assert np.array_equal(vec, tab[p - 1])
            jvec = np.stack([np.asarray(jax_inject.lag_vector(
                jsched, jtopo, jnp.int32(p), bound=D,
                srcs=jnp.asarray(srcs[r]))) for r in range(R)])
            assert np.array_equal(vec, jvec)
        assert tab.max() == D
    raw = inject.lag_table(sched, topo, 10, bound=None)
    assert np.array_equal(raw, jax_inject.lag_table(jsched, jtopo, 10))
    assert raw.max() == 9 and raw[5, 0].min() >= 3


def test_schedule_round_trips_and_refusals():
    """The straggler clauses, and with them every clause of items 6a, 6b
    and 6d (membership, once refused), parse, print and serialize as the
    JAX schedule does."""
    spec = "drop=0,seed=5,lag=3-9@2,slow=1@7"
    s, js = ChaosSchedule.parse(spec), JaxChaos.parse(spec)
    assert s.to_spec() == js.to_spec() and s.to_dict() == js.to_dict()
    assert ChaosSchedule.from_dict(js.to_dict()) == s
    assert (s.has_lags, s.max_scheduled_lag()) == (js.has_lags,
                                                   js.max_scheduled_lag())
    for clause in ("drop=0.4", "flaky=1-5@0.5", "delay=3", "die=1@4",
                   "bitflip=1-5@0.5", "nanstep=1@3", "preempt=2@1",
                   "leave=1@3", "join=2@4:0"):
        spec = "seed=1," + clause
        s, js = ChaosSchedule.parse(spec), JaxChaos.parse(spec)
        assert s.to_spec() == js.to_spec() and s.to_dict() == js.to_dict()
        assert ChaosSchedule.from_dict(js.to_dict()) == s
        assert ChaosSchedule.parse(s.to_spec()) == s


# --- step level: the port against itself ------------------------------------


def _port_run(staleness, *, algo="eventgrad", chaos=None, gossip_wire="dense",
              wire=None, bucketed=None, carrier=False, steps=5):
    topo, model = Ring(R), _port_model()
    cfg = events.EventConfig(**CFG)
    state = init_train_state(model, IN_SHAPE, topo, algo, cfg, seed=0,
                             resident_wire=wire if carrier else None,
                             bucketed=bucketed, staleness=staleness,
                             device="cpu")
    if chaos is not None:
        state = state.replace(chaos=monitor.PeerHealth.init(topo))
    spec = arena_spec(model)
    cap = None
    if gossip_wire == "compact":
        cap = (collectives.bucketed_capacity_floor(spec.buckets(bucketed))
               if bucketed else spec.n_total)
    step = make_train_step(model, topo, algo, cfg, fused_sgd=(LR, 0.0),
                           staleness=staleness, chaos=chaos,
                           gossip_wire=gossip_wire, compact_capacity=cap,
                           wire=wire, bucketed=bucketed,
                           carrier_resident=carrier)
    m = None
    for x, y in _batches(steps):
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y).long()))
    return state, m


def _assert_state_bitwise(s1, s2, fields=("thres", "last_sent_norm", "slopes",
                                          "num_events", "num_deferred",
                                          "bufs", "buf_scales")):
    _assert_same(s1.params, s2.params, "params")
    for f in fields:
        _assert_same(getattr(s1.event, f), getattr(s2.event, f), f)


COMPOSED = {
    "masked-f32": dict(),
    "compact-f32": dict(gossip_wire="compact"),
    "masked-int8": dict(wire="int8"),
    "b4-masked-f32": dict(bucketed=4),
    "b4-compact-f32": dict(bucketed=4, gossip_wire="compact"),
    "b4-masked-int8-carrier": dict(bucketed=4, wire="int8", carrier=True),
    "b4-compact-int8-carrier": dict(bucketed=4, gossip_wire="compact",
                                    wire="int8", carrier=True),
    "masked-int8-carrier": dict(wire="int8", carrier=True),
    "compact-int8-carrier": dict(gossip_wire="compact", wire="int8",
                                 carrier=True),
    "compact-bf16-carrier": dict(gossip_wire="compact", wire="bf16",
                                 carrier=True),
}


@pytest.mark.parametrize("name", sorted(COMPOSED))
def test_baseline_lag_reproduces_staleness1_bitwise(name):
    """D = 2 and D = 4 with no lag schedule == staleness 1 bitwise:
    parameters, trigger state and every shared metric; the queue adds
    only its two metrics. The resident buffers and scales hold what the
    mix reads next: at D >= 2 the messages of passes up to p - 1 (pass
    p's wait in slot 0), so they equal staleness 1's one pass earlier
    (staleness 1 commits pass p's and mixes the pre-commit copy)."""
    kw = COMPOSED[name]
    s1, m1 = _port_run(1, **kw)
    s1_prev, _ = _port_run(1, steps=4, **kw)
    for D in (2, 4):
        sd, md = _port_run(D, **kw)
        _assert_state_bitwise(s1, sd, fields=(
            "thres", "last_sent_norm", "slopes", "num_events",
            "num_deferred"))
        for f in ("bufs", "buf_scales"):
            _assert_same(getattr(s1_prev.event, f), getattr(sd.event, f), f)
        for k in m1:
            _assert_same(m1[k], md[k], k)
        assert set(md) - set(m1) == {"edge_staleness", "late_commits"}
        assert int(md["late_commits"].sum()) == 0
        assert int(md["edge_staleness"].max()) <= 1
        if kw.get("carrier"):
            assert all(b.dtype == torch.int8 or b.dtype == torch.bfloat16
                       for b in _leaves(sd.event.bufs))


@pytest.mark.parametrize("bucketed,wire", [(None, None), (4, "int8")])
def test_sp_payload_queue_baseline_matches_staleness1(bucketed, wire):
    """sparsified EventGraD at D = 2 through its payload queues ==
    staleness 1: the mix reads the same replicas, so parameters and every
    metric agree bitwise."""
    s1, m1 = _port_run(1, algo="sp_eventgrad", bucketed=bucketed, wire=wire)
    s2, m2 = _port_run(2, algo="sp_eventgrad", bucketed=bucketed, wire=wire)
    _assert_same(s1.params, s2.params, "params")
    for k in m1:
        _assert_same(m1[k], m2[k], k)
    assert s2.sparse.pending is not None and len(s2.sparse.pending[0]) == 2


# --- the straggler against the JAX step --------------------------------------


STRAGGLER = dict(gossip_wire="compact", wire="int8", bucketed=4,
                 carrier=True)


@pytest.fixture(scope="module")
def straggler_passes():
    """Per pass of the composed stack under slow=(1, 7) at D = 4: the JAX
    state and metrics after it, and the port's step from the carried JAX
    state before it."""
    D, steps = 4, 8
    jtopo, topo = JaxRing(R), Ring(R)
    jsched = JaxChaos(seed=5, slow=((1, 7),))
    sched = ChaosSchedule(seed=5, slow=((1, 7),))
    jmodel, model = JaxMLP(hidden=HIDDEN), _port_model()
    spec = arena_spec(model)
    tx = optax.sgd(LR)
    jcfg, cfg = jax_events.EventConfig(**CFG), events.EventConfig(**CFG)
    jstate = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, "eventgrad", jcfg,
                            seed=0, arena=True, staleness=D, bucketed=4,
                            resident_wire="int8")
    jstate = jstate.replace(chaos=stack_for_ranks(
        jax_monitor.PeerHealth.init(jtopo), jtopo))
    jspec = jax_arena.arena_spec(jax.tree.map(lambda a: a[0], jstate.params))
    cap = int(jax_coll.bucketed_capacity_floor(jspec.buckets(4)))
    assert cap == collectives.bucketed_capacity_floor(spec.buckets(4))
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, "eventgrad", jcfg, arena=True, staleness=D,
        chaos=jsched, gossip_wire="compact", compact_capacity=cap,
        wire="int8", bucketed=4, carrier_resident=True), jtopo))
    tstep = make_train_step(model, topo, "eventgrad", cfg, fused_sgd=(LR, 0.0),
                            staleness=D, chaos=sched, gossip_wire="compact",
                            compact_capacity=cap, wire="int8", bucketed=4,
                            carrier_resident=True)
    out = []
    for x, y in _batches(steps):
        js = jax.tree.map(np.asarray, jstate)
        tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                         stacked=True)
        tstate = TrainState(
            params=spec.ravel(tp), trace=None, batch_stats=ts,
            pass_num=int(js.pass_num[0]),
            event=convert.event_state_from_jax(js.event, spec),
            chaos=monitor.PeerHealth(
                silence=torch.from_numpy(np.array(js.chaos.silence)),
                sync_req=torch.from_numpy(np.array(js.chaos.sync_req)),
                drops=torch.from_numpy(np.array(js.chaos.drops))))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        out.append((jax.tree.map(np.asarray, jstate),
                    jax.tree.map(np.asarray, jm), tstate,
                    {k: v.numpy() for k, v in tm.items()}))
    return spec, out


def test_straggler_matches_jax(straggler_passes):
    spec, passes = straggler_passes
    for p, (js, jm, ts, tm) in enumerate(passes, start=1):
        w = f"pass {p}"
        assert set(tm) == set(jm), w
        for k in ("edge_staleness", "late_commits", "edge_silence",
                  "chaos_drops", "sent_bytes", "sent_bytes_wire_real",
                  "sent_bytes_wire_real_per_bucket", "fired_elems",
                  "num_events", "num_deferred", "fired_frac"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{w} {k}")
        tp, _ = convert.params_from_jax(js.params, stacked=True)
        np.testing.assert_allclose(ts.params.numpy(),
                                   spec.ravel(tp).numpy(), err_msg=w, **TOL)
        jev = convert.event_state_from_jax(js.event, spec)
        for f in ("bufs", "buf_scales", "pending", "edge_clock",
                  "late_commits", "num_events"):
            _assert_same(getattr(ts.event, f), getattr(jev, f), f"{w} {f}")
    last = passes[-1][3]
    es = last["edge_staleness"]
    assert es.max() == 4 and int(last["late_commits"].sum()) > 0
    # only rank 1's two ring neighbours see stale edges
    assert set(np.argwhere(es == 4)[:, 0].tolist()) == {0, 2}


def test_straggler_clamps_and_replays_bitwise():
    """Free-running: the gauge plateaus at D on the edges rank 1 feeds,
    late commits accrue, and a rerun replays every bit."""
    sched = ChaosSchedule(seed=5, slow=((1, 7),))
    for D in (2, 4):
        sa, ma = _port_run(D, chaos=sched, steps=8)
        assert int(ma["edge_staleness"].max()) == D
        assert int(ma["late_commits"].sum()) > 0
        assert set(torch.nonzero(ma["edge_staleness"] == D)[:, 0].tolist()) \
            == {0, 2}
    sa, ma = _port_run(4, chaos=sched, steps=8, **STRAGGLER)
    sb, mb = _port_run(4, chaos=sched, steps=8, **STRAGGLER)
    _assert_state_bitwise(sa, sb, fields=("bufs", "buf_scales", "pending",
                                          "edge_clock", "late_commits"))
    for k in ma:
        _assert_same(ma[k], mb[k], k)


# --- guards ----------------------------------------------------------------


def test_bounded_async_guards():
    """The JAX step's and loop's D >= 2 and chaos guards raise ValueError
    in the port; the fused-tail guard does not carry over (the port's
    tail is the kernels)."""
    topo, model = Ring(R), _port_model()
    kw = dict(fused_sgd=(LR, 0.0))
    with pytest.raises(ValueError, match="staleness"):
        make_train_step(model, topo, "eventgrad", staleness=-1, **kw)
    with pytest.raises(ValueError, match="event"):
        make_train_step(model, topo, "dpsgd", staleness=2, **kw)
    with pytest.raises(ValueError, match="trace"):
        make_train_step(model, topo, "eventgrad", staleness=2, trace=True,
                        **kw)
    with pytest.raises(ValueError, match="dpsgd, eventgrad"):
        make_train_step(model, topo, "sp_eventgrad", staleness=2,
                        chaos="slow=1@3", **kw)
    make_train_step(model, topo, "eventgrad", staleness=2, **kw)
    x, y = jax_synthetic(64, IN_SHAPE, seed=3)
    with pytest.raises(ValueError, match="event"):
        train(_port_model(), topo, x, y, algo="allreduce", epochs=1,
              batch_size=4, staleness=2, device="cpu")
    with pytest.raises(ValueError, match="dpsgd, eventgrad"):
        train(_port_model(), topo, x, y, algo="sp_eventgrad", epochs=1,
              batch_size=4, staleness=2, chaos="slow=1@3", device="cpu")
    # a chaos step needs the state's peer health
    state = init_train_state(model, IN_SHAPE, topo, "eventgrad",
                             events.EventConfig(**CFG), device="cpu",
                             staleness=2)
    step = make_train_step(model, topo, "eventgrad", events.EventConfig(**CFG),
                           staleness=2, chaos="slow=1@3", **kw)
    x0, y0 = _batches(1)[0]
    with pytest.raises(ValueError, match="PeerHealth"):
        step(state, (torch.from_numpy(x0), torch.from_numpy(y0).long()))


def test_train_records_the_straggler_run():
    """train() through the composed stack: the records carry the JAX
    records' keys for it, and the schedule rides the first record."""
    x, y = jax_synthetic(R * PER_RANK * 4, IN_SHAPE, seed=3)
    _, hist = train(_port_model(), Ring(R), x, y, algo="eventgrad", epochs=2,
                    batch_size=PER_RANK, learning_rate=LR,
                    event_cfg=events.EventConfig(**CFG), staleness=4,
                    gossip_wire="compact", compact_frac=0.5, wire="int8",
                    carrier_resident=True, bucketed=4,
                    chaos="seed=5,slow=1@7", device="cpu")
    first, last = hist
    assert first["chaos"] == JaxChaos.parse("seed=5,slow=1@7").to_dict()
    assert last["edge_staleness_max"] == 4 and last["late_commits"] > 0
    assert last["buckets"] == 4 and last["chaos_drops"] == 0
    assert last["edge_status"] == ["healthy", "healthy"]
    assert sum(last["sent_bytes_wire_real_per_bucket"]) == \
        last["sent_bytes_wire_real_per_step_per_chip"]
