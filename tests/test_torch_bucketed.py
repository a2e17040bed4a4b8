"""The port's bucketed gossip schedule against its monolithic schedule
and against the JAX package's bucketed step.

The contracts, as `tests/test_bucketed.py` states them for the JAX
package:

  * bucketed == monolithic, port against port, bitwise, for K in {2, 4}:
    the full state (parameters, momentum trace, trigger state, receive
    buffers and scales, top-k shadows and replicas) and every metric
    after 5 passes, on the JAX matrix's cases that need no engine the
    port lacks (masked f32 / int8 / bf16 + staleness 1 / momentum,
    compact f32 at full capacity, compact + staleness 1, sp f32, sp int8
    + staleness 1); the per-bucket wire metric sums to the total;
  * the port's bucketed step against the JAX bucketed step: before
    every pass the JAX state is carried into the port
    (`convert.event_state_from_jax`, the per-bucket buffers included),
    both take the same batch; parameters within rtol=1e-4, atol=1e-5
    (float32; sums reduce in another order, and the JAX tail is optax's
    where the port runs kernel 1), the receive buffers and int8 scales
    bitwise, fire bits, counters and byte metrics equal, the thresholds
    within rtol=1e-6 (a refreshed threshold is the mean of slopes of leaf
    norms, which torch reduces in another order) — also on the
    compact wire below full capacity, where deferral re-contends within
    each bucket;
  * the bucket geometry, `split_capacity`, `bucketed_capacity_floor`
    and `bucketed_wire_real_bytes_per_neighbor` equal the JAX ones
    exactly, and the per-bucket bytes sum to the monolithic bytes;
  * the pitched forms of kernels 1, 2, 3 and 5 (here their plain
    versions) are bitwise the contiguous forms' columns;
  * the bucketed guards raise ValueError as the JAX step's do;
  * the bucketed schedule under the fault clauses (drop, flaky, delay,
    die, nanstep, the forced sync and the edge freeze; f32, bf16 and int8
    wires, the int8 carrier, D = 2): K = 2 and 4 bitwise the monolithic
    step over 8 passes (the state, NaNs by their bits, and every
    metric); the gated pitched forms of kernels 1 and 5 (their plain
    versions) bitwise the gated whole-arena forms' columns; and the
    port's bucketed step under faults against the JAX bucketed step from
    the carried JAX state, within `tests/test_torch_chaos.py`'s
    tolerance (parameters rtol=1e-4, atol=1e-5, NaNs equal; silence,
    sync requests, drops, byte and event counts exact; the receive
    buffers and scales bitwise).

MLP (hidden 16, 8x8 inputs), Ring(4), 4 samples per rank, float32 on
both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.chaos import monitor as jax_monitor
from eventgrad_tpu.chaos import policy as jax_policy
from eventgrad_tpu.chaos.schedule import ChaosSchedule as JaxChaos
from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel import arena as jax_arena
from eventgrad_tpu.parallel import collectives as jax_coll
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.ops import arena_update, event_engine
from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
R, IN_SHAPE, PER_RANK, LR = 4, (8, 8, 1), 4, 0.05
CFG = dict(adaptive=True, horizon=0.95, warmup_passes=2, max_silence=4)
HIDDEN = 16
#: the MLP's element count: a compact capacity that binds no bucket
FULL_CAPACITY = 1210


def _model():
    return MLP(hidden=HIDDEN, input_shape=IN_SHAPE, device="cpu")


def _batches(steps, seed=0):
    x, y = jax_synthetic(R * PER_RANK * steps, IN_SHAPE, seed=seed)
    x = x.reshape((steps, R, PER_RANK) + IN_SHAPE)
    y = y.reshape((steps, R, PER_RANK))
    return [(x[i], y[i]) for i in range(steps)]


def _bits(t):
    return t.contiguous().view({torch.float32: torch.int32,
                                torch.bfloat16: torch.int16}.get(
                                    t.dtype, t.dtype))


def _flat_bufs(bufs):
    """Per-neighbour flat view of either layout."""
    return [torch.cat(b, dim=-1) if isinstance(b, tuple) else b for b in bufs]


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), what


def _port_run(algo, bucketed, *, wire=None, gossip_wire="dense",
              capacity=None, staleness=0, momentum=0.0, steps=5):
    topo, model = Ring(R), _model()
    cfg = EventConfig(**CFG)
    state = init_train_state(model, IN_SHAPE, topo, algo, cfg, seed=0,
                             momentum=momentum, bucketed=bucketed,
                             device="cpu")
    step = make_train_step(model, topo, algo, cfg, fused_sgd=(LR, momentum),
                           wire=wire, gossip_wire=gossip_wire,
                           compact_capacity=capacity, staleness=staleness,
                           bucketed=bucketed)
    m = None
    for x, y in _batches(steps):
        state, m = step(state, (torch.from_numpy(x),
                                torch.from_numpy(y).long()))
    return state, m


#: the JAX matrix's cases the port runs (tests/test_bucketed.py CASES)
CASES = {
    "event_masked_f32": dict(algo="eventgrad"),
    "event_masked_int8": dict(algo="eventgrad", wire="int8"),
    "event_masked_bf16_stale": dict(algo="eventgrad", wire="bf16",
                                    staleness=1),
    "event_masked_mom": dict(algo="eventgrad", momentum=0.9),
    "event_compact_f32": dict(algo="eventgrad", gossip_wire="compact",
                              capacity=FULL_CAPACITY),
    "event_compact_stale": dict(algo="eventgrad", gossip_wire="compact",
                                capacity=FULL_CAPACITY, staleness=1),
    "sp_f32": dict(algo="sp_eventgrad"),
    "sp_int8_stale": dict(algo="sp_eventgrad", wire="int8", staleness=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bucketed_bitwise_matches_monolithic(name):
    kw = dict(CASES[name])
    algo = kw.pop("algo")
    s_m, m_m = _port_run(algo, None, **kw)
    for K in (2, 4):
        s_b, m_b = _port_run(algo, K, **kw)
        _same(s_m.params, s_b.params, "params")
        if s_m.trace is not None:
            _same(s_m.trace, s_b.trace, "trace")
        for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes",
                  "num_events", "num_deferred"):
            _same(getattr(s_m.event, f), getattr(s_b.event, f), f)
        for i, (bm, bb) in enumerate(zip(_flat_bufs(s_m.event.bufs),
                                         _flat_bufs(s_b.event.bufs))):
            _same(bm, bb, f"bufs[{i}]")
        if algo == "sp_eventgrad":
            _same(s_m.sparse.prev_sent, s_b.sparse.prev_sent, "prev_sent")
            for rm, rb in zip(s_m.sparse.replicas, s_b.sparse.replicas):
                _same(rm, rb, "replicas")
        for k in m_m:
            _same(m_m[k], m_b[k], k)
        assert set(m_b) - set(m_m) == {"sent_bytes_wire_real_per_bucket"}
        per = m_b["sent_bytes_wire_real_per_bucket"]
        assert per.shape == (R, K)
        np.testing.assert_array_equal(per.sum(-1).numpy(),
                                      m_b["sent_bytes_wire_real"].numpy())


def test_carrier_bucketed_bitwise_matches_monolithic():
    """The int8 carrier: per-bucket carriers and scales, bitwise the
    monolithic carrier buffers and scales, and the parameters."""
    out = {}
    for K in (None, 4):
        topo, model = Ring(R), _model()
        cfg = EventConfig(**CFG)
        state = init_train_state(model, IN_SHAPE, topo, "eventgrad", cfg,
                                 resident_wire="int8", bucketed=K,
                                 device="cpu")
        step = make_train_step(model, topo, "eventgrad", cfg,
                               fused_sgd=(LR, 0.0), wire="int8",
                               carrier_resident=True, bucketed=K)
        for x, y in _batches(5):
            state, _ = step(state, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        out[K] = state
    spec = arena_spec(_model())
    _same(out[None].params, out[4].params, "params")
    for bm, bb in zip(out[None].event.bufs, _flat_bufs(out[4].event.bufs)):
        _same(bm, bb, "carrier bufs")
    for sm, sb in zip(out[None].event.buf_scales, out[4].event.buf_scales):
        _same(sm, torch.cat(sb, dim=-1), "scales")
    deq_m = collectives.dequant_carrier_bufs(out[None].event.bufs,
                                             out[None].event.buf_scales, spec)
    deq_b = collectives.dequant_carrier_bufs(out[4].event.bufs,
                                             out[4].event.buf_scales, spec)
    for a, b in zip(deq_m, _flat_bufs(deq_b)):
        _same(a, b, "dequantized")


# --- the port's bucketed step against the JAX bucketed step -----------------


JAX_CASES = {
    "masked_f32_k4": dict(),
    "masked_int8_k2": dict(wire="int8", K=2),
    "compact_f32_below_full_k2": dict(gossip_wire="compact", K=2),
    "compact_int8_below_full_k2": dict(gossip_wire="compact", wire="int8",
                                       K=2),
}


def _jax_vs_port(wire=None, gossip_wire="dense", K=4, steps=4):
    jtopo, topo = JaxRing(R), Ring(R)
    jmodel, model = JaxMLP(hidden=HIDDEN), _model()
    spec = arena_spec(model)
    tx = optax.sgd(LR)
    jcfg, cfg = JaxEventConfig(**CFG), EventConfig(**CFG)
    jstate = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, "eventgrad", jcfg,
                            seed=0, arena=True, bucketed=K)
    cap = None
    if gossip_wire == "compact":
        # binding: the bucketed floor, well under the element count
        cap = collectives.bucketed_capacity_floor(spec.buckets(K))
        assert cap < spec.n_total
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, "eventgrad", jcfg, arena=True, bucketed=K,
        wire=wire, gossip_wire=gossip_wire, compact_capacity=cap), jtopo))
    tstep = make_train_step(model, topo, "eventgrad", cfg,
                            fused_sgd=(LR, 0.0), bucketed=K, wire=wire,
                            gossip_wire=gossip_wire, compact_capacity=cap)
    out = []
    for x, y in _batches(steps, seed=1):
        js = jax.tree.map(np.asarray, jstate)
        tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                         stacked=True)
        tstate = TrainState(params=spec.ravel(tp), trace=None,
                            batch_stats=ts, pass_num=int(js.pass_num[0]),
                            event=convert.event_state_from_jax(js.event,
                                                               spec))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        out.append((jax.tree.map(np.asarray, jstate),
                    jax.tree.map(np.asarray, jm), tstate,
                    {k: v.numpy() for k, v in tm.items()}))
    return spec, out


@pytest.mark.parametrize("name", sorted(JAX_CASES))
def test_bucketed_step_matches_jax(name):
    kw = dict(JAX_CASES[name])
    spec, passes = _jax_vs_port(**kw)
    deferred = 0
    for p, (js, jm, ts, tm) in enumerate(passes, start=1):
        w = f"{name} pass {p}"
        assert set(tm) == set(jm), w
        for k in ("sent_bytes", "sent_bytes_wire_real",
                  "sent_bytes_wire_real_per_bucket", "fired_elems",
                  "num_events", "num_deferred", "fired_frac"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{w} {k}")
        np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
        tp, _ = convert.params_from_jax(js.params, stacked=True)
        np.testing.assert_allclose(ts.params.numpy(),
                                   spec.ravel(tp).numpy(), err_msg=w, **TOL)
        jev = convert.event_state_from_jax(js.event, spec)
        for f in ("last_sent_iter", "num_events", "num_deferred"):
            np.testing.assert_array_equal(getattr(ts.event, f).numpy(),
                                          getattr(jev, f).numpy(),
                                          err_msg=f"{w} {f}")
        # the leaf norms reduce in another order (events.leaf_norms), so
        # a refreshed threshold may sit an ulp off
        np.testing.assert_allclose(ts.event.thres.numpy(),
                                   jev.thres.numpy(), rtol=1e-6,
                                   err_msg=f"{w} thres")
        for i, (tb, jb) in enumerate(zip(ts.event.bufs, jev.bufs)):
            for b, (x, y) in enumerate(zip(tb, jb)):
                _same(x, y, f"{w} bufs[{i}][{b}]")
        deferred = int(tm["num_deferred"].sum())
    if kw.get("gossip_wire") == "compact":
        # the binding budget defers within the buckets
        assert deferred > 0


def test_bucket_geometry_and_capacity_match_jax():
    """Buckets, the capacity split and floor, and the per-bucket wire
    bytes equal the JAX package's; the per-bucket bytes sum to the
    monolithic bytes exactly."""
    tree = {f"l{i:02d}": jnp.zeros((s,), jnp.float32)
            for i, s in enumerate((1024, 16, 160, 10, 300, 7))}
    jspec = jax_arena.arena_spec(tree)
    spec = arena_spec({k: (v.shape[0],) for k, v in tree.items()})
    for k in (1, 2, 3, 4, 6, 9):
        jb, tb = jspec.buckets(k), spec.buckets(k)
        assert [(b.lo, b.hi, b.start, b.size, b.floor) for b in jb] == \
            [(b.lo, b.hi, b.start, b.size, b.floor) for b in tb]
        for b in tb:
            np.testing.assert_array_equal(
                b.seg_expand().numpy(),
                np.asarray(jb[b.index].seg_expand()))
        floor = collectives.bucketed_capacity_floor(tb)
        assert floor == jax_coll.bucketed_capacity_floor(jb)
        for cap in (floor, floor + 37, spec.n_total - 1, spec.n_total):
            if cap < floor:
                continue
            caps = collectives.split_capacity(cap, tb)
            assert caps == jax_coll.split_capacity(cap, jb)
            assert sum(caps) == cap
        with pytest.raises(ValueError, match="bucketed floor"):
            collectives.split_capacity(floor - 1, tb)
        for wire in (None, "bf16", "int8"):
            for caps in (None, collectives.split_capacity(spec.n_total, tb)):
                per = collectives.bucketed_wire_real_bytes_per_neighbor(
                    tb, wire, caps)
                assert per == jax_coll.bucketed_wire_real_bytes_per_neighbor(
                    jb, wire, caps)
                assert sum(per) == collectives.wire_real_bytes_per_neighbor(
                    spec.n_total, spec.n_leaves, wire, fire_bits=True,
                    compact_capacity=None if caps is None else spec.n_total)


def test_pitched_forms_are_the_contiguous_columns():
    """On a bucket's columns the pitched forms of kernels 1, 2, 3 and 5
    (their plain versions on the CPU) give the contiguous forms' bits;
    p', t' land in the bucket's columns of the output arenas and nothing
    else is written."""
    g = torch.Generator().manual_seed(0)
    n, off, c = 41, 7, 19
    rn = lambda *s: torch.randn(*s, generator=g)
    bits = lambda *s: (torch.rand(*s, generator=g) < 0.5).float()
    flat, fire, scale = rn(R, n), bits(R, n), torch.rand(R, n, generator=g)
    cols = lambda x: x[:, off:off + c].contiguous()
    _same(event_engine.masked_wire(flat, cols(fire), off=off),
          cols(event_engine.masked_wire(flat, fire)), "masked wire")
    _same(event_engine.masked_wire(flat, cols(fire), cols(scale), off=off),
          cols(event_engine.masked_wire(flat, fire, scale)), "int8 wire")
    p, gr, t = rn(R, n), rn(R, n), rn(R, n)
    cands, keeps, lasts = ((rn(R, n), rn(R, n)), (bits(R, n), bits(R, n)),
                           (rn(R, n), rn(R, n)))
    for stale in (False, True):
        whole = arena_update.fused_mix_commit(p, cands, keeps, lasts, gr, t,
                                              0.01, 0.9, 1 / 3, stale)
        out = (torch.full((R, n), 7.0), torch.full((R, n), 7.0))
        po, to, bufs = arena_update.fused_mix_commit(
            p, tuple(map(cols, cands)), tuple(map(cols, keeps)),
            tuple(map(cols, lasts)), gr, t, 0.01, 0.9, 1 / 3, stale,
            off=off, out=out)
        assert po is out[0] and to is out[1]
        _same(cols(po), cols(whole[0]), "p'")
        _same(cols(to), cols(whole[1]), "t'")
        assert (po[:, :off] == 7).all() and (po[:, off + c:] == 7).all()
        for a, b in zip(bufs, whole[2]):
            _same(a, cols(b), "bufs")
        q = lambda: torch.randint(-127, 128, (R, n), generator=g,
                                  dtype=torch.int8)
        cq, lq, sc = (q(), q()), (q(), q()), (rn(R, n), rn(R, n))
        whole = arena_update.fused_mix_commit_carrier(
            p, cq, keeps, lq, gr, t, 0.01, 0.9, 1 / 3, mix_scales=sc,
            mix_stale=stale)
        po, to, bufs = arena_update.fused_mix_commit_carrier(
            p, tuple(map(cols, cq)), tuple(map(cols, keeps)),
            tuple(map(cols, lq)), gr, t, 0.01, 0.9, 1 / 3,
            mix_scales=tuple(map(cols, sc)), mix_stale=stale, off=off,
            out=(torch.zeros(R, n), torch.zeros(R, n)))
        _same(cols(po), cols(whole[0]), "carrier p'")
        for a, b in zip(bufs, whole[2]):
            _same(a, cols(b), "carrier bufs")
    with pytest.raises(ValueError, match="outside the arena row"):
        event_engine.masked_wire(flat, cols(fire), off=n - c + 1)


def test_mix_carrier_flat_into_tree_matches_jax():
    """The plain carrier mix, per leaf, equals the JAX function's."""
    jspec = jax_arena.arena_spec({"a": jnp.zeros((3, 4)),
                                  "b": jnp.zeros((5,))})
    spec = arena_spec({"a": (3, 4), "b": (5,)})
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    bufs = tuple(rng.integers(-127, 128, 17).astype(np.int8)
                 for _ in range(2))
    scales = tuple(rng.random(2).astype(np.float32) for _ in range(2))
    jout = jax_coll.mix_carrier_flat_into_tree(
        {k: jnp.asarray(v) for k, v in params.items()},
        tuple(map(jnp.asarray, bufs)), tuple(map(jnp.asarray, scales)),
        jspec, JaxRing(3))
    tout = collectives.mix_carrier_flat_into_tree(
        {k: torch.from_numpy(v)[None] for k, v in params.items()},
        tuple(torch.from_numpy(b)[None] for b in bufs),
        tuple(torch.from_numpy(s)[None] for s in scales), spec, Ring(3))
    for k in params:
        _same(tout[k][0], torch.from_numpy(np.array(jout[k])), k)


def test_bucketed_guards():
    topo, model = Ring(R), _model()
    kw = dict(fused_sgd=(LR, 0.0))
    with pytest.raises(ValueError, match="eventgrad, sp_eventgrad"):
        make_train_step(model, topo, "dpsgd", bucketed=2, **kw)
    with pytest.raises(ValueError, match="bucketed must be"):
        make_train_step(model, topo, "eventgrad", bucketed=-1, **kw)
    with pytest.raises(ValueError, match="bucketed floor"):
        make_train_step(model, topo, "eventgrad", bucketed=4,
                        gossip_wire="compact", compact_capacity=1024, **kw)
    # the JAX loop's demotion to the monolithic tail does not carry over:
    # the fused bucketed step builds
    make_train_step(model, topo, "eventgrad", bucketed=4, **kw)


# --- the bucketed schedule under the fault clauses ---------------------------


#: (chaos spec, recovery policy, step keywords): drops, a flaky window, a
#: death early enough to freeze its edges, delay phases, nansteps (not on
#: a carrier, which refuses them), the forced sync
FAULT_CASES = {
    "f32_drop_flaky_die_sync_freeze": (
        "drop=0.3,seed=2,flaky=3-5@0.9,die=2@2",
        dict(sync_after=5, freeze_after=6), {}),
    "f32_delay_nanstep_freeze": (
        "drop=0.2,seed=4,delay=2,nanstep=1@3",
        dict(freeze_after=6), {}),
    "f32_momentum_drop_nanstep": (
        "drop=0.25,seed=7,nanstep=3@6", None, dict(momentum=0.9)),
    "bf16_die_nanstep_freeze": (
        "drop=0.3,seed=5,die=1@3,nanstep=2@5",
        dict(freeze_after=6), dict(wire="bf16")),
    "bf16_drop_die_sync_freeze": (
        "drop=0.3,seed=9,die=1@3", dict(sync_after=5, freeze_after=6),
        dict(wire="bf16")),
    "int8_drop_die_sync_freeze": (
        "drop=0.3,seed=6,die=3@2", dict(sync_after=5, freeze_after=6),
        dict(wire="int8")),
    "int8_carrier_drop_die_freeze": (
        "drop=0.3,seed=8,die=0@3,delay=3", dict(freeze_after=6),
        dict(wire="int8", carrier=True)),
    "f32_stale2_drop_die_slow": (
        "drop=0.3,seed=3,die=2@2,slow=1@3", dict(freeze_after=6),
        dict(staleness=2)),
}


def _fault_run(K, spec, pol, *, wire=None, carrier=False, staleness=0,
               momentum=0.0, steps=8):
    topo, model = Ring(R), _model()
    cfg = EventConfig(**CFG)
    state = init_train_state(model, IN_SHAPE, topo, "eventgrad", cfg,
                             seed=0, momentum=momentum, bucketed=K,
                             staleness=staleness,
                             resident_wire=wire if carrier else None,
                             device="cpu")
    state = state.replace(chaos=PeerHealth.init(topo, "cpu"))
    step = make_train_step(
        model, topo, "eventgrad", cfg, fused_sgd=(LR, momentum), wire=wire,
        carrier_resident=carrier, staleness=staleness, bucketed=K,
        chaos=spec, chaos_policy=None if pol is None
        else RecoveryPolicy(**pol), n_passes=steps)
    ms = []
    for x, y in _batches(steps):
        state, m = step(state, (torch.from_numpy(x),
                                torch.from_numpy(y).long()))
        ms.append(m)
    return state, ms


def _flat_pending(pending):
    return [x for edge in pending for slot in edge for x in
            (torch.cat(v, dim=-1) if isinstance(v, tuple) else v
             for v in slot)]


@pytest.mark.parametrize("name", sorted(FAULT_CASES))
def test_bucketed_under_faults_bitwise_matches_monolithic(name):
    spec, pol, kw = FAULT_CASES[name]
    s_m, ms_m = _fault_run(None, spec, pol, **kw)
    for K in (2, 4):
        s_b, ms_b = _fault_run(K, spec, pol, **kw)
        w = f"{name} K={K}"
        _same(s_m.params, s_b.params, f"{w} params")
        if s_m.trace is not None:
            _same(s_m.trace, s_b.trace, f"{w} trace")
        for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes",
                  "num_events", "num_deferred"):
            _same(getattr(s_m.event, f), getattr(s_b.event, f), f"{w} {f}")
        for i, (bm, bb) in enumerate(zip(_flat_bufs(s_m.event.bufs),
                                         _flat_bufs(s_b.event.bufs))):
            _same(bm, bb, f"{w} bufs[{i}]")
        if s_m.event.buf_scales is not None:
            for sm, sb in zip(s_m.event.buf_scales,
                              _flat_bufs(s_b.event.buf_scales)):
                _same(sm, sb, f"{w} scales")
        if s_m.event.pending is not None:
            for a, b in zip(_flat_pending(s_m.event.pending),
                            _flat_pending(s_b.event.pending)):
                _same(a, b, f"{w} pending")
        for f in ("silence", "sync_req", "drops"):
            _same(getattr(s_m.chaos, f), getattr(s_b.chaos, f), f"{w} {f}")
        for p, (mm, mb) in enumerate(zip(ms_m, ms_b), start=1):
            for k in mm:
                _same(mm[k], mb[k], f"{w} pass {p} {k}")
    # the faults landed: drops were counted, and the freeze or the
    # nanstep reached the state
    assert int(s_m.chaos.drops.sum()) > 0
    if pol and pol.get("freeze_after"):
        assert int(s_m.chaos.silence.max()) >= pol["freeze_after"]
    if "nanstep" in spec:
        assert torch.isnan(s_m.params).any()


def test_gated_pitched_forms_are_the_gated_columns():
    """The gated pitched forms of kernels 1 and 5 (their plain versions)
    give the gated whole-arena forms' bits on a bucket's columns."""
    g = torch.Generator().manual_seed(1)
    n, off, c = 41, 7, 19
    rn = lambda *s: torch.randn(*s, generator=g)
    bits = lambda *s: (torch.rand(*s, generator=g) < 0.5).float()
    cols = lambda x: x[:, off:off + c].contiguous()
    gate = torch.ones((R, 2), dtype=torch.bool)
    gate[1, 0] = gate[2, 1] = False
    gkw = dict(w_rows=collectives.mix_weights(gate), gate=gate)
    poison = torch.ones(R)
    poison[3] = float("nan")
    quar = torch.zeros(R, dtype=torch.bool)
    quar[0] = True
    p, gr, t = rn(R, n), rn(R, n), rn(R, n)
    cands, keeps, lasts = ((rn(R, n), rn(R, n)), (bits(R, n), bits(R, n)),
                           (rn(R, n), rn(R, n)))
    for stale in (False, True):
        kw = dict(gkw, poison=poison, quar=quar)
        whole = arena_update.fused_mix_commit(p, cands, keeps, lasts, gr, t,
                                              0.01, 0.9, 1 / 3, stale, **kw)
        po, to, bufs = arena_update.fused_mix_commit(
            p, tuple(map(cols, cands)), tuple(map(cols, keeps)),
            tuple(map(cols, lasts)), gr, t, 0.01, 0.9, 1 / 3, stale,
            off=off, out=(torch.zeros(R, n), torch.zeros(R, n)), **kw)
        _same(cols(po), cols(whole[0]), "gated p'")
        _same(cols(to), cols(whole[1]), "gated t'")
        for a, b in zip(bufs, whole[2]):
            _same(a, cols(b), "gated bufs")
        assert torch.isnan(po[3, off:off + c]).all()
        q = lambda: torch.randint(-127, 128, (R, n), generator=g,
                                  dtype=torch.int8)
        cq, lq, sc = (q(), q()), (q(), q()), (rn(R, n), rn(R, n))
        whole = arena_update.fused_mix_commit_carrier(
            p, cq, keeps, lq, gr, t, 0.01, 0.9, 1 / 3, mix_scales=sc,
            mix_stale=stale, **gkw)
        po, to, bufs = arena_update.fused_mix_commit_carrier(
            p, tuple(map(cols, cq)), tuple(map(cols, keeps)),
            tuple(map(cols, lq)), gr, t, 0.01, 0.9, 1 / 3,
            mix_scales=tuple(map(cols, sc)), mix_stale=stale, off=off,
            out=(torch.zeros(R, n), torch.zeros(R, n)), **gkw)
        _same(cols(po), cols(whole[0]), "gated carrier p'")
        for a, b in zip(bufs, whole[2]):
            _same(a, cols(b), "gated carrier bufs")
    with pytest.raises(ValueError, match="w_rows must be"):
        arena_update.fused_mix_commit(
            p, tuple(map(cols, cands)), tuple(map(cols, keeps)),
            tuple(map(cols, lasts)), gr, t, 0.01, 0.9, 1 / 3, off=off,
            out=(torch.zeros(R, n), torch.zeros(R, n)),
            w_rows=torch.ones(R + 1), gate=gate)


def _jax_health(js):
    return PeerHealth(
        silence=torch.from_numpy(np.array(js.chaos.silence)),
        sync_req=torch.from_numpy(np.array(js.chaos.sync_req)),
        drops=torch.from_numpy(np.array(js.chaos.drops)))


#: the JAX comparison's cases (one JAX compile each). On the bf16 wire
#: the nanstep's poison reaches a neighbour in a few positions only, so
#: that rank's gradient runs through a relu on NaNs (`models/activation`)
JAX_FAULT_CASES = ("f32_drop_flaky_die_sync_freeze",
                   "f32_delay_nanstep_freeze", "bf16_die_nanstep_freeze",
                   "bf16_drop_die_sync_freeze",
                   "int8_carrier_drop_die_freeze")


@pytest.mark.parametrize("name", JAX_FAULT_CASES)
def test_bucketed_step_under_faults_matches_jax(name):
    spec, pol, kw = FAULT_CASES[name]
    wire, carrier = kw.get("wire"), kw.get("carrier", False)
    K, steps = 2, 8
    jtopo, topo = JaxRing(R), Ring(R)
    jmodel, model = JaxMLP(hidden=HIDDEN), _model()
    aspec = arena_spec(model)
    tx = optax.sgd(LR)
    jcfg, cfg = JaxEventConfig(**CFG), EventConfig(**CFG)
    jstate = jax_init_state(jmodel, IN_SHAPE, tx, jtopo, "eventgrad", jcfg,
                            seed=0, arena=True, bucketed=K,
                            resident_wire=wire if carrier else None)
    jstate = jstate.replace(chaos=stack_for_ranks(
        jax_monitor.PeerHealth.init(jtopo), jtopo))
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, "eventgrad", jcfg, arena=True, bucketed=K,
        wire=wire, carrier_resident=carrier, chaos=JaxChaos.parse(spec),
        chaos_policy=jax_policy.RecoveryPolicy(**pol)), jtopo))
    tstep = make_train_step(model, topo, "eventgrad", cfg,
                            fused_sgd=(LR, 0.0), bucketed=K, wire=wire,
                            carrier_resident=carrier, chaos=spec,
                            chaos_policy=RecoveryPolicy(**pol),
                            n_passes=steps)
    exact = ("edge_silence", "chaos_drops", "sent_bytes",
             "sent_bytes_wire_real", "sent_bytes_wire_real_per_bucket",
             "fired_elems", "num_events", "num_deferred", "fired_frac")
    for p, (x, y) in enumerate(_batches(steps, seed=2), start=1):
        js = jax.tree.map(np.asarray, jstate)
        tp, ts = convert.params_from_jax(js.params, js.batch_stats,
                                         stacked=True)
        tstate = TrainState(params=aspec.ravel(tp), trace=None,
                            batch_stats=ts, pass_num=int(js.pass_num[0]),
                            event=convert.event_state_from_jax(js.event,
                                                               aspec),
                            chaos=_jax_health(js))
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
        js, jm = jax.tree.map(np.asarray, jstate), jax.tree.map(np.asarray,
                                                                jm)
        w = f"{name} pass {p}"
        for k in exact:
            if k in jm:
                np.testing.assert_array_equal(tm[k].numpy(), jm[k],
                                              err_msg=f"{w} {k}")
        jp, _ = convert.params_from_jax(js.params, stacked=True)
        np.testing.assert_allclose(tstate.params.numpy(),
                                   aspec.ravel(jp).numpy(), err_msg=w,
                                   equal_nan=True, **TOL)
        jh = _jax_health(js)
        for f in ("silence", "sync_req", "drops"):
            _same(getattr(tstate.chaos, f), getattr(jh, f), f"{w} {f}")
        jev = convert.event_state_from_jax(js.event, aspec)
        # a poisoned rank's payload is NaN on both sides; the two
        # frameworks' bf16 casts need not agree on a NaN's sign bit
        canon = lambda v: torch.where(torch.isnan(v), float("nan"), v)
        for i, (tb, jb) in enumerate(zip(tstate.event.bufs, jev.bufs)):
            for b, (u, v) in enumerate(zip(tb, jb)):
                _same(canon(u), canon(v), f"{w} bufs[{i}][{b}]")
        if jev.buf_scales is not None:
            for u, v in zip(tstate.event.buf_scales, jev.buf_scales):
                for a, b in zip(u, v):
                    _same(a, b, f"{w} scales")
    assert int(tstate.chaos.drops.sum()) > 0
    assert int(tstate.chaos.silence.max()) >= pol["freeze_after"]
