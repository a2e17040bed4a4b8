"""The port's compact static-capacity wire against the JAX package's.

The capacity helpers, the capacity gate, the pack and its int8 encode
and the compact exchange are bitwise the JAX functions on the same
inputs (the JAX side lifted over the ranks with `vmap` or the `spmd`
lift); the leaves here are one-dimensional, so the flax and torch
layouts of the arena agree. The compact step is held against the JAX
step pass by pass: before every pass the JAX state is carried into the
port (as in tests/test_torch_algos.py), both take the same batch, and
the results are compared at tests/test_torch_step.py's tolerances on
the small ResNet in float64 compute:
  * parameters and momentum trace: rtol=1e-4, atol=1e-5;
  * fire bits (post-gate), `num_events`, `num_deferred`, `sent_bytes`,
    `sent_bytes_wire_real`, `fired_elems`, `fired_frac`: equal;
  * the committed receive buffers (f32 or int8 carriers) and the int8
    scales: bitwise (packed copies of equal parameters).
The capacity is tight, so the gate defers leaves (`num_deferred > 0`).

`train(gossip_wire="compact")` is held to the JAX `train()` records of
the same op-point: the epoch of the switch, the capacity and the compact
record keys. The op-points make the fired sizes independent of the
training trajectory (the two packages initialize differently): a fixed
threshold no drift reaches (nothing fires after warmup), and the micro
policy (its owned partition, by position).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.models.resnet import BasicBlock as JaxBasicBlock
from eventgrad_tpu.models.resnet import ResNet as JaxResNet
from eventgrad_tpu.parallel import arena as jax_arena
from eventgrad_tpu.parallel import collectives as jax_coll
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.events import EventState as JaxEventState
from eventgrad_tpu.parallel.spmd import spmd, stack_for_ranks
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.parallel.topology import Torus as JaxTorus
from eventgrad_tpu.train.loop import train as jax_train
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.models.resnet import ResNet
from eventgrad_tpu_torch.ops.event_engine import event_propose_pack
from eventgrad_tpu_torch.parallel import arena, collectives, events
from eventgrad_tpu_torch.parallel.arena import arena_spec, flax_positions
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.topology import Ring, Torus
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step

R = 8
#: flax order a, b, c_10, c_2, d, e (39 elements, the largest leaf 11)
SIZES = {"b": 5, "a": 7, "c_10": 3, "c_2": 11, "d": 9, "e": 4}
TOPOS = {"ring8": (JaxRing(8), Ring(8)),
         "torus2x4": (JaxTorus(2, 4), Torus(2, 4))}


def _bits(x) -> np.ndarray:
    """The bit pattern of a torch tensor or an array of any dtype."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return a
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _assert_bits(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {k: (3 * rng.standard_normal((R, z))).astype(np.float32)
            for k, z in SIZES.items()}


def _specs(tree):
    jspec = jax_arena.arena_spec({k: v[0] for k, v in tree.items()})
    tspec = arena.arena_spec({k: v.shape[1:] for k, v in tree.items()})
    assert tspec.sizes == jspec.sizes and tspec.starts == jspec.starts
    assert tspec.floor == jspec.floor == 11
    return jspec, tspec


def _flat(tree, tspec):
    return tspec.ravel({k: torch.from_numpy(v) for k, v in tree.items()})


def test_capacity_helpers_match_jax():
    sizes = (7, 5, 3, 11, 9, 4)
    assert (collectives.compact_capacity_floor(sizes)
            == jax_coll.compact_capacity_floor(sizes) == 11)
    n = 17_444_682
    floor = 2_359_296
    for peak in (0.0, 1.0, 1e5, 2_000_000.5, 5_223_219.0, 1.6e7, 2e7):
        for headroom, gran in ((1.25, 8192), (1.0, 1), (2.0, 4096)):
            assert collectives.choose_capacity(
                n, peak, floor, headroom, gran
            ) == jax_coll.choose_capacity(n, peak, floor, headroom, gran)
    assert collectives.choose_capacity(39, 20.0, 11) == 39  # clamped to n
    for wire in collectives.WIRE_MODES:
        for cap in (None, 1, 6_541_756):
            for fire_bits in (False, True):
                assert collectives.wire_real_bytes_per_neighbor(
                    n, 86, wire, compact_capacity=cap, fire_bits=fire_bits
                ) == jax_coll.wire_real_bytes_per_neighbor(
                    n, 86, wire, compact_capacity=cap, fire_bits=fire_bits)
        assert collectives.fired_wire_bytes_per_neighbor(
            123_457, 17, wire
        ) == jax_coll.fired_wire_bytes_per_neighbor(123_457, 17, wire)
    # the flagship at compact_frac 0.375, per chip (two neighbors)
    per_nb = collectives.wire_real_bytes_per_neighbor
    assert 2 * per_nb(n, 86, None, 6_541_756, True) == 52_334_220
    assert 2 * per_nb(n, 86, "int8", 6_541_756, True) == 13_084_372


def _fire_bits(rng, p=0.6):
    return rng.random((R, len(SIZES))) < p


@pytest.mark.parametrize("with_priority", [False, True],
                         ids=["leaf-order", "priority"])
def test_capacity_gate_matches_jax(with_priority):
    rng = np.random.default_rng(11)
    sizes = np.array(list(SIZES.values()), np.int32)
    for trial in range(20):
        fire = _fire_bits(rng, 0.3 + 0.03 * trial)
        pri = rng.random(fire.shape) < 0.4 if with_priority else None
        cap = int(rng.integers(11, 40))
        if with_priority:
            want = jax.vmap(lambda f, p: jax_events.capacity_gate(
                f, tuple(sizes), cap, priority=p))(fire, pri)
        else:
            want = jax.vmap(lambda f: jax_events.capacity_gate(
                f, tuple(sizes), cap))(fire)
        got = events.capacity_gate(
            torch.from_numpy(fire), torch.from_numpy(sizes), cap,
            priority=None if pri is None else torch.from_numpy(pri))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not (got.numpy() & ~fire).any()  # a subset of the fire bits


def _gated(tree, rng, cap):
    """Fire bits gated to `cap` by the JAX gate (the pack's contract)."""
    sizes = tuple(SIZES[k] for k in sorted(SIZES))
    fire = _fire_bits(rng)
    fire[3] = False     # a rank with nothing to send
    fire[4] = True      # a rank whose overflow defers
    return np.array(jax.vmap(
        lambda f: jax_events.capacity_gate(f, sizes, cap))(fire))


@pytest.mark.parametrize("cap", [11, 24, 39])
def test_compact_pack_and_int8_encode_match_jax(cap):
    tree = _tree(3)
    jspec, tspec = _specs(tree)
    fire = _gated(tree, np.random.default_rng(cap), cap)
    flat = _flat(tree, tspec)
    packed, leaf_id = collectives._compact_pack(
        flat, torch.from_numpy(fire), tspec, cap)
    jflat = jnp.asarray(flat.numpy())
    jpacked, jleaf = jax.vmap(lambda f, b: jax_coll._compact_pack(
        f, b, jspec.sizes, jspec.starts, cap))(jflat, jnp.asarray(fire))
    _assert_bits(packed, jpacked, "packed")
    np.testing.assert_array_equal(leaf_id.numpy(), np.asarray(jleaf))
    # positions past the fired total hold zero
    total = (fire * np.array([SIZES[k] for k in sorted(SIZES)])).sum(-1)
    for r in range(R):
        assert np.all(packed[r, total[r]:].numpy() == 0)
    scales = collectives._masked_scales(
        collectives._leaf_absmax(flat, tspec), torch.from_numpy(fire))
    q = collectives._int8_encode_flat(packed, scales, leaf_id)
    for r in range(R):
        leaves = [jnp.asarray(tree[k][r]) for k in tspec.names]
        js = jax_coll._masked_scales(jax_coll._leaf_absmax(leaves),
                                     jnp.asarray(fire[r]))
        _assert_bits(scales[r], js, f"scales rank {r}")
        _assert_bits(q[r], jax_coll._int8_encode_flat(jpacked[r], js,
                                                      jleaf[r]),
                     f"int8 pack rank {r}")


EXCHANGES = [(w, c) for w in (None, "bf16", "int8")
             for c in ((False, True) if w else (False,))]


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
@pytest.mark.parametrize("wire,carrier", EXCHANGES,
                         ids=[f"{w or 'f32'}{'-carrier' if c else ''}"
                              for w, c in EXCHANGES])
def test_compact_exchange_matches_jax(topo_name, wire, carrier):
    cap = 24
    tree = _tree(5)
    jspec, tspec = _specs(tree)
    jtopo, topo = TOPOS[topo_name]
    fire = _gated(tree, np.random.default_rng(6), cap)

    def jax_fn(t, f):
        flat = jnp.concatenate([t[k] for k in tspec.names])
        packed, leaf_id = jax_coll._compact_pack(flat, f, jspec.sizes,
                                                 jspec.starts, cap)
        return jax_coll.compact_neighbor_vals_flat(
            t, f, packed, leaf_id, jtopo, cap, jspec, wire, carrier=carrier)

    want = spmd(jax_fn, jtopo)({k: jnp.asarray(v) for k, v in tree.items()},
                               jnp.asarray(fire))
    flat, fire_t = _flat(tree, tspec), torch.from_numpy(fire)
    packed, leaf_id = collectives._compact_pack(flat, fire_t, tspec, cap)
    got = collectives.compact_neighbor_vals_flat(
        flat, fire_t, packed, leaf_id, topo, cap, tspec, wire,
        carrier=carrier)
    assert len(got) == len(want) == (4 if carrier else 3)
    seg = tspec.seg_expand()
    for i, (g, w, e) in enumerate(zip(got[0], want[0], got[1])):
        want_dt = {None: torch.float32, "bf16": torch.bfloat16,
                   "int8": torch.int8}[wire] if carrier else torch.float32
        assert g.dtype == want_dt
        keep = e[:, seg].numpy()
        # the positions the commit keeps: the fired leaves' elements
        _assert_bits(_bits(g)[keep], _bits(w)[keep], f"candidates {i}")
    for part in (1, 2):
        for i, (g, w) in enumerate(zip(got[part], want[part])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"part {part} nb {i}")
    if carrier:
        assert (got[3] is None) == (want[3] is None) == (wire == "bf16")
        for g, w in zip(got[3] or (), want[3] or ()):
            _assert_bits(g, w, "received scales")
    # the candidates equal the masked exchange's where the commit keeps
    masked = collectives.masked_neighbor_vals_flat(flat, fire_t, topo, tspec,
                                                   wire, carrier=carrier)
    for g, m, e in zip(got[0], masked[0], got[1]):
        keep = e[:, seg].numpy()
        _assert_bits(_bits(g)[keep], _bits(m)[keep], "compact vs masked")


def test_sender_pass_suppress_force_and_priority():
    """The sender pass's order: suppression clears bits before the gate
    (winning over force and the silence bound); the gate admits forced
    and overdue leaves first."""
    tree = _tree(8)
    _, tspec = _specs(tree)
    flat = _flat(tree, tspec)
    cfg = EventConfig(warmup_passes=0, max_silence=3, horizon=0.5)
    st = EventState.init(tspec, Ring(R), cfg, with_bufs=False)
    # thresholds no drift reaches: only silence and force fire
    st = st.replace(thres=torch.full((R, 6), 1e9),
                    last_sent_norm=events.leaf_norms(flat, tspec))
    force = torch.zeros((R, 6), dtype=torch.bool)
    force[:, 5] = True
    suppress = torch.zeros((R, 6), dtype=torch.bool)
    suppress[:, 4:] = True
    # pass 2: nothing overdue; force fires leaf e, suppression clears it
    prop, fire, packed, _ = event_propose_pack(
        flat, st, 2, cfg, tspec, capacity=11, force_fire=force,
        suppress_fire=suppress)
    assert prop.fire_vec[:, 5].all() and not fire.any()
    assert torch.all(packed == 0)
    # pass 3: every leaf overdue; suppressed d, e stay silent, and the
    # gate admits leaf order a (7) only: b (5) would pass 11
    _, fire, packed, leaf_id = event_propose_pack(
        flat, st, 3, cfg, tspec, capacity=11, suppress_fire=suppress)
    assert fire[:, 0].all() and not fire[:, 1:].any()
    # pass 2 again, leaves a (7) and b (5) firing on drift: in leaf
    # order b would pass 11 and defer e; forced e (4) claims the budget
    # first, then a, and b defers
    thres = st.thres.clone()
    thres[:, :2] = 0.0
    prop, fire, packed, leaf_id = event_propose_pack(
        flat, st.replace(thres=thres), 2, cfg, tspec, capacity=11,
        force_fire=force)
    assert prop.fire_vec[:, [0, 1, 5]].all()
    assert fire[:, [0, 5]].all() and not fire[:, 1:5].any()
    np.testing.assert_array_equal(
        packed[:, :7].numpy(), flat[:, :7].numpy())
    np.testing.assert_array_equal(
        packed[:, 7:11].numpy(), flat[:, 35:39].numpy())
    assert leaf_id[0, :11].tolist() == [0] * 7 + [5] * 4


# ---------------------------------------------------------------------------
# the compact step against the JAX step

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)
PER_RANK, SHAPE = 4, (32, 32, 3)
LR, MOM = 0.01, 0.9
CFG = dict(adaptive=True, horizon=0.6, warmup_passes=2, max_silence=3)
PASSES = 4

#: the compact step cases (capacity a third of the arena)
STEP_CASES = {
    "f32": dict(),
    "int8": dict(wire="int8"),
    "int8-carrier": dict(wire="int8", carrier_resident=True),
    "f32-stale1": dict(staleness=1),
}


def _batches(n_steps):
    x, y = jax_synthetic(R * PER_RANK * n_steps, SHAPE, seed=4)
    x = x.reshape((n_steps, R, PER_RANK) + SHAPE)
    y = y.reshape((n_steps, R, PER_RANK))
    return [(x[i], y[i]) for i in range(n_steps)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_of(tree, spec):
    """A stacked flax parameter tree as the port's `[R, n]` arena."""
    tp, _ = convert.params_from_jax(_np(tree), stacked=True)
    return spec.ravel(tp)


def _arena_of(jflat, spec):
    """A JAX `[R, n]` arena (flax layout inside each leaf, f32 or int8)
    in the port's layout."""
    a = np.array(jflat)
    out = torch.empty(a.shape, dtype=torch.from_numpy(a[:1, :1]).dtype)
    out[:, flax_positions(spec)] = torch.from_numpy(a)
    return out


def carry(jstate, spec, topo, cfg, resident_wire=None):
    """The port's TrainState holding the JAX EventGraD state's values."""
    js = _np(jstate)
    tp, ts = convert.params_from_jax(js.params, js.batch_stats, stacked=True)
    ev = EventState.init(spec, topo, cfg, resident_wire=resident_wire,
                         device="cpu")
    ev = ev.replace(
        **{f: torch.from_numpy(np.array(getattr(js.event, f)))
           for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes",
                     "num_events", "num_deferred")},
        bufs=tuple(_arena_of(b, spec) for b in js.event.bufs),
        buf_scales=None if js.event.buf_scales is None else tuple(
            torch.from_numpy(np.array(s)) for s in js.event.buf_scales),
    )
    return TrainState(
        params=spec.ravel(tp), trace=_flat_of(js.opt_state[0].trace, spec),
        batch_stats=ts, pass_num=int(js.pass_num[0]), event=ev,
        rng=torch.Generator().manual_seed(0),
    )


def _resnets():
    return (JaxResNet(block_cls=JaxBasicBlock, dtype=jnp.float64, **SMALL),
            ResNet(dtype=torch.float64, **SMALL))


def jax_resnet_state():
    """The small ResNet's initial JAX EventGraD state on Ring(8), built
    once per test module (the flax init takes ~25 s on the CPU). Its
    BatchNorm statistics and event counters take the dtypes a float64
    step returns, so each JAX step compiles once."""
    jmodel, _ = _resnets()
    with jax.enable_x64(True):
        js = jax_init_state(jmodel, SHAPE, optax.sgd(LR, momentum=MOM),
                            JaxRing(R), "eventgrad", JaxEventConfig(**CFG),
                            seed=0, arena=True)
        return js.replace(batch_stats=jax.tree.map(
            lambda a: a.astype(jnp.float64), js.batch_stats))


def run_carried(jstate0, batches, cfg_kw, kw, jtopo=JaxRing(R), topo=Ring(R)):
    """The small ResNet's EventGraD step, both packages, from `jstate0`
    with a fresh event state for `kw` (wire, residency, staleness).
    Per pass: (JAX state and metrics after it, port state and metrics
    after the port's step from the carried JAX state before it)."""
    jmodel, tmodel = _resnets()
    spec = arena_spec(tmodel)
    tx = optax.sgd(LR, momentum=MOM)
    trace = not kw.get("staleness")
    resident = kw.get("wire") if kw.get("carrier_resident") else None
    tstep = make_train_step(tmodel, topo, "eventgrad", EventConfig(**cfg_kw),
                            fused_sgd=(LR, MOM), trace=trace, **kw)
    out = []
    with jax.enable_x64(True):
        ev = stack_for_ranks(JaxEventState.init(
            jax.tree.map(lambda a: a[0], jstate0.params), jtopo,
            JaxEventConfig(**cfg_kw), arena=True,
            staleness=kw.get("staleness", 0), resident_wire=resident,
        ), jtopo)
        jstate = jstate0.replace(event=ev.replace(
            num_events=ev.num_events.astype(jnp.int64),
            num_deferred=ev.num_deferred.astype(jnp.int64)))
        jstep = jax.jit(spmd(jax_make_step(
            jmodel, tx, jtopo, "eventgrad", JaxEventConfig(**cfg_kw),
            fused_sgd=(LR, MOM), trace=trace, arena=True, **kw,
        ), jtopo))
        for x, y in batches:
            tstate = carry(jstate, spec, topo, EventConfig(**cfg_kw),
                           resident)
            jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
            tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                        torch.from_numpy(y).long()))
            out.append((_np(jstate), _np(jm), tstate,
                        {k: v.numpy() for k, v in tm.items()}))
    return spec, out


def assert_carried(spec, passes, what):
    for p, (jstate, jm, tstate, tm) in enumerate(passes, start=1):
        w = f"{what} pass {p}"
        np.testing.assert_allclose(
            tstate.params.numpy(), _flat_of(jstate.params, spec).numpy(),
            err_msg=f"{w}: params", **TOL)
        np.testing.assert_allclose(
            tstate.trace.numpy(),
            _flat_of(jstate.opt_state[0].trace, spec).numpy(),
            err_msg=f"{w}: trace", **TOL)
        np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
        for k in ("sent_bytes", "sent_bytes_wire_real", "fired_elems",
                  "fired_frac", "num_events", "num_deferred"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{w}: {k}")
        if "trace_fired" in jm:
            np.testing.assert_array_equal(tm["trace_fired"], jm["trace_fired"],
                                          err_msg=f"{w}: fire bits")
        for tb, jb in zip(tstate.event.bufs, jstate.event.bufs):
            _assert_bits(tb, _arena_of(jb, spec), f"{w}: receive buffers")
        for ts, js in zip(tstate.event.buf_scales or (),
                          jstate.event.buf_scales or ()):
            _assert_bits(ts, js, f"{w}: scales")


@pytest.fixture(scope="module")
def jstate0():
    return jax_resnet_state()


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_compact_step_matches_jax(jstate0, case):
    kw = dict(STEP_CASES[case])
    spec = arena_spec(_resnets()[1])
    cap = max(spec.floor, spec.n_total // 3)
    kw.update(gossip_wire="compact", compact_capacity=cap)
    spec, passes = run_carried(jstate0, _batches(PASSES), CFG, kw)
    assert_carried(spec, passes, case)
    tm = passes[-1][3]
    assert tm["num_deferred"].min() > 0  # the gate deferred leaves
    wire = kw.get("wire")
    assert np.all(tm["sent_bytes_wire_real"] == 2 * (
        collectives.WIRE_VAL_BYTES[wire] * cap + spec.n_leaves
        + (4 * spec.n_leaves if wire == "int8" else 0)))
    if kw.get("carrier_resident"):
        assert all(b.dtype == torch.int8 for b in passes[-1][2].event.bufs)


@pytest.mark.parametrize("wire", [None, "int8"])
def test_compact_bitwise_matches_masked(wire):
    """At capacity = n_params nothing defers: the compact step is bitwise
    the masked step, every state field and metric."""
    model, topo, cfg = ResNet(**SMALL), Ring(R), EventConfig(**CFG)
    spec = arena_spec(model)
    carrier = True if wire else None
    runs = []
    for kw in (dict(), dict(gossip_wire="compact",
                            compact_capacity=spec.n_total)):
        step = make_train_step(model, topo, "eventgrad", cfg,
                               fused_sgd=(LR, MOM), wire=wire,
                               carrier_resident=carrier, **kw)
        st = init_train_state(model, SHAPE, topo, "eventgrad", cfg, 0,
                              momentum=MOM, resident_wire=wire,
                              device="cpu")
        for x, y in _batches(PASSES):
            st, m = step(st, (torch.from_numpy(x),
                              torch.from_numpy(y).long()))
        runs.append((st, m))
    (sm, mm), (sc, mc) = runs
    _assert_bits(sc.params, sm.params, "params")
    _assert_bits(sc.trace, sm.trace, "trace")
    for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes",
              "num_events", "num_deferred"):
        _assert_bits(getattr(sc.event, f), getattr(sm.event, f), f)
    for a, b in zip(sc.event.bufs, sm.event.bufs):
        _assert_bits(a, b, "bufs")
    for a, b in zip(sc.event.buf_scales or (), sm.event.buf_scales or ()):
        _assert_bits(a, b, "scales")
    for k in mm:
        _assert_bits(mc[k], mm[k], f"metric {k}")


# ---------------------------------------------------------------------------
# train(gossip_wire="compact") against the JAX train()

MLP_KW = dict(hidden=128)
IN_SHAPE = (8, 8, 1)
#: (train() kwargs, event config): the fired sizes do not depend on the
#: trajectory
TRAIN_CASES = {
    # compact_frac: the switch at the first epoch past warmup
    "frac": (dict(compact_frac=0.9),
             dict(adaptive=True, horizon=0.95, warmup_passes=6)),
    # a threshold no drift reaches, no silence bound: nothing fires
    # after warmup, so the autotune sizes the floor (rounded to 8192)
    "autotuned": (dict(), dict(adaptive=False, constant=1e9,
                               warmup_passes=6)),
    # micro's owned partition is 8,192 elements: 1.25x that rounds past
    # the arena, so the run stays dense
    "skipped": (dict(trigger_policy="micro"),
                dict(adaptive=True, horizon=0.95, warmup_passes=6)),
}
COMPACT_KEYS = ("gossip_wire", "compact_capacity", "compact_autotuned",
                "compact_fired_peak_elems", "compact_skipped", "policy")


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_compact_records_match_jax(case):
    kw, cfg_kw = TRAIN_CASES[case]
    x, y = jax_synthetic(256, IN_SHAPE, seed=3)
    common = dict(algo="eventgrad", epochs=4, batch_size=4,
                  learning_rate=0.01, momentum=0.9, gossip_wire="compact",
                  **kw)
    _, jhist = jax_train(JaxMLP(**MLP_KW), JaxRing(4), x, y,
                         event_cfg=JaxEventConfig(**cfg_kw), **common)
    state, hist = egt.train(MLP(input_shape=IN_SHAPE, **MLP_KW), Ring(4), x,
                            y, event_cfg=EventConfig(**cfg_kw),
                            device="cpu", **common)
    assert len(hist) == len(jhist) == 4
    for rec, jrec in zip(hist, jhist):
        got = {k: rec[k] for k in COMPACT_KEYS if k in rec}
        want = {k: jrec[k] for k in COMPACT_KEYS if k in jrec}
        assert got == want, (rec["epoch"], got, want)
        assert rec["sent_bytes_wire_real_per_step_per_chip"] == float(
            jrec["sent_bytes_wire_real_per_step_per_chip"])
    n = arena_spec(MLP(input_shape=IN_SHAPE, **MLP_KW)).n_total
    modes = [r["gossip_wire"] for r in hist]
    if case == "skipped":
        assert modes == ["dense"] * 4 and "compact_skipped" in hist[2]
    else:
        # 16 steps a epoch: the switch after epoch 1 (frac: its last
        # pass is past warmup) or epoch 2 (16 post-warmup samples)
        switch = 1 if case == "frac" else 2
        assert modes == ["dense"] * switch + ["compact"] * (4 - switch)
        cap = hist[-1]["compact_capacity"]
        assert cap == (int(np.ceil(0.9 * n)) if case == "frac" else 8192)
    assert torch.isfinite(state.params).all()


def test_compact_guards():
    """The JAX guards, with their messages."""
    model, topo = ResNet(**SMALL), Ring(R)
    spec = arena_spec(model)

    def mk(algo, **kw):
        return make_train_step(model, topo, algo, EventConfig(**CFG),
                               fused_sgd=(LR, MOM), **kw)

    for algo in ("dpsgd", "allreduce"):
        with pytest.raises(ValueError, match="declares no compact"):
            mk(algo, gossip_wire="compact", compact_capacity=100)
        with pytest.raises(ValueError, match="declares no compact"):
            jax_make_step(JaxMLP(), optax.sgd(LR), JaxRing(R), algo,
                          gossip_wire="compact", compact_capacity=100)
    with pytest.raises(ValueError, match="needs a static compact_capacity"):
        mk("eventgrad", gossip_wire="compact")
    with pytest.raises(ValueError, match="gossip_wire must be"):
        mk("eventgrad", gossip_wire="sparse")
    # a capacity below the largest leaf raises where JAX raises: in the
    # exchange, on the first step
    step = mk("eventgrad", gossip_wire="compact",
              compact_capacity=spec.floor - 1)
    st = init_train_state(model, SHAPE, Ring(R), "eventgrad",
                          EventConfig(**CFG), 0, momentum=MOM, device="cpu")
    x, y = _batches(1)[0]
    with pytest.raises(ValueError, match="below the largest leaf"):
        step(st, (torch.from_numpy(x), torch.from_numpy(y).long()))
    x, y = jax_synthetic(64, IN_SHAPE, seed=3)
    with pytest.raises(ValueError, match="declares no compact"):
        egt.train(MLP(input_shape=IN_SHAPE), Ring(4), x, y, algo="dpsgd",
                  gossip_wire="compact", device="cpu")
    with pytest.raises(ValueError, match="compact_frac needs"):
        egt.train(MLP(input_shape=IN_SHAPE), Ring(4), x, y,
                  algo="eventgrad", compact_frac=0.5, device="cpu")
    with pytest.raises(ValueError, match="capacity-free"):
        egt.train(MLP(input_shape=IN_SHAPE), Ring(4), x, y,
                  algo="sp_eventgrad", gossip_wire="compact",
                  compact_frac=0.5, device="cpu")
    with pytest.raises(ValueError, match=r"must be in \(0, 1\]"):
        egt.train(MLP(input_shape=IN_SHAPE), Ring(4), x, y,
                  algo="eventgrad", gossip_wire="compact", compact_frac=1.5,
                  device="cpu")
