"""The port's train step against the JAX package's, on a small ResNet.

Both packages start from the same state — the JAX `init_train_state`
carried across with `convert.params_from_jax` — and take the same
batches on `Ring(8)`, 4 samples per rank. The JAX step is
`make_train_step(..., arena=True, fused_sgd=(lr, momentum))`, whose tail
runs the Pallas kernels in interpret mode on the CPU.

Both models compute in float64 (`dtype=float64`, with `jax.enable_x64`
on the JAX side); parameters, gradients, momentum trace, event state and
the fused tails stay float32. In float32 compute the gradient of this
net on 4-sample batches is ill-conditioned: on some ranks either
framework's float32 gradient departs from the float64 one by up to
3.5e-2 (a ReLU input within rounding of zero lands on the other side),
and which ranks do differs between XLA:CPU and torch, so a float32
forward cannot pin the step at this tolerance.

Tolerances, and why:
  * parameters and momentum trace after one step: rtol=1e-4, atol=1e-5
    (float32; the convolutions reduce in another order, and XLA:CPU
    contracts two FMAs in the interpreted kernels, tests/test_torch_ops.py);
  * fire bits and `num_events`: equal. Over the 6-pass run a bit may
    differ only where the trigger sat on its threshold,
    |value_diff - thres| < 1e-5 * thres (the leaf norms reduce in
    another order), and `msgs_saved_pct` then differs by at most the
    share of those flipped bits;
  * the bf16/int8 wires (`make_train_step(wire=..., carrier_resident=...,
    staleness=...)`): after the first pass the committed receive
    buffers — carriers or f32 — and the int8 scales are bitwise the JAX
    ones (the wire is built from identical parameters), and `sent_bytes`
    and `sent_bytes_wire_real` are exact. Past the first pass the
    parameters agree only to the tolerance above, so an int8 lane may
    differ by one quantum at a rounding boundary: |dq| <= 1.

The port's own contract, as the JAX package pins its own
(tests/test_arena.py): carrier residency on and off give the same bits
in every state field and metric over 5 passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models.resnet import BasicBlock as JaxBasicBlock
from eventgrad_tpu.models.resnet import Bottleneck as JaxBottleneck
from eventgrad_tpu.models.resnet import ResNet as JaxResNet
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu.utils.metrics import msgs_saved_pct as jax_msgs_saved
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch import convert, ops
from eventgrad_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.metrics import msgs_saved_pct

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)
R, PER_RANK, SHAPE = 8, 4, (32, 32, 3)
LR, MOM = 0.01, 0.9
PASSES = 6
#: warmup 2, a fast-decaying threshold and a short silence bound, so
#: passes 3-6 mix drift fires, silence fires and quiet leaves
CFG = dict(adaptive=True, horizon=0.6, warmup_passes=2, max_silence=4)


class _InitOnce:
    """A JAX model whose flax `init` runs once per test module: every
    case here starts from the same seed, so the initial variables are
    shared (the JAX `init_train_state` calls nothing else of the model).
    The small ResNet's flax init is the costliest JAX call of the file
    after the step compiles."""

    _variables: dict = {}

    def __init__(self, model):
        self.model = model

    def init(self, rng, x):
        key = (repr(self.model), tuple(x.shape), str(x.dtype),
               bool(jax.config.jax_enable_x64), np.asarray(rng).tobytes())
        if key not in self._variables:
            self._variables[key] = self.model.init(rng, x)
        return self._variables[key]


def _batches(n_steps):
    x, y = jax_synthetic(R * PER_RANK * n_steps, SHAPE, seed=4)
    x = x.reshape((n_steps, R, PER_RANK) + SHAPE)
    y = y.reshape((n_steps, R, PER_RANK))
    return [(x[i], y[i]) for i in range(n_steps)]


def _flat_of(jparams, spec):
    """A stacked flax params tree as the port's `[R, n]` arena."""
    tp, _ = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    stacked=True)
    return spec.ravel(tp)


def _port_state(jstate, spec, topo, algo, resident_wire=None):
    """The port's TrainState holding the JAX state's values."""
    tp, ts = convert.params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats), stacked=True,
    )
    flat = spec.ravel(tp)
    event = None
    if algo == "eventgrad":
        event = EventState.init(spec, topo, EventConfig(**CFG),
                                resident_wire=resident_wire, device="cpu")
    return TrainState(params=flat, trace=torch.zeros_like(flat),
                      batch_stats=ts, pass_num=0, event=event)


#: the block types: (flax, port)
BLOCKS = {"basic": (JaxBasicBlock, BasicBlock),
          "bottleneck": (JaxBottleneck, Bottleneck)}


def _run_both(algo, n_steps, trace=True, block="basic", **wire_kw):
    """Both packages' steps from the same state over `n_steps` passes;
    `wire_kw` (wire, carrier_resident, staleness) goes to both."""
    jblock, tblock = BLOCKS[block]
    jmodel = JaxResNet(block_cls=jblock, dtype=jnp.float64, **SMALL)
    tmodel = ResNet(block_cls=tblock, dtype=torch.float64, **SMALL)
    spec = arena_spec(tmodel)
    jtopo, topo = JaxRing(R), Ring(R)
    tx = optax.sgd(LR, momentum=MOM)
    resident = wire_kw["wire"] if wire_kw.get("carrier_resident") else None
    tstep = make_train_step(tmodel, topo, algo, EventConfig(**CFG),
                            fused_sgd=(LR, MOM), trace=trace, **wire_kw)
    passes = []
    with jax.enable_x64(True):
        jstate = jax_init_state(_InitOnce(jmodel), SHAPE, tx, jtopo,
                                algo, JaxEventConfig(**CFG), seed=0,
                                arena=True,
                                staleness=wire_kw.get("staleness", 0),
                                resident_wire=resident)
        tstate = _port_state(jstate, spec, topo, algo, resident)
        jstep = jax.jit(spmd(jax_make_step(
            jmodel, tx, jtopo, algo, JaxEventConfig(**CFG),
            fused_sgd=(LR, MOM), trace=trace, arena=True, **wire_kw,
        ), jtopo))
        for x, y in _batches(n_steps):
            jprev = jstate
            jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
            tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                        torch.from_numpy(y).long()))
            passes.append((
                jax.tree.map(np.asarray, jprev), jax.tree.map(np.asarray, jstate),
                jax.tree.map(np.asarray, jm),
                tstate, {k: v.numpy() for k, v in tm.items()},
            ))
    return spec, passes


@pytest.fixture(scope="module")
def eventgrad_run():
    return _run_both("eventgrad", PASSES)


@pytest.fixture(scope="module")
def dpsgd_run():
    return _run_both("dpsgd", 1)


def _assert_first_step(spec, passes):
    _, jstate, jm, tstate, tm = passes[0]
    np.testing.assert_allclose(
        tstate.params.numpy(), _flat_of(jstate.params, spec).numpy(), **TOL
    )
    np.testing.assert_allclose(
        tstate.trace.numpy(),
        _flat_of(jstate.opt_state[0].trace, spec).numpy(), **TOL,
    )
    tstats_np = {k: v.numpy() for k, v in tstate.batch_stats.items()}
    jstats = {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(
            jstate.batch_stats)[0]
    }
    assert list(tstats_np) == list(jstats)
    for k in jstats:
        np.testing.assert_allclose(tstats_np[k], jstats[k], err_msg=k, **TOL)
    np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
    for k in ("sent_bytes", "sent_bytes_wire_real", "fired_elems",
              "num_events", "num_deferred", "fired_frac"):
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)


def test_dpsgd_step_matches_jax(dpsgd_run):
    spec, passes = dpsgd_run
    _assert_first_step(spec, passes)


def test_eventgrad_step_matches_jax(eventgrad_run):
    _assert_first_event_step(*eventgrad_run)


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_bottleneck_step_matches_jax(algo):
    """One step on the small ResNet built of Bottleneck blocks (ResNet-50's
    block), weights carried across by `convert.py`."""
    spec, passes = _run_both(algo, 1, block="bottleneck")
    assert spec.names[0].startswith("Bottleneck_0.")
    if algo == "eventgrad":
        _assert_first_event_step(spec, passes)
    else:
        _assert_first_step(spec, passes)


def _assert_first_event_step(spec, passes):
    _assert_first_step(spec, passes)
    _, jstate, jm, tstate, tm = passes[0]
    np.testing.assert_array_equal(tm["trace_fired"], jm["trace_fired"])
    np.testing.assert_allclose(tm["trace_norm"], jm["trace_norm"], **TOL)
    np.testing.assert_allclose(tm["trace_thres"], jm["trace_thres"], **TOL)
    # the committed receive buffers: what each rank heard
    for tb, jb in zip(tstate.event.bufs, jstate.event.bufs):
        np.testing.assert_allclose(tb.numpy(), _flat_of_bufs(jb, spec),
                                   **TOL)


def _flat_of_bufs(jbuf, spec):
    """A JAX flat `[R, n]` receive buffer (flax layout inside each leaf)
    in the port's layout."""
    jbuf = np.asarray(jbuf)
    tree = {
        name: jbuf[:, s:s + z].reshape((R,) + _flax_shape(shape))
        for name, s, z, shape in zip(spec.names, spec.starts, spec.sizes,
                                     spec.shapes)
    }
    tp, _ = convert.params_from_jax(tree, stacked=True)
    return spec.ravel(tp).numpy()


def _flax_shape(torch_shape):
    if len(torch_shape) == 4:  # OIHW -> HWIO
        o, i, h, w = torch_shape
        return (h, w, i, o)
    if len(torch_shape) == 2:  # (out, in) -> (in, out)
        return tuple(reversed(torch_shape))
    return tuple(torch_shape)


def test_eventgrad_six_passes_fire_bits(eventgrad_run):
    spec, passes = eventgrad_run
    horizon = np.float32(CFG["horizon"])
    flips = fired_post_warmup = 0
    for p, (jprev, _, jm, _, tm) in enumerate(passes, start=1):
        jf, tf = jm["trace_fired"] > 0, tm["trace_fired"] > 0
        if p > CFG["warmup_passes"]:
            fired_post_warmup += int(jf.sum())
        diff = jf != tf
        if diff.any():
            # the trigger's inputs on the JAX side at this pass
            value_diff = np.abs(
                jm["trace_norm"] - np.asarray(jprev.event.last_sent_norm)
            )
            thres = np.asarray(jprev.event.thres) * horizon
            margin = np.abs(value_diff - thres)
            assert np.all(margin[diff] < 1e-5 * thres[diff]), (p, margin[diff])
            flips += int(diff.sum())
        if flips == 0:
            np.testing.assert_array_equal(tm["num_events"], jm["num_events"],
                                          err_msg=f"pass {p}")
    # the run exercised the trigger past warmup, not only warmup fires
    assert 0 < fired_post_warmup < R * spec.n_leaves * (
        PASSES - CFG["warmup_passes"])
    n_nb = Ring(R).n_neighbors
    jev = int(passes[-1][2]["num_events"].sum())
    tev = int(passes[-1][4]["num_events"].sum())
    assert abs(tev - jev) <= n_nb * flips
    got = msgs_saved_pct(tev, PASSES, spec.n_leaves, n_nb, R)
    want = jax_msgs_saved(jev, PASSES, spec.n_leaves, n_nb, R)
    per_flip = 100.0 * n_nb / (n_nb * PASSES * spec.n_leaves * R)
    assert abs(got - want) <= flips * per_flip + 1e-9


def test_step_runs_the_kernels_only_on_cuda(eventgrad_run):
    """On CPU tensors the step takes the plain versions: no launches."""
    ops.reset_launch_counts()
    spec, passes = eventgrad_run
    tstate = passes[-1][3]
    step = make_train_step(ResNet(**SMALL), Ring(R), "eventgrad",
                           EventConfig(**CFG), fused_sgd=(LR, MOM))
    x, y = _batches(1)[0]
    step(tstate, (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert ops.launch_counts() == {
        "masked_wire": 0, "masked_wire_int8": 0, "fused_mix_commit": 0,
        "fused_mix_sgd": 0, "fused_mix_commit_carrier": 0,
        "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
        "fused_mix_commit_gated": 0, "fused_mix_sgd_gated": 0,
        "fused_mix_commit_carrier_gated": 0,
        "fused_mix_commit_pitched_gated": 0,
        "fused_mix_commit_carrier_pitched_gated": 0,
    }


#: the wire cases held against the JAX step: (algo, passes, step kwargs)
WIRE_CASES = {
    "eventgrad-int8-carrier": ("eventgrad", 1,
                               dict(wire="int8", carrier_resident=True)),
    "eventgrad-int8-f32": ("eventgrad", 1, dict(wire="int8")),
    "eventgrad-bf16-carrier": ("eventgrad", 1,
                               dict(wire="bf16", carrier_resident=True)),
    "eventgrad-int8-stale1": ("eventgrad", 2,
                              dict(wire="int8", carrier_resident=True,
                                   staleness=1)),
    "dpsgd-int8": ("dpsgd", 1, dict(wire="int8")),
}


@pytest.fixture(scope="module", params=sorted(WIRE_CASES))
def wire_run(request):
    algo, n_steps, kw = WIRE_CASES[request.param]
    spec, passes = _run_both(algo, n_steps, trace=not kw.get("staleness"),
                             **kw)
    return algo, kw, spec, passes


def _f32_bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def test_wire_step_matches_jax(wire_run):
    algo, kw, spec, passes = wire_run
    _assert_first_step(spec, passes)
    _, jstate, _, tstate, _ = passes[0]
    if algo == "eventgrad":
        want_dt = {"int8": torch.int8, "bf16": torch.bfloat16}[kw["wire"]]
        for tb, jb in zip(tstate.event.bufs, jstate.event.bufs):
            assert tb.dtype == (want_dt if kw.get("carrier_resident")
                                else torch.float32)
            np.testing.assert_array_equal(
                _f32_bits(tb.to(torch.float32)),
                _f32_bits(_flat_of_bufs(np.asarray(jb, np.float32), spec)),
                err_msg="first-pass receive buffers",
            )
        assert (tstate.event.buf_scales is None) == (
            jstate.event.buf_scales is None)
        for ts, js in zip(tstate.event.buf_scales or (),
                          jstate.event.buf_scales or ()):
            np.testing.assert_array_equal(_f32_bits(ts), _f32_bits(js),
                                          err_msg="first-pass scales")
    for _, jstate, jm, tstate, tm in passes[1:]:
        np.testing.assert_allclose(
            tstate.params.numpy(), _flat_of(jstate.params, spec).numpy(),
            **TOL)
        for tb, jb in zip(tstate.event.bufs, jstate.event.bufs):
            dq = np.abs(tb.to(torch.float32).numpy()
                        - _flat_of_bufs(np.asarray(jb, np.float32), spec))
            assert dq.max() <= 1, dq.max()


#: carrier residency on vs off, the port against itself (the compact
#: cases at a third of the arena: the gate defers leaves)
COMPACT = dict(gossip_wire="compact", compact_capacity=max(
    arena_spec(ResNet(**SMALL)).floor,
    arena_spec(ResNet(**SMALL)).n_total // 3))
RESIDENT_CASES = {
    "int8": dict(wire="int8"),
    "bf16": dict(wire="bf16"),
    "int8-stale1": dict(wire="int8", staleness=1),
    "bf16-compact": dict(wire="bf16", **COMPACT),
    "int8-compact-stale1": dict(wire="int8", staleness=1, **COMPACT),
}


@pytest.mark.parametrize("name", sorted(RESIDENT_CASES))
def test_carrier_resident_bitwise_matches_f32_resident(name):
    kw = RESIDENT_CASES[name]
    model, topo, cfg = ResNet(**SMALL), Ring(R), EventConfig(**CFG)
    batches = _batches(5)
    runs = []
    for carrier in (None, True):
        step = make_train_step(model, topo, "eventgrad", cfg,
                               fused_sgd=(LR, MOM), carrier_resident=carrier,
                               **kw)
        st = init_train_state(
            model, SHAPE, topo, "eventgrad", cfg, 0, momentum=MOM,
            resident_wire=kw["wire"] if carrier else None, device="cpu",
        )
        for x, y in batches:
            st, m = step(st, (torch.from_numpy(x), torch.from_numpy(y).long()))
        runs.append((st, m))
    (sf, mf), (sc, mc) = runs
    want_dt = {"int8": torch.int8, "bf16": torch.bfloat16}[kw["wire"]]
    assert all(b.dtype == want_dt for b in sc.event.bufs)
    assert all(b.dtype == torch.float32 for b in sf.event.bufs)
    eq = lambda a, b, what: np.testing.assert_array_equal(
        _f32_bits(a), _f32_bits(b), err_msg=what)
    eq(sc.params, sf.params, "params")
    eq(sc.trace, sf.trace, "trace")
    for k in sf.batch_stats:
        eq(sc.batch_stats[k], sf.batch_stats[k], k)
    for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes"):
        eq(getattr(sc.event, f), getattr(sf.event, f), f)
    for f in ("num_events", "num_deferred"):
        np.testing.assert_array_equal(getattr(sc.event, f),
                                      getattr(sf.event, f), err_msg=f)
    deq = collectives.dequant_carrier_bufs(sc.event.bufs, sc.event.buf_scales,
                                           arena_spec(model))
    for d, b in zip(deq, sf.event.bufs):
        eq(d, b, "bufs")
    for k in mf:
        np.testing.assert_array_equal(mc[k].numpy(), mf[k].numpy(),
                                      err_msg=f"metric {k}")


def test_wire_guards():
    """The JAX step's guards that apply to the port, with their
    messages; the staleness >= 2 carrier step, which the port refused
    until the bounded-async queues were ported, now builds."""
    model, topo = ResNet(**SMALL), Ring(R)

    def mk(algo, **kw):
        return make_train_step(model, topo, algo, EventConfig(**CFG),
                               fused_sgd=(LR, MOM), **kw)

    with pytest.raises(ValueError, match="algo='eventgrad'"):
        mk("dpsgd", wire="int8", carrier_resident=True)
    with pytest.raises(ValueError, match="wire="):
        mk("eventgrad", carrier_resident=True)
    with pytest.raises(ValueError, match="wire must be one of"):
        mk("eventgrad", wire="fp8")
    with pytest.raises(ValueError, match="RMA asynchrony"):
        mk("dpsgd", staleness=1)
    with pytest.raises(ValueError, match="trace records"):
        mk("eventgrad", staleness=1, trace=True)
    with pytest.raises(ValueError, match="staleness must be"):
        mk("eventgrad", staleness=-1)
    assert callable(mk("eventgrad", wire="int8", carrier_resident=True,
                       staleness=2))
    x, y = _batches(1)[0]
    with pytest.raises(ValueError, match="algo='eventgrad'"):
        egt.train(model, topo, x.reshape((-1,) + SHAPE), y.reshape(-1),
                  algo="dpsgd", wire="int8", carrier_resident=True,
                  epochs=1, batch_size=PER_RANK, device="cpu")
    # the exchange's carrier contract
    spec = arena_spec(model)
    flat = torch.zeros((R, spec.n_total))
    fire = torch.ones((R, spec.n_leaves), dtype=torch.bool)
    with pytest.raises(ValueError, match="integrity"):
        collectives.masked_neighbor_vals_flat(
            flat, fire, topo, spec, "int8", checksum=True, carrier=True)
    with pytest.raises(ValueError, match="bf16/int8"):
        collectives.masked_neighbor_vals_flat(flat, fire, topo, spec,
                                              carrier=True)
