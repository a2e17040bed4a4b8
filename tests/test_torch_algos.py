"""The port's allreduce and sparsified-EventGraD steps, and its Torus,
against the JAX package's steps.

Each case runs the JAX step (`make_train_step(..., arena=True,
fused_sgd=(lr, momentum))`, its Pallas tails in interpret mode) for a
few passes on 4 samples per rank. Before every pass the JAX state is
carried into the port with `convert` (parameters, momentum trace, event
state, top-k shadows and replicas, EventGraD receive buffers), the
port's step takes the same batch, and the result is held against the
JAX state after that pass. Carrying the state each pass keeps the
comparison at one step's rounding, so later passes (the trigger past
warmup, the drifted top-k selections, the stale replicas of
staleness 1) are checked as sharply as the first.

Tolerances, and why (those of tests/test_torch_step.py):
  * parameters and momentum trace: rtol=1e-4, atol=1e-5 (float32; the
    dense and convolution sums reduce in another order, the mix adds in
    another order where the JAX tail is optax's);
  * the top-k shadow and the replicas: bitwise (the selection reads the
    carried parameters, which are equal; the values, indices and int8
    scales are then bitwise, tests/test_torch_sparse.py);
  * the EventGraD receive buffers: bitwise (masked copies of equal
    parameters);
  * fire bits, `num_events`, `num_deferred`, `sent_bytes`,
    `sent_bytes_wire_real`, `fired_elems`, `fired_frac`: equal.

The MLP has no dropout and computes in float32 on both sides; the small
ResNet computes in float64 on both sides (its float32 gradient on
4-sample batches is ill-conditioned, tests/test_torch_step.py) and takes
a single step. The port's own contract rides along: after an allreduce
step every rank holds the same parameters.
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
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.sparsify import SparseConfig as JaxSparseConfig
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.parallel.topology import Torus as JaxTorus
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.models.resnet import ResNet
from eventgrad_tpu_torch.parallel.arena import arena_spec, flax_positions
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig, SparseState
from eventgrad_tpu_torch.parallel.topology import Ring, Torus
from eventgrad_tpu_torch.train.state import TrainState
from eventgrad_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
R, PER_RANK = 8, 4
LR, MOM = 0.01, 0.9
CFG = dict(adaptive=True, horizon=0.6, warmup_passes=2, max_silence=4)
TOPK = 20.0
SMALL_RESNET = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)
TOPOS = {"ring8": (JaxRing(8), Ring(8)), "torus2x4": (JaxTorus(2, 4), Torus(2, 4))}

#: case -> (model, topology, algo, passes, step kwargs)
CASES = {
    "mlp-allreduce": ("mlp", "ring8", "allreduce", 2, {}),
    "mlp-sp-f32": ("mlp", "ring8", "sp_eventgrad", 3, {}),
    "mlp-sp-int8": ("mlp", "ring8", "sp_eventgrad", 3, dict(wire="int8")),
    "mlp-sp-f32-stale1": ("mlp", "ring8", "sp_eventgrad", 3,
                          dict(staleness=1)),
    "mlp-sp-int8-stale1": ("mlp", "ring8", "sp_eventgrad", 3,
                           dict(wire="int8", staleness=1)),
    "mlp-eventgrad-torus": ("mlp", "torus2x4", "eventgrad", 3, {}),
    "mlp-dpsgd-torus": ("mlp", "torus2x4", "dpsgd", 2, {}),
    "resnet-allreduce": ("resnet", "ring8", "allreduce", 1, {}),
    "resnet-sp-f32": ("resnet", "ring8", "sp_eventgrad", 1, {}),
    "resnet-sp-int8": ("resnet", "ring8", "sp_eventgrad", 1,
                       dict(wire="int8")),
}


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


def _models(name):
    if name == "mlp":
        return JaxMLP(), MLP(), (28, 28, 1)
    return (JaxResNet(block_cls=JaxBasicBlock, dtype=jnp.float64,
                      **SMALL_RESNET),
            ResNet(dtype=torch.float64, **SMALL_RESNET), (32, 32, 3))


def _batches(shape, n_steps):
    x, y = jax_synthetic(R * PER_RANK * n_steps, shape, seed=4)
    x = x.reshape((n_steps, R, PER_RANK) + shape)
    y = y.reshape((n_steps, R, PER_RANK))
    return [(x[i], y[i]) for i in range(n_steps)]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat_of(tree, spec):
    """A stacked flax parameter tree as the port's `[R, n]` arena."""
    tp, _ = convert.params_from_jax(_np(tree), stacked=True)
    return spec.ravel(tp)


def _flat_of_arena(jflat, spec):
    """A JAX `[R, n]` arena (flax layout inside each leaf) in the port's
    layout."""
    out = torch.empty((R, spec.n_total))
    out[:, flax_positions(spec)] = torch.from_numpy(np.array(jflat, np.float32))
    return out


def _carry(jstate, spec, topo, algo):
    """The port's TrainState holding the JAX state's values."""
    js = _np(jstate)
    tp, ts = convert.params_from_jax(js.params, js.batch_stats, stacked=True)
    flat = spec.ravel(tp)
    event = sparse = None
    if algo in ("eventgrad", "sp_eventgrad"):
        event = EventState.init(spec, topo, EventConfig(**CFG), device="cpu",
                                with_bufs=algo == "eventgrad")
        event = event.replace(
            **{f: torch.from_numpy(np.array(getattr(js.event, f)))
               for f in ("thres", "last_sent_norm", "last_sent_iter",
                         "slopes", "num_events", "num_deferred")},
            bufs=tuple(_flat_of_arena(b, spec) for b in js.event.bufs)
            if algo == "eventgrad" else (),
        )
    if algo == "sp_eventgrad":
        sparse = SparseState(
            prev_sent=_flat_of(js.sparse.prev_sent, spec),
            replicas=tuple(_flat_of(r, spec) for r in js.sparse.replicas),
        )
    return TrainState(
        params=flat, trace=_flat_of(js.opt_state[0].trace, spec),
        batch_stats=ts, pass_num=int(js.pass_num[0]), event=event,
        sparse=sparse, rng=torch.Generator().manual_seed(0),
    )


def _run(case):
    """Per pass: (JAX state after it, JAX metrics, port state and metrics
    after the port's step from the carried JAX state before it)."""
    model_name, topo_name, algo, n_steps, kw = CASES[case]
    jmodel, tmodel, shape = _models(model_name)
    jtopo, topo = TOPOS[topo_name]
    spec = arena_spec(tmodel)
    tx = optax.sgd(LR, momentum=MOM)
    trace = algo != "allreduce" and algo != "dpsgd" and not kw.get("staleness")
    tstep = make_train_step(tmodel, topo, algo, EventConfig(**CFG),
                            fused_sgd=(LR, MOM), trace=trace,
                            sparse_cfg=SparseConfig(TOPK), **kw)
    out = []
    with jax.enable_x64(model_name == "resnet"):
        jstate = jax_init_state(
            _InitOnce(jmodel), shape, tx, jtopo, algo,
            JaxEventConfig(**CFG), seed=0, arena=True,
            staleness=kw.get("staleness", 0),
            sparse_cfg=JaxSparseConfig(TOPK))
        jstep = jax.jit(spmd(jax_make_step(
            jmodel, tx, jtopo, algo, JaxEventConfig(**CFG),
            fused_sgd=(LR, MOM), trace=trace, arena=True,
            sparse_cfg=JaxSparseConfig(TOPK), **kw,
        ), jtopo))
        for x, y in _batches(shape, n_steps):
            tstate = _carry(jstate, spec, topo, algo)
            jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
            tstate, tm = tstep(tstate, (torch.from_numpy(x),
                                        torch.from_numpy(y).long()))
            out.append((_np(jstate), _np(jm), tstate,
                        {k: v.numpy() for k, v in tm.items()}))
    return spec, algo, kw, out


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    return request.param, _run(request.param)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def test_step_matches_jax(run):
    case, (spec, algo, kw, passes) = run
    for p, (jstate, jm, tstate, tm) in enumerate(passes, start=1):
        what = f"{case} pass {p}"
        np.testing.assert_allclose(
            tstate.params.numpy(), _flat_of(jstate.params, spec).numpy(),
            err_msg=f"{what}: params", **TOL)
        np.testing.assert_allclose(
            tstate.trace.numpy(),
            _flat_of(jstate.opt_state[0].trace, spec).numpy(),
            err_msg=f"{what}: trace", **TOL)
        np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
        for k in ("sent_bytes", "sent_bytes_wire_real", "fired_elems",
                  "fired_frac", "num_events", "num_deferred"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{what}: {k}")
        if "trace_fired" in jm:
            np.testing.assert_array_equal(tm["trace_fired"], jm["trace_fired"],
                                          err_msg=f"{what}: fire bits")
        if algo == "sp_eventgrad":
            _assert_sp_bytes(spec, kw.get("wire"), tm)
            np.testing.assert_array_equal(
                _bits(tstate.sparse.prev_sent),
                _bits(_flat_of(jstate.sparse.prev_sent, spec)),
                err_msg=f"{what}: prev_sent")
            for tr, jr in zip(tstate.sparse.replicas, jstate.sparse.replicas):
                np.testing.assert_array_equal(
                    _bits(tr), _bits(_flat_of(jr, spec)),
                    err_msg=f"{what}: replicas")
        if algo == "eventgrad":
            for tb, jb in zip(tstate.event.bufs, jstate.event.bufs):
                np.testing.assert_array_equal(
                    _bits(tb), _bits(_flat_of_arena(jb, spec)),
                    err_msg=f"{what}: receive buffers")
        if algo == "allreduce":
            # the port's contract: every rank holds the same parameters
            assert torch.equal(tstate.params,
                               tstate.params[:1].expand_as(tstate.params))


def _assert_sp_bytes(spec, wire, tm):
    """sp_eventgrad's bytes from the formula, per rank: the fired leaves'
    lanes (values + int32 indices) and int8 scales; the wire-real count
    ships every leaf's k lanes, its fire bit and its scale."""
    ks = np.array(SparseConfig(TOPK).ks(spec))
    vb = {None: 4, "bf16": 2, "int8": 1}[wire]
    sb = 4 if wire == "int8" else 0
    fired = tm["trace_fired"] > 0 if "trace_fired" in tm else None
    assert np.all(tm["sent_bytes_wire_real"] == 2 * (
        (vb + 4) * ks.sum() + spec.n_leaves + sb * spec.n_leaves))
    if fired is not None:
        np.testing.assert_array_equal(tm["sent_bytes"], 2 * (
            (vb + 4) * (fired * ks).sum(-1) + sb * fired.sum(-1)))


def test_train_runs_every_algo_on_every_model():
    """`train(model, topo, x, y, algo=a, device="cpu")` for the four
    algorithms on MLP, CNN2, LeNetCifar (with augmentation) and the
    small ResNet: finite losses, the records' keys."""
    cases = (
        (egt.MLP(), (28, 28, 1), {}),
        (egt.CNN2(), (28, 28, 1), {}),
        (egt.LeNetCifar(), (32, 32, 3), dict(augment=True)),
        (ResNet(**SMALL_RESNET), (32, 32, 3), {}),
    )
    for model, shape, kw in cases:
        x, y = jax_synthetic(64, shape, seed=1)
        for algo in ("allreduce", "dpsgd", "eventgrad", "sp_eventgrad"):
            state, hist = egt.train(
                model, egt.Ring(R), x, y, algo=algo, epochs=1,
                batch_size=PER_RANK, learning_rate=0.01, momentum=0.9,
                event_cfg=egt.EventConfig(warmup_passes=1),
                sparse_cfg=egt.SparseConfig(10.0), x_test=x[:16],
                y_test=y[:16], device="cpu", **kw)
            rec = hist[-1]
            assert np.isfinite(rec["loss"]) and state.pass_num == 2
            assert bool(torch.isfinite(state.params).all())
            event = algo in ("eventgrad", "sp_eventgrad")
            assert ("msgs_saved_pct" in rec) == event
            assert ("policy" in rec) == event
            if event:
                assert rec["policy"] == ("topk" if algo == "sp_eventgrad"
                                         else "norm_delta")
                assert 0.0 <= rec["msgs_saved_pct"] < 100.0
            if algo == "allreduce":
                assert rec["sent_bytes_per_step_per_chip"] == 4 * rec["n_params"]


def test_random_stream_is_the_states():
    """Dropout and augmentation draw from the state's generator only: the
    same generator state gives the same step bitwise, another one
    another step; a model without dropout and without augmentation
    draws nothing; a step that must draw refuses a state without one."""
    x, y = jax_synthetic(R * 2, (32, 32, 3), seed=2)
    batch = (torch.from_numpy(x.reshape(R, 2, 32, 32, 3)),
             torch.from_numpy(y.reshape(R, 2)).long())

    def one_step(model, rng_seed, **kw):
        step = make_train_step(model, Ring(R), "dpsgd", fused_sgd=(LR, 0.0),
                               **kw)
        st = egt.init_train_state(model, (32, 32, 3), Ring(R), "dpsgd",
                                  device="cpu")
        st.rng.manual_seed(rng_seed)
        return step(st, batch)[0]

    lenet = egt.LeNetCifar()
    a, b, c = (one_step(lenet, s, augment=True) for s in (5, 5, 6))
    assert torch.equal(a.params, b.params)
    assert not torch.equal(a.params, c.params)
    plain = one_step(ResNet(**SMALL_RESNET), 5)
    assert plain.rng.get_state().equal(
        torch.Generator().manual_seed(5).get_state())
    st = egt.init_train_state(lenet, (32, 32, 3), Ring(R), "dpsgd",
                              device="cpu").replace(rng=None)
    step = make_train_step(lenet, Ring(R), "dpsgd", fused_sgd=(LR, 0.0),
                           augment=True)
    with pytest.raises(ValueError, match="generator"):
        step(st, batch)


def test_epoch_byte_mean_is_exact():
    """The records' per-step byte counts average in float64: the
    sp_eventgrad ResNet-18 leg's 27,912,332 wire-real bytes a step are
    exact in float32, but a float32 mean over three steps reads
    27,912,330 (as the JAX loop's record would)."""
    from eventgrad_tpu_torch.train.loop import _step_mean

    steps = np.full((3, R), 27_912_332, np.float32)
    assert float(steps[..., 0].mean()) == 27_912_330.0
    assert _step_mean(steps) == 27_912_332.0
