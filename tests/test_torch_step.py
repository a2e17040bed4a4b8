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
    share of those flipped bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_dataset as jax_synthetic
from eventgrad_tpu.models.resnet import BasicBlock as JaxBasicBlock
from eventgrad_tpu.models.resnet import ResNet as JaxResNet
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu.utils.metrics import msgs_saved_pct as jax_msgs_saved
from eventgrad_tpu_torch import convert, ops
from eventgrad_tpu_torch.models.resnet import ResNet
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import TrainState
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


def _port_state(jstate, spec, topo, algo):
    """The port's TrainState holding the JAX state's values."""
    tp, ts = convert.params_from_jax(
        jax.tree.map(np.asarray, jstate.params),
        jax.tree.map(np.asarray, jstate.batch_stats), stacked=True,
    )
    flat = spec.ravel(tp)
    event = None
    if algo == "eventgrad":
        event = EventState.init(spec, topo, EventConfig(**CFG), device="cpu")
    return TrainState(params=flat, trace=torch.zeros_like(flat),
                      batch_stats=ts, pass_num=0, event=event)


def _run_both(algo, n_steps):
    jmodel = JaxResNet(block_cls=JaxBasicBlock, dtype=jnp.float64, **SMALL)
    tmodel = ResNet(dtype=torch.float64, **SMALL)
    spec = arena_spec(tmodel)
    jtopo, topo = JaxRing(R), Ring(R)
    tx = optax.sgd(LR, momentum=MOM)
    tstep = make_train_step(tmodel, topo, algo, EventConfig(**CFG),
                            fused_sgd=(LR, MOM), trace=True)
    passes = []
    with jax.enable_x64(True):
        jstate = jax_init_state(jmodel, SHAPE, tx, jtopo, algo,
                                JaxEventConfig(**CFG), seed=0, arena=True)
        tstate = _port_state(jstate, spec, topo, algo)
        jstep = jax.jit(spmd(jax_make_step(
            jmodel, tx, jtopo, algo, JaxEventConfig(**CFG),
            fused_sgd=(LR, MOM), trace=True, arena=True,
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
    spec, passes = eventgrad_run
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
        "masked_wire": 0, "fused_mix_commit": 0, "fused_mix_sgd": 0,
    }
