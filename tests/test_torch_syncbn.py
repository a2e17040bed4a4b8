"""`sync_bn`: the BatchNorm running statistics averaged over the ranks
after the update, the port's step against the JAX step.

One D-PSGD pass of a one-block ResNet (three BatchNorms) on Ring(4),
4 samples a rank, both steps built with `sync_bn=True` from the same
state (the JAX `init_train_state` carried across with
`convert.params_from_jax`). As in `tests/test_torch_step.py`, both
models compute in float64 (float32 gradients of this net on 4-sample
batches are ill-conditioned), parameters and statistics stay float32,
and the tolerance is that file's: rtol=1e-4, atol=1e-5. The synced
statistics are the same on every rank, and differ from the unsynced
step's. The JAX step compiles once in this module.

The port's own contract: the bucketed schedule (K = 2) with `sync_bn`
gives the monolithic step's bits.
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
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models.resnet import BasicBlock, ResNet
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import TrainState, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
#: one stage of one block (stem, two convolutions, three BatchNorms):
#: the smallest ResNet the JAX step compiles quickly
SMALL = dict(stage_sizes=(1,), num_filters=4, extra_block=False)
R, PER_RANK, SHAPE = 4, 4, (4, 4, 3)
LR, MOM = 0.01, 0.9


def _batch():
    x, y = jax_synthetic(R * PER_RANK, SHAPE, seed=4)
    return x.reshape((R, PER_RANK) + SHAPE), y.reshape((R, PER_RANK))


def _stats_of(jstats):
    return {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jstats)[0]}


@pytest.fixture(scope="module")
def both():
    """(JAX state after the synced pass, the port's, the port's unsynced
    pass, the arena spec)."""
    jmodel = JaxResNet(block_cls=JaxBasicBlock, dtype=jnp.float64, **SMALL)
    tmodel = ResNet(block_cls=BasicBlock, dtype=torch.float64, **SMALL)
    spec = arena_spec(tmodel)
    tx = optax.sgd(LR, momentum=MOM)
    x, y = _batch()
    with jax.enable_x64(True):
        jstate = jax_init_state(jmodel, SHAPE, tx, JaxRing(R), "dpsgd",
                                seed=0, arena=True)
        tp, ts = convert.params_from_jax(
            jax.tree.map(np.asarray, jstate.params),
            jax.tree.map(np.asarray, jstate.batch_stats), stacked=True)
        flat = spec.ravel(tp)
        jstep = jax.jit(spmd(jax_make_step(
            jmodel, tx, JaxRing(R), "dpsgd", fused_sgd=(LR, MOM),
            arena=True, sync_bn=True), JaxRing(R)))
        jnew, _ = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        jnew = jax.tree.map(np.asarray, jnew)
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    out = {}
    for sync in (True, False):
        state = TrainState(params=flat.clone(),
                           trace=torch.zeros_like(flat),
                           batch_stats={k: v.clone() for k, v in ts.items()},
                           pass_num=0)
        step = make_train_step(tmodel, Ring(R), "dpsgd",
                               fused_sgd=(LR, MOM), sync_bn=sync)
        out[sync], _ = step(state, batch)
    return jnew, out[True], out[False], spec


def test_synced_step_matches_jax(both):
    jnew, tnew, _, spec = both
    tp, _ = convert.params_from_jax(jnew.params, stacked=True)
    np.testing.assert_allclose(tnew.params.numpy(),
                               spec.ravel(tp).numpy(), **TOL)
    jstats = _stats_of(jnew.batch_stats)
    assert list(tnew.batch_stats) == list(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(tnew.batch_stats[k].numpy(), v,
                                   err_msg=k, **TOL)


def test_synced_stats_agree_across_ranks(both):
    jnew, tnew, unsynced, _ = both
    for k, v in tnew.batch_stats.items():
        assert v.is_contiguous()
        assert torch.equal(v, v[:1].expand_as(v)), k
        assert (np.asarray(v) == np.asarray(v)[:1]).all()
    for v in _stats_of(jnew.batch_stats).values():
        np.testing.assert_allclose(v, np.broadcast_to(v[:1], v.shape),
                                   **TOL)
    # the ranks saw different batches: unsynced, their statistics differ
    assert any(not torch.equal(v, v[:1].expand_as(v))
               for v in unsynced.batch_stats.values())


def test_bucketed_sync_bn_is_the_monolithic_step():
    model = ResNet(block_cls=BasicBlock, dtype=torch.float64, **SMALL)
    cfg = EventConfig(warmup_passes=1)
    x, y = _batch()
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    got = []
    for k in (None, 2):
        state = init_train_state(model, SHAPE, Ring(R), "eventgrad", cfg,
                                 momentum=MOM, bucketed=k, device="cpu")
        step = make_train_step(model, Ring(R), "eventgrad", cfg,
                               fused_sgd=(LR, MOM), bucketed=k,
                               sync_bn=True)
        for _ in range(2):
            state, _ = step(state, batch)
        got.append(state)
    assert torch.equal(got[0].params, got[1].params)
    for k, v in got[0].batch_stats.items():
        assert torch.equal(v, got[1].batch_stats[k]), k
        assert torch.equal(v, v[:1].expand_as(v)), k
