"""The port's tensor-parallel transformer against the JAX package's, on
the CPU.

The same numpy tokens through `eventgrad_tpu.models.tp` and
`eventgrad_tpu_torch.models.tp` at a small size (dim 32, 2 heads, 2
layers, T 16): the parameter conversion rank by rank, the forward on a
`dp:2,tp:2` mesh from weights carried across by `convert.py`, the
sharded initialization's contract, and one EventGraD, one D-PSGD and
one allreduce pass on that mesh from the carried JAX state
(`_torch_hybrid.py` states the shared tolerances: logits rtol=1e-4,
atol=1e-5 as well). Allreduce on `dp x tp` averages over dp only: each
tp shard takes the gradient of its own slice, held here against the
JAX step as in the JAX package's own test of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models.tp import TPTransformerLM as JaxTP
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models.tp import TPTransformerLM
from eventgrad_tpu_torch.parallel.arena import arena_spec, flax_order
from eventgrad_tpu_torch.train.state import init_train_state

from _torch_hybrid import (
    LM, T, TOL, assert_gossip_bytes, check_passes, lm_batches, mesh,
    np_tree, run_both,
)

SPEC = "dp:2,tp:2"


def _models():
    return (JaxTP(**LM, axis="tp", tp_size=2),
            TPTransformerLM(**LM, axis="tp", tp_size=2))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX state of the mesh, initialized once for the module."""
    from eventgrad_tpu.train.state import init_train_state_spmd
    import optax

    jtopo, _ = mesh(SPEC)
    return init_train_state_spmd(_models()[0], (T,), optax.sgd(0.1), jtopo,
                                 "dpsgd", input_dtype=jnp.int32)


def test_leaf_names_shapes_and_round_trip(jax_init):
    """The port's leaves are the flax leaves (names, shapes in torch
    layout: the `tp_kernel`s transposed), in flax order; the stacked JAX
    state carries across rank by rank and back bitwise."""
    jparams = np_tree(jax_init.params)
    tp, _ = convert.params_from_jax(jparams, stacked=True)
    model = _models()[1]
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert tuple(tp) == flax_order(shapes)
    for name, t in tp.items():
        assert tuple(t.shape[1:]) == shapes[name], name
    assert "TPBlock_0.ColParallelDense_0.tp_kernel" in tp
    back, _ = convert.params_to_jax(tp, stacked=True)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(jparams),
            jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(a, b)


def test_sharded_init_contract():
    """The port's own initialization: replicated leaves identical on the
    whole mesh, `tp_` leaves equal along dp and distinct along tp."""
    _, topo = mesh(SPEC)
    model = _models()[1]
    state = init_train_state(model, (T,), topo, "dpsgd", device="cpu")
    spec = arena_spec(model)
    leaves = spec.unravel(state.params)
    for name, v in leaves.items():
        grid = v.reshape((2, 2) + tuple(v.shape[1:]))
        assert torch.equal(grid[0], grid[1]), name  # along dp
        if "tp_kernel" in name:
            assert not torch.equal(grid[:, 0], grid[:, 1]), name
        else:
            assert torch.equal(grid[:, 0], grid[:, 1]), name


def test_init_shards_draw_replicated_leaves_once():
    """`init_shards` gives each shard index the dict that
    `init_variables(shard=i)` gives, with the replicated leaves drawn
    once: every shard's dict holds the same tensors."""
    model = _models()[1]
    shards = model.init_shards(3, (0, 1))
    for i, got in enumerate(shards):
        want, _ = model.init_variables(3, shard=i)
        assert list(got) == list(want)
        for name in want:
            assert torch.equal(got[name], want[name]), (i, name)
    for name in shards[0]:
        assert (shards[0][name] is shards[1][name]) == (
            "tp_kernel" not in name), name


def test_forward_matches_jax(jax_init):
    jmodel, tmodel = _models()
    jtopo, topo = mesh(SPEC)
    x, _ = lm_batches(jtopo, 1)[0]
    want = spmd(lambda p, t: jmodel.apply({"params": p}, t), jtopo)(
        jax_init.params, jnp.asarray(x))
    tp, _ = convert.params_from_jax(np_tree(jax_init.params), stacked=True)
    got, aux = tmodel.forward_stacked(tp, torch.from_numpy(x).long(), topo)
    assert aux == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_step_matches_jax(algo):
    """Two passes (warmup 1, then the trigger decides); the gossip rides
    dp only, so msgs-saved-% and the bytes count two neighbours."""
    jmodel, tmodel = _models()
    jtopo, _ = mesh(SPEC)
    spec, topo, passes = run_both(jmodel, tmodel, SPEC, algo,
                                  lm_batches(jtopo, 2), (T,))
    fired = check_passes(algo, spec, topo, passes)
    assert_gossip_bytes(algo, spec, topo, passes)
    if algo == "eventgrad":
        assert 0 < fired < topo.n_ranks * spec.n_leaves


def test_allreduce_times_tp_matches_jax():
    """`algo="allreduce"` on `dp x tp`: the gradients average over dp
    only (the sharded kernels take their own shard's gradient)."""
    jmodel, tmodel = _models()
    jtopo, _ = mesh(SPEC)
    spec, topo, passes = run_both(jmodel, tmodel, SPEC, "allreduce",
                                  lm_batches(jtopo, 1), (T,))
    check_passes("allreduce", spec, topo, passes)
    params = passes[0][2].params.reshape(2, 2, -1)
    assert torch.equal(params[0], params[1])  # one model per tp shard
