"""The port's ResNet against the flax ResNet, with weights carried across.

Flax-initialized weights go through `convert.params_from_jax`; the
train-mode forward logits, the updated batch statistics, the eval-mode
logits and the gradients (mapped back with `convert.params_to_jax`)
must agree within rtol=1e-4, atol=1e-5 in float32 — the convolutions
and reductions sum in another order than XLA:CPU's, so bitwise is not
on offer. The gradients are held against the flax model run in float64
(see `test_gradients_match_flax`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models.resnet import BasicBlock as JaxBasicBlock
from eventgrad_tpu.models.resnet import ResNet as JaxResNet
from eventgrad_tpu.train.steps import _xent as jax_xent
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models.resnet import ResNet
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.spmd import per_rank
from eventgrad_tpu_torch.train.steps import _xent

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxResNet(block_cls=JaxBasicBlock, **SMALL)
    tmodel = ResNet(**SMALL)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    # non-trivial running statistics, so the update and eval use them
    stats = jax.tree.map(
        lambda s: jnp.asarray(rng.uniform(0.5, 1.5, s.shape), jnp.float32),
        variables["batch_stats"],
    )
    params_np = jax.tree.map(np.asarray, variables["params"])
    stats_np = jax.tree.map(np.asarray, stats)
    return jmodel, tmodel, x, y, params_np, stats_np


def _flat(tree):
    return {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_convert_round_trip(setup):
    _, tmodel, _, _, params_np, stats_np = setup
    tp, ts = convert.params_from_jax(params_np, stats_np)
    assert list(tp) == list(arena_spec(tmodel).names)
    for name, t in tp.items():
        assert tuple(t.shape) == tuple(dict(tmodel.named_parameters())[name].shape)
    back_p, back_s = convert.params_to_jax(tp, ts)
    for got, want in ((back_p, params_np), (back_s, stats_np)):
        fg, fw = _flat(got), _flat(want)
        assert list(fg) == list(fw)
        for k in fw:
            np.testing.assert_array_equal(fg[k], fw[k])


def test_forward_train_and_eval_match_flax(setup):
    jmodel, tmodel, x, _, params_np, stats_np = setup
    variables = {"params": params_np, "batch_stats": stats_np}
    out_j, upd = jmodel.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    tp, ts = convert.params_from_jax(params_np, stats_np)
    out_t, new_stats = torch.func.functional_call(
        tmodel, tp, (torch.from_numpy(x), ts, True)
    )
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    _, stats_back = convert.params_to_jax(tp, new_stats)
    fj, ft = _flat(upd["batch_stats"]), _flat(stats_back)
    assert list(ft) == list(fj)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], err_msg=k, **TOL)
    ev_j = jmodel.apply(variables, jnp.asarray(x), train=False)
    ev_t = torch.func.functional_call(tmodel, tp, (torch.from_numpy(x), ts, False))
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), **TOL)


def test_gradients_match_flax(setup):
    """The oracle is the flax model's gradient in float64. In float32
    the gradient of this net on a 4-sample batch is ill-conditioned: a
    ReLU input within rounding of zero can land on the other side, and
    on this batch XLA:CPU's float32 gradient departs from its float64
    one by up to ~6e-4 (stem_conv.kernel, and every leaf below
    BasicBlock_5.BatchNorm_0) while the port's float32 gradient stays
    within ~1e-6 of it. The float32 JAX gradient therefore cannot serve
    as the reference at this tolerance."""
    _, tmodel, x, y, params_np, stats_np = setup
    jmodel64 = JaxResNet(block_cls=JaxBasicBlock, dtype=jnp.float64, **SMALL)

    with jax.enable_x64(True):
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)
        stats64 = to64(stats_np)

        def jloss(p):
            out, _ = jmodel64.apply({"params": p, "batch_stats": stats64},
                                    jnp.asarray(x, jnp.float64), train=True,
                                    mutable=["batch_stats"])
            return jax_xent(out, jnp.asarray(y))

        loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(to64(params_np))
        loss_j = float(loss_j)
        grads_j = jax.tree.map(lambda a: np.asarray(a, np.float32), grads_j)
    tp, ts = convert.params_from_jax(params_np, stats_np)

    def tloss(p):
        out, _ = torch.func.functional_call(
            tmodel, p, (torch.from_numpy(x), ts, True)
        )
        return _xent(out, torch.from_numpy(y).long())

    grads_t, loss_t = torch.func.grad_and_value(tloss)(tp)
    np.testing.assert_allclose(float(loss_t), float(loss_j), **TOL)
    back, _ = convert.params_to_jax(grads_t)
    fj, ft = _flat(grads_j), _flat(back)
    assert list(ft) == list(fj)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], err_msg=k, **TOL)


def test_rank_vmap_matches_per_rank_calls(setup):
    """`per_rank` over the leading rank dimension equals separate calls."""
    _, tmodel, x, y, params_np, stats_np = setup
    tp, ts = convert.params_from_jax(params_np, stats_np)
    rng = np.random.default_rng(2)
    r = 3
    stacked = {k: v[None] + 0.01 * torch.from_numpy(
        rng.standard_normal((r,) + tuple(v.shape)).astype(np.float32))
        for k, v in tp.items()}
    sts = {k: v[None].repeat(r, *([1] * v.dim())) for k, v in ts.items()}
    xs = torch.from_numpy(np.stack([x, x[::-1].copy(), x * 0.5]))

    def fwd(p, s, xb):
        return torch.func.functional_call(tmodel, p, (xb, s, True))

    out, new = per_rank(fwd)(stacked, sts, xs)
    for i in range(r):
        o, ns = fwd({k: v[i] for k, v in stacked.items()},
                    {k: v[i] for k, v in sts.items()}, xs[i])
        np.testing.assert_allclose(out[i].numpy(), o.numpy(), **TOL)
        for k in ns:
            np.testing.assert_allclose(new[k][i].numpy(), ns[k].numpy(), **TOL)


def test_init_is_flax_like(setup):
    jmodel, tmodel, x, _, _, _ = setup
    params, stats = tmodel.init_variables(seed=3)
    shapes_j = {
        ".".join(str(k.key) for k in path): v
        for path, v in jax.tree_util.tree_flatten_with_path(jax.eval_shape(
            lambda k: jmodel.init(k, jnp.asarray(x)), jax.random.PRNGKey(0)
        )["params"])[0]
    }
    back, stats_back = convert.params_to_jax(params, stats)
    fb = _flat(back)
    assert list(fb) == list(shapes_j)
    for k, v in fb.items():
        assert v.shape == shapes_j[k].shape, k
        leaf = k.rsplit(".", 1)[1]
        if leaf == "kernel":
            fan_in = int(np.prod(shapes_j[k].shape[:-1]))
            assert np.abs(v).max() <= 2.0 / 0.87962566 / np.sqrt(fan_in) + 1e-6
            if v.size >= 4096:  # enough draws for a 10% check on the std
                assert abs(v.std() * np.sqrt(fan_in) - 1.0) < 0.1, k
        elif leaf == "scale":
            np.testing.assert_array_equal(v, 1.0)
        else:
            np.testing.assert_array_equal(v, 0.0)
    for k, v in _flat(stats_back).items():
        np.testing.assert_array_equal(v, 0.0 if k.endswith("mean") else 1.0)
    # the same seed gives the same weights
    again, _ = tmodel.init_variables(seed=3)
    for k in params:
        assert torch.equal(params[k], again[k])
