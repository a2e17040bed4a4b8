"""The port's ResNet against the flax ResNet, with weights carried across.

Flax-initialized weights go through `convert.params_from_jax`; the
train-mode forward logits, the updated batch statistics, the eval-mode
logits and the gradients (mapped back with `convert.params_to_jax`)
must agree within rtol=1e-4, atol=1e-5 in float32 — the convolutions
and reductions sum in another order than XLA:CPU's, so bitwise is not
on offer. The gradients are held against the flax model run in float64
(see `test_gradients_match_flax`).

Each check runs on the BasicBlock ResNet (`test_<check>`) and on the
Bottleneck one (`test_bottleneck_<check>`), both at the small geometry
(one block a stage, plus the reference's extra block; 8 base filters).

`test_relu_derivative_matches_flax` holds the port's relu to flax's
`nn.relu`, value and gradient, NaN for NaN, on NaNs, zeros, infinities
and signed values, under `torch.func.vjp` and `vmap` as the step runs
it, and its forward to torch's relu bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models.resnet import BasicBlock as JaxBasicBlock
from eventgrad_tpu.models.resnet import Bottleneck as JaxBottleneck
from eventgrad_tpu.models.resnet import ResNet as JaxResNet
from eventgrad_tpu.train.steps import _xent as jax_xent
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models.activation import relu
from eventgrad_tpu_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.spmd import per_rank
from eventgrad_tpu_torch.train.steps import _xent

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(stage_sizes=(1, 1, 1, 1), num_filters=8)


def _setup(jblock, tblock):
    """(jmodel, tmodel, x, y, params_np, stats_np, jblock): the flax and
    the port's ResNet of one block type, a batch, and flax weights."""
    jmodel = JaxResNet(block_cls=jblock, **SMALL)
    tmodel = ResNet(block_cls=tblock, **SMALL)
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
    return jmodel, tmodel, x, y, params_np, stats_np, jblock


@pytest.fixture(scope="module")
def setup():
    return _setup(JaxBasicBlock, BasicBlock)


@pytest.fixture(scope="module")
def bottleneck():
    return _setup(JaxBottleneck, Bottleneck)


def _flat(tree):
    return {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _convert_round_trip(setup):
    _, tmodel, _, _, params_np, stats_np, _ = setup
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


def _forward_train_and_eval(setup):
    jmodel, tmodel, x, _, params_np, stats_np, _ = setup
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


def _gradients(setup):
    """The oracle is the flax model's gradient in float64. In float32
    the gradient of this net on a 4-sample batch is ill-conditioned: a
    ReLU input within rounding of zero can land on the other side, and
    on this batch XLA:CPU's float32 gradient departs from its float64
    one by up to ~6e-4 (stem_conv.kernel, and every leaf below
    BasicBlock_5.BatchNorm_0) while the port's float32 gradient stays
    within ~1e-6 of it. The float32 JAX gradient therefore cannot serve
    as the reference at this tolerance."""
    _, tmodel, x, y, params_np, stats_np, jblock = setup
    jmodel64 = JaxResNet(block_cls=jblock, dtype=jnp.float64, **SMALL)

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


def _rank_vmap(setup):
    """`per_rank` over the leading rank dimension equals separate calls."""
    _, tmodel, x, y, params_np, stats_np, _ = setup
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


def _init_flax_like(setup):
    jmodel, tmodel, x, _, _, _, _ = setup
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


CHECKS = {
    "convert_round_trip": _convert_round_trip,
    "forward_train_and_eval_match_flax": _forward_train_and_eval,
    "gradients_match_flax": _gradients,
    "rank_vmap_matches_per_rank_calls": _rank_vmap,
    "init_is_flax_like": _init_flax_like,
}


def test_convert_round_trip(setup):
    _convert_round_trip(setup)


def test_forward_train_and_eval_match_flax(setup):
    _forward_train_and_eval(setup)


def test_gradients_match_flax(setup):
    _gradients(setup)


def test_rank_vmap_matches_per_rank_calls(setup):
    _rank_vmap(setup)


def test_init_is_flax_like(setup):
    _init_flax_like(setup)


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_bottleneck(bottleneck, check):
    """Every check above on the Bottleneck ResNet: 1x1, 3x3 (the stride),
    1x1 to 4 x filters, a projection wherever the shapes differ (the
    first block of every stage here, stride 1 in the first stage), and
    flax's key order in the leaves (`BatchNorm_*` < `Conv_*` <
    `downsample_*` inside a block; `Bottleneck_10` < `Bottleneck_2`)."""
    CHECKS[check](bottleneck)


def test_bottleneck_leaf_order_on_equal_shapes(bottleneck):
    """A wrong leaf order fails no shape check where leaves share a shape:
    the Bottleneck's BatchNorm_0/1 (and bias/scale) are all [filters]. The
    converted values land on their own names: each flax leaf filled with
    its own index comes back in the port's dict under its name, in flax
    order, and the arena's segments hold them in that order."""
    _, tmodel, _, _, params_np, _, _ = bottleneck
    names = list(_flat(params_np))
    tagged = {}
    for i, name in enumerate(names):
        node = tagged
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.full(_flat(params_np)[name].shape, float(i),
                             np.float32)
    tp, _ = convert.params_from_jax(tagged)
    spec = arena_spec(tmodel)
    assert list(tp) == names == list(spec.names)
    flat = spec.ravel({k: v[None] for k, v in tp.items()})[0]
    for i, (start, size) in enumerate(zip(spec.starts, spec.sizes)):
        assert bool((flat[start:start + size] == float(i)).all()), names[i]
    same = [n for n in names
            if n.startswith(("Bottleneck_1.BatchNorm_0.",
                             "Bottleneck_1.BatchNorm_1."))]
    assert len({tuple(tp[n].shape) for n in same}) == 1 and len(same) == 4


def test_relu_derivative_matches_flax():
    """flax's relu stops a NaN input's gradient (`select(x > 0, g, 0)`),
    where torch's own relu passes it on: the port's relu gives flax's
    values and gradients, NaN for NaN and value for value, per rank under
    vmap."""
    import flax.linen as fnn

    x = np.array([[np.nan, -np.nan, 0.0, -0.0, 1.5, -2.0, np.inf, -np.inf],
                  [3.0, np.nan, -1.0, 0.0, 2.0, np.nan, -0.5, 7.0]],
                 np.float32)
    g = np.array([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0],
                  [np.nan, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]], np.float32)
    jy, jvjp = jax.vjp(fnn.relu, jnp.asarray(x))
    (jg,) = jvjp(jnp.asarray(g))
    tx, tgo = torch.from_numpy(x), torch.from_numpy(g)
    ty = relu(tx)
    (tg,) = per_rank(lambda xi, gi: torch.func.vjp(relu, xi)[1](gi))(tx, tgo)
    for a, b in ((ty.numpy(), np.asarray(jy)), (tg.numpy(), np.asarray(jg))):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(np.nan_to_num(a), np.nan_to_num(b))
    assert tg[0, 0].item() == 0.0
    # the forward is torch's relu bit for bit, NaN signs included
    assert torch.equal(ty.view(torch.int32), torch.relu(tx).view(torch.int32))
    # torch's own relu passes the NaN input's gradient on
    t = tx.clone().requires_grad_()
    torch.relu(t).backward(tgo)
    assert t.grad[0, 0].item() == g[0, 0]
