"""The port's small classifiers (MLP, CNN1, CNN2, LeNetCifar) against
flax, with weights carried across by `convert`.

Flax-initialized weights go through `convert.params_from_jax`; both
sides compute in float64 (the float32 weights widened exactly), in eval
mode (dropout off). The forward and the parameter gradients of the
cross-entropy must agree within rtol=1e-10 (atol=1e-12 for entries near
zero): every layer reduces (dense and convolution sums, max-pool,
log-softmax), and the two frameworks sum in another order, so bitwise
is not on offer; float64 keeps the difference at rounding.

Dropout is checked twice. Against flax: the keep bits flax's
`nn.Dropout` draws in a train-mode pass are read back from its outputs
(`flax.linen.intercept_methods`) and handed to the port's train-mode
forward, whose output and gradients must then agree at the same
tolerance. On the port's own terms: the keep bits are drawn outside the
model from an explicit generator (`models.common.draw_dropout`), keep
about half, scale the kept values by exactly 1/keep_prob, and Dropout2d
holds one bit per (sample, channel) across the spatial dims.
"""

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from eventgrad_tpu.train.steps import _xent as jax_xent
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models import MODEL_REGISTRY
from eventgrad_tpu_torch.models.common import draw_dropout, dropout
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.train.steps import _xent

TOL = dict(rtol=1e-10, atol=1e-12)
#: registry key -> (input shape, parameter count, leaves) of the JAX model
SMALL = {
    "mlp": ((28, 28, 1), 101_770, 4),
    "cnn1": ((28, 28, 1), 38_390, 8),
    "cnn2": ((28, 28, 1), 27_480, 8),
    "lenet_cifar": ((32, 32, 3), 62_006, 10),
}


def _flat(tree):
    return {
        ".".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module", params=sorted(SMALL))
def pair(request):
    key = request.param
    shape = SMALL[key][0]
    jmodel = JAX_REGISTRY[key]()
    tmodel = MODEL_REGISTRY[key](dtype=torch.float64)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.asarray(x))
    params_np = jax.tree.map(np.asarray, variables["params"])
    return key, jmodel, tmodel, x, y, params_np


def test_shapes_match_jax(pair):
    key, _, tmodel, _, _, params_np = pair
    spec = arena_spec(tmodel)
    _, n_params, n_leaves = SMALL[key]
    assert (spec.n_total, spec.n_leaves) == (n_params, n_leaves)
    tp, _ = convert.params_from_jax(params_np)
    assert list(tp) == list(spec.names)
    for name, shape in zip(spec.names, spec.shapes):
        assert tuple(tp[name].shape) == shape, name


def test_convert_round_trip(pair):
    _, _, tmodel, _, _, params_np = pair
    tp, ts = convert.params_from_jax(params_np)
    assert ts == {}
    back, _ = convert.params_to_jax(tp)
    want, got = _flat(params_np), _flat(back)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's own init goes through the same layouts
    init, _ = tmodel.init_variables(0)
    again, _ = convert.params_from_jax(convert.params_to_jax(init)[0])
    for k in init:
        assert torch.equal(again[k], init[k]), k


def test_forward_and_gradients_match_flax(pair):
    _, jmodel, tmodel, x, y, params_np = pair
    tp, _ = convert.params_from_jax(params_np)
    tp = {k: v.double() for k, v in tp.items()}
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y).long()

    def tloss(p):
        out = torch.func.functional_call(tmodel, p, (xt, {}, False))
        return _xent(out, yt), out

    tgrad, tout = torch.func.grad(tloss, has_aux=True)(tp)
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params_np)
        jx = jnp.asarray(x, jnp.float64)

        def jloss(p):
            out = jmodel.apply({"params": p}, jx, train=False)
            return jax_xent(out, jnp.asarray(y)), out

        jgrad, jout = jax.grad(jloss, has_aux=True)(jp)
        jout = np.asarray(jout)
        jgrad_np = jax.tree.map(np.asarray, jgrad)
    assert tout.dtype == torch.float64 and jout.dtype == np.float64
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)
    want = _flat(jgrad_np)
    assert list(tgrad) == list(want)
    for k in want:
        np.testing.assert_allclose(_flax_layout(tgrad[k].numpy()), want[k],
                                   err_msg=k, **TOL)


def _flax_keep_bits(jmodel, params, x, key):
    """{site: keep bits in the port's layout} of flax's train-mode pass
    with dropout key `key`, read from each `nn.Dropout`'s output: a
    kept value is its input over keep_prob, a dropped one 0 (the inputs
    are never 0 where it matters: conv outputs, and post-ReLU zeros
    whose keep bit changes no value and no gradient)."""
    keep = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if (isinstance(context.module, flax_nn.Dropout)
                and context.method_name == "__call__"):
            bits = np.asarray(out) != 0
            if bits.ndim == 4:  # Dropout2d: [B, 1, 1, C] -> [B, C, 1, 1]
                bits = bits.any(axis=(1, 2))[:, :, None, None]
            keep[context.module.name] = torch.from_numpy(bits)
        return out

    with flax_nn.intercept_methods(grab):
        jmodel.apply({"params": params}, x, train=True,
                     rngs={"dropout": key})
    return keep


@pytest.mark.parametrize("key", ["cnn1", "cnn2", "lenet_cifar"])
def test_train_mode_dropout_matches_flax(key):
    shape = SMALL[key][0]
    jmodel = JAX_REGISTRY[key]()
    tmodel = MODEL_REGISTRY[key](dtype=torch.float64)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6,) + shape).astype(np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    params_np = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    tp, _ = convert.params_from_jax(params_np)
    tp = {k: v.double() for k, v in tp.items()}
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y).long()
    with jax.enable_x64(True):
        jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params_np)
        jx, dkey = jnp.asarray(x, jnp.float64), jax.random.PRNGKey(9)
        keep = _flax_keep_bits(jmodel, jp, jx, dkey)

        def jloss(p):
            out = jmodel.apply({"params": p}, jx, train=True,
                               rngs={"dropout": dkey})
            return jax_xent(out, jnp.asarray(y)), out

        jgrad, jout = jax.grad(jloss, has_aux=True)(jp)
        jout, jgrad = np.asarray(jout), jax.tree.map(np.asarray, jgrad)
    sites = tmodel.dropout_sites(6)
    assert list(keep) == list(sites)
    for name, (shp, _) in sites.items():
        assert tuple(keep[name].shape) == shp
        assert 0 < int(keep[name].sum()) < keep[name].numel()

    def tloss(p):
        out, _ = torch.func.functional_call(tmodel, p, (xt, {}, True),
                                            {"drop": keep})
        return _xent(out, yt), out

    tgrad, tout = torch.func.grad(tloss, has_aux=True)(tp)
    np.testing.assert_allclose(tout.numpy(), jout, **TOL)
    want = _flat(jgrad)
    for k in want:
        np.testing.assert_allclose(_flax_layout(tgrad[k].numpy()), want[k],
                                   err_msg=k, **TOL)


def _flax_layout(a):
    """A float64 leaf in flax's layout (`convert` carries float32):
    OIHW -> HWIO, (out, in) -> (in, out)."""
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a.T if a.ndim == 2 else a


def test_train_forward_needs_keep_bits():
    model = MODEL_REGISTRY["cnn2"]()
    params, _ = model.init_variables(0)
    x = torch.zeros((2, 28, 28, 1))
    with pytest.raises(ValueError, match="keep bits"):
        torch.func.functional_call(model, params, (x, {}, True))
    # models without dropout draw nothing
    assert MODEL_REGISTRY["mlp"]().dropout_sites(4) == {}


def test_dropout_keep_bits_statistics():
    model = MODEL_REGISTRY["cnn2"]()
    r, b = 8, 512
    sites = model.dropout_sites(b)
    assert sites == {"Dropout_0": ((b, 20, 1, 1), 0.5),
                     "Dropout_1": ((b, 50), 0.5)}
    gen = torch.Generator().manual_seed(5)
    keep = draw_dropout(sites, (r,), gen, "cpu")
    for name, (shape, rate) in sites.items():
        k = keep[name]
        assert k.dtype == torch.bool and tuple(k.shape) == (r,) + shape
        n = k.numel()
        share = float(k.float().mean())
        # Bernoulli(0.5): the share within 5 standard deviations
        assert abs(share - (1 - rate)) < 5 * np.sqrt(0.25 / n), (name, share)
    # the same generator state draws the same bits; a new one others
    again = draw_dropout(sites, (r,), torch.Generator().manual_seed(5), "cpu")
    assert all(torch.equal(again[k], keep[k]) for k in keep)
    # Dropout2d: one bit per (sample, channel), broadcast over H and W,
    # kept values scaled by exactly 1 / keep_prob
    x = torch.randn((r, b, 20, 11, 11), generator=gen) + 3.0
    out = dropout(x, keep["Dropout_0"], 0.5)
    kept = keep["Dropout_0"].expand_as(x)
    assert torch.equal(out[kept], x[kept] * 2.0)
    assert torch.all(out[~kept] == 0)
    per_channel = (out != 0).flatten(3)
    assert torch.all(per_channel.all(-1) | ~per_channel.any(-1))


def test_registry_matches_jax_keys():
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)
    # the BasicBlock and Bottleneck ResNets, built on the meta device, with
    # the JAX model's leaves: names and sizes in JAX's leaf order
    for key in ("resnet34", "resnet50", "resnet101", "resnet152"):
        jparams = jax.eval_shape(
            JAX_REGISTRY[key]().init, jax.random.PRNGKey(0),
            jnp.zeros((1, 32, 32, 3)))["params"]
        model = MODEL_REGISTRY[key]()
        assert next(model.parameters()).device.type == "meta"
        spec = arena_spec(model)
        flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
        names = [".".join(str(k.key) for k in path) for path, _ in flat]
        sizes = [int(np.prod(v.shape)) for _, v in flat]
        assert list(spec.names) == names, key
        assert list(spec.sizes) == sizes, key
        if key == "resnet50":
            assert (spec.n_total, spec.n_leaves) == (29_451_082, 197)
