"""The port's data path against the JAX package's: the bundled digit
scans array-equal (values and dtype) for both splits and geometries,
and the pad/flip/crop augmentation bitwise, given the JAX function's own
draws (it is pure data movement)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.data.augment import pad_flip_crop as jax_pad_flip_crop
from eventgrad_tpu.data.datasets import load_digits as jax_load_digits
from eventgrad_tpu_torch.data import datasets
from eventgrad_tpu_torch.data.augment import draw_pad_flip_crop, pad_flip_crop


@pytest.mark.parametrize("geometry", ["mnist", "cifar32"])
@pytest.mark.parametrize("split", ["train", "test"])
def test_load_digits_equals_jax(split, geometry):
    for seed in (0, 3):
        got = datasets.load_digits(split, seed=seed, geometry=geometry)
        want = jax_load_digits(split, seed=seed, geometry=geometry)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert np.array_equal(g, w)
    shape = (28, 28, 1) if geometry == "mnist" else (32, 32, 3)
    assert got[0].shape == ((1440 if split == "train" else 357),) + shape


def test_load_or_synthesize_digits():
    for name, geometry in (("digits", "mnist"), ("digits32", "cifar32")):
        got = datasets.load_or_synthesize(name, None, "test", seed=1)
        want = jax_load_digits("test", seed=1, geometry=geometry)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="geometry"):
        datasets.load_digits("train", geometry="svhn")


def _jax_draws(key, b, pad=4):
    """The draws `eventgrad_tpu.data.augment.pad_flip_crop` makes from
    `key`, made the way it makes them."""
    kf, kx, ky = jax.random.split(key, 3)
    flip = jax.random.bernoulli(kf, 0.5, (b,))
    ox = jax.random.randint(kx, (b,), 0, 2 * pad + 1)
    oy = jax.random.randint(ky, (b,), 0, 2 * pad + 1)
    return [torch.from_numpy(np.array(v)) for v in (flip, ox, oy)]


@pytest.mark.parametrize("shape", [(16, 32, 32, 3), (9, 28, 28, 1)])
def test_pad_flip_crop_bitwise_given_jax_draws(shape):
    images = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_pad_flip_crop(key, jnp.asarray(images)))
        flip, ox, oy = _jax_draws(key, shape[0])
        got = pad_flip_crop(torch.from_numpy(images), flip, ox, oy).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_pad_flip_crop_rank_stacked_and_draws():
    """`[R, B, H, W, C]` with `[R, B]` draws is the flat call per image;
    the draws cover their ranges."""
    r, b = 4, 256
    gen = torch.Generator().manual_seed(3)
    flip, ox, oy = draw_pad_flip_crop((r, b), gen, "cpu")
    assert flip.dtype == torch.bool and flip.shape == (r, b)
    assert abs(float(flip.float().mean()) - 0.5) < 5 * np.sqrt(0.25 / (r * b))
    for o in (ox, oy):
        assert o.shape == (r, b) and set(o.unique().tolist()) == set(range(9))
    x = torch.randn((r, b, 8, 8, 3), generator=gen)
    got = pad_flip_crop(x, flip, ox, oy)
    flat = pad_flip_crop(x.reshape(r * b, 8, 8, 3), flip.reshape(-1),
                         ox.reshape(-1), oy.reshape(-1))
    assert torch.equal(got, flat.reshape(got.shape))
    # centred crop, no flip: the identity
    z = torch.zeros((r, b), dtype=torch.long)
    assert torch.equal(pad_flip_crop(x, z.bool(), z + 4, z + 4), x)
