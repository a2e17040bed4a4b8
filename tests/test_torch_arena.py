"""The port's arena, topology, exchange and data against the JAX package.

* `ArenaSpec` sizes, starts and segment map equal the JAX spec's for the
  flagship ResNet-18 (from shapes only: `jax.eval_shape` on one side, a
  model on the meta device on the other).
* The roll of the rank dimension receives from the same rank as JAX's
  ppermute exchange, on a rank-id payload.
* The flat exchanges and the buffer commit equal JAX's, bitwise.
* `synthetic_dataset` and `epoch_index_plan` produce identical arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.data import datasets as jax_datasets
from eventgrad_tpu.data import sharding as jax_sharding
from eventgrad_tpu.models.resnet import ResNet18 as JaxResNet18
from eventgrad_tpu.parallel import arena as jax_arena
from eventgrad_tpu.parallel import collectives as jax_collectives
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu_torch.data import datasets, sharding
from eventgrad_tpu_torch.models.resnet import ResNet18
from eventgrad_tpu_torch.parallel import arena, collectives
from eventgrad_tpu_torch.parallel.topology import Ring


def test_flagship_arena_spec_matches_jax():
    shapes = jax.eval_shape(
        lambda k: JaxResNet18(dtype=jnp.bfloat16).init(
            k, jnp.zeros((1, 32, 32, 3), jnp.float32)
        ),
        jax.random.PRNGKey(0),
    )["params"]
    jspec = jax_arena.arena_spec(shapes)
    tspec = arena.arena_spec(ResNet18(dtype=torch.bfloat16))  # meta device
    assert tspec.n_leaves == jspec.n_leaves == 86
    assert tspec.n_total == jspec.n_total == 17_444_682
    assert tspec.sizes == jspec.sizes
    assert tspec.starts == jspec.starts
    np.testing.assert_array_equal(
        tspec.seg_expand().numpy(), np.asarray(jspec.seg_expand())
    )
    # flax's key-sorted leaf order: BasicBlock_10 before BasicBlock_2
    jnames = [
        ".".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]
    ]
    assert list(tspec.names) == jnames
    assert jnames.index("BasicBlock_10.BatchNorm_0.bias") < jnames.index(
        "BasicBlock_2.BatchNorm_0.bias"
    )


@pytest.mark.parametrize("n", [8, 2])
def test_roll_matches_jax_exchange(n):
    jtopo, ttopo = JaxRing(n), Ring(n)
    ids = np.arange(n, dtype=np.int32)
    assert [nb.offset for nb in ttopo.neighbors] == [-1, +1]
    for jnb, tnb in zip(jtopo.neighbors, ttopo.neighbors):
        got_j = spmd(lambda x: jax_collectives.recv_from(x, jtopo, jnb), jtopo)(
            jnp.asarray(ids)
        )
        got_t = collectives.recv_from(torch.from_numpy(ids), ttopo, tnb)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(got_j))
        # offset -1: rank r hears rank r-1 — a roll by +1
        np.testing.assert_array_equal(
            got_t.numpy(),
            [ttopo.neighbor_source(r, tnb) for r in range(n)],
        )
    if n == 8:
        left = collectives.recv_from(torch.from_numpy(ids), ttopo,
                                     ttopo.neighbors[0])
        np.testing.assert_array_equal(left.numpy(), np.roll(ids, 1))
    assert ttopo.mix_weight == jtopo.mix_weight


def _tiny_tree(rng, r):
    # 1-D leaves: the flax and torch layouts agree, so arenas compare flat
    sizes = {"b": 5, "a": 7, "c_10": 3, "c_2": 11}
    return {k: rng.standard_normal((r, z)).astype(np.float32)
            for k, z in sizes.items()}


@pytest.mark.parametrize("builder", [False, True], ids=["inline", "kernel"])
def test_flat_exchanges_match_jax(builder):
    from eventgrad_tpu_torch.ops.event_engine import masked_wire

    rng = np.random.default_rng(3)
    r = 8
    jtopo, ttopo = JaxRing(r), Ring(r)
    tree = _tiny_tree(rng, r)
    fire = rng.random((r, 4)) > 0.5
    lasts = [rng.standard_normal((r, 26)).astype(np.float32) for _ in range(2)]
    jspec = jax_arena.arena_spec({k: v[0] for k, v in tree.items()})
    tspec = arena.arena_spec({k: v.shape[1:] for k, v in tree.items()})
    assert tspec.names == ("a", "b", "c_10", "c_2")
    assert tspec.sizes == jspec.sizes

    def jax_step(t, f, l0, l1):
        cands, effs, raws = jax_collectives.masked_neighbor_vals_flat(
            t, f, jtopo, jspec
        )
        bufs = jax_collectives.commit_bufs_flat(cands, effs, (l0, l1), jspec)
        return cands, effs, raws, bufs, jax_collectives.neighbor_vals_flat(
            t, jtopo, jspec
        )

    want = spmd(jax_step, jtopo)(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(fire),
        jnp.asarray(lasts[0]), jnp.asarray(lasts[1]),
    )
    flat = tspec.ravel({k: torch.from_numpy(v) for k, v in tree.items()})
    fire_t = torch.from_numpy(fire)
    cands, effs, raws = collectives.masked_neighbor_vals_flat(
        flat, fire_t, ttopo, tspec,
        wire_builder=masked_wire if builder else None,
    )
    bufs = collectives.commit_bufs_flat(
        cands, effs, tuple(torch.from_numpy(l) for l in lasts), tspec
    )
    dense = collectives.neighbor_vals_flat(flat, ttopo, tspec)
    for got, exp in zip((cands, effs, raws, bufs, dense), want):
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))


def test_wire_accounting_matches_jax():
    for wire in (None, "bf16", "int8"):
        for fire_bits in (False, True):
            assert collectives.wire_real_bytes_per_neighbor(
                17_444_682, 86, wire, fire_bits=fire_bits
            ) == jax_collectives.wire_real_bytes_per_neighbor(
                17_444_682, 86, wire, fire_bits=fire_bits
            )
        assert (collectives.WIRE_VAL_BYTES[wire]
                == jax_collectives.WIRE_VAL_BYTES[wire])
    # the compact wire ships its capacity's lanes
    assert collectives.wire_real_bytes_per_neighbor(
        10, 2, compact_capacity=4
    ) == jax_collectives.wire_real_bytes_per_neighbor(
        10, 2, compact_capacity=4)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_dataset_equal(split):
    for shape in ((32, 32, 3), (28, 28, 1)):
        xj, yj = jax_datasets.synthetic_dataset(96, shape, seed=5, split=split)
        xt, yt = datasets.synthetic_dataset(96, shape, seed=5, split=split)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)
    xj, yj = jax_datasets.load_or_synthesize("cifar10", None, split, n_synth=64)
    xt, yt = datasets.load_or_synthesize("cifar10", None, split, n_synth=64)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("random", [False, True])
def test_epoch_index_plan_equal(random):
    for epoch in (1, 2, 7):
        a = sharding.epoch_index_plan(1030, 8, 32, random=random, seed=3,
                                      epoch=epoch)
        b = jax_sharding.epoch_index_plan(1030, 8, 32, random=random, seed=3,
                                          epoch=epoch)
        np.testing.assert_array_equal(a, b)
    assert sharding.epoch_steps(16384, 8, 32) == jax_sharding.epoch_steps(
        16384, 8, 32
    ) == 64
    x = np.arange(100 * 2, dtype=np.float32).reshape(100, 2)
    y = np.arange(100, dtype=np.int32)
    for got, want in zip(
        sharding.batched_epoch(x, y, 4, 5, random=True, seed=1, epoch=2),
        jax_sharding.batched_epoch(x, y, 4, 5, random=True, seed=1, epoch=2),
    ):
        np.testing.assert_array_equal(got, want)
