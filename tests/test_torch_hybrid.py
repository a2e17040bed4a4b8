"""The port's hybrid meshes against the JAX package's, on the CPU.

  * `Topology` with its three axis classes: every property the JAX class
    has (gossip, sharded, aux, data-aux and data axes, the rank counts,
    `is_hybrid`, the neighbours on gossip axes only, the mixing weight),
    on the meshes the CLI builds and on the pure `sp:4` and `tp:2`;
  * `expand_to_mesh`, bitwise (sequence chunks along sp, the same batch
    along tp/pp/ep, its own shard along ddp);
  * the grid collectives against the JAX ones under `spmd` (`psum`,
    `pmean`, `all_to_all`, `axis_index`), bitwise, and ring and Ulysses
    attention along the `sp` axis of a `dp x sp` stack against the JAX
    functions (rtol=1e-4, atol=1e-5);
  * one EventGraD and one D-PSGD pass, from the carried JAX state, on
    `dp:2,sp:2` with ring and with Ulysses attention inside the model
    (with and without the flash path: the JAX side runs its Pallas
    kernels in interpret mode, the port its flash Functions' plain
    versions), on `dp:2,ddp:2` (the MLP) and on `dp:2,ddp:2,sp:2`
    (ring); `_torch_hybrid.py` states the tolerances. Gossip rides dp
    only: msgs-saved-% and the bytes count its two neighbours.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.data.sharding import expand_to_mesh as jax_expand
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.models.transformer import TransformerLM as JaxLM
from eventgrad_tpu.parallel import ring_attention as jax_ra
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Topology as JaxTopology
from eventgrad_tpu_torch.data.sharding import expand_to_mesh
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.parallel import collectives, ring_attention
from eventgrad_tpu_torch.parallel.topology import Topology

from _torch_hybrid import (
    LM, T, TOL, assert_gossip_bytes, check_passes, lm_batches, mesh,
    run_both,
)

MESHES = ("dp:4,sp:2", "dp:2,ddp:2", "dp:2,ddp:2,sp:2", "dp:4,tp:2",
          "dp:4,pp:2", "dp:2,ep:4", "sp:4", "tp:2")
PROPS = ("axes", "shape", "gossip_axes", "sharded_axes", "data_aux_axes",
         "n_ranks", "n_gossip_ranks", "is_hybrid", "data_axes",
         "n_data_ranks", "aux_axes", "neighbors", "n_neighbors",
         "mix_weight")


def _pure(spec):
    """A pure axis as the JAX package builds one: `sp:4` replicated aux
    (no gossip axis), `tp:2` sharded."""
    name, _, n = spec.partition(":")
    kw = dict(axes=(name,), shape=(int(n),))
    if name == "tp":
        kw["sharded_axes"] = ("tp",)
    else:
        kw["gossip_axes"] = ()
    return JaxTopology(**kw), Topology(**kw)


@pytest.mark.parametrize("spec", MESHES)
def test_topology_matches_jax(spec):
    jtopo, topo = mesh(spec) if "," in spec else _pure(spec)
    for prop in PROPS:
        got, want = getattr(topo, prop), getattr(jtopo, prop)
        if prop == "neighbors":
            got = [(nb.axis, nb.offset, nb.name) for nb in got]
            want = [(nb.axis, nb.offset, nb.name) for nb in want]
        assert got == want, prop
    for a in topo.axes:
        assert topo.axis_size(a) == jtopo.axis_size(a)
    for r in range(topo.n_ranks):
        for nb, jnb in zip(topo.neighbors, jtopo.neighbors):
            assert topo.neighbor_source(r, nb) == jtopo.neighbor_source(r,
                                                                        jnb)


def test_topology_validation_words_match_jax():
    bad = (dict(axes=("dp", "tp"), shape=(2, 2), gossip_axes=("tp",),
                sharded_axes=("tp",)),
           dict(axes=("dp",), shape=(2,), gossip_axes=("x",)),
           dict(axes=("dp",), shape=(2,), sharded_axes=("tp",)),
           dict(axes=("dp", "ddp"), shape=(2, 2), gossip_axes=("dp",),
                data_aux_axes=("dp",)),
           dict(axes=("dp",), shape=(0,)),
           dict(axes=("dp", "sp"), shape=(2,)))
    for kw in bad:
        with pytest.raises(ValueError) as want:
            JaxTopology(**kw)
        with pytest.raises(ValueError) as got:
            Topology(**kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", MESHES[:6])
def test_expand_to_mesh_is_bitwise_jax(spec):
    jtopo, topo = mesh(spec)
    rng = np.random.default_rng(3)
    n_data = topo.n_data_ranks
    xb = rng.integers(0, 50, (n_data, 3, 2, 8), dtype=np.int32)
    yb = rng.integers(0, 50, (n_data, 3, 2, 8), dtype=np.int32)
    got, want = expand_to_mesh(xb, yb, topo), jax_expand(xb, yb, jtopo)
    for g, w in zip(got, want):
        assert g.shape[0] == topo.n_ranks
        np.testing.assert_array_equal(g, w)


def test_expand_to_mesh_guards_match_jax():
    jtopo, topo = mesh("dp:2,sp:2")
    for xb in (np.zeros((2, 1, 1, 8), np.float32),
               np.zeros((2, 1, 1, 7), np.int32)):
        with pytest.raises(ValueError) as want:
            jax_expand(xb, xb, jtopo)
        with pytest.raises(ValueError) as got:
            expand_to_mesh(xb, xb, topo)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_grid_collectives_are_bitwise_jax(axis):
    """`axis_sum`, `axis_mean`, `axis_all_to_all` and `axis_index` on a
    `dp:2,sp:4` stack against `psum`, `pmean`, `all_to_all` (tiled,
    split and concat axis 0) and `axis_index` under the JAX lift."""
    from jax import lax

    jtopo, topo = mesh("dp:2,sp:4")
    n = topo.axis_size(axis)
    x = np.random.default_rng(0).standard_normal(
        (topo.n_ranks, n, 3)).astype(np.float32)

    def per_rank(v):
        return (lax.psum(v, axis), lax.pmean(v, axis),
                lax.all_to_all(v, axis, 0, 0, tiled=True),
                lax.axis_index(axis))

    want = spmd(per_rank, jtopo)(jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = (collectives.axis_sum(xt, topo, axis),
           collectives.axis_mean(xt, topo, axis),
           collectives.axis_all_to_all(xt, topo, axis),
           collectives.axis_index(topo, axis))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_along_sp_matches_jax(fn):
    """Ring and Ulysses attention over the `sp` axis of `dp:2,sp:2`: each
    dp replica's sequence sharded over sp, causal."""
    jtopo, topo = mesh("dp:2,sp:2")
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((4, 2, 8, 2, 4)).astype(np.float32)
               for _ in range(3))
    want = spmd(lambda q, k, v: getattr(jax_ra, fn)(
        q, k, v, jtopo, axis="sp", causal=True), jtopo)(q, k, v)
    got = getattr(ring_attention, fn)(
        *(torch.from_numpy(a) for a in (q, k, v)), topo, axis="sp",
        causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


#: (mesh, attn, use_flash) of the transformer step cases
LM_CASES = [("dp:2,sp:2", "ring", False), ("dp:2,sp:2", "ring", True),
            ("dp:2,sp:2", "ulysses", False), ("dp:2,sp:2", "ulysses", True),
            ("dp:2,ddp:2,sp:2", "ring", False)]


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
@pytest.mark.parametrize("spec,attn,flash", LM_CASES,
                         ids=["-".join(map(str, c)) for c in LM_CASES])
def test_sequence_parallel_step_matches_jax(spec, attn, flash, algo):
    jtopo, topo = mesh(spec)
    jmodel = JaxLM(**LM, attn=attn, topo=jtopo, sp_axis="sp",
                   use_flash=flash)
    tmodel = TransformerLM(**LM, attn=attn, topo=topo, sp_axis="sp",
                           use_flash=flash)
    n_sp = topo.axis_size("sp")
    spec_, topo_, passes = run_both(jmodel, tmodel, spec, algo,
                                    lm_batches(jtopo, 2), (T // n_sp,))
    fired = check_passes(algo, spec_, topo_, passes)
    assert_gossip_bytes(algo, spec_, topo_, passes)
    # the sp ranks of a replica hold the same parameters after the pass
    grid = passes[-1][2].params.reshape(tuple(topo.shape) + (-1,))
    assert torch.equal(grid.select(topo.axes.index("sp"), 0),
                       grid.select(topo.axes.index("sp"), 1))
    if algo == "eventgrad":
        assert 0 < fired < topo.n_ranks * spec_.n_leaves


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_ddp_step_matches_jax(algo):
    """`dp:2,ddp:2` on the MLP: each ddp pair averages its gradients
    (synchronous allreduce subgroups), the dp pairs gossip."""
    from eventgrad_tpu.data.datasets import synthetic_dataset

    spec = "dp:2,ddp:2"
    shape = (8, 8, 1)
    x, y = synthetic_dataset(4 * 4 * 2, shape, seed=2)
    x = x.reshape((2, 4, 4) + shape).transpose(1, 0, 2, 3, 4, 5)
    y = y.reshape(2, 4, 4).transpose(1, 0, 2)
    batches = [(x[:, i], y[:, i].astype(np.int32)) for i in range(2)]
    spec_, topo, passes = run_both(JaxMLP(hidden=16),
                                   MLP(hidden=16, input_shape=shape), spec,
                                   algo, batches, shape, jnp.float32)
    check_passes(algo, spec_, topo, passes)
    assert_gossip_bytes(algo, spec_, topo, passes)


def test_stacked_model_guards():
    """A stacked model must fit the topology it steps on."""
    from eventgrad_tpu_torch.models.tp import TPTransformerLM
    from eventgrad_tpu_torch.train.steps import make_train_step

    _, topo = mesh("dp:2,tp:2")
    with pytest.raises(ValueError, match="built for tp=4"):
        make_train_step(TPTransformerLM(**dict(LM, n_heads=4), tp_size=4),
                        topo, "dpsgd", fused_sgd=(0.1, 0.0))
    _, topo = mesh("dp:2,sp:2")
    with pytest.raises(ValueError, match="not a sharded axis"):
        make_train_step(TPTransformerLM(**LM, tp_size=2), topo, "dpsgd",
                        fused_sgd=(0.1, 0.0))
    with pytest.raises(ValueError, match="runs rank-stacked"):
        TransformerLM(**LM, attn="ring")(torch.zeros((1, T),
                                                     dtype=torch.long))
