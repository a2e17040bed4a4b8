"""The port's top-k sparsification against the JAX package's, bitwise.

The payload helpers (`policy.topk_payload`, `policy.scatter_into`), the
per-leaf k (`SparseConfig.k_for`) and one `sparse_exchange` on the f32,
bf16 and int8 wires. The same numpy inputs feed both packages; the
JAX tree is carried to the port's `[R, n]` arena with `convert`, whose
layouts differ inside convolution and dense kernels (OIHW / `(out, in)`
against flax's HWIO / `(in, out)`). The port selects by the flax-layout
index, so values, indices, shadows and replicas are all bitwise the JAX
ones, ties included: tie-heavy inputs (small integers) and the all-ties
first exchange, where prev_sent equals the parameters and the selection
must be indices 0..k-1 of every leaf.
"""

import jax
import numpy as np
import pytest
import torch

from eventgrad_tpu.parallel.policy import scatter_into as jax_scatter_into
from eventgrad_tpu.parallel.policy import topk_payload as jax_topk_payload
from eventgrad_tpu.parallel.sparsify import SparseConfig as JaxSparseConfig
from eventgrad_tpu.parallel.sparsify import SparseState as JaxSparseState
from eventgrad_tpu.parallel.sparsify import sparse_exchange as jax_sparse_exchange
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.parallel.topology import Torus as JaxTorus
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.policy import (
    resolve, scatter_into, topk_payload,
)
from eventgrad_tpu_torch.parallel.sparsify import (
    SparseConfig, SparseState, sparse_exchange,
)
from eventgrad_tpu_torch.parallel.topology import Ring, Torus

R = 8
#: a flax parameter tree: a convolution, two dense layers, biases
SHAPES = {
    "Conv_0": {"kernel": (3, 3, 2, 5), "bias": (5,)},
    "Dense_0": {"kernel": (12, 7), "bias": (7,)},
    "Dense_1": {"kernel": (7, 3)},
}


def _tree(rng, fn):
    return jax.tree.map(lambda s: fn(rng, (R,) + s), SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))


def _ties(rng, shape):
    """Small integers: |p - prev| ties everywhere."""
    return rng.integers(0, 4, shape).astype(np.float32)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _flat(tree, spec):
    """A stacked flax tree as the port's `[R, n]` arena."""
    tp, _ = convert.params_from_jax(tree, stacked=True)
    return spec.ravel(tp)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.fixture(scope="module")
def spec():
    params, _ = convert.params_from_jax(
        _tree(np.random.default_rng(0), _normal), stacked=True)
    return arena_spec({k: v.shape[1:] for k, v in params.items()})


@pytest.mark.parametrize("case", ["ties", "all-ties", "normal"])
@pytest.mark.parametrize("percent", [10.0, 33.3])
def test_topk_payload_bitwise(spec, case, percent):
    rng = np.random.default_rng(1)
    make = _normal if case == "normal" else _ties
    p = _tree(rng, make)
    prev = p if case == "all-ties" else _tree(rng, make)
    jv, ji = jax.vmap(lambda a, b: jax_topk_payload(
        a, b, JaxSparseConfig(percent)))(p, prev)
    cfg = SparseConfig(percent)
    vals, idxs = topk_payload(_flat(p, spec), _flat(prev, spec),
                              cfg.ks(spec), spec)
    assert vals.dtype == torch.float32 and idxs.dtype == torch.int32
    want_v = np.concatenate([np.asarray(v) for v in jax.tree.leaves(jv)], -1)
    want_i = np.concatenate([np.asarray(i) for i in jax.tree.leaves(ji)], -1)
    np.testing.assert_array_equal(_bits(vals), _bits(want_v))
    np.testing.assert_array_equal(idxs.numpy(), want_i)
    if case == "all-ties":
        want = np.concatenate([np.arange(k) for k in cfg.ks(spec)])
        np.testing.assert_array_equal(idxs.numpy(),
                                      np.broadcast_to(want, idxs.shape))


def test_scatter_into_bitwise(spec):
    rng = np.random.default_rng(2)
    p, prev, full = (_tree(rng, _ties) for _ in range(3))
    gate = jax.tree.map(lambda s: rng.random(R) < 0.6, SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))
    cfg = JaxSparseConfig(25.0)
    jv, ji = jax.vmap(lambda a, b: jax_topk_payload(a, b, cfg))(p, prev)
    want = jax.vmap(jax_scatter_into)(full, jv, ji, gate)
    ks = SparseConfig(25.0).ks(spec)
    vals, idxs = topk_payload(_flat(p, spec), _flat(prev, spec), ks, spec)
    gate_vec = torch.from_numpy(np.stack(jax.tree.leaves(gate), -1))
    got = scatter_into(_flat(full, spec), vals, idxs, gate_vec, ks, spec)
    np.testing.assert_array_equal(_bits(got), _bits(_flat(
        jax.tree.map(np.asarray, want), spec)))


def test_k_for_equals_jax():
    for percent in (0.01, 0.5, 1.0, 5.0, 10.0, 12.5, 33.3, 50.0, 99.9, 100.0):
        port, ref = SparseConfig(percent), JaxSparseConfig(percent)
        for numel in list(range(1, 300)) + [1000, 4097, 17_444_682, 2_359_296]:
            assert port.k_for(numel) == ref.k_for(numel), (percent, numel)


@pytest.mark.parametrize("topo_name", ["ring8", "torus2x4"])
@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_sparse_exchange_bitwise(spec, wire, topo_name):
    """One exchange from identical params (the all-ties first pass) and
    one from drifted ones, on a per-leaf fire pattern."""
    jtopo, topo = {"ring8": (JaxRing(8), Ring(8)),
                   "torus2x4": (JaxTorus(2, 4), Torus(2, 4))}[topo_name]
    rng = np.random.default_rng(3)
    p0 = _tree(rng, _normal)
    fire = jax.tree.map(lambda s: rng.random(R) < 0.7, SHAPES,
                        is_leaf=lambda s: isinstance(s, tuple))
    cfg_j, cfg = JaxSparseConfig(20.0), SparseConfig(20.0)

    def jax_step(params, fire, sp):
        return jax_sparse_exchange(params, fire, sp, jtopo, cfg_j, wire)

    jstep = spmd(jax_step, jtopo)
    jsp = jax.vmap(lambda q: JaxSparseState.init(q, jtopo))(p0)
    tsp = SparseState.init(_flat(p0, spec), topo)
    fire_vec = torch.from_numpy(np.stack(jax.tree.leaves(fire), -1))
    p1 = jax.tree.map(lambda a: a + 0.1 * _normal(rng, a.shape), p0)
    for params in (p0, p1):
        jsp = jstep(params, fire, jsp)
        tsp = sparse_exchange(_flat(params, spec), fire_vec, tsp, topo, cfg,
                              spec, wire)
        np.testing.assert_array_equal(
            _bits(tsp.prev_sent),
            _bits(_flat(jax.tree.map(np.asarray, jsp.prev_sent), spec)))
        assert len(tsp.replicas) == len(jsp.replicas) == topo.n_neighbors
        for tr, jr in zip(tsp.replicas, jsp.replicas):
            np.testing.assert_array_equal(
                _bits(tr), _bits(_flat(jax.tree.map(np.asarray, jr), spec)))


def test_policies_and_refusals(spec):
    assert resolve(None, "sp_eventgrad").name == "topk"
    assert resolve(None, "eventgrad").name == "norm_delta"
    assert resolve("topk", "sp_eventgrad").algos == ("sp_eventgrad",)
    for name in ("micro", "hybrid"):  # ported with the compact wire
        assert resolve(name, "eventgrad").name == name
    with pytest.raises(ValueError, match="drives"):
        resolve("topk", "eventgrad")
    with pytest.raises(ValueError, match="no event trigger"):
        resolve(None, "allreduce")
    # the bucketed emission and the staleness >= 2 payload queues, once
    # refused (ROADMAP queue 1, item 5), now run: a bucketed exchange
    # gives the monolithic state, and the queue fills its slot 0
    flat = torch.randn((R, spec.n_total), generator=torch.Generator()
                       .manual_seed(0))
    fire = torch.ones((R, spec.n_leaves), dtype=torch.bool)
    sp = SparseState.init(torch.zeros_like(flat), Ring(R))
    mono = sparse_exchange(flat, fire, sp, Ring(R), SparseConfig(), spec)
    got = sparse_exchange(flat, fire, sp, Ring(R), SparseConfig(), spec,
                          buckets=spec.buckets(2))
    for a, b in zip((mono.prev_sent,) + mono.replicas,
                    (got.prev_sent,) + got.replicas):
        assert torch.equal(a, b)
    sp2 = SparseState.init(torch.zeros_like(flat), Ring(R), SparseConfig(),
                           spec, staleness=2)
    q = sparse_exchange(flat, fire, sp2, Ring(R), SparseConfig(), spec,
                        staleness=2)
    # slot 0 was empty: the replicas keep their values, and this pass's
    # payload (every leaf fired) waits in the new slot 0
    assert all(torch.equal(r, torch.zeros_like(flat)) for r in q.replicas)
    assert all(bool(edge[0][2].all()) for edge in q.pending)
