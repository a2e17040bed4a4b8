"""The port's expert-parallel transformer against the JAX package's, on
the CPU.

The same numpy inputs through `eventgrad_tpu.models.moe` and
`eventgrad_tpu_torch.models.moe` at a small size (dim 32, 2 heads, 2
layers, T 16, 4 experts, top-2, capacity factor 2.0): the dispatch and
combine tensors and the routed counts of `_dispatch_combine`, bitwise on
the same probabilities, ties included (`lax.top_k` takes the lower
index first) and with a capacity that drops tokens; the parameter
conversion rank by rank (the `[e_local, d, hidden]` expert kernels keep
the JAX layout); the forward on a `dp:2,ep:2` mesh from weights carried
across by `convert.py`, logits and the sown load-balancing loss within
rtol=1e-4, atol=1e-5; and one EventGraD and one D-PSGD pass on that mesh
from the carried JAX state, the load-balancing loss in the objective
(`_torch_hybrid.py` states the shared tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models.moe import MoETransformerLM as JaxMoE
from eventgrad_tpu.models.moe import _dispatch_combine as jax_dispatch
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models.moe import MoETransformerLM, _dispatch_combine
from eventgrad_tpu_torch.parallel.arena import flax_order

from _torch_hybrid import (
    LM, T, TOL, assert_gossip_bytes, check_passes, lm_batches, mesh,
    np_tree, run_both,
)

SPEC = "dp:2,ep:2"
N_EXPERTS = 4


def _models():
    return (JaxMoE(**LM, n_experts=N_EXPERTS, axis="ep", ep_size=2),
            MoETransformerLM(**LM, n_experts=N_EXPERTS, axis="ep",
                             ep_size=2))


def _probs(s, e, seed, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((s, e)).astype(np.float32)
    if ties:
        # whole rows of equal logits, and pairs tied for second place
        logits[::3] = 0.5
        logits[1::3, 1] = logits[1::3, 2] = -0.25
        logits[1::3, 0] = 2.0
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("s,e,k,cap,ties", [
    (16, 4, 2, 16, False), (24, 4, 2, 5, False), (30, 8, 2, 3, True),
    (12, 4, 1, 2, True), (9, 3, 3, 4, True),
])
def test_dispatch_combine_is_bitwise_jax(s, e, k, cap, ties):
    probs = _probs(s, e, s + e, ties)
    jd, jc, jr = jax_dispatch(jnp.asarray(probs), k, cap, jnp.float32)
    td, tc, tr = _dispatch_combine(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.fixture(scope="module")
def jax_init():
    from eventgrad_tpu.train.state import init_train_state_spmd
    import optax

    jtopo, _ = mesh(SPEC)
    return init_train_state_spmd(_models()[0], (T,), optax.sgd(0.1), jtopo,
                                 "dpsgd", input_dtype=jnp.int32)


def test_expert_leaves_round_trip(jax_init):
    jparams = np_tree(jax_init.params)
    tp, _ = convert.params_from_jax(jparams, stacked=True)
    shapes = {n: tuple(p.shape)
              for n, p in _models()[1].named_parameters()}
    assert tuple(tp) == flax_order(shapes)
    wi = "MoEBlock_0.ExpertParallelMLP_0.tp_wi"
    assert tuple(tp[wi].shape[1:]) == (N_EXPERTS // 2, LM["dim"],
                                       4 * LM["dim"])
    back, _ = convert.params_to_jax(tp, stacked=True)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_forward_and_aux_loss_match_jax(jax_init):
    jmodel, tmodel = _models()
    jtopo, topo = mesh(SPEC)
    x, _ = lm_batches(jtopo, 1)[0]

    def fwd(p, t):
        out, upd = jmodel.apply({"params": p}, t, mutable=["losses"])
        return out, sum(jnp.sum(v) for v in jax.tree.leaves(upd["losses"]))

    want, want_aux = spmd(fwd, jtopo)(jax_init.params, jnp.asarray(x))
    tp, _ = convert.params_from_jax(np_tree(jax_init.params), stacked=True)
    got, auxes = tmodel.forward_stacked(tp, torch.from_numpy(x).long(), topo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(auxes) == LM["n_layers"]
    np.testing.assert_allclose(sum(auxes).numpy(), np.asarray(want_aux),
                               **TOL)


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_step_matches_jax(algo):
    jmodel, tmodel = _models()
    jtopo, _ = mesh(SPEC)
    spec, topo, passes = run_both(jmodel, tmodel, SPEC, algo,
                                  lm_batches(jtopo, 2), (T,))
    fired = check_passes(algo, spec, topo, passes)
    assert_gossip_bytes(algo, spec, topo, passes)
    if algo == "eventgrad":
        assert 0 < fired < topo.n_ranks * spec.n_leaves


def test_expert_count_guard():
    with pytest.raises(ValueError, match="not divisible by ep_size"):
        MoETransformerLM(**LM, n_experts=3, ep_size=2)
