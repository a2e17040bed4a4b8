"""The port's pipeline-parallel transformer against the JAX package's, on
the CPU.

The same numpy inputs through `eventgrad_tpu.models.pp` and
`eventgrad_tpu_torch.models.pp` at a small size (dim 32, 2 heads, 2
layers, T 16, 2 microbatches): the GPipe schedule with an identity stage
and with a stage that adds one, bitwise (the schedule only moves data);
the parameter conversion rank by rank; the forward on a `dp:2,pp:2` mesh
from weights carried across by `convert.py` (rtol=1e-4, atol=1e-5); and
one EventGraD and one D-PSGD pass on that mesh from the carried JAX
state (`_torch_hybrid.py` states the shared tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models.pp import PPTransformerLM as JaxPP
from eventgrad_tpu.models.pp import gpipe as jax_gpipe
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.models.pp import PPTransformerLM, gpipe
from eventgrad_tpu_torch.parallel.arena import flax_order

from _torch_hybrid import (
    LM, T, TOL, assert_gossip_bytes, check_passes, lm_batches, mesh,
    np_tree, run_both,
)

SPEC = "dp:2,pp:2"
N_MICRO = 2


def _models():
    return (JaxPP(**LM, axis="pp", pp_size=2, n_micro=N_MICRO),
            PPTransformerLM(**LM, axis="pp", pp_size=2, n_micro=N_MICRO))


@pytest.mark.parametrize("spec,n_micro", [("dp:2,pp:2", 2), ("pp:4", 3),
                                          ("dp:2,pp:3", 1)])
@pytest.mark.parametrize("stage", ["identity", "plus_one"])
def test_gpipe_schedule_is_bitwise_jax(spec, n_micro, stage):
    """Every rank's banked outputs (the last stage's microbatches, zeros
    elsewhere) bitwise the JAX schedule's, on distinct per-rank inputs
    (only stage 0's copy may enter the pipeline)."""
    jtopo, topo = mesh(spec)
    fn = (lambda h: h) if stage == "identity" else (lambda h: h + 1.0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((topo.n_ranks, n_micro, 2, 3)).astype(np.float32)
    want = spmd(lambda xm: jax_gpipe(fn, xm, "pp", topo.axis_size("pp")),
                jtopo)(jnp.asarray(x))
    got = gpipe(fn, torch.from_numpy(x), topo, "pp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jax_init():
    from eventgrad_tpu.train.state import init_train_state_spmd
    import optax

    jtopo, _ = mesh(SPEC)
    return init_train_state_spmd(_models()[0], (T,), optax.sgd(0.1), jtopo,
                                 "dpsgd", input_dtype=jnp.int32)


def test_stage_leaves_round_trip(jax_init):
    """The stage leaves `tp_l{i}_*` keep the JAX layout, every leaf
    carries across rank by rank and back bitwise, and the stage kernels
    differ along pp."""
    jparams = np_tree(jax_init.params)
    tp, _ = convert.params_from_jax(jparams, stacked=True)
    shapes = {n: tuple(p.shape) for n, p in _models()[1].named_parameters()}
    assert tuple(tp) == flax_order(shapes)
    assert tuple(tp["tp_l0_wqkv"].shape[1:]) == (LM["dim"], 3 * LM["dim"])
    grid = tp["tp_l0_wqkv"].reshape((2, 2) + tuple(shapes["tp_l0_wqkv"]))
    assert not torch.equal(grid[:, 0], grid[:, 1])
    back, _ = convert.params_to_jax(tp, stacked=True)
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_forward_matches_jax(jax_init):
    jmodel, tmodel = _models()
    jtopo, topo = mesh(SPEC)
    x, _ = lm_batches(jtopo, 1)[0]
    want = spmd(lambda p, t: jmodel.apply({"params": p}, t), jtopo)(
        jax_init.params, jnp.asarray(x))
    tp, _ = convert.params_from_jax(np_tree(jax_init.params), stacked=True)
    got, _ = tmodel.forward_stacked(tp, torch.from_numpy(x).long(), topo)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the masked sum broadcasts the last stage's logits along pp
    g = got.reshape((2, 2) + tuple(got.shape[1:]))
    assert torch.equal(g[:, 0], g[:, 1])


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


def test_microbatch_guards():
    _, topo = mesh(SPEC)
    model = PPTransformerLM(**LM, pp_size=2, n_micro=3)
    with pytest.raises(ValueError, match="not divisible by n_micro 3"):
        model._n_micro(4)
    assert model._n_micro(1) == 1
    with pytest.raises(ValueError, match="not divisible by pp_size"):
        PPTransformerLM(**dict(LM, n_layers=3), pp_size=2)
