"""The port's transformer LM path against the JAX package's, on the CPU.

Same numpy inputs through both packages at a small size (`dim=32,
n_heads=2, n_layers=2, vocab=32, T=16`): the synthetic LM dataset, the
weight conversion, the model's forward and parameter gradients from
weights carried across by `convert.params_from_jax`, and EventGraD and
D-PSGD steps on `Ring(4)` from identical state; then one step of each at
head dimension 128 (`dim=256, n_heads=2, T=48`), the head width of the
card's `transformer-d128` legs, which the DMAX = 128 flash kernels run
there, and at head dimension 256 (`dim=512, n_heads=2, T=48`), the
`transformer-d256` legs' width, which the kernels' wide form runs. The
JAX side runs `attn="flash"` through its Pallas kernels in
interpret mode; the port runs its flash Functions on their plain
versions (CPU tensors).

All in float32 — unlike the small ResNet of `test_torch_step.py`, this
net has no ReLU for a rounding to flip, so float32 compute pins the step.
Tolerances, and why:
  * logits: rtol=1e-4, atol=1e-5 (the two frameworks reduce the matrix
    products and the LayerNorm statistics in another order);
  * parameter gradients, and parameters and momentum trace after one
    step: rtol=1e-4, atol=1e-5 (as `test_torch_step.py`);
  * fire bits, `num_events` and the byte accounting: equal.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_lm_dataset as jax_lm_dataset
from eventgrad_tpu.models.transformer import TransformerLM as JaxTransformerLM
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import TrainState
from eventgrad_tpu_torch.train.steps import _xent, make_train_step

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(vocab=32, dim=32, n_heads=2, n_layers=2, max_len=16)
R, PER_RANK, T = 4, 2, 16
#: two heads of 128 at T = 48
WIDE = dict(vocab=32, dim=256, n_heads=2, n_layers=2, max_len=48)
#: two heads of 256 at T = 48
WIDER = dict(vocab=32, dim=512, n_heads=2, n_layers=2, max_len=48)
LR, MOM = 0.01, 0.9
CFG = dict(adaptive=True, horizon=0.6, warmup_passes=1, max_silence=4)


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_lm_dataset_equals_jax(split):
    got = synthetic_lm_dataset(24, seq_len=20, vocab=48, seed=3, split=split)
    want = jax_lm_dataset(24, seq_len=20, vocab=48, seed=3, split=split)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32 and g.shape == (24, 20)
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][:, 1:], got[1][:, :-1])


def _flax_params(attn="full", seed=0, **kw):
    jmodel = JaxTransformerLM(attn=attn, **{**SMALL, **kw})
    t = kw.get("max_len", SMALL["max_len"])
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, t), jnp.int32))["params"]
    return jmodel, jax.tree.map(np.asarray, flax.core.unfreeze(params))


def _flax_names(params):
    return [".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]


def test_convert_round_trip_and_leaf_order():
    """Eleven blocks, so that flax's key-sorted order puts `Block_10`
    before `Block_2`; dense kernels transpose, embeddings and LayerNorm
    leaves keep their shape."""
    kw = dict(dim=8, n_heads=2, n_layers=11, vocab=16, max_len=4)
    _, jparams = _flax_params(**kw)
    tparams, tstats = convert.params_from_jax(jparams)
    names = _flax_names(jparams)
    assert names.index("Block_10.Dense_0.kernel") < names.index(
        "Block_2.Dense_0.kernel")
    spec = arena_spec(TransformerLM(**kw))
    assert list(tparams) == names == list(spec.names)
    assert tstats == {}
    for name, shape in zip(spec.names, spec.shapes):
        assert tuple(tparams[name].shape) == shape, name
    assert tuple(tparams["Block_0.Dense_0.kernel"].shape) == (24, 8)
    assert tuple(tparams["Embed_1.embedding"].shape) == (4, 8)
    back, _ = convert.params_to_jax(tparams)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jparams)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_init_variables_follow_flax_init():
    """Names, shapes and the init's scales: zero biases, unit LayerNorm
    scales, dense kernels and embeddings with variance 1 / fan_in."""
    model = TransformerLM(vocab=64, dim=64, n_heads=4, n_layers=2, max_len=64)
    params, stats = model.init_variables(0, device="cpu")
    _, jparams = _flax_params(vocab=64, dim=64, n_heads=4, max_len=64)
    jflat = dict(zip(_flax_names(jparams), jax.tree.leaves(jparams)))
    assert stats == {} and list(params) == list(jflat)
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[1]
        if leaf == "bias":
            assert not p.any(), name
        elif leaf == "scale":
            assert (p == 1).all(), name
        else:
            np.testing.assert_allclose(float(p.std()), jflat[name].std(),
                                       rtol=0.15, err_msg=name)


def _tokens(n, seed=1, t=T):
    x, y = jax_lm_dataset(n, seq_len=t, vocab=SMALL["vocab"], seed=seed)
    return x, y


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_transformer_forward_and_grads_match_flax(attn):
    jmodel, jparams = _flax_params(attn)
    tmodel = TransformerLM(attn=attn, **SMALL)
    x, y = _tokens(6)
    tparams, _ = convert.params_from_jax(jparams)
    leaves = {k: v.requires_grad_() for k, v in tparams.items()}
    tx, ty = torch.from_numpy(x).long(), torch.from_numpy(y).long()
    logits = torch.func.functional_call(tmodel, leaves, (tx,))
    jlogits = jmodel.apply({"params": jparams}, jnp.asarray(x))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (6, T, 32)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    # train mode returns the (empty) statistics too, the step's protocol
    out, new_stats = torch.func.functional_call(tmodel, leaves, (tx, {}, True))
    assert new_stats == {} and torch.equal(out, logits)

    grads = torch.autograd.grad(_xent(logits, ty), list(leaves.values()))

    def jloss(p):
        lg = jmodel.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(
            lg, jnp.asarray(y)).mean()

    jgrads, _ = convert.params_from_jax(
        jax.tree.map(np.asarray, jax.grad(jloss)(jparams)))
    for name, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(),
                                   err_msg=name, **TOL)


def test_sequence_parallel_modes_wait():
    """Ring and Ulysses attention run rank-stacked inside the train step
    (tests/test_torch_hybrid.py holds them against the JAX model): the
    model builds, and its per-rank forward refuses and names the stacked
    one."""
    for attn in ("ring", "ulysses"):
        model = TransformerLM(attn=attn, **SMALL)
        assert model.rank_stacked
        with pytest.raises(ValueError, match="forward_stacked"):
            model(torch.zeros((1, T), dtype=torch.long))
    with pytest.raises(ValueError, match="unknown attn"):
        TransformerLM(attn="sparse", **SMALL)
    with pytest.raises(ValueError, match="token sequence"):
        egt.init_train_state(TransformerLM(**SMALL), (T + 1,), Ring(R),
                             "dpsgd", device="cpu")


def _flat_of(jparams, spec):
    tp, _ = convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                    stacked=True)
    return spec.ravel(tp)


def _run_both(algo, n_steps, sizes=SMALL):
    jmodel = JaxTransformerLM(attn="flash", **sizes)
    tmodel = TransformerLM(attn="flash", **sizes)
    spec = arena_spec(tmodel)
    jtopo, topo = JaxRing(R), Ring(R)
    tx = optax.sgd(LR, momentum=MOM)
    t = sizes["max_len"]
    jstate = jax_init_state(jmodel, (t,), tx, jtopo, algo,
                            JaxEventConfig(**CFG), seed=0,
                            input_dtype=jnp.int32, arena=True)
    assert jstate.batch_stats == {}
    flat = _flat_of(jstate.params, spec)
    event = None
    if algo == "eventgrad":
        event = EventState.init(spec, topo, EventConfig(**CFG), device="cpu")
    tstate = TrainState(params=flat, trace=torch.zeros_like(flat),
                        batch_stats={}, pass_num=0, event=event)
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, algo, JaxEventConfig(**CFG), fused_sgd=(LR, MOM),
        trace=True, arena=True), jtopo))
    tstep = make_train_step(tmodel, topo, algo, EventConfig(**CFG),
                            fused_sgd=(LR, MOM), trace=True)
    x, y = _tokens(n_steps * R * PER_RANK, t=t)
    x = x.reshape(n_steps, R, PER_RANK, t)
    y = y.reshape(n_steps, R, PER_RANK, t)
    passes = []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, (jnp.asarray(x[i]), jnp.asarray(y[i])))
        tstate, tm = tstep(tstate, (torch.from_numpy(x[i]).long(),
                                    torch.from_numpy(y[i]).long()))
        passes.append((jax.tree.map(np.asarray, jstate),
                       jax.tree.map(np.asarray, jm), tstate,
                       {k: v.numpy() for k, v in tm.items()}))
    return spec, passes


def _check_passes(algo, spec, passes):
    """Parameters, trace, loss and token counts within tolerance; fire
    bits, events and bytes equal. Returns the fire bits set past
    warmup."""
    fired_past_warmup = 0
    for p, (jstate, jm, tstate, tm) in enumerate(passes, start=1):
        np.testing.assert_allclose(
            tstate.params.numpy(), _flat_of(jstate.params, spec).numpy(),
            err_msg=f"params, pass {p}", **TOL)
        np.testing.assert_allclose(
            tstate.trace.numpy(),
            _flat_of(jstate.opt_state[0].trace, spec).numpy(),
            err_msg=f"trace, pass {p}", **TOL)
        np.testing.assert_allclose(tm["loss"], jm["loss"], **TOL)
        assert tstate.batch_stats == {}
        # tokens, not sequences: up to PER_RANK * T per rank
        np.testing.assert_array_equal(tm["correct"], jm["correct"])
        assert tm["correct"].shape == (R,)
        for k in ("sent_bytes", "sent_bytes_wire_real", "fired_elems",
                  "num_events", "num_deferred", "fired_frac"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{k} {p}")
        if algo == "eventgrad":
            np.testing.assert_array_equal(tm["trace_fired"],
                                          jm["trace_fired"])
            np.testing.assert_allclose(tm["trace_norm"], jm["trace_norm"],
                                       **TOL)
            if p > CFG["warmup_passes"]:
                fired_past_warmup += int(tm["trace_fired"].sum())
    return fired_past_warmup


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_transformer_step_matches_jax(algo):
    """Three passes (warmup 1, then the trigger decides)."""
    spec, passes = _run_both(algo, 3)
    fired_past_warmup = _check_passes(algo, spec, passes)
    if algo == "eventgrad":  # the trigger, not only warmup, was exercised
        assert 0 < fired_past_warmup < 2 * R * spec.n_leaves


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_transformer_step_at_head_dim_128_matches_jax(algo):
    """One pass at two heads of 128, weights carried across by
    `convert.py`: the port's flash Functions against the JAX package's
    Pallas kernels (interpret mode), which pad nothing at D = 128."""
    assert WIDE["dim"] // WIDE["n_heads"] == 128
    spec, passes = _run_both(algo, 1, WIDE)
    _check_passes(algo, spec, passes)


@pytest.mark.parametrize("algo", ["eventgrad", "dpsgd"])
def test_transformer_step_at_head_dim_256_matches_jax(algo):
    """One pass at two heads of 256, weights carried across by
    `convert.py`: the port's flash Functions against the JAX package's
    Pallas kernels (interpret mode), which take D = 256 as two 128-lane
    blocks."""
    assert WIDER["dim"] // WIDER["n_heads"] == 256
    spec, passes = _run_both(algo, 1, WIDER)
    _check_passes(algo, spec, passes)


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_rank_stacked_step_equals_per_rank_steps(attn):
    """The step batches the ranks with `vmap(grad(loss))`; with `attn=
    "flash"` the attention Functions join through their own vmap rules.
    After one step from a zero trace the momentum trace IS the gradient,
    so it is held against R single-rank gradients taken without vmap."""
    tmodel = TransformerLM(attn=attn, **SMALL)
    topo, spec = Ring(R), arena_spec(tmodel)
    state = egt.init_train_state(tmodel, (T,), topo, "dpsgd", seed=2,
                                 momentum=MOM, device="cpu")
    # decorrelate the ranks' parameters
    gen = torch.Generator().manual_seed(0)
    state = state.replace(params=state.params + 0.02 * torch.randn(
        state.params.shape, generator=gen))
    x, y = _tokens(R * PER_RANK, seed=5)
    tx = torch.from_numpy(x).long().reshape(R, PER_RANK, T)
    ty = torch.from_numpy(y).long().reshape(R, PER_RANK, T)
    step = make_train_step(tmodel, topo, "dpsgd", fused_sgd=(LR, MOM))
    new_state, m = step(state, (tx, ty))
    for r in range(R):
        leaves = {k: v.clone().requires_grad_()
                  for k, v in spec.unravel(state.params[r]).items()}
        out = torch.func.functional_call(tmodel, leaves, (tx[r],))
        loss = _xent(out, ty[r])
        grads = torch.autograd.grad(loss, list(leaves.values()))
        want = spec.ravel(dict(zip(leaves, grads)))
        np.testing.assert_allclose(new_state.trace[r].numpy(), want.numpy(),
                                   err_msg=f"rank {r}", **TOL)
        np.testing.assert_allclose(float(m["loss"][r]), float(loss.detach()),
                                   rtol=1e-5)
        assert int(m["correct"][r]) == int((out.argmax(-1) == ty[r]).sum())


def test_train_on_cpu_learns_and_records():
    """`train(device="cpu")` on the LM task: falling loss, the ResNet
    path's record keys, token-level accuracies, msgs_saved_pct in range."""
    model = TransformerLM(attn="flash", **SMALL)
    x, y = synthetic_lm_dataset(96, seq_len=T, vocab=SMALL["vocab"])
    xt, yt = synthetic_lm_dataset(32, seq_len=T, vocab=SMALL["vocab"],
                                  split="test")
    for algo in ("eventgrad", "dpsgd"):
        state, hist = egt.train(
            model, egt.Ring(R), x, y, algo=algo, epochs=2, batch_size=4,
            learning_rate=0.1, momentum=0.9,
            event_cfg=egt.EventConfig(horizon=1.05, warmup_passes=2,
                                      max_silence=50),
            x_test=xt, y_test=yt, device="cpu",
        )
        assert len(hist) == 2 and state.pass_num == 12
        assert state.batch_stats == {}
        for rec in hist:
            for key in ("loss", "train_acc", "steps", "wall_s", "n_params",
                        "sent_bytes_per_step_per_chip", "wire",
                        "resident_dtype", "staleness", "test_accuracy",
                        "test_loss"):
                assert key in rec, key
            assert np.isfinite(rec["loss"])
            assert 0.0 <= rec["train_acc"] <= 100.0
            assert 0.0 <= rec["test_accuracy"] <= 100.0
        assert hist[1]["loss"] < hist[0]["loss"]
        assert hist[1]["test_loss"] < np.log(SMALL["vocab"])
        if algo == "eventgrad":
            assert 0.0 < hist[-1]["msgs_saved_pct"] < 100.0
        assert torch.isfinite(state.params).all()


def test_evaluate_scores_every_token():
    model = TransformerLM(**SMALL)
    params, stats = model.init_variables(3, device="cpu")
    flat = arena_spec(model).ravel(params)
    x, y = synthetic_lm_dataset(10, seq_len=T, vocab=SMALL["vocab"])
    got = egt.evaluate(model, flat, stats, x, y, batch_size=4, device="cpu")
    # whole batches only: the first 8 sequences
    tx, ty = torch.from_numpy(x[:8]).long(), torch.from_numpy(y[:8]).long()
    logits = torch.func.functional_call(model, params, (tx,))
    assert got["loss"] == pytest.approx(float(_xent(logits, ty)), rel=1e-5)
    assert got["accuracy"] == pytest.approx(
        100.0 * float((logits.argmax(-1) == ty).float().mean()), rel=1e-6)
