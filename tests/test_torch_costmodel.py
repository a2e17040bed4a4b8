"""The port's analytic cost model (`obs/costmodel.py`) on the CPU: FLOP
counts against closed forms, phase attribution from the step's phase
tags, the tags' bitwise neutrality, the kernel ops' closed forms
(`ops/work.py`) against their traced boundaries, and the port's whole-
step FLOPs beside the JAX package's (XLA's cost analysis of the JAX
step).

FLOP oracles, as the JAX package's tests state them:
  * MLP (matrix products only): EXACT. Through `vmap(grad(loss))`,
    layer 1 contributes 2 products (forward, weight gradient — the input
    gradient of the first layer is never built) and every deeper layer 3
    (forward, weight gradient, input gradient), each 2·B·in·out.
  * CNN2: within the documented bound — the backward adds a data-grad
    and a filter-grad convolution of about forward cost each, so the
    conv + dot FLOPs sit in [2x, 4x] the closed-form forward count.
"""

import math

import numpy as np
import optax
import pytest
import torch

from eventgrad_tpu.data.datasets import synthetic_dataset
from eventgrad_tpu.models import CNN2 as JaxCNN2
from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.train.state import init_train_state as jax_init_state
from eventgrad_tpu.utils.flops import train_step_flops as jax_step_flops
from eventgrad_tpu_torch.analysis import walker
from eventgrad_tpu_torch.models import CNN2, MLP
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.obs import Registry, costmodel
from eventgrad_tpu_torch.obs.devicespec import GENERIC_CPU
from eventgrad_tpu_torch.ops import work
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.flops import step_layout_kwargs

N_RANKS = 4
PER_RANK = 4
IN_SHAPE = (8, 8, 1)
CFG_KW = dict(adaptive=True, horizon=0.95, warmup_passes=2, max_silence=4)
CFG = EventConfig(**CFG_KW)


def _mlp():
    return MLP(hidden=16, input_shape=IN_SHAPE, device="cpu")


def _setup(model, algo, in_shape=IN_SHAPE, n=64, **state_kw):
    topo = Ring(N_RANKS)
    state = init_train_state(model, in_shape, topo, algo, CFG,
                             device="cpu", **state_kw)
    x, y = synthetic_dataset(n, in_shape, seed=0)
    return topo, state, x, y


def _analyze(model, algo, in_shape=IN_SHAPE, state_kw=None, **step_kw):
    topo, state, x, y = _setup(model, algo, in_shape, **(state_kw or {}))
    return costmodel.analyze_step(model, topo, algo, CFG, x, y, PER_RANK,
                                  state, **step_kw)


# --- FLOP oracles ------------------------------------------------------------


def test_mlp_dot_flops_match_closed_form_exactly():
    cm = _analyze(_mlp(), "dpsgd")
    batch = N_RANKS * PER_RANK
    layers = [(math.prod(IN_SHAPE), 16), (16, 10)]
    expected = sum((2 if i == 0 else 3) * 2 * batch * fi * fo
                   for i, (fi, fo) in enumerate(layers))
    assert cm["dot_flops"] == expected
    assert cm["conv_flops"] == 0.0
    assert cm["flops_total"] > cm["dot_flops"]  # eltwise/reductions ride
    assert cm["unbounded_loops"] == 0 and cm["n_eqns"] > 0


def test_cnn_conv_flops_within_documented_bound():
    cm = _analyze(CNN2(device="cpu"), "dpsgd", in_shape=(28, 28, 1))
    batch = N_RANKS * PER_RANK
    fwd = (2 * batch * 26 * 26 * 10 * (3 * 3 * 1)
           + 2 * batch * 11 * 11 * 20 * (3 * 3 * 10)
           + 2 * batch * (500 * 50 + 50 * 10))
    total = cm["conv_flops"] + cm["dot_flops"]
    assert 2.0 * fwd <= total <= 4.0 * fwd, (total, fwd, total / fwd)
    assert cm["conv_flops"] > 0


# --- phase attribution -------------------------------------------------------


def test_phases_attributed_across_step():
    cm = _analyze(_mlp(), "eventgrad")
    by = cm["by_phase"]
    # forward AND backward run inside _phase("grad"): every matrix
    # product lands there, and grad dominates the step's FLOPs
    assert by["grad"]["flops"] >= cm["dot_flops"] > 0
    assert by["grad"]["flops"] > 0.5 * cm["flops_total"]
    for p in ("gate_pack", "exchange", "commit_mix"):
        assert by[p]["flops"] > 0 and by[p]["hbm_bytes"] > 0, p
    assert sum(p["flops"] for p in by.values()) == cm["flops_total"]
    assert sum(p["hbm_bytes"] for p in by.values()) == cm["hbm_bytes_total"]


def test_backward_nodes_tagged_grad():
    """The backward's nodes (recorded by autograd inside the grad call)
    carry the grad tag, like the forward's."""
    model = _mlp()
    topo, state, x, y = _setup(model, "dpsgd")
    step = make_train_step(model, topo, "dpsgd", CFG, fused_sgd=(0.05, 0.0))
    tr = walker.trace(step, state, costmodel.step_batch(x, y, topo,
                                                        PER_RANK, "cpu"))
    products = [n for n, _ in walker.iter_nodes(tr.graph)
                if walker.op_name(n) in ("aten::bmm", "aten::mm",
                                         "aten::addmm")]
    assert len(products) == 5  # 2 forward, 2 weight grads, 1 input grad
    assert {costmodel.phase_of(n) for n in products} == {"grad"}


def test_bucketed_phases_carry_bucket_labels():
    cm = _analyze(_mlp(), "eventgrad", state_kw=dict(bucketed=4))
    labels = set(cm["phases"])
    assert {f"exchange.b{k}" for k in range(4)} <= labels, labels
    assert {f"commit_mix.b{k}" for k in range(4)} <= labels, labels
    for base in ("exchange", "commit_mix"):
        assert cm["by_phase"][base]["hbm_bytes"] == sum(
            cm["phases"][lb]["hbm_bytes"] for lb in labels
            if lb.startswith(base))


def test_annotations_are_bitwise_neutral():
    model = _mlp()
    topo, state, x, y = _setup(model, "eventgrad")
    batch = costmodel.step_batch(x, y, topo, PER_RANK, "cpu")

    def run():
        step = make_train_step(model, topo, "eventgrad", CFG,
                               fused_sgd=(0.05, 0.0))
        s, m = state, None
        for _ in range(3):
            s, m = walker.trace(step, s, batch).out
        return s, m

    assert costmodel.annotations_enabled()
    s_on, m_on = run()
    with costmodel.annotations_disabled():
        assert not costmodel.annotations_enabled()
        s_off, m_off = run()
        cm = costmodel.analyze_step(model, topo, "eventgrad", CFG, x, y,
                                    PER_RANK, state)
    assert costmodel.annotations_enabled()
    a, b = walker.flatten(s_on)[0], walker.flatten(s_off)[0]
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for k in m_on:
        assert torch.equal(m_on[k], m_off[k]), k
    assert set(cm["phases"]) == {"other"}


# --- the kernel ops ----------------------------------------------------------


def _boundary_bytes(node):
    return sum(costmodel._nbytes(t) for a in list(node.args) + [node]
               for t in costmodel._tensors(a))


def _kernel_nodes(step, state, batch):
    tr = walker.trace(step, state, batch)
    return [n for n, _ in walker.iter_nodes(tr.graph)
            if (walker.op_name(n) or "").startswith("eg::")]


KERNEL_CASES = {
    "eventgrad-f32": ("eventgrad", {}, {}),
    "dpsgd-f32": ("dpsgd", {}, {}),
    "eventgrad-int8": ("eventgrad", dict(wire="int8"), {}),
    "eventgrad-int8-carrier": ("eventgrad", dict(wire="int8",
                                                 carrier_resident=True),
                               dict(resident_wire="int8")),
    "eventgrad-bf16-carrier": ("eventgrad", dict(wire="bf16",
                                                 carrier_resident=True),
                               dict(resident_wire="bf16")),
}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_tail_kernel_work_equals_closed_form(case):
    """Every contiguous tail op of the step: FLOPs and bytes are the
    closed form of `ops/work.py` (the bound `chip_smoke.py` reports), and
    the bytes are the op's traced boundary."""
    algo, step_kw, state_kw = KERNEL_CASES[case]
    model = _mlp()
    topo, state, x, y = _setup(model, algo, **state_kw)
    step = make_train_step(model, topo, algo, CFG, fused_sgd=(0.05, 0.0),
                           **step_kw)
    nodes = _kernel_nodes(step, state, costmodel.step_batch(
        x, y, topo, PER_RANK, "cpu"))
    assert nodes
    n = N_RANKS * state.params.shape[1]
    carrier = state_kw.get("resident_wire")
    for node in nodes:
        kernel = walker.op_name(node)[len("eg::"):]
        flops, nbytes = costmodel.kernel_work(node)
        assert (flops, nbytes) == work.tail(kernel, n, 2, carrier), kernel
        assert nbytes == _boundary_bytes(node), kernel
    cm = costmodel.analyze_step(model, topo, algo, CFG, x, y, PER_RANK,
                                state, **step_kw)
    assert cm["kernel_flops"] == sum(costmodel.kernel_work(n)[0]
                                     for n in nodes)


def test_pitched_kernel_work_counts_the_bucket_columns():
    model = _mlp()
    topo, state, x, y = _setup(model, "eventgrad", bucketed=4)
    step = make_train_step(model, topo, "eventgrad", CFG,
                           fused_sgd=(0.05, 0.0), bucketed=4)
    nodes = _kernel_nodes(step, state, costmodel.step_batch(
        x, y, topo, PER_RANK, "cpu"))
    tails = [n for n in nodes
             if walker.op_name(n) == "eg::fused_mix_commit_bucket"]
    assert len(tails) == 4
    total = 0
    for node in tails:
        cols = costmodel._tensors(node.args[1])[0].shape[1]
        want = work.tail("fused_mix_commit", N_RANKS * cols, 2)
        assert costmodel.kernel_work(node) == want
        total += cols
    assert total == state.params.shape[1]


def test_flash_kernel_work_equals_closed_form():
    lm = TransformerLM(vocab=32, dim=16, n_heads=2, n_layers=1, max_len=16,
                       attn="flash", device="cpu")
    topo = Ring(N_RANKS)
    state = init_train_state(lm, (16,), topo, "eventgrad", CFG, device="cpu")
    toks = np.random.default_rng(0).integers(0, 32, (64, 16))
    step = make_train_step(lm, topo, "eventgrad", CFG, fused_sgd=(0.05, 0.0))
    nodes = _kernel_nodes(step, state, costmodel.step_batch(
        toks, np.roll(toks, -1, axis=-1), topo, 2, "cpu"))
    flash = [n for n in nodes if "flash" in walker.op_name(n)]
    assert sorted(walker.op_name(n) for n in flash) == [
        "eg::flash_dkv", "eg::flash_dq", "eg::flash_fwd"]
    shape = (N_RANKS * 2, 16, 2, 8)  # ranks folded into the batch
    for node in flash:
        kernel = walker.op_name(node)[len("eg::"):]
        want = work.flash(kernel, shape, 4, causal=True)
        assert costmodel.kernel_work(node) == want, kernel
        assert want[1] == _boundary_bytes(node), kernel


# --- bytes, layouts, the JAX package's FLOPs ---------------------------------


def test_carrier_resident_bytes_below_f32_twin():
    model = _mlp()
    cm_f = _analyze(model, "eventgrad", wire="int8")
    cm_c = _analyze(model, "eventgrad", state_kw=dict(resident_wire="int8"),
                    wire="int8")
    assert cm_c["hbm_bytes_total"] < cm_f["hbm_bytes_total"]
    step_s = 0.01
    rl_f = costmodel.roofline(cm_f["flops_total"], cm_f["hbm_bytes_total"],
                              step_s, GENERIC_CPU)
    rl_c = costmodel.roofline(cm_c["flops_total"], cm_c["hbm_bytes_total"],
                              step_s, GENERIC_CPU)
    assert rl_f["roofline_bound"] == "memory"
    assert rl_c["roofline_frac"] < rl_f["roofline_frac"]


def test_step_layout_detection():
    model = _mlp()
    topo = Ring(N_RANKS)
    mk = lambda algo, **kw: init_train_state(model, IN_SHAPE, topo, algo,
                                             CFG, device="cpu", **kw)
    assert step_layout_kwargs(mk("dpsgd")) == {}
    assert step_layout_kwargs(mk("eventgrad")) == {}
    assert step_layout_kwargs(mk("eventgrad", bucketed=2)) == {"bucketed": 2}
    assert step_layout_kwargs(mk("eventgrad", resident_wire="int8")) == {
        "carrier_resident": True, "wire": "int8"}
    assert step_layout_kwargs(mk("eventgrad", resident_wire="bf16")) == {
        "carrier_resident": True, "wire": "bf16"}


#: the port's `flops_total` over the JAX package's `train_step_flops`
#: (XLA's cost analysis of the compiled JAX step) at the same op-points,
#: measured on the CPU before this test was written: MLP 1.0949 (dpsgd)
#: and 1.0978 (eventgrad), CNN2 1.0441 and 1.0467. The port counts each
#: kernel's closed-form work and every ATen op unfused; XLA counts its
#: fused program. The test holds the ratio to [1.0, 1.15].
JAX_RATIO = (1.0, 1.15)


@pytest.mark.parametrize("model_name,algo", [
    ("mlp", "dpsgd"), ("mlp", "eventgrad"), ("cnn2", "dpsgd")])
def test_flops_total_beside_the_jax_step_flops(model_name, algo):
    shape = IN_SHAPE if model_name == "mlp" else (28, 28, 1)
    jmodel = JaxMLP(hidden=16) if model_name == "mlp" else JaxCNN2()
    model = _mlp() if model_name == "mlp" else CNN2(device="cpu")
    jcfg = JaxEventConfig(**CFG_KW)
    x, y = synthetic_dataset(64, shape, seed=0)
    jstate = jax_init_state(jmodel, shape, optax.sgd(0.05), JaxRing(N_RANKS),
                            algo, jcfg, seed=0, arena=True)
    jflops = jax_step_flops(jmodel, optax.sgd(0.05), JaxRing(N_RANKS), algo,
                            jcfg, x, y, PER_RANK, jstate)
    cm = _analyze(model, algo, in_shape=shape)
    ratio = cm["flops_total"] / jflops
    assert JAX_RATIO[0] <= ratio <= JAX_RATIO[1], ratio


# --- start-up stages ---------------------------------------------------------


def test_compile_timed_records_stage_spans():
    model = _mlp()
    topo, state, x, y = _setup(model, "dpsgd")
    reg = Registry()
    batch = costmodel.step_batch(x, y, topo, PER_RANK, "cpu")
    step, spans, memory = costmodel.compile_timed(
        lambda: make_train_step(model, topo, "dpsgd", CFG,
                                fused_sgd=(0.05, 0.0)),
        state, batch, registry=reg, label="unit")
    stages = ("step_build", "kernel_build", "first_dispatch")
    assert set(spans) == set(stages) and all(v >= 0 for v in spans.values())
    names = [s.name for s in reg.spans]
    for st in stages:
        assert st in names
    assert all(s.cat == "compile" for s in reg.spans if s.name in stages)
    assert memory is None  # the CPU allocator keeps no peak
    assert callable(step)
