"""What the hybrid-mesh tests of the port share (`test_torch_hybrid.py`,
`test_torch_tp.py`, `test_torch_pp.py`, `test_torch_moe.py`,
`test_torch_mesh_hybrid.py`).

Both packages start from the same state: the JAX package's
`init_train_state_spmd` on the JAX topology (its tree path, as its loop
runs hybrid meshes), carried into the port's arena by
`convert.params_from_jax` rank by rank, with fresh event states on both
sides. The same numpy batches (the data ranks' batches lifted onto the
mesh by the JAX `expand_to_mesh`) go through the JAX step lifted by
`spmd` and the port's step.

Tolerances, and why (all float32 unless a test says otherwise):
  * parameters and momentum trace after each pass, per-rank loss:
    rtol=1e-4, atol=1e-5 (the two frameworks reduce matrix products,
    LayerNorm statistics and the group means in another order; the JAX
    step runs optax's tail, the port its fused kernel tail, documented
    bitwise equal in the JAX package);
  * fire bits, `num_events`, `correct`, msgs-saved-% and the byte
    metrics: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from eventgrad_tpu.data.sharding import expand_to_mesh as jax_expand
from eventgrad_tpu.parallel.events import EventConfig as JaxEventConfig
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Topology as JaxTopology
from eventgrad_tpu.train.state import init_train_state_spmd as jax_init_spmd
from eventgrad_tpu.train.steps import make_train_step as jax_make_step
from eventgrad_tpu.utils.metrics import msgs_saved_pct as jax_msgs_saved
from eventgrad_tpu_torch import convert
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig, EventState
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.train.state import TrainState
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.metrics import msgs_saved_pct

TOL = dict(rtol=1e-4, atol=1e-5)
LR, MOM = 0.01, 0.9
#: warmup 1, then a fast-decaying threshold: pass 2 mixes fires and
#: quiet leaves
CFG = dict(adaptive=True, horizon=0.6, warmup_passes=1, max_silence=4)
#: the small LM of these tests
LM = dict(vocab=32, dim=32, n_heads=2, n_layers=2, max_len=16)
VOCAB, T = LM["vocab"], LM["max_len"]
SHARDED = ("tp", "pp", "ep")


def mesh(spec: str):
    """(JAX topology, port topology) of a hybrid mesh spec ("dp:2,sp:2"),
    classed as the CLI classes them: dp gossips, ddp is a data-aux axis,
    tp/pp/ep shard, sp is a replicated aux axis."""
    axes, shape = [], []
    for part in spec.split(","):
        name, _, n = part.partition(":")
        axes.append(name)
        shape.append(int(n))
    kw = dict(axes=tuple(axes), shape=tuple(shape),
              gossip_axes=tuple(a for a in axes if a == "dp"),
              sharded_axes=tuple(a for a in axes if a in SHARDED),
              data_aux_axes=tuple(a for a in axes if a == "ddp"))
    return JaxTopology(**kw), Topology(**kw)


def lm_batches(jtopo, n_steps, per_rank=2, seed=1):
    """`n_steps` (x, y) token batches on the full mesh: each data rank's
    next-token pairs, lifted by the JAX `expand_to_mesh`."""
    rng = np.random.default_rng(seed)
    n_data = jtopo.n_data_ranks
    toks = rng.integers(0, VOCAB, (n_data, n_steps, per_rank, T),
                        dtype=np.int32)
    xb, yb = jax_expand(toks, np.roll(toks, -1, axis=-1), jtopo)
    return [(xb[:, i], yb[:, i]) for i in range(n_steps)]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat_of(jparams, spec):
    """A stacked flax params tree as the port's `[R, n]` arena."""
    tp, _ = convert.params_from_jax(np_tree(jparams), stacked=True)
    return spec.ravel(tp)


def jax_init_jit(jmodel, input_shape, tx, jtopo, algo, seed=0,
                 input_dtype=jnp.int32):
    """`init_train_state_spmd`'s per-rank initialization (flax init, the
    optimizer state, the event state; every rank the same root key, the
    random streams split from it) compiled as one jit: the JAX function
    runs it op by op on the CPU, which costs seconds a model here."""
    from eventgrad_tpu.parallel.events import EventState as JaxEventState
    from eventgrad_tpu.train.state import TrainState as JaxTrainState

    def per_rank_init(key):
        variables = jmodel.init(key, jnp.zeros((1,) + tuple(input_shape),
                                               input_dtype))
        params = variables["params"]
        event = (JaxEventState.init(params, jtopo, JaxEventConfig(**CFG))
                 if algo == "eventgrad" else None)
        return JaxTrainState(
            params=params, opt_state=tx.init(params),
            batch_stats=variables.get("batch_stats", {}),
            pass_num=jnp.zeros((), jnp.int32), rng=key, event=event)

    @jax.jit
    def build(root):
        keys = jnp.broadcast_to(root, (jtopo.n_ranks,) + root.shape)
        state = spmd(per_rank_init, jtopo)(keys)
        rngs = jax.random.split(jax.random.fold_in(root, 1), jtopo.n_ranks)
        return state.replace(rng=rngs)

    return build(jax.random.PRNGKey(seed))


def carried_start(jmodel, tmodel, spec_str, algo, input_shape,
                  input_dtype=jnp.int32, jit=False):
    """The JAX package's initial state on the mesh `spec_str` and the
    port's, carried from it with a fresh event state. Returns (JAX
    state, port state, arena spec). `jit=True` builds the JAX state with
    `jax_init_jit`."""
    jtopo, topo = mesh(spec_str)
    tx = optax.sgd(LR, momentum=MOM)
    if jit:
        jstate = jax_init_jit(jmodel, input_shape, tx, jtopo, algo,
                              input_dtype=input_dtype)
    else:
        jstate = jax_init_spmd(jmodel, input_shape, tx, jtopo, algo,
                               JaxEventConfig(**CFG), seed=0,
                               input_dtype=input_dtype)
    spec = arena_spec(tmodel)
    tp, ts = convert.params_from_jax(np_tree(jstate.params),
                                     np_tree(jstate.batch_stats),
                                     stacked=True)
    flat = spec.ravel(tp)
    tstate = TrainState(
        params=flat, trace=torch.zeros_like(flat), batch_stats=ts,
        pass_num=0,
        event=(EventState.init(spec, topo, EventConfig(**CFG), device="cpu")
               if algo == "eventgrad" else None))
    return jstate, tstate, spec


def port_step(tmodel, topo, algo, mesh=None):
    """The port's step of these tests (`trace` on for EventGraD), lifted
    onto `mesh` when one is given."""
    return make_train_step(tmodel, topo, algo, EventConfig(**CFG),
                           fused_sgd=(LR, MOM), trace=algo == "eventgrad",
                           mesh=mesh)


def torch_batch(x, y):
    """A numpy batch as the port's step takes it."""
    return (torch.from_numpy(np.asarray(x)).to(
        torch.int64 if x.dtype.kind == "i" else torch.float32),
        torch.from_numpy(np.asarray(y)).long())


def jax_passes(jmodel, jstate, spec_str, algo, batches):
    """[(JAX state, JAX metrics)] after each batch, from `jstate`."""
    jtopo, _ = mesh(spec_str)
    tx = optax.sgd(LR, momentum=MOM)
    jstep = jax.jit(spmd(jax_make_step(
        jmodel, tx, jtopo, algo, JaxEventConfig(**CFG),
        trace=algo == "eventgrad"), jtopo))
    out = []
    for x, y in batches:
        jstate, jm = jstep(jstate, (jnp.asarray(x), jnp.asarray(y)))
        out.append((np_tree(jstate), np_tree(jm)))
    return out


def run_both(jmodel, tmodel, spec_str, algo, batches, input_shape,
             input_dtype=jnp.int32):
    """Both packages' steps from the same state over `batches` on the
    mesh `spec_str`. Returns (arena spec, port topology, [(JAX state,
    JAX metrics, port state, port metrics) per pass])."""
    _, topo = mesh(spec_str)
    jstate, tstate, spec = carried_start(jmodel, tmodel, spec_str, algo,
                                         input_shape, input_dtype)
    tstep = port_step(tmodel, topo, algo)
    passes = []
    for (js, jm), (x, y) in zip(
            jax_passes(jmodel, jstate, spec_str, algo, batches), batches):
        tstate, tm = tstep(tstate, torch_batch(x, y))
        passes.append((js, jm, tstate,
                       {k: v.numpy() for k, v in tm.items()}))
    return spec, topo, passes


def check_passes(algo, spec, topo, passes, tol=TOL):
    """Parameters, trace and loss within `tol`; fire bits, events,
    msgs-saved-%, token counts and bytes equal. Returns the fire bits
    set past warmup (EventGraD)."""
    fired = 0
    for p, (jstate, jm, tstate, tm) in enumerate(passes, start=1):
        np.testing.assert_allclose(
            tstate.params.numpy(), flat_of(jstate.params, spec).numpy(),
            err_msg=f"params, pass {p}", **tol)
        np.testing.assert_allclose(
            tstate.trace.numpy(), flat_of(jstate.opt_state[0].trace,
                                          spec).numpy(),
            err_msg=f"trace, pass {p}", **tol)
        np.testing.assert_allclose(tm["loss"], jm["loss"],
                                   err_msg=f"loss, pass {p}", **tol)
        np.testing.assert_array_equal(tm["correct"], jm["correct"])
        for k in ("sent_bytes", "sent_bytes_wire_real", "fired_elems",
                  "num_events", "num_deferred", "fired_frac"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=f"{k} {p}")
        if algo == "eventgrad":
            np.testing.assert_array_equal(tm["trace_fired"],
                                          jm["trace_fired"],
                                          err_msg=f"fire bits, pass {p}")
            events = int(tm["num_events"].sum())
            assert msgs_saved_pct(
                events, p, spec.n_leaves, topo.n_neighbors,
                topo.n_ranks) == jax_msgs_saved(
                int(jm["num_events"].sum()), p, spec.n_leaves,
                topo.n_neighbors, topo.n_ranks)
            if p > CFG["warmup_passes"]:
                fired += int(tm["trace_fired"].sum())
    return fired


def assert_gossip_bytes(algo, spec, topo, passes):
    """The bytes of the gossip axes alone: D-PSGD ships the f32 arena to
    each gossip neighbour; EventGraD's wire-real is that plus a fire
    byte a leaf, its sent bytes the fired leaves' payload."""
    n_nb = topo.n_neighbors
    assert n_nb == 2 * sum(topo.axis_size(a) > 1 for a in topo.gossip_axes)
    for _, _, tstate, tm in passes:
        if algo == "dpsgd":
            want = np.float32(n_nb) * np.float32(4.0 * spec.n_total)
            assert (tm["sent_bytes"] == want).all()
        else:
            want = np.float32(n_nb) * np.float32(4 * spec.n_total
                                                 + spec.n_leaves)
            assert (tm["sent_bytes_wire_real"] == want).all()
            sizes = np.asarray(spec.sizes, np.float32)
            fired = (tm["trace_fired"] * sizes).sum(-1)
            np.testing.assert_array_equal(
                tm["sent_bytes"], np.float32(n_nb) * np.float32(4.0) * fired)
