"""The port's partitioned trigger policies (`micro`, `hybrid`) and their
partition geometry against the JAX package's.

The geometry is plain integers on both sides, so it is held equal:
`ArenaSpec.buckets(k)`, `partition_masks`, `partition_table`,
`validate_partitions` and `max_partition_elems` on the MLP, LeNetCifar
and ResNet-18 specs, and `ownership_vec` per rank and pass against the
JAX function under the `spmd` lift on Ring(8) and Torus(2, 4). The
micro and hybrid steps, on the masked and the compact wire, are held to
the JAX steps pass by pass from the carried JAX state, at
tests/test_torch_compact.py's tolerances (equal fire bits, bitwise
receive buffers): the warmup pass proposes every leaf (the compact gate
may defer some), and from the warmup on every rank fires inside its
owned partition only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.models import MLP as JaxMLP
from eventgrad_tpu.models import LeNetCifar as JaxLeNetCifar
from eventgrad_tpu.models.resnet import ResNet18 as JaxResNet18
from eventgrad_tpu.parallel import arena as jax_arena
from eventgrad_tpu.parallel import policy as jax_policy
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu.parallel.topology import Torus as JaxTorus
import eventgrad_tpu_torch as egt
from eventgrad_tpu_torch.models import MLP, LeNetCifar
from eventgrad_tpu_torch.models.resnet import ResNet18
from eventgrad_tpu_torch.parallel import policy
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring, Torus
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from test_torch_compact import (
    CFG, PASSES, _batches, _bits, _resnets, assert_carried, jax_resnet_state,
    run_carried,
)

R = 8
#: model -> (JAX model, input shape, port model)
MODELS = {
    "mlp": (JaxMLP(), (28, 28, 1), MLP()),
    "lenet_cifar": (JaxLeNetCifar(), (32, 32, 3), LeNetCifar()),
    "resnet18": (JaxResNet18(dtype=jnp.bfloat16), (32, 32, 3), ResNet18()),
}
TOPOS = {"ring8": (JaxRing(8), Ring(8)),
         "torus2x4": (JaxTorus(2, 4), Torus(2, 4))}


def _jax_spec(jmodel, shape):
    params = jax.eval_shape(
        lambda k: jmodel.init(k, jnp.zeros((1,) + shape)), jax.random.PRNGKey(0)
    )["params"]
    return jax_arena.arena_spec(params)


@pytest.fixture(scope="module", params=sorted(MODELS))
def specs(request):
    jmodel, shape, tmodel = MODELS[request.param]
    jspec, tspec = _jax_spec(jmodel, shape), arena_spec(tmodel)
    assert tspec.sizes == jspec.sizes and tspec.starts == jspec.starts
    return request.param, jspec, tspec


def test_buckets_match_jax(specs):
    _, jspec, tspec = specs
    assert tspec.floor == jspec.floor
    for k in (1, 2, 3, 4, 8, 16, 100):
        got, want = tspec.buckets(k), jspec.buckets(k)
        assert len(got) == len(want) == min(k, tspec.n_leaves)
        for g, w in zip(got, want):
            for f in ("index", "lo", "hi", "start", "size", "sizes",
                      "starts_rel", "floor", "n_leaves"):
                assert getattr(g, f) == getattr(w, f), (k, f)


def test_partition_geometry_matches_jax(specs):
    name, jspec, tspec = specs
    for k in (2, 4, 8):
        assert policy.partition_masks(tspec, k) == jax_policy.partition_masks(
            jspec, k)
        assert policy.partition_table(tspec, k) == jax_policy.partition_table(
            jspec, k)
        assert policy.validate_partitions(
            tspec, k) == jax_policy.validate_partitions(jspec, k)
        assert policy.max_partition_elems(
            tspec, k) == jax_policy.max_partition_elems(jspec, k)
        assert policy.validate_partitions(tspec, k)["ok"]
    if name == "lenet_cifar":  # the frontier op-point's capacity
        assert policy.max_partition_elems(tspec, 8) == 48_000


@pytest.mark.parametrize("topo_name", sorted(TOPOS))
def test_ownership_matches_jax(topo_name):
    jmodel, shape, tmodel = MODELS["lenet_cifar"]
    jspec, tspec = _jax_spec(jmodel, shape), arena_spec(tmodel)
    jtopo, topo = TOPOS[topo_name]
    for pass_num in range(0, 20):
        want = spmd(lambda _: jax_policy.ownership_vec(jspec, jtopo, pass_num),
                    jtopo)(jnp.zeros(R))
        got = policy.ownership_vec(tspec, topo, pass_num)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"pass {pass_num}")
        # every leaf is owned by exactly one rank each pass
        assert (got.sum(0) == 1).all()


def test_policies_resolve_with_their_wire_specs():
    for name, algo in (("norm_delta", "eventgrad"), ("topk", "sp_eventgrad"),
                       ("micro", "eventgrad"), ("hybrid", "eventgrad")):
        got = policy.resolve(name, algo)
        want = jax_policy.resolve(name, algo).wire_spec()
        assert got.name == name
        assert (got.algos, got.gossip_wires, got.compact_needs_capacity,
                got.partitioned) == (want.algos, want.gossip_wires,
                                     want.compact_needs_capacity,
                                     want.partitioned)
    for name in ("micro", "hybrid"):
        with pytest.raises(ValueError, match="drives"):
            policy.resolve(name, "sp_eventgrad")
    with pytest.raises(ValueError, match="unknown trigger policy"):
        policy.resolve("bogus", "eventgrad")


@pytest.fixture(scope="module")
def jstate0():
    return jax_resnet_state()


#: (policy, gossip wire)
STEP_CASES = [(p, w) for p in ("micro", "hybrid")
              for w in ("dense", "compact")]


@pytest.mark.parametrize("pol,gossip_wire", STEP_CASES,
                         ids=[f"{p}-{w}" for p, w in STEP_CASES])
def test_partitioned_step_matches_jax(jstate0, pol, gossip_wire):
    spec = arena_spec(_resnets()[1])
    kw = dict(trigger_policy=pol, gossip_wire=gossip_wire)
    if gossip_wire == "compact":
        kw["compact_capacity"] = policy.max_partition_elems(spec, R)
    spec, passes = run_carried(jstate0, _batches(PASSES), CFG, kw)
    assert_carried(spec, passes, f"{pol}-{gossip_wire}")
    deferred = np.zeros(R, np.int64)
    for p, (_, _, tstate, tm) in enumerate(passes, start=1):
        fired = tm["trace_fired"] > 0
        newly_deferred = tm["num_deferred"] - deferred
        deferred = tm["num_deferred"]
        if p < CFG["warmup_passes"]:
            # warmup proposes everything and suppresses nothing: every
            # leaf fires, or (compact) the gate defers it
            assert np.all(fired.sum(-1) + newly_deferred == spec.n_leaves)
            continue
        owned = policy.ownership_vec(spec, Ring(R), p).numpy()
        assert not (fired & ~owned).any(), p
        if pol == "micro":
            # micro ships exactly its owned partition, which fits
            np.testing.assert_array_equal(fired, owned)


def test_sp_eventgrad_compact_is_its_native_wire():
    """sp_eventgrad takes gossip_wire='compact' as a no-op alias: bitwise
    its native top-k wire, every state field and metric."""
    model, topo = MLP(), Ring(R)
    cfg = EventConfig(**CFG)
    x, y = _batches_mlp()
    runs = []
    for kw in (dict(), dict(gossip_wire="compact", compact_capacity=7)):
        step = make_train_step(model, topo, "sp_eventgrad", cfg,
                               fused_sgd=(0.01, 0.9), wire="int8", **kw)
        st = init_train_state(model, (28, 28, 1), topo, "sp_eventgrad", cfg,
                              0, momentum=0.9, device="cpu")
        for i in range(3):
            st, m = step(st, (x[i], y[i]))
        runs.append((st, m))
    (sa, ma), (sb, mb) = runs
    for a, b in ((sa.params, sb.params), (sa.trace, sb.trace),
                 (sa.sparse.prev_sent, sb.sparse.prev_sent),
                 *zip(sa.sparse.replicas, sb.sparse.replicas)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for k in ma:
        np.testing.assert_array_equal(_bits(ma[k]), _bits(mb[k]), err_msg=k)
    # and through train(): the records say compact from the first epoch
    xs, ys = (v.reshape((-1,) + tuple(v.shape[3:])).numpy() for v in (x, y))
    _, hist = egt.train(model, topo, xs, ys, algo="sp_eventgrad", epochs=1,
                        batch_size=4, gossip_wire="compact", event_cfg=cfg,
                        device="cpu")
    assert hist[0]["gossip_wire"] == "compact"
    assert "compact_capacity" not in hist[0]


def _batches_mlp():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((3, R, 4, 28, 28, 1)).astype(
        np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (3, R, 4)))
    return x, y
