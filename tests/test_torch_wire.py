"""The port's bf16/int8 wires and carrier-resident buffers against the
JAX package's, bitwise.

The int8 codec is bitwise in the JAX package (per-leaf absmax, a 1e-30
floor, an IEEE float32 division by 127, the 17-significand-bit
truncation, then clip(round_half_even(x / s))), and so are the bf16
cast, the exchanges built from them, the carrier scale commit and the
dequantized view of carrier buffers. Every comparison here is of bit
patterns, so signed zeros count. The small tree has ragged leaves (26
elements in all) and carries the codec's edge cases: an all-zero leaf,
non-fired leaves, and values that land exactly on .5 after the division
(round half to even).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.parallel import arena as jax_arena
from eventgrad_tpu.parallel import collectives as jax_coll
from eventgrad_tpu.parallel import events as jax_events
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu_torch.ops.event_engine import masked_wire
from eventgrad_tpu_torch.parallel import arena, collectives, events
from eventgrad_tpu_torch.parallel.topology import Ring

R = 8
#: flax order a, b, c_10, c_2 (26 elements)
SIZES = {"b": 5, "a": 7, "c_10": 3, "c_2": 11}
#: rank 1's leaf c_2: absmax 15.875, so its scale is exactly 0.125 and
#: the rest divide to 2.5, -2.5, 3.5, -3.5, 0.5, -0.5, -0, 1.5, -127, 0
HALVES = [15.875, 0.3125, -0.3125, 0.4375, -0.4375, 0.0625, -0.0625,
          -0.0, 0.1875, -15.875, 0.0]


def _bits(x) -> np.ndarray:
    """The bit pattern of a torch tensor or an array of any float type."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    a = np.asarray(x)
    if a.dtype.kind in "iub":
        return a
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _assert_bits(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _tree(seed=3):
    rng = np.random.default_rng(seed)
    tree = {k: (3 * rng.standard_normal((R, z))).astype(np.float32)
            for k, z in SIZES.items()}
    tree["a"][0] = 0.0
    tree["b"][2, 0] = -0.0
    tree["c_2"][1] = HALVES
    fire = rng.random((R, 4)) > 0.4
    fire[0, 0] = True   # the all-zero leaf fires: its scale bottoms out
    fire[1, 3] = True   # the .5 leaf fires
    fire[2, 1] = True   # the signed zero rides a fired leaf
    fire[3] = False     # a rank with nothing to send
    return tree, fire


def _specs(tree):
    jspec = jax_arena.arena_spec({k: v[0] for k, v in tree.items()})
    tspec = arena.arena_spec({k: v.shape[1:] for k, v in tree.items()})
    assert tspec.names == ("a", "b", "c_10", "c_2")
    assert tspec.sizes == jspec.sizes
    return jspec, tspec


def test_contract_safe_matches_jax():
    rng = np.random.default_rng(0)
    s = np.concatenate([
        rng.uniform(1e-6, 1e3, 500).astype(np.float32),
        np.float32([0.0, -0.0, 1e-30 / 127, 1.0, 3.4e38, 1e-44, 0.125]),
    ]).astype(np.float32)
    got = collectives._contract_safe(torch.from_numpy(s))
    _assert_bits(got, jax_coll._contract_safe(jnp.asarray(s)), "contract_safe")
    # 17 significand bits: the low 7 stored mantissa bits are clear
    assert not np.any(_bits(got) & 0x7F)


def test_int8_codec_pieces_match_jax():
    tree, fire = _tree()
    jspec, tspec = _specs(tree)
    flat = tspec.ravel({k: torch.from_numpy(v) for k, v in tree.items()})
    fire_t = torch.from_numpy(fire)
    seg = tspec.seg_expand()
    absmax = collectives._leaf_absmax(flat, tspec)
    scales = collectives._masked_scales(absmax, fire_t)
    zero = torch.zeros(())
    q = collectives._int8_encode_flat(
        torch.where(fire_t[:, seg], flat, zero), scales, seg
    )
    jseg = jspec.seg_expand()
    for r in range(R):
        leaves = [jnp.asarray(tree[k][r]) for k in tspec.names]
        j_absmax = jax_coll._leaf_absmax(leaves)
        j_scales = jax_coll._masked_scales(j_absmax, jnp.asarray(fire[r]))
        j_masked = jnp.where(jnp.asarray(fire[r])[jseg],
                             jnp.asarray(flat[r].numpy()), 0.0)
        _assert_bits(absmax[r], j_absmax, f"absmax rank {r}")
        _assert_bits(scales[r], j_scales, f"scales rank {r}")
        _assert_bits(q[r], jax_coll._int8_encode_flat(j_masked, j_scales, jseg),
                     f"int8 rank {r}")
    # the edge cases took the path they were built for
    assert scales[0, 0] == collectives._contract_safe(
        torch.tensor(np.float32(1e-30)) / 127.0)   # all-zero leaf
    assert torch.all(q[3] == 0)                     # nothing fired
    c2 = tspec.starts[3]
    assert scales[1, 3] == 0.125
    assert q[1, c2:c2 + 11].tolist() == [127, 2, -2, 4, -4, 0, 0, 0, 2, -127, 0]


def test_wire_out_and_bytes_match_jax():
    x = np.random.default_rng(1).standard_normal(1001).astype(np.float32)
    x[::9] = -0.0
    _assert_bits(collectives._wire_out(torch.from_numpy(x), "bf16"),
                 jax_coll._wire_out(jnp.asarray(x), "bf16"), "bf16 wire")
    assert collectives._wire_out(torch.from_numpy(x), "int8").dtype == torch.float32
    assert collectives.WIRE_MODES == jax_coll.WIRE_MODES
    assert collectives.WIRE_VAL_BYTES == jax_coll.WIRE_VAL_BYTES
    for wire in collectives.WIRE_MODES:
        for fire_bits in (False, True):
            assert collectives.wire_real_bytes_per_neighbor(
                17_444_682, 86, wire, fire_bits=fire_bits
            ) == jax_coll.wire_real_bytes_per_neighbor(
                17_444_682, 86, wire, fire_bits=fire_bits
            )
    # the flagship's int8 wire per chip (two neighbors): D-PSGD ships the
    # values and the [L] scales, EventGraD also the [L] fire bits
    per_nb = collectives.wire_real_bytes_per_neighbor
    assert 2 * per_nb(17_444_682, 86, "int8") == 34_890_052
    assert 2 * per_nb(17_444_682, 86, "int8", fire_bits=True) == 34_890_224
    with pytest.raises(ValueError, match="wire must be one of"):
        per_nb(10, 2, wire="fp8")
    # the compact wire ships its capacity's lanes
    assert per_nb(10, 2, wire="int8", compact_capacity=4) == (
        jax_coll.wire_real_bytes_per_neighbor(10, 2, wire="int8",
                                              compact_capacity=4))


@pytest.mark.parametrize("builder", [False, True], ids=["inline", "kernel"])
@pytest.mark.parametrize("carrier", [False, True], ids=["f32", "carrier"])
@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_exchanges_match_jax(wire, carrier, builder):
    tree, fire = _tree(seed=5)
    jspec, tspec = _specs(tree)
    jtopo, ttopo = JaxRing(R), Ring(R)

    def jax_step(t, f):
        return (
            jax_coll.masked_neighbor_vals_flat(t, f, jtopo, jspec, wire,
                                               carrier=carrier),
            jax_coll.neighbor_vals_flat(t, jtopo, jspec, wire),
        )

    want_masked, want_dense = spmd(jax_step, jtopo)(
        {k: jnp.asarray(v) for k, v in tree.items()}, jnp.asarray(fire)
    )
    flat = tspec.ravel({k: torch.from_numpy(v) for k, v in tree.items()})
    got_masked = collectives.masked_neighbor_vals_flat(
        flat, torch.from_numpy(fire), ttopo, tspec, wire,
        wire_builder=masked_wire if builder else None, carrier=carrier,
    )
    got_dense = collectives.neighbor_vals_flat(flat, ttopo, tspec, wire)
    assert len(got_masked) == len(want_masked) == (4 if carrier else 3)
    if carrier:
        want_dt = torch.int8 if wire == "int8" else torch.bfloat16
        assert all(c.dtype == want_dt for c in got_masked[0])
        assert (got_masked[3] is None) == (want_masked[3] is None) == (
            wire == "bf16")
    for part, (got, want) in enumerate(zip(got_masked, want_masked)):
        if want is None:
            continue
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bits(g, w, f"masked part {part} neighbor {i}")
    for i, (g, w) in enumerate(zip(got_dense, want_dense)):
        _assert_bits(g, w, f"dense neighbor {i}")


def test_carrier_commit_and_dequant_match_jax():
    rng = np.random.default_rng(7)
    tree, _ = _tree(seed=7)
    jspec, tspec = _specs(tree)
    n, L = tspec.n_total, tspec.n_leaves
    mk_scales = lambda: np.array(jax_coll._contract_safe(
        jnp.asarray(rng.uniform(1e-3, 1.0, (R, L)).astype(np.float32))))
    cands = [rng.integers(-127, 128, (R, n)).astype(np.int8) for _ in range(2)]
    lasts = [rng.integers(-127, 128, (R, n)).astype(np.int8) for _ in range(2)]
    cs, ls = [mk_scales() for _ in range(2)], [mk_scales() for _ in range(2)]
    effs = [rng.random((R, L)) > 0.5 for _ in range(2)]
    T = lambda xs: tuple(torch.from_numpy(x) for x in xs)
    new_s = collectives.commit_carrier_scales(T(cs), T(effs), T(ls))
    new_b = collectives.commit_bufs_flat(T(cands), T(effs), T(lasts), tspec)
    deq = collectives.dequant_carrier_bufs(new_b, new_s, tspec)
    deq_bf16 = collectives.dequant_carrier_bufs(
        tuple(torch.from_numpy(c.astype(np.float32)).to(torch.bfloat16)
              for c in cands), None, tspec)
    for r in range(R):
        J = lambda xs: tuple(jnp.asarray(x[r]) for x in xs)
        j_s = jax_coll.commit_carrier_scales(J(cs), J(effs), J(ls))
        j_b = jax_coll.commit_bufs_flat(J(cands), J(effs), J(lasts), jspec)
        j_d = jax_coll.dequant_carrier_bufs(j_b, j_s, jspec)
        j_bf = jax_coll.dequant_carrier_bufs(
            tuple(jnp.asarray(c[r], jnp.float32).astype(jnp.bfloat16)
                  for c in cands), None, jspec)
        for i in range(2):
            _assert_bits(new_s[i][r], j_s[i], f"scales rank {r}")
            _assert_bits(new_b[i][r], j_b[i], f"bufs rank {r}")
            _assert_bits(deq[i][r], j_d[i], f"dequant rank {r}")
            _assert_bits(deq_bf16[i][r], j_bf[i], f"bf16 dequant rank {r}")


@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_carrier_layout_matches_jax(wire):
    tree, _ = _tree()
    jspec, tspec = _specs(tree)
    jdt = jax_arena.carrier_dtype(wire)
    tdt = arena.carrier_dtype(wire)
    assert (jdt is None) == (tdt is None)
    if tdt is not None:
        assert str(tdt).removeprefix("torch.") == jnp.dtype(jdt).name
    assert arena.carrier_needs_scales(wire) == jax_arena.carrier_needs_scales(wire)
    jb, js = jax_arena.alloc_event_bufs(jspec, 2, wire=wire)
    tb, ts = arena.alloc_event_bufs(tspec, 2, R, wire=wire)
    assert (ts is None) == (js is None)
    for t, j in zip(tb, jb):
        assert tuple(t.shape) == (R,) + tuple(j.shape)
        _assert_bits(t[0], j, "zero buffer")
    if ts is not None:
        for t, j in zip(ts, js):
            _assert_bits(t[0], j, "unit scales")
    st = events.EventState.init(tspec, Ring(R), events.EventConfig(),
                                resident_wire=wire)
    jst = jax_events.EventState.init(
        {k: jnp.asarray(v[0]) for k, v in tree.items()}, JaxRing(R),
        jax_events.EventConfig(), arena=True, resident_wire=wire,
    )
    assert [b.dtype for b in st.bufs] == [tdt or torch.float32] * 2
    assert (st.buf_scales is None) == (jst.buf_scales is None)
