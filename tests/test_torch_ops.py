"""The port's kernel modules against the JAX package's kernels.

Each wrapper of `eventgrad_tpu_torch/ops` takes its plain PyTorch
version on a CPU tensor; that version is held against the JAX function
with its Pallas kernel run in interpret mode, as tests/test_ops.py and
tests/test_arena.py run it, comparing float32 bit patterns (so -0.0 and
NaN payloads count too).

Where the comparison is not bitwise, and why: XLA:CPU compiles the
interpreted Pallas kernel bodies of `fused_mix_commit` and
`fused_mix_sgd` with two FMA contractions,
    trace' = fma(momentum, trace, grad)
    p'     = fma(acc, w, -(lr * trace'))
while the port (plain version and CUDA kernel alike, built with
-fmad=false) rounds every product and sum, as the JAX code is written
and as its jnp twins compute. So for those two outputs the tests prove
(a) the port equals the uncontracted formula bitwise, (b) the JAX
kernel equals the contracted formula bitwise, so contraction is the
only difference: at each of the two sites the JAX kernel skips exactly
one rounding the port performs. Everything else —
the committed buffers, the masked wire, `fused_mix_sgd`'s jnp path for
leaves under 2^16 elements — is bitwise. The carrier-resident commit
(`fused_mix_commit_carrier`) contracts at the same two sites; its
dequant products `q * s` are exact (the scales are truncated to 17
significand bits, as `collectives._contract_safe` does), so the
contraction of the mix adds changes no bit. The int8 masked wire is
bitwise, signed zeros, .5 ties and the clip included. The CUDA kernels
are held bitwise against the same plain versions on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from eventgrad_tpu.ops import arena_update as jax_arena_update
from eventgrad_tpu.ops import event_engine as jax_event_engine
from eventgrad_tpu.ops import fused_update as jax_fused_update
from eventgrad_tpu_torch import ops
from eventgrad_tpu_torch.ops import arena_update, event_engine, fused_update

#: a small length and a ragged one past three 512x128 Pallas blocks
SIZES = (1000, 512 * 128 * 3 + 5)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _assert_bitwise(got, want, what):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _fma(a, b, c):
    """float32 fused multiply-add: the exact product plus c, rounded once
    (emulated in float64, where the product of two float32 is exact)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def _assert_tail(got, want, acc, g, t, lr, momentum, w, contracted):
    """`got` (the port) is the uncontracted SGD tail bitwise; `want` (the
    JAX function) is the uncontracted tail bitwise on its jnp path, or
    the FMA-contracted one on its interpreted Pallas path."""
    f = np.float32
    trace = f(momentum) * t + g
    p_new = acc * f(w) - f(lr) * trace
    _assert_bitwise(got[0], p_new, "p_new vs uncontracted formula")
    _assert_bitwise(got[1], trace, "trace vs uncontracted formula")
    if not contracted:
        _assert_bitwise(want[0], p_new, "JAX p_new")
        _assert_bitwise(want[1], trace, "JAX trace")
        return
    trace_c = _fma(np.full_like(t, f(momentum)), t, g)
    p_c = _fma(acc, np.full_like(acc, f(w)), -(f(lr) * trace_c))
    _assert_bitwise(want[0], p_c, "JAX p_new vs contracted formula")
    _assert_bitwise(want[1], trace_c, "JAX trace vs contracted formula")


def _inputs(seed, n, k):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((k, n)).astype(np.float32), rng


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("mix_stale", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_fused_mix_commit_plain_matches_jax(n, mix_stale, momentum):
    (p, g, t, c0, c1, l0, l1), rng = _inputs(n + 3 * mix_stale, n, 7)
    k0 = (rng.random(n) > 0.5).astype(np.float32)
    k1 = (rng.random(n) > 0.3).astype(np.float32)
    lr, w = 0.01, 1 / 3
    want = jax_arena_update.fused_mix_commit(
        jnp.asarray(p), (jnp.asarray(c0), jnp.asarray(c1)),
        (jnp.asarray(k0), jnp.asarray(k1)), (jnp.asarray(l0), jnp.asarray(l1)),
        jnp.asarray(g), jnp.asarray(t), lr, momentum, w,
        mix_stale=mix_stale, interpret=True,
    )
    T = torch.from_numpy
    before = ops.launch_counts()
    got = arena_update.fused_mix_commit(
        T(p), (T(c0), T(c1)), (T(k0), T(k1)), (T(l0), T(l1)), T(g), T(t),
        lr, momentum, w, mix_stale=mix_stale,
    )
    assert ops.launch_counts() == before  # CPU tensors: the plain version
    for i in range(2):
        _assert_bitwise(got[2][i], want[2][i], f"buf{i}")
    mixed_in = (l0, l1) if mix_stale else tuple(np.asarray(b) for b in got[2])
    acc = p + mixed_in[0] + mixed_in[1]
    _assert_tail(got, want, acc, g, t, lr, momentum, w, contracted=True)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("n", SIZES)
def test_fused_mix_sgd_plain_matches_jax(n, momentum):
    (p, b, g, t), _ = _inputs(n + 11, n, 4)
    lr, w = 0.01, 1 / 3
    want = jax_fused_update.fused_mix_sgd(
        jnp.asarray(p), jnp.asarray(b), jnp.asarray(g), jnp.asarray(t),
        lr, momentum, w, interpret=True,
    )
    T = torch.from_numpy
    got = fused_update.fused_mix_sgd(T(p), T(b), T(g), T(t), lr, momentum, w)
    # the JAX function sends leaves of >= 2^16 elements to its Pallas
    # kernel and smaller ones to a jnp chain
    _assert_tail(got, want, p + b, g, t, lr, momentum, w,
                 contracted=n >= 1 << 16)


@pytest.mark.parametrize("n", SIZES)
def test_masked_wire_plain_matches_jax(n):
    (flat,), rng = _inputs(n + 5, n, 1)
    flat[::7] = -0.0  # signed zeros survive a fired position
    fire = (rng.random(n) > 0.5).astype(np.float32)
    want = jax_event_engine.masked_wire(
        jnp.asarray(flat), jnp.asarray(fire), interpret=True
    )
    got = event_engine.masked_wire(torch.from_numpy(flat), torch.from_numpy(fire))
    _assert_bitwise(got, want, "wire")
    _assert_bitwise(
        event_engine.masked_wire_reference(
            torch.from_numpy(flat), torch.from_numpy(fire)
        ),
        jax_event_engine.masked_wire_reference(
            jnp.asarray(flat), jnp.asarray(fire) > 0
        ),
        "reference",
    )


def _contract_safe(s):
    return (np.asarray(s, np.float32).view(np.int32) & ~0x7F).view(np.float32)


@pytest.mark.parametrize("n", SIZES)
def test_masked_wire_int8_plain_matches_jax(n):
    (flat,), rng = _inputs(n + 9, n, 1)
    scale = _contract_safe(rng.uniform(0.01, 0.05, n))
    kind = np.arange(n) % 10
    flat[kind == 0] = -0.0                       # signed zeros survive
    for k, v in ((1, 2.5), (2, -3.5), (3, 300.0), (4, -300.0)):
        flat[kind == k] = v * scale[kind == k]   # exact ties; the clip
    fire = (rng.random(n) > 0.3).astype(np.float32)
    want = jax_event_engine.masked_wire(
        jnp.asarray(flat), jnp.asarray(fire), jnp.asarray(scale),
        interpret=True,
    )
    T = torch.from_numpy
    before = ops.launch_counts()
    got = event_engine.masked_wire(T(flat), T(fire), T(scale))
    assert ops.launch_counts() == before  # CPU tensors: the plain version
    _assert_bitwise(got, want, "int8 wire")
    assert got.dtype == torch.float32
    on, q = fire > 0, got.numpy()
    for k, v in ((1, 2.0), (2, -4.0), (3, 127.0), (4, -127.0)):
        np.testing.assert_array_equal(q[on & (kind == k)], v)
    assert np.all(_bits(q[on & (kind == 0)]) == 0x80000000)  # -0.0
    _assert_bitwise(
        event_engine.masked_wire_reference(T(flat), T(fire), T(scale)),
        jax_event_engine.masked_wire_reference(
            jnp.asarray(flat), jnp.asarray(fire) > 0, jnp.asarray(scale)
        ),
        "reference",
    )


def _carriers(rng, carrier, n):
    """Two random carriers as (torch, jax) pairs of the same bits."""
    out = []
    for _ in range(2):
        if carrier == "int8":
            a = rng.integers(-127, 128, n).astype(np.int8)
            out.append((torch.from_numpy(a), jnp.asarray(a)))
        else:
            a = rng.standard_normal(n).astype(np.float32)
            t = torch.from_numpy(a).to(torch.bfloat16)
            j = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            out.append((t, jnp.asarray(j)))
    return out


@pytest.mark.parametrize("mix_stale", [False, True])
@pytest.mark.parametrize("carrier", ["int8", "bf16"])
@pytest.mark.parametrize("n", SIZES)
def test_fused_mix_commit_carrier_plain_matches_jax(n, carrier, mix_stale):
    (p, g, t), rng = _inputs(n + 17 + 2 * mix_stale, n, 3)
    cands, lasts = _carriers(rng, carrier, n), _carriers(rng, carrier, n)
    keeps = [(rng.random(n) > f).astype(np.float32) for f in (0.5, 0.3)]
    scales = None
    if carrier == "int8":
        scales = [_contract_safe(rng.uniform(1e-3, 0.1, n)) for _ in range(2)]
    lr, mom, w = 0.01, 0.9, 1 / 3
    jtup = lambda xs: tuple(jnp.asarray(x) for x in xs)
    want = jax_arena_update.fused_mix_commit_carrier(
        jnp.asarray(p), tuple(c[1] for c in cands), jtup(keeps),
        tuple(l[1] for l in lasts), jnp.asarray(g), jnp.asarray(t),
        lr, mom, w, mix_scales=None if scales is None else jtup(scales),
        mix_stale=mix_stale, interpret=True,
    )
    T = torch.from_numpy
    args = (T(p), tuple(c[0] for c in cands), tuple(T(k) for k in keeps),
            tuple(l[0] for l in lasts), T(g), T(t), lr, mom, w)
    skw = dict(mix_scales=None if scales is None else tuple(T(s) for s in scales),
               mix_stale=mix_stale)
    before = ops.launch_counts()
    got = arena_update.fused_mix_commit_carrier(*args, **skw)
    assert ops.launch_counts() == before
    to_np = lambda b: (b.view(torch.int16).numpy().view(np.uint16)
                       if b.dtype == torch.bfloat16 else b.numpy())
    for i in range(2):
        assert got[2][i].dtype == lasts[0][0].dtype
        np.testing.assert_array_equal(
            to_np(got[2][i]), np.asarray(want[2][i]).view(to_np(got[2][i]).dtype),
            err_msg=f"buf{i}")
    mixed_in = [l[0] if mix_stale else b for l, b in zip(lasts, got[2])]
    vals = [x.to(torch.float32).numpy() for x in mixed_in]
    if scales is not None:
        vals = [v * s for v, s in zip(vals, scales)]
    acc = p + vals[0] + vals[1]
    _assert_tail(got, want, acc, g, t, lr, mom, w, contracted=True)
    # the plain twins agree bitwise (neither contracts)
    ref = jax_arena_update.mix_commit_carrier_reference(
        jnp.asarray(p), tuple(c[1] for c in cands), jtup(keeps),
        tuple(l[1] for l in lasts), jnp.asarray(g), jnp.asarray(t),
        lr, mom, w, mix_scales=None if scales is None else jtup(scales),
        mix_stale=mix_stale,
    )
    plain = arena_update.mix_commit_carrier_reference(*args, **skw)
    _assert_bitwise(plain[0], ref[0], "reference p_new")
    _assert_bitwise(plain[1], ref[1], "reference trace")


def test_carrier_wrapper_validates_inputs():
    x = torch.zeros(64)
    q = torch.zeros(64, dtype=torch.int8)
    b = torch.zeros(64, dtype=torch.bfloat16)
    fmc = arena_update.fused_mix_commit_carrier
    with pytest.raises(ValueError, match="mix_scales"):
        fmc(x, (q,), (x,), (q,), x, x, 0.1, 0.9, 0.5)
    with pytest.raises(ValueError, match="mix_scales"):
        fmc(x, (b,), (x,), (b,), x, x, 0.1, 0.9, 0.5, mix_scales=(x,))
    with pytest.raises(TypeError):
        fmc(x, (x,), (x,), (x,), x, x, 0.1, 0.9, 0.5)
    with pytest.raises(TypeError):  # candidates and stale buffers differ
        fmc(x, (b,), (x,), (q,), x, x, 0.1, 0.9, 0.5, mix_scales=(x,))
    with pytest.raises(ValueError):
        fmc(x, (q,) * 5, (x,) * 5, (q,) * 5, x, x, 0.1, 0.9, 1 / 6,
            mix_scales=(x,) * 5)


def test_wrappers_validate_inputs():
    x = torch.zeros(64)
    with pytest.raises(TypeError):
        event_engine.masked_wire(x, torch.zeros(64, dtype=torch.bool))
    with pytest.raises(ValueError):
        event_engine.masked_wire(x, torch.zeros(65))
    with pytest.raises(ValueError):
        fused_update.fused_mix_sgd(
            torch.zeros(8, 8).t(), x.view(8, 8), x.view(8, 8), x.view(8, 8),
            0.1, 0.9, 1 / 3,
        )
    with pytest.raises(ValueError):
        arena_update.fused_mix_commit(
            x, (x,) * 5, (x,) * 5, (x,) * 5, x, x, 0.1, 0.9, 1 / 6
        )
    with pytest.raises(TypeError):  # the int8 wire's scales are f32
        event_engine.masked_wire(x, x, scale_exp=x.double())
    with pytest.raises(ValueError):
        event_engine.masked_wire(x, x, scale_exp=torch.ones(65))
