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
leaves under 2^16 elements — is bitwise. The CUDA kernels are held
bitwise against the same plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
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
    with pytest.raises(NotImplementedError):
        event_engine.masked_wire(x, x, scale_exp=x)
