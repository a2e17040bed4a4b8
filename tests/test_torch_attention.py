"""The port's attention against the JAX package's, on the CPU.

The same numpy inputs (one seed per case) go through both packages. The
JAX side runs its Pallas kernels in interpret mode (`interpret=True`),
as the JAX package's own tests do on the CPU; the port runs the plain
versions its wrappers take for CPU tensors, through the same
`torch.autograd.Function`s (and their `vmap` rules) that launch the CUDA
kernels on the card.

Tolerances are those of `tests/test_flash_attention.py`, float32: the two
sides sum the same products in another order.
  * forward (out, lse): atol = rtol = 2e-5;
  * gradients: atol = 5e-5, rtol = 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventgrad_tpu.ops.attention import flash_attention as jax_flash
from eventgrad_tpu.ops.attention import flash_attention_lse as jax_flash_lse
from eventgrad_tpu.parallel.ring_attention import full_attention as jax_full
from eventgrad_tpu.parallel.ring_attention import ring_attention as jax_ring
from eventgrad_tpu.parallel.ring_attention import (
    ulysses_attention as jax_ulysses,
)
from eventgrad_tpu.parallel.spmd import spmd
from eventgrad_tpu.parallel.topology import Ring as JaxRing
from eventgrad_tpu_torch.ops import attention as fa
from eventgrad_tpu_torch.parallel.ring_attention import (
    full_attention, ring_attention, ulysses_attention,
)
from eventgrad_tpu_torch.parallel.topology import Ring, Topology

FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-5, rtol=5e-4)
#: (T, D): one tile, and ragged in both; then the DMAX = 128 kernels'
#: widths, whole and zero-padded (D = 80 runs on 48 zero columns); then
#: the wide form's (two 128-column chunks; D = 192 runs on 64 zero
#: columns of the second, as the reference pads it to 256)
SHAPES = [(48, 32), (160, 24), (48, 128), (160, 80), (48, 256), (160, 192)]


def _inputs(seed, *shape, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _leaves(arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


def _check_flash_attention(t, d, causal):
    q, k, v, w = _inputs(t + d, 2, t, 2, d, n=4)
    tq = _leaves([q, k, v])
    out = fa.flash_attention(*tq, causal=causal)
    _close(out, jax_flash(q, k, v, causal, interpret=True), FWD, "out")
    _close(out, jax_full(q, k, v, causal), FWD, "out vs full")
    _close(fa.flash_attention_reference(*tq, causal=causal),
           jax_full(q, k, v, causal), FWD, "reference")
    grads = torch.autograd.grad(out, tq, torch.from_numpy(w))
    jgrads = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash(q, k, v, causal, interpret=True) * w),
        argnums=(0, 1, 2),
    )(q, k, v)
    for name, g, jg in zip("qkv", grads, jgrads):
        _close(g, jg, GRAD, f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d", SHAPES)
def test_flash_attention_matches_jax(t, d, causal):
    _check_flash_attention(t, d, causal)


def test_flash_attention_at_head_dim_320_matches_jax():
    """Three 128-column chunks, the last on 64 zero columns: the
    reference pads D = 320 to 384 lanes."""
    _check_flash_attention(80, 320, True)


#: (q_offset, k_offset) at T = 48: every key in the past, the diagonal
#: block, a partly visible block, every key in the future
OFFSETS = {"visible": (48, 0), "diagonal": (96, 96), "partial": (48, 24),
           "masked": (0, 48)}


def _check_offsets_and_dlse(hop, d):
    qo, ko = OFFSETS[hop]
    t = 48
    q, k, v, w = _inputs(7, 2, t, 2, d, n=4)
    w_lse = _inputs(8, 2, t, 2, n=1)[0]
    tq = _leaves([q, k, v])
    out, lse = fa.flash_attention_lse(*tq, causal=True, q_offset=qo,
                                      k_offset=ko)
    jfn = lambda q, k, v: jax_flash_lse(q, k, v, causal=True, q_offset=qo,
                                        k_offset=ko, interpret=True)
    jout, jlse = jfn(q, k, v)
    _close(out, jout, FWD, "out")
    _close(lse, jlse, FWD, "lse")
    out_d, lse_d = out.detach(), lse.detach()
    assert torch.isfinite(out_d).all() and torch.isfinite(lse_d).all()
    if hop == "masked":  # no visible key: zero output, lse near -1e30
        assert float(out_d.abs().max()) == 0.0 and float(lse_d.max()) < -1e29
    # both cotangents: the one of lse folds into the delta term
    grads = torch.autograd.grad(
        (out, lse), tq, (torch.from_numpy(w), torch.from_numpy(w_lse)))

    def jloss(q, k, v):
        o, l = jfn(q, k, v)
        return jnp.sum(o * w) + jnp.sum(l * w_lse)

    for name, g, jg in zip("qkv", grads,
                           jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)):
        assert torch.isfinite(g).all()
        _close(g, jg, GRAD, f"d{name}")


@pytest.mark.parametrize("hop", sorted(OFFSETS))
def test_flash_attention_lse_offsets_and_dlse_match_jax(hop):
    _check_offsets_and_dlse(hop, 32)


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("hop", sorted(OFFSETS))
def test_flash_attention_lse_offsets_at_wide_heads_match_jax(hop, d):
    """The offset variant at the head widths of the DMAX = 128 kernels
    and of the wide form."""
    _check_offsets_and_dlse(hop, d)


@pytest.mark.parametrize("t,d", SHAPES)
def test_plain_backward_equals_autograd_of_plain_forward(t, d):
    """The FA2 backward written out (`attention_bwd_reference`, what the
    Functions' backward runs on the CPU) against autograd through the
    plain forward."""
    q, k, v, w = _inputs(3, 2, t, 2, d, n=4)
    w_lse = _inputs(4, 2, t, 2, n=1)[0]
    tq = _leaves([q, k, v])
    out, lse = fa.attention_lse_reference(*tq, causal=True, q_offset=5,
                                          k_offset=2)
    do, dlse = torch.from_numpy(w), torch.from_numpy(w_lse)
    want = torch.autograd.grad((out, lse), tq, (do, dlse))
    got = fa.attention_bwd_reference(*tq, out, lse, do, dlse, causal=True,
                                     q_offset=5, k_offset=2)
    for name, g, wg in zip("qkv", got, want):
        _close(g, wg.numpy(), GRAD, f"d{name}")


def test_offsets_per_group_of_batch_rows():
    """A length-N offset tensor gives one (q_offset, k_offset) pair per
    group of B / N consecutive batch rows."""
    t, d = 40, 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, 6, t, 2, d))
    qo = torch.tensor([0, 40, 80])
    ko = torch.tensor([40, 40, 0])
    out, lse = fa.flash_attention_lse(q, k, v, True, qo, ko)
    for g in range(3):
        rows = slice(2 * g, 2 * g + 2)
        o1, l1 = fa.flash_attention_lse(q[rows], k[rows], v[rows], True,
                                        int(qo[g]), int(ko[g]))
        _close(out[rows], o1.numpy(), dict(atol=0, rtol=0))
        _close(lse[rows], l1.numpy(), dict(atol=0, rtol=0))
    with pytest.raises(ValueError, match="do not divide"):
        fa.flash_attention_lse(q, k, v, True, torch.arange(4), 0)


def test_wrapper_refuses_mismatched_inputs():
    q, k, v = (torch.from_numpy(a) for a in _inputs(6, 1, 8, 2, 16))
    with pytest.raises(ValueError, match="share one"):
        fa.flash_attention(q, k[:, :4], v)
    with pytest.raises(TypeError, match="dtypes differ"):
        fa.flash_attention(q, k.double(), v)


def test_vmap_of_grad_folds_ranks_into_the_batch():
    """`vmap(grad(loss))` over stacked ranks — the train step's lift —
    equals the per-rank gradients, forward and backward each running once
    on the folded `[R * B, T, H, D]` batch."""
    r, t, h, d = 3, 48, 2, 16
    qs, ks, vs = (torch.from_numpy(a) for a in _inputs(9, r, 2, t, h, d))
    calls = []
    plain_fwd = fa.lse_reference

    def counting(q, *a):
        calls.append(tuple(q.shape))
        return plain_fwd(q, *a)

    def loss(q, k, v):
        qkv = torch.cat([q, k, v], dim=2)  # strided views, as in the model
        return (fa.flash_attention(*qkv.split(h, dim=2), causal=True) ** 2
                ).sum()

    fa.lse_reference = counting
    try:
        got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
            qs, ks, vs)
    finally:
        fa.lse_reference = plain_fwd
    assert calls == [(r * 2, t, h, d)]
    for i in range(r):
        leaves = [x[i].clone().requires_grad_() for x in (qs, ks, vs)]
        want = torch.autograd.grad(
            (full_attention(*leaves, causal=True) ** 2).sum(), leaves)
        for g, wg in zip(got, want):
            _close(g[i], wg.numpy(), GRAD)


N_SP = 4


def _sp_case(seed):
    b, t, h, d = 2, 32, 8, 16  # global sequence T, T // N per rank
    full = _inputs(seed, b, t, h, d, n=4)
    shard = lambda x: np.stack(np.split(x, N_SP, axis=1))
    return full, [shard(x) for x in full]


def _jax_sp(fn, causal, use_flash):
    topo = JaxRing(N_SP)
    return spmd(lambda q, k, v: fn(q, k, v, topo, causal=causal,
                                   use_flash=use_flash), topo)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_stacked_sequence_parallel_attention_matches_jax(kind, use_flash,
                                                         causal):
    (q, k, v, _), (qs, ks, vs, ws) = _sp_case(11)
    fn, jfn = {"ring": (ring_attention, jax_ring),
               "ulysses": (ulysses_attention, jax_ulysses)}[kind]
    leaves = _leaves([qs, ks, vs])
    out = fn(*leaves, Ring(N_SP), causal=causal, use_flash=use_flash)
    jlift = _jax_sp(jfn, causal, use_flash)
    _close(out, jlift(qs, ks, vs), FWD, "out")
    whole = np.concatenate(list(out.detach().numpy()), axis=1)
    _close(whole, jax_full(q, k, v, causal), FWD, "out vs full attention")
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(ws))
    jgrads = jax.grad(lambda q, k, v: jnp.sum(jlift(q, k, v) * ws),
                      argnums=(0, 1, 2))(qs, ks, vs)
    for name, g, jg in zip("qkv", grads, jgrads):
        _close(g, jg, GRAD, f"d{name}")


def test_sequence_parallel_guards():
    qs = torch.zeros((4, 1, 8, 6, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ulysses_attention(qs, qs, qs, Ring(4))
    with pytest.raises(ValueError, match="rank-stacked shards"):
        ring_attention(qs[:2], qs[:2], qs[:2], Ring(4))
    # a multi-axis topology runs along its named axis (the hybrid tests
    # hold it against the JAX functions); an axis it lacks is refused
    with pytest.raises(ValueError, match="is not an axis"):
        ring_attention(qs, qs, qs, Topology(axes=("dp", "sp"), shape=(2, 2)),
                       axis="tp")


# --------------------------------------------------------------------------
# the float32 products of the forward and dK/dV kernels: 3xTF32


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """`cvt.rna.tf32.f32`: round the low 13 bits of a float32
    significand away, to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _mm_3xtf32(a, b):
    """`a @ b` as the kernels' float32 path sums it: each operand split
    into big = tf32(x) and small = tf32(x - big), and small*big +
    big*small + big*big summed in float32."""
    ab, bb = _tf32(a), _tf32(b)
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _split_forward(q, k, v, mm):
    """The forward kernel's arithmetic on `[B, T, H, D]`, causal: the
    scale on the float32 scores, p from the row max."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    t = q.shape[1]
    s = mm(qh, kh.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_sum = p.sum(-1, keepdim=True)
    out = mm(p, vh) / l_sum
    return out.transpose(1, 2), (m + torch.log(l_sum))[..., 0].transpose(1, 2)


def _split_bwd_terms(q, k, v, do, lse, delta, mm):
    """`(qh, kh, doh, p, ds)` of the backward kernels' arithmetic, causal,
    on `[B, H, T, *]` views; lse, delta `[B, H, T]`."""
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    t = q.shape[1]
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = mm(qh, kh.transpose(-1, -2)) * scale
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -torch.inf)
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta[..., None]) * scale
    return qh, kh, doh, p, ds


def _split_dq(q, k, v, do, lse, delta, mm):
    """The dQ kernel's arithmetic: `(dq,)`."""
    _, kh, _, _, ds = _split_bwd_terms(q, k, v, do, lse, delta, mm)
    return (mm(ds, kh).transpose(1, 2),)


def _split_dkv(q, k, v, do, lse, delta, mm):
    """The dK/dV kernel's arithmetic: `(dk, dv)`."""
    qh, _, doh, p, ds = _split_bwd_terms(q, k, v, do, lse, delta, mm)
    dk = mm(ds.transpose(-1, -2), qh)
    dv = mm(p.transpose(-1, -2), doh)
    return dk.transpose(1, 2), dv.transpose(1, 2)


def _holds(got, want, tol) -> bool:
    return all(np.allclose(g.numpy(), w.numpy(), **tol)
               for g, w in zip(got, want))


@pytest.mark.parametrize("split,holds", [("3xtf32", True), ("1xtf32", False)])
@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
def test_tf32_split_against_float32_tolerances(kernel, split, holds):
    """At B2 x T256 x H2 x D64, causal, the float32 products summed as
    3xTF32 stay within the float32 tolerances of the plain versions
    (forward 2e-5; gradients atol 5e-5, rtol 5e-4), and one TF32 product
    (about three decimal digits) does not: the reason the kernels split
    every float32 operand in two."""
    mm = {"3xtf32": _mm_3xtf32, "1xtf32": _mm_1xtf32}[split]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(12, 2, 256, 2, 64,
                                                        n=4))
    out, lse = fa.lse_reference(q, k, v, None, True, 1)
    if kernel == "forward":
        assert _holds(_split_forward(q, k, v, mm), (out, lse), FWD) is holds
        return
    lse_bht = lse.transpose(1, 2).contiguous()
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse_bht, delta)
    if kernel == "dq":
        want = (fa.dq_reference(*args, None, True, 1),)
        got = _split_dq(*args, mm)
    else:
        want = fa.dkv_reference(*args, None, True, 1)
        got = _split_dkv(*args, mm)
    assert _holds(got, want, GRAD) is holds


def _key_halves(t):
    """The keys each warp of a pair sweeps in the float32 forward and dQ
    kernels at DMAX = 128: the first and the second 32 of every 64-key
    tile, as `[T]` masks."""
    first = (torch.arange(t) % 64) < 32
    return first, ~first


def _pair_forward(q, k, v, mm):
    """The float32 forward at DMAX = 128: each warp of a pair runs its
    own softmax over its key halves (row max floored at -1e30, as the
    kernel starts it), then the pair merges (m, l, acc) as two ring
    hops merge."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    t = q.shape[1]
    s = mm(qh, kh.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -torch.inf)
    parts = []
    for half in _key_halves(t):
        sh = s.masked_fill(~half, -torch.inf)
        m = sh.amax(-1, keepdim=True).clamp_min(-1e30)
        p = torch.exp(sh - m)
        parts.append((m, p.sum(-1, keepdim=True), mm(p, vh)))
    (ma, la, acc_a), (mb, lb, acc_b) = parts
    m = torch.maximum(ma, mb)
    ca, cb = torch.exp(ma - m), torch.exp(mb - m)
    l_sum = la * ca + lb * cb
    out = (acc_a * ca + acc_b * cb) / l_sum
    return out.transpose(1, 2), (m + torch.log(l_sum))[..., 0].transpose(1, 2)


def _pair_dq(q, k, v, do, lse, delta, mm):
    """The float32 dQ kernel at DMAX = 128: each warp of a pair sums ds k
    over its key halves; the two partials add at the end."""
    _, kh, _, _, ds = _split_bwd_terms(q, k, v, do, lse, delta, mm)
    a, b = (mm(ds * half, kh) for half in _key_halves(q.shape[1]))
    return ((a + b).transpose(1, 2),)


def _whole_forward(q, k, v, mm):
    """The float32 forward of the whole form (D = 256): each score built
    once over all columns, one row max for the two warps of a row block
    (their 32-key halves' maxima meet in shared memory), each half's row
    sum kept apart and added at the end, p v once."""
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    t = q.shape[1]
    s = mm(qh, kh.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    la, lb = ((p * half).sum(-1, keepdim=True) for half in _key_halves(t))
    out = mm(p, vh) / (la + lb)
    return (out.transpose(1, 2),
            (m + torch.log(la + lb))[..., 0].transpose(1, 2))


def _whole_dq(q, k, v, do, lse, delta, mm):
    """The float32 dQ of the whole form (D = 256): s and dp each built
    once over all columns; dQ += ds k summed by one warp over the keys,
    one 32-key tile after another (the two column halves by two warps,
    each the same sum over the same keys)."""
    _, kh, _, _, ds = _split_bwd_terms(q, k, v, do, lse, delta, mm)
    dq = torch.zeros(ds.shape[:-1] + kh.shape[-1:], dtype=ds.dtype)
    for j in range(0, q.shape[1], 32):
        dq = dq + mm(ds[..., j:j + 32], kh[..., j:j + 32, :])
    return (dq.transpose(1, 2),)


def _check_pair_split(kernel, split, holds, d, seed, forward=_pair_forward,
                      dq=_pair_dq):
    mm = {"3xtf32": _mm_3xtf32, "1xtf32": _mm_1xtf32}[split]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(seed, 2, 256, 2, d,
                                                        n=4))
    out, lse = fa.lse_reference(q, k, v, None, True, 1)
    if kernel == "forward":
        assert _holds(forward(q, k, v, mm), (out, lse), FWD) is holds
        return
    args = (q, k, v, do, lse.transpose(1, 2).contiguous(),
            (do * out).sum(-1).transpose(1, 2).contiguous())
    if kernel == "dq":
        want = (fa.dq_reference(*args, None, True, 1),)
        got = dq(*args, mm)
    else:
        want = fa.dkv_reference(*args, None, True, 1)
        got = _split_dkv(*args, mm)
    assert _holds(got, want, GRAD) is holds


@pytest.mark.parametrize("split,holds", [("3xtf32", True), ("1xtf32", False)])
@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
def test_tf32_split_at_head_dim_128(kernel, split, holds):
    """As above at D = 128 (B2 x T256 x H2), the main path's head width:
    twice the terms in each score's sum, in the order of the DMAX = 128
    kernels. The float32 forward and dQ split each K tile's keys between
    two warps and merge the halves (`_pair_forward`, `_pair_dq`). dK/dV
    splits D between two warps instead, but each dK/dV element is still
    summed by one warp, over the same queries in the same order, so its
    emulation is the unsplit one."""
    _check_pair_split(kernel, split, holds, 128, 14)


@pytest.mark.parametrize("split,holds", [("3xtf32", True), ("1xtf32", False)])
@pytest.mark.parametrize("kernel", ["forward", "dq", "dkv"])
def test_tf32_split_at_head_dim_256(kernel, split, holds):
    """As above at D = 256 (B2 x T256 x H2), the transformer-d256 legs'
    head width. All three run the whole form (`csrc/flash_*_whole.cu`):
    each score sums its 256 terms in order in one product, the forward's
    two warps of a row block share one row max and add their halves' row
    sums (`_whole_forward`), each dK/dV element is summed by one warp over
    the queries in order (the unsplit emulation), and each dQ element by
    one warp over the keys, 32-key tile by tile (`_whole_dq`)."""
    _check_pair_split(kernel, split, holds, 256, 16, forward=_whole_forward,
                      dq=_whole_dq)


def test_pair_emulation_is_the_plain_arithmetic_in_float64():
    """The pair merge itself is exact arithmetic: in float64 with exact
    products, `_pair_forward` and `_pair_dq` equal the plain versions to
    rounding, the first row (whose second half sees no key) included
    (the plain lse is float32 whatever the inputs)."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(15, 1, 160, 2, 128, n=4))
    exact = lambda a, b: a @ b
    out, lse = fa.lse_reference(q, k, v, None, True, 1)
    tight = dict(atol=1e-12, rtol=1e-10)
    got_out, got_lse = _pair_forward(q, k, v, exact)
    assert _holds((got_out,), (out,), tight)
    assert _holds((got_lse.float(),), (lse,), dict(atol=0, rtol=2e-7))
    args = (q, k, v, do, lse.transpose(1, 2).contiguous(),
            (do * out).sum(-1).transpose(1, 2).contiguous())
    assert _holds(_pair_dq(*args, exact),
                  (fa.dq_reference(*args, None, True, 1),), tight)


def test_whole_emulation_is_the_plain_arithmetic_in_float64():
    """`_whole_forward`'s shared row max and split row sums are exact
    arithmetic: in float64 with exact products it equals the plain
    forward to rounding at D = 256, the first row (whose second half sees
    no key) included."""
    q, k, v = (torch.from_numpy(a).double()
               for a in _inputs(17, 1, 160, 2, 256, n=3))
    out, lse = fa.lse_reference(q, k, v, None, True, 1)
    got_out, got_lse = _whole_forward(q, k, v, lambda a, b: a @ b)
    assert _holds((got_out,), (out,), dict(atol=1e-12, rtol=1e-10))
    assert _holds((got_lse.float(),), (lse,), dict(atol=0, rtol=2e-7))


def test_whole_dq_emulation_is_the_plain_arithmetic_in_float64():
    """`_whole_dq`'s 32-key tiles summed in order are exact arithmetic:
    in float64 with exact products it equals the plain dQ to rounding at
    D = 256 on a ragged causal T (the last tile half full)."""
    q, k, v, do = (torch.from_numpy(a).double()
                   for a in _inputs(18, 1, 144, 2, 256, n=4))
    exact = lambda a, b: a @ b
    out, lse = fa.lse_reference(q, k, v, None, True, 1)
    args = (q, k, v, do, lse.transpose(1, 2).contiguous(),
            (do * out).sum(-1).transpose(1, 2).contiguous())
    assert _holds(_whole_dq(*args, exact),
                  (fa.dq_reference(*args, None, True, 1),),
                  dict(atol=1e-12, rtol=1e-10))


def test_tf32_rounding_and_split():
    """`_tf32` keeps 10 explicit significand bits, rounds ties away from
    zero, and big + small carries a float32 to about 2^-22 of itself."""
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12,
                      3.0, -0.1])
    t = _tf32(x)
    assert t[0] == 1.0 + 2.0**-10 and t[1] == -(1.0 + 2.0**-10)
    assert t[2] == 1.0 and t[3] == 3.0
    assert (t.view(torch.int32) & 0x1FFF).eq(0).all()
    y = torch.from_numpy(_inputs(13, 4096, n=1)[0])
    big = _tf32(y)
    rel = ((big + _tf32(y - big)) - y).abs() / y.abs()
    assert float(rel.max()) <= 2.0**-22
