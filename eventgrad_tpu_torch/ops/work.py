"""The kernels' work: FLOPs and bytes of each kernel call, in closed form.

One definition serves two readers: `chip_smoke.py` divides it by the
card's peaks (`obs/devicespec.py`) for each kernel's bound, and the cost
model (`obs/costmodel.py`) charges it for the kernel ops of a traced
step, whose bodies it cannot see.

The gossip tails (kernels 1-5 and the auditor's kernel 9) are
elementwise: `tail(kernel, n, n_nb, carrier)` is (operations per
element x n, bytes per element x n) over the n elements of the work
(the `[R, n]` arena, or one bucket's `[R, c]` columns for a pitched
form). Bytes count each input read once and each output written once;
the arena operands are float32, the receive buffers of kernel 5 the
carrier's dtype. `tail` leaves out the gated forms' per-row operands
(`[R]`, `[R, n_nb]`); `gated_tail` adds them and the gated element's
extra operations (a gate select per neighbour; on kernel 1 also the
poison factor on the update and the trace and the two quarantine
selects), for the gated forms on a whole arena or on one bucket's
columns (the bucketed schedule under the fault clauses).

The flash kernels (6-8): `flash(kernel, shape, elem_bytes, causal)` —
their matrix products, 2·T·T·D FLOPs each per (batch row, head), halved
by the causal mask (the masked tiles are skipped), and their `[B, T, H,
D]` tensors plus float32 `[B, H, T]` rows moved once.
"""

from __future__ import annotations

from typing import Optional, Tuple

#: (operations per element, bytes per element) of each elementwise
#: kernel, as functions of the neighbour count and the carrier
_TAILS = {
    # out = fire > 0 ? flat : 0 — reads flat, fire; writes out (f32):
    # a compare and a select
    "masked_wire": lambda nb, car: (2, 4 * 3),
    # the masked select, then clip(rint(x / scale), +-127): reads flat,
    # fire, scale; writes out (f32): a compare, a select, a division, a
    # rounding and two clip compares
    "masked_wire_int8": lambda nb, car: (6, 4 * 4),
    # reads p, g, t and per neighbour cand, keep, last; writes p', t'
    # and the committed buffers: per element per neighbour a compare, a
    # select and an add, then 5 operations of mix and SGD
    "fused_mix_commit": lambda nb, car: (3 * nb + 5,
                                         4 * (3 + 3 * nb + 2 + nb)),
    # kernel 1 on carriers: int8 cand, last and the committed buffers
    # with an f32 keep and scale per neighbour (a conversion and a
    # dequant multiply more); bf16 without scales (a conversion more)
    "fused_mix_commit_carrier": lambda nb, car: (
        (5 * nb + 5, 4 * 3 + nb * (1 + 4 + 1 + 4) + 4 * 2 + nb)
        if car == "int8" else
        (4 * nb + 5, 4 * 3 + nb * (2 + 4 + 2) + 4 * 2 + 2 * nb)),
    # p' = (p + buf_sum) w - lr (m t + g): reads p, buf_sum, g, t; writes
    # p', t'
    "fused_mix_sgd": lambda nb, car: (6, 4 * 6),
    # kernel 9, x * 2: reads x, writes the product
    "leak_kernel": lambda nb, car: (1, 4 * 2),
}

#: flash kernel -> (matrix products, [B, T, H, D] tensors, f32 [B, H, T]
#: rows): the forward reads q, k, v and writes out, lse; dQ reads q, k,
#: v, dO, lse, delta and writes dQ; dK/dV the same reads, writes dK, dV
_FLASH = {
    "flash_fwd": (2, 4, 1),
    "flash_dq": (3, 5, 2),
    "flash_dkv": (4, 6, 2),
}

#: (extra operations per element, per-row operand bytes per row) of the
#: gated forms: kernel 1 reads w_rows (f32), gate (one byte an edge),
#: poison (f32) and quar (one byte); kernel 5 w_rows and gate; kernel 4
#: w_rows
_GATED = {
    "fused_mix_commit": lambda nb: (nb + 4, 4 + nb + 4 + 1),
    "fused_mix_commit_carrier": lambda nb: (nb, 4 + nb),
    "fused_mix_sgd": lambda nb: (0, 4),
}

TAILS = tuple(_TAILS)
FLASH = tuple(_FLASH)


def tail(kernel: str, n: int, n_nb: int = 2,
         carrier: Optional[str] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one elementwise kernel call over `n` elements
    with `n_nb` neighbours; `carrier` ("int8" | "bf16") is kernel 5's
    buffer dtype."""
    ops, nbytes = _TAILS[kernel](int(n_nb), carrier)
    return float(ops) * n, float(nbytes) * n


def gated_tail(kernel: str, n: int, rows: int, n_nb: int = 2,
               carrier: Optional[str] = None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one gated kernel call over `n` elements in
    `rows` rows: `tail`'s work plus the gated element's operations and
    the per-row operands, read once a call."""
    flops, nbytes = tail(kernel, n, n_nb, carrier)
    ops, row_bytes = _GATED[kernel](int(n_nb))
    return flops + float(ops) * n, nbytes + float(row_bytes) * rows


def flash(kernel: str, shape, elem_bytes: int,
          causal: bool = True) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash kernel call on `[B, T, H, D]` inputs of
    `elem_bytes` bytes an element; `causal` halves the products (the
    masked tiles are skipped)."""
    products, n_tensors, n_rows = _FLASH[kernel]
    b, t, h, d = (int(s) for s in shape)
    flops = products * 2.0 * b * h * t * t * d
    if causal:
        flops /= 2.0
    nbytes = float(n_tensors * b * t * h * d * elem_bytes + n_rows * b * h * t * 4)
    return flops, nbytes
