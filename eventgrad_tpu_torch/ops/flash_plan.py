"""Which form of the flash kernels a launch takes, and the shared memory
each instantiation asks for: the Python mirror of the C dispatcher
(`csrc/flash_base.cuh`, `flash_form`) and of the kernels' layouts.

Three forms serve each of the three kernels (forward, dQ, dK/dV):

  "wgmma"  bfloat16 at D = 64, 128 or 256 with every q/k/v (and dO)
           pointer 16-byte aligned and every (batch, time, head) stride a
           positive multiple of 16 bytes, as TMA needs
           (`csrc/flash_{fwd,dq,dkv}_wgmma.cu`);
  "whole"  float32 at D = 256 (`csrc/flash_{fwd,dq,dkv}_whole.cu`);
  "mma"    everything else: the mma.sync kernels (`csrc/flash_fwd.cu`,
           `csrc/flash_dq.cu`, `csrc/flash_dkv.cu`, their DMAX = 32, 64,
           128 instantiations and the wide form).

The choice is made by shape before the launch, never by a retry after a
failed one. `chip_smoke.py` holds this module against the C dispatcher on
the card (`eg_flash_form`) on the main shapes and on every small case's
forward, dQ and dK/dV.
"""

from __future__ import annotations

from typing import Sequence

FORMS = ("mma", "wgmma", "whole")
#: the most dynamic shared memory a block may opt into on the H100
SMEM_MAX = 232_448
#: the head widths of the wgmma form
WGMMA_D = (64, 128, 256)


def tma_ok(ptrs: Sequence[int], strides: Sequence[int]) -> bool:
    """True when TMA can read every tensor: each pointer 16-byte aligned,
    each (batch, time, head) element stride of a bfloat16 tensor (three a
    tensor in `strides`, in the order of `ptrs`) a positive multiple of
    16 bytes."""
    return (all(p % 16 == 0 for p in ptrs)
            and all(s > 0 and (2 * s) % 16 == 0 for s in strides))


def flash_form(dtype: str, d: int, ptrs: Sequence[int],
               strides: Sequence[int]) -> str:
    """The form of a forward (q, k, v), dQ or dK/dV (q, k, v, dO) launch:
    `dtype` "float32" or "bfloat16", head width `d`, the tensors' data
    pointers and their (batch, time, head) element strides."""
    if dtype == "bfloat16" and d in WGMMA_D and tma_ok(ptrs, strides):
        return "wgmma"
    if dtype == "float32" and d == 256:
        return "whole"
    return "mma"


def tensor_form(q, k, v, do=None) -> str:
    """`flash_form` of the tensors themselves (head dimension
    contiguous)."""
    ts = [x for x in (q, k, v, do) if x is not None]
    dtype = str(q.dtype).replace("torch.", "")
    return flash_form(dtype, q.shape[-1], [x.data_ptr() for x in ts],
                      [s for x in ts for s in x.stride()[:3]])


def _wgmma_stages(d: int) -> int:
    return 2 if d == 256 else 3 if d == 128 else 4


def smem_bytes(kernel: str, form: str, elem: int, d: int,
               wide: bool = False) -> int:
    """Dynamic shared memory of one instantiation, as its launch sizes it.

    "wgmma" (bf16, D = d): 1,024 bytes of alignment slack and 8 a
    barrier beside the tiles. Forward: q [128, d], then per stage k and v
    [64, d]; barriers q, and k full, v full, empty per stage. dQ: q, dO
    [128, d] (d = 64, 128) or [64, d] and the p exchange 32 x 128
    float32 (d = 256), per stage k and v [64, d]; barriers q and dO, and
    full, empty per stage. dK/dV: k, v [64, d], per stage q and dO
    [64, d], the p exchange; barriers k and v, and full, empty per stage
    (at d = 256 dQ's sizes, with the roles of the tiles swapped).

    "whole" (float32, D = 256, [rows][D + 4] tiles): forward q, k, v
    [64] and p [64][68], the row exchange [2][64]; dQ q, dO [64], k, v
    [32] and the p / ds tile [64][36]; dK/dV k, v [32], q, dO [64], p^T,
    ds^T [32][68], lse and delta [64].

    "mma" (`elem` bytes, DMAX = d, `wide` for the chunked form; tiles
    [64][DMAX + 16 bytes]): DMAX <= 128: forward q + two stages of k and
    v; dQ q, dO + two stages of k and v; dK/dV k, v + two stages of q
    and dO, and of lse and delta. Wide (128-column chunks): forward two
    stages of (q, k, v); dQ stages of (q, dO, k, v) and the k tile of the
    block's dQ columns; dK/dV stages of (k, v, q, dO), the q and dO tiles
    of its columns, lse and delta; two stages where they fit in
    SMEM_MAX, else one."""
    if form == "wgmma":
        tile = 64 * d * 2
        stages = _wgmma_stages(d)
        if kernel == "flash_fwd":
            return 1024 + 2 * tile + 2 * stages * tile + 8 * (1 + 3 * stages)
        if kernel == "flash_dq" and d != 256:
            return 1024 + 4 * tile + 2 * stages * tile + 8 * (1 + 2 * stages)
        return (1024 + 2 * tile + 2 * stages * tile + 32 * 128 * 4
                + 8 * (1 + 2 * stages))
    if form == "whole":
        ld = (d + 4) * 4
        p = 64 + 4
        if kernel == "flash_fwd":
            return 3 * 64 * ld + 64 * p * 4 + 2 * 64 * 4
        if kernel == "flash_dq":
            return 2 * 64 * ld + 2 * 32 * ld + 64 * (32 + 4) * 4
        return 2 * 32 * ld + 2 * 64 * ld + 2 * 32 * p * 4 + 2 * 64 * 4
    tile = 64 * (d + 16 // elem) * elem

    def slots(stage, extra):
        return 2 if 2 * stage + extra <= SMEM_MAX else 1

    if kernel == "flash_fwd":
        return (6 if wide else 5) * tile
    if kernel == "flash_dq":
        if not wide:
            return 6 * tile
        return (4 * slots(4 * tile, tile) + 1) * tile
    if not wide:
        return 6 * tile + 4 * 64 * 4
    return (4 * slots(4 * tile, 2 * tile + 2 * 64 * 4) + 2) * tile + 2 * 64 * 4


def instantiations():
    """(kernel, form, elem bytes, D, wide) of every instantiation the
    forms compile: the new forms' and the mma.sync form's 24."""
    out = [(k, "wgmma", 2, d, False)
           for k in ("flash_fwd", "flash_dq", "flash_dkv") for d in WGMMA_D]
    out += [(k, "whole", 4, 256, False)
            for k in ("flash_fwd", "flash_dq", "flash_dkv")]
    out += [(k, "mma", e, dmax, wide)
            for k in ("flash_fwd", "flash_dq", "flash_dkv") for e in (4, 2)
            for dmax, wide in ((32, False), (64, False), (128, False),
                               (128, True))]
    return out
