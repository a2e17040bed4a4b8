"""FlashAttention-2 style fused attention (forward + backward).

Port of `eventgrad_tpu/ops/attention.py`: `flash_attention`,
`flash_attention_lse` and `flash_attention_reference`. Three CUDA
kernels replace the three TPU kernels:

  `csrc/flash_fwd.cu`  <- `_fwd_kernel`: online softmax over K/V tiles,
                          writes the output and the row logsumexp;
  `csrc/flash_dq.cu`   <- `_dq_kernel`:  dQ, sweeping K/V tiles;
  `csrc/flash_dkv.cu`  <- `_dkv_kernel`: dK and dV, sweeping Q tiles.

The score matrix never reaches device memory: each kernel rebuilds it
one 64 x 64 tile at a time from (q, k, lse), on the tensor cores
(`csrc/flash_mma.cuh`: bf16 operands for bfloat16, which round p and ds
to bf16 before their second product; 3xTF32 for float32). Beside the
wrappers `flash_fwd`, `flash_dq` and `flash_dkv` stand their plain PyTorch
versions on materialized scores, `lse_reference`, `dq_reference` and
`dkv_reference` (by their public arguments: `attention_lse_reference`,
the forward with the logsumexp and the offset-aware causal mask, and
`attention_bwd_reference`, the FA2 backward written out);
`flash_attention_reference` is `full_attention`, the plain softmax
attention whose autograd the backward is held against.

Each launch takes one of three forms, chosen by shape before it
(`ops/flash_plan.py`, the mirror of the C dispatcher): bfloat16 at D =
64, 128 and 256 on rows TMA can read runs the three kernels on Hopper's
wgmma fed by TMA through an mbarrier ring
(`csrc/flash_{fwd,dq,dkv}_wgmma.cu`); float32 at D = 256 runs them with
every score tile built once on mma.sync
(`csrc/flash_{fwd,dq,dkv}_whole.cu`); everything else runs the mma.sync
kernels above. Each wrapper counts its launches (`.launches`) and, by
form, `.forms`.

Layout follows the models: q, k, v are `[B, T, H, D]` and share one
sequence length. The kernels read them through their strides (batch,
time, head; the head dimension contiguous), so the strided views a fused
QKV projection splits into need no copy; outputs are contiguous. Any
`T >= 1` and any `D >= 1` run: ragged tiles are masked (keys past `T`
are invalid, query rows past `T` write nothing), and a `D` short of the
instantiation's 32, 64 or 128 columns runs on zero-filled columns, as
the reference pads `D` to a multiple of its 128 lanes. Above 128 the
kernels' wide form streams the head dimension through the score
products in chunks of 128 columns, each block owning one 128-column
chunk of the output (`csrc/flash_mma.cuh`).

Masking is finite: invalid scores are `-1e30` and `p` is multiplied by
the validity, so a fully masked row gives a zero output and a finite
`lse` near `-1e30` rather than NaN (the ring's fully masked hops rely on
it).

The causal offsets of `flash_attention_lse` shift the mask to global
positions. They may differ along the batch: a length-`N` int tensor
gives one offset per group of `B / N` consecutive batch rows (the stacked
ranks of `parallel/ring_attention.py`, folded into the batch).

Both public functions go through one `torch.autograd.Function` whose
backward is a second Function launching the dQ and dK/dV kernels. Both
Functions carry a `vmap` rule that folds the mapped dimension into the
batch, so the train step's `vmap(grad(loss))` over the ranks runs
forward and backward as one launch per kernel. On CPU tensors the
Functions run the plain versions; on CUDA tensors they launch the
kernels or raise. The three launches are dispatcher operators
(`eg::flash_fwd`, `eg::flash_dq`, `eg::flash_dkv`), each with its plain
version as the CPU implementation, so a traced step shows one node per
kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from eventgrad_tpu_torch.ops import build, flash_plan
from eventgrad_tpu_torch.parallel.ring_attention import full_attention

_NEG_INF = -1e30  # finite mask value; exact zeros guaranteed by masking p
_L_FLOOR = 1e-30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

flash_attention_reference = full_attention


# --------------------------------------------------------------------------
# plain versions


def _row_offsets(offs: Optional[torch.Tensor], per: int, b: int):
    """Per-batch-row (q_offset, k_offset) from the `[N, 2]` table: row i
    reads entry `(i // per) % N`."""
    idx = (torch.arange(b, device=offs.device) // per) % offs.shape[0]
    rows = offs[idx]
    return rows[:, 0], rows[:, 1]


def _valid_mask(t: int, causal: bool, offs, per: int, b: int, device):
    """Boolean `[B or 1, 1, T, T]` validity of the scores (None = all
    valid): causal in global positions, `q_off + i >= k_off + j`."""
    if not causal:
        return None
    pos = torch.arange(t, device=device)
    if offs is None:
        return (pos[:, None] >= pos[None, :])[None, None]
    q_off, k_off = _row_offsets(offs, per, b)
    qpos = q_off[:, None] + pos[None, :]
    kpos = k_off[:, None] + pos[None, :]
    return (qpos[:, :, None] >= kpos[:, None, :])[:, None]


def _scores(q, k, scale_q: bool):
    """f32 (at least) scaled scores `[B, H, T, T]`. The forward scales q
    before the product, the backward kernels scale the product."""
    ct = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf = q.to(ct), k.to(ct)
    if scale_q:
        return torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    return torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale


def lse_reference(q, k, v, offs, causal: bool, per: int):
    """Plain version of `flash_fwd` (same arguments)."""
    b, t = q.shape[0], q.shape[1]
    s = _scores(q, k, scale_q=True)
    valid = _valid_mask(t, causal, offs, per, b, q.device)
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if valid is not None:
        p = p * valid
    l_safe = torch.clamp(p.sum(dim=-1, keepdim=True), min=_L_FLOOR)
    out = torch.einsum("bhqk,bkhd->bqhd", p / l_safe, v.to(p.dtype))
    lse = (m + torch.log(l_safe))[..., 0]  # [B, H, T]
    return out.to(q.dtype), lse.to(torch.float32).transpose(1, 2)


def _bwd_terms(q, k, v, do, lse, delta, offs, causal: bool, per: int):
    """`(p, ds)` `[B, H, T, T]` of the FA2 backward, rebuilt from
    `(q, k, lse)`; `lse` and `delta` are `[B, H, T]`."""
    b, t = q.shape[0], q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, scale_q=False)
    ct = s.dtype
    valid = _valid_mask(t, causal, offs, per, b, q.device)
    if valid is not None:
        s = torch.where(valid, s, _NEG_INF)
    p = torch.exp(s - lse.to(ct)[..., None])
    if valid is not None:
        p = p * valid
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(ct), v.to(ct))
    return p, p * (dp - delta.to(ct)[..., None]) * scale


def dq_reference(q, k, v, do, lse, delta, offs, causal: bool, per: int):
    """Plain version of `flash_dq` (same arguments)."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, offs, causal, per)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype)).to(q.dtype)


def dkv_reference(q, k, v, do, lse, delta, offs, causal: bool, per: int):
    """Plain version of `flash_dkv` (same arguments)."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, offs, causal, per)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.to(p.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(out, do, dlse) -> torch.Tensor:
    """`rowsum(dO * O) - dlse` as f32 `[B, H, T]`: the lse cotangent
    folds into the delta term, `ds = p * (dp - (delta - dlse))`."""
    ct = torch.promote_types(out.dtype, torch.float32)
    delta = (do.to(ct) * out.to(ct)).sum(-1) - dlse.to(ct)
    return delta.transpose(1, 2).contiguous()


def attention_lse_reference(q, k, v, causal: bool = False, q_offset=0,
                            k_offset=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: `(out [B,T,H,D],
    lse [B,T,H])` on materialized scores, with the finite masking and the
    offset-aware causal mask of `flash_attention_lse`."""
    offs, per = _offsets_table(q_offset, k_offset, q.shape[0], q.device)
    return lse_reference(q, k, v, offs, bool(causal), per)


def attention_bwd_reference(q, k, v, out, lse, do, dlse=None,
                            causal: bool = False, q_offset=0, k_offset=0):
    """Plain PyTorch version of the dQ and dK/dV kernels: `(dq, dk, dv)`
    from the forward's `(out, lse [B,T,H])` and the cotangents `do` and
    `dlse`, on materialized scores."""
    offs, per = _offsets_table(q_offset, k_offset, q.shape[0], q.device)
    if dlse is None:
        dlse = torch.zeros_like(lse)
    args = (q, k, v, do, lse.transpose(1, 2), _delta(out, do, dlse), offs,
            bool(causal), per)
    return (dq_reference(*args),) + dkv_reference(*args)


# --------------------------------------------------------------------------
# kernel launches


def _check(op: str, q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"{op}: q/k/v must share one [B, T, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{op}: q/k/v dtypes differ: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{op}: q/k/v lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {q.device}")


def _check_cuda(op: str, q):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{op}: the CUDA kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    if min(q.shape) < 1:
        raise ValueError(f"{op}: empty shape {tuple(q.shape)}")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """`x` readable by the kernels: head dimension contiguous (one copy
    only when it is not)."""
    return x if x.stride(-1) == 1 else x.contiguous()


def _strides(*tensors):
    """(batch, time, head) element strides of each tensor as one C array."""
    flat = [s for x in tensors for s in x.stride()[:3]]
    return (ctypes.c_int64 * len(flat))(*flat)


def _offs_args(offs: Optional[torch.Tensor]):
    if offs is None:
        return None, 0
    if offs.dtype != torch.int32 or not offs.is_contiguous():
        raise TypeError("flash attention: offsets must be contiguous int32")
    return offs.data_ptr(), offs.shape[0]


def _bwd_args(op, q, k, v, do, lse, delta, offs, causal, per):
    """The arguments the two backward kernels share, checked: `(head,
    tail)` around each kernel's output pointers."""
    _check_cuda(op, q)
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or not x.is_contiguous()
                or tuple(x.shape) != (q.shape[0], q.shape[2], q.shape[1])):
            raise ValueError(f"{op}: {name} must be contiguous f32 "
                             f"[B, H, T], got {x.dtype}{tuple(x.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if x.stride(-1) != 1 or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"{op}: {name} must be {q.dtype}"
                             f"{tuple(q.shape)} with a contiguous head "
                             f"dimension")
    offs_ptr, n_off = _offs_args(offs)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    tail = (offs_ptr, _strides(q, k, v, do), *q.shape, n_off, per,
            int(causal), _DTYPE_CODES[q.dtype], build.stream_of(q.device))
    return head, tail


@torch.library.custom_op("eg::flash_fwd", mutates_args=(),
                         device_types="cpu")
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  offs: Optional[torch.Tensor], causal: bool,
                  per: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return lse_reference(q, k, v, offs, causal, per)


@_flash_fwd_op.register_kernel("cuda")
def _flash_fwd_cuda(q, k, v, offs, causal, per):
    _check_cuda("flash_attention", q)
    q, k, v = _rows(q), _rows(k), _rows(v)
    b, t, h, d = q.shape
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    offs_ptr, n_off = _offs_args(offs)
    with torch.cuda.device(q.device):
        build.launch(
            "flash_attention forward", build.library().eg_flash_fwd,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), offs_ptr, _strides(q, k, v), b, t, h, d, n_off,
            per, int(causal), _DTYPE_CODES[q.dtype],
            build.stream_of(q.device),
        )
    flash_fwd.launches += 1
    flash_fwd.forms[flash_plan.tensor_form(q, k, v)] += 1
    return out, lse.transpose(1, 2)


@_flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, offs, causal, per):
    b, t, h, _ = q.shape
    lse = q.new_empty((b, h, t), dtype=torch.float32)
    return torch.empty_like(q, memory_format=torch.contiguous_format), \
        lse.transpose(1, 2)


def flash_fwd(q, k, v, offs, causal: bool, per: int):
    """Forward on `[B, T, H, D]`: `(out, lse [B, T, H])`. The operator
    `eg::flash_fwd`: CPU tensors run the plain version, CUDA tensors
    launch `csrc/flash_fwd.cu`."""
    return _flash_fwd_op(q, k, v, offs, bool(causal), int(per))


@torch.library.custom_op("eg::flash_dq", mutates_args=(), device_types="cpu")
def _flash_dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 offs: Optional[torch.Tensor], causal: bool,
                 per: int) -> torch.Tensor:
    return dq_reference(q, k, v, do, lse, delta, offs, causal, per)


@_flash_dq_op.register_kernel("cuda")
def _flash_dq_cuda(q, k, v, do, lse, delta, offs, causal, per):
    head, tail = _bwd_args("flash_attention dQ", q, k, v, do, lse, delta,
                           offs, causal, per)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        build.launch("flash_attention dQ", build.library().eg_flash_dq,
                     *head, dq.data_ptr(), *tail)
    flash_dq.launches += 1
    flash_dq.forms[flash_plan.tensor_form(q, k, v, do)] += 1
    return dq


@_flash_dq_op.register_fake
def _flash_dq_fake(q, k, v, do, lse, delta, offs, causal, per):
    return q.new_empty(q.shape)


def flash_dq(q, k, v, do, lse, delta, offs, causal: bool, per: int):
    """dQ `[B, T, H, D]` from q, k, v, dO (head dimension contiguous) and
    `lse`, `delta` (f32 `[B, H, T]`). The operator `eg::flash_dq`: CPU
    tensors run the plain version, CUDA tensors launch
    `csrc/flash_dq.cu`."""
    return _flash_dq_op(q, k, v, do, lse, delta, offs, bool(causal),
                        int(per))


@torch.library.custom_op("eg::flash_dkv", mutates_args=(),
                         device_types="cpu")
def _flash_dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  offs: Optional[torch.Tensor], causal: bool,
                  per: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return dkv_reference(q, k, v, do, lse, delta, offs, causal, per)


@_flash_dkv_op.register_kernel("cuda")
def _flash_dkv_cuda(q, k, v, do, lse, delta, offs, causal, per):
    head, tail = _bwd_args("flash_attention dK/dV", q, k, v, do, lse, delta,
                           offs, causal, per)
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        build.launch("flash_attention dK/dV", build.library().eg_flash_dkv,
                     *head, dk.data_ptr(), dv.data_ptr(), *tail)
    flash_dkv.launches += 1
    flash_dkv.forms[flash_plan.tensor_form(q, k, v, do)] += 1
    return dk, dv


@_flash_dkv_op.register_fake
def _flash_dkv_fake(q, k, v, do, lse, delta, offs, causal, per):
    return q.new_empty(q.shape), q.new_empty(q.shape)


def flash_dkv(q, k, v, do, lse, delta, offs, causal: bool, per: int):
    """`(dK, dV)`, with `flash_dq`'s arguments. The operator
    `eg::flash_dkv`: CPU tensors run the plain version, CUDA tensors
    launch `csrc/flash_dkv.cu`."""
    return _flash_dkv_op(q, k, v, do, lse, delta, offs, bool(causal),
                         int(per))


def flash_bwd(q, k, v, out, lse, do, dlse, offs, causal: bool, per: int):
    """Backward: `(dq, dk, dv)` through `flash_dq` and `flash_dkv`."""
    delta = _delta(out, do, dlse)
    q, k, v, do = (_rows(x) for x in (q, k, v, do.to(q.dtype)))
    args = (q, k, v, do, lse.transpose(1, 2).contiguous(), delta, offs,
            causal, per)
    return (flash_dq(*args),) + flash_dkv(*args)


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0
for _fn in (flash_fwd, flash_dq, flash_dkv):
    _fn.forms = dict.fromkeys(flash_plan.FORMS, 0)


def form_counts():
    """{kernel: {form: launches}} of the three flash wrappers."""
    return {name: dict(fn.forms) for name, fn in (
        ("flash_fwd", flash_fwd), ("flash_dq", flash_dq),
        ("flash_dkv", flash_dkv))}


# --------------------------------------------------------------------------
# autograd + vmap


def _fold(x: Optional[torch.Tensor], dim: Optional[int], size: int):
    """Move a mapped dimension to the front and fold it into the next
    one; an unmapped tensor is repeated first."""
    if x is None:
        return None
    x = x.movedim(dim, 0) if dim is not None else x.expand(
        (size,) + tuple(x.shape))
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _unfold(x: torch.Tensor, size: int) -> torch.Tensor:
    return x.reshape((size, x.shape[0] // size) + tuple(x.shape[1:]))


def _fold_offs(offs, dim, size):
    """The offsets table under a mapped dimension: unmapped it is shared
    by every slice (row i reads entry `(i // per) % N`, and the slices'
    rows repeat with period `N * per`); mapped, the tables concatenate."""
    if offs is None or dim is None:
        return offs
    return _fold(offs, dim, size).contiguous()


class _FlashForward(torch.autograd.Function):
    """(q, k, v, offs, causal, per) -> (out, lse)."""

    @staticmethod
    def forward(q, k, v, offs, causal, per):
        return flash_fwd(q, k, v, offs, causal, per)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, offs, causal, per = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.offs, ctx.causal, ctx.per = offs, causal, per

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBackward.apply(
            q, k, v, out, lse, do, dlse, ctx.offs, ctx.causal, ctx.per)
        return dq, dk, dv, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, offs, causal, per):
        n = info.batch_size
        q, k, v = (_fold(x, d, n) for x, d in zip((q, k, v), in_dims[:3]))
        offs = _fold_offs(offs, in_dims[3], n)
        out, lse = _FlashForward.apply(q, k, v, offs, causal, per)
        return (_unfold(out, n), _unfold(lse, n)), (0, 0)


class _FlashBackward(torch.autograd.Function):
    """(q, k, v, out, lse, do, dlse, offs, causal, per) -> (dq, dk, dv);
    not differentiable again."""

    @staticmethod
    def forward(q, k, v, out, lse, do, dlse, offs, causal, per):
        return flash_bwd(q, k, v, out, lse, do, dlse, offs, causal, per)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "flash attention is differentiable once (no double backward)")

    @staticmethod
    def vmap(info, in_dims, q, k, v, out, lse, do, dlse, offs, causal, per):
        n = info.batch_size
        folded = [_fold(x, d, n) for x, d in
                  zip((q, k, v, out, lse, do, dlse), in_dims[:7])]
        offs = _fold_offs(offs, in_dims[7], n)
        grads = _FlashBackward.apply(*folded, offs, causal, per)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


# --------------------------------------------------------------------------
# public functions


def _offsets_table(q_offset, k_offset, b: int, device):
    """`(offs, per)`: the int32 `[N, 2]` table of (q_offset, k_offset)
    pairs and the number of consecutive batch rows sharing one pair.
    Python ints and 0-d tensors give one pair for the whole batch; a
    length-`N` tensor gives one per group of `B / N` rows."""
    as_t = lambda o: torch.as_tensor(o, dtype=torch.int32, device=device)
    qo, ko = as_t(q_offset), as_t(k_offset)
    if qo.dim() > 1 or ko.dim() > 1:
        raise ValueError("flash_attention_lse: offsets must be scalars or "
                         "1-D tensors")
    n = max(qo.numel() if qo.dim() else 1, ko.numel() if ko.dim() else 1)
    qo, ko = (torch.broadcast_to(o.reshape(-1), (n,)) for o in (qo, ko))
    if b % n:
        raise ValueError(f"flash_attention_lse: {n} offset pairs do not "
                         f"divide the batch of {b}")
    return torch.stack([qo, ko], dim=1).contiguous(), b // n


def flash_attention_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    q_offset=0,
    k_offset=0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention returning (out [B,T,H,D], logsumexp [B,T,H]).

    The lse output makes partial results mergeable with the online-softmax
    combine rule — ring attention computes each KV hop through this kernel
    and folds the hops together (`parallel/ring_attention.py`). `q_offset`
    and `k_offset` shift the causal mask to global sequence positions: a
    hop is fully visible, diagonal or fully masked depending on the
    ranks' relative positions. Each is a Python int, a 0-d int tensor, or
    a length-`N` int tensor holding one offset per group of `B / N`
    consecutive batch rows. Differentiable in q/k/v, including through
    lse; the offsets get no gradient."""
    _check("flash_attention_lse", q, k, v)
    offs, per = _offsets_table(q_offset, k_offset, q.shape[0], q.device)
    return _FlashForward.apply(q, k, v, offs, bool(causal), per)


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
) -> torch.Tensor:
    """Fused self-attention on [B, T, H, D] tensors (model layout).
    Differentiable (FA2 backward kernels). q, k, v must share one
    sequence length."""
    _check("flash_attention", q, k, v)
    out, _ = _FlashForward.apply(q, k, v, None, bool(causal), 1)
    return out
