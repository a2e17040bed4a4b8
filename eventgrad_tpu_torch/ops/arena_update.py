"""Fused buffer-commit + gossip-mix + momentum-SGD on the flat arena.

Port of `eventgrad_tpu/ops/arena_update.py`: `fused_mix_commit` — the
CUDA kernel `csrc/mix_commit.cu`, replacing the TPU kernel
`_commit_kernel` — and its plain version `mix_commit_reference`. Per
element and per neighbor:

    buf_new_i = where(keep_i > 0, candidate_i, stale_i)   # the commit
    mixed     = (p + sum(buf_mix_*)) * w                  # gossip mix
    trace     = momentum * trace + grad                   # sgd trace
    p_new     = mixed - lr * trace                        # optimizer step

`mix_stale=True` mixes the stale buffers while committing the new ones.
The carrier-resident variant (`fused_mix_commit_carrier`) is not ported
yet. The scalars enter as float32 values, as JAX's weakly typed scalars
do, so the plain version is bitwise the JAX one and the kernel bitwise
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.ops import build

Tensors = Tuple[torch.Tensor, ...]


def _f32(x: float) -> float:
    return float(np.float32(x))


def mix_commit_reference(
    p: torch.Tensor,
    cands: Tensors,
    keeps: Tensors,
    lasts: Tensors,
    g: torch.Tensor,
    t: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    mix_stale: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """Plain PyTorch version of `fused_mix_commit`."""
    bufs = tuple(
        torch.where(k.to(torch.float32) > 0, c, l)
        for c, k, l in zip(cands, keeps, lasts)
    )
    acc = p
    for i in range(len(bufs)):
        acc = acc + (lasts[i] if mix_stale else bufs[i])
    mixed = acc * _f32(mix_weight)
    trace = _f32(momentum) * t + g
    return mixed - _f32(lr) * trace, trace, bufs


def _ptrs(ts: Tensors):
    return (ctypes.c_void_p * len(ts))(*(x.data_ptr() for x in ts))


def fused_mix_commit(
    p: torch.Tensor,
    cands: Tensors,
    keeps: Tensors,
    lasts: Tensors,
    g: torch.Tensor,
    t: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    mix_stale: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """Fused commit+mix+SGD over flat f32 arenas of one shape (`[R, n]`
    for all ranks in one launch). `cands`/`keeps`/`lasts` hold one entry
    per neighbor: received candidates, per-POSITION f32 keep bits and the
    stale buffers. Returns (p_new, trace_new, committed_bufs). On CPU
    tensors this is `mix_commit_reference`; on CUDA tensors it launches
    `csrc/mix_commit.cu` or raises."""
    nb = len(cands)
    if len(keeps) != nb or len(lasts) != nb:
        raise ValueError("fused_mix_commit: cands/keeps/lasts lengths differ")
    if not 1 <= nb <= 4:
        raise ValueError(f"fused_mix_commit: 1..4 neighbors, got {nb}")
    named = {"p": p, "g": g, "t": t}
    for i in range(nb):
        named.update({f"cand{i}": cands[i], f"keep{i}": keeps[i],
                      f"last{i}": lasts[i]})
    device, n = build.check_inputs("fused_mix_commit", **named)
    if device.type == "cpu":
        return mix_commit_reference(p, cands, keeps, lasts, g, t, lr,
                                    momentum, mix_weight, mix_stale)
    p_out, t_out = torch.empty_like(p), torch.empty_like(p)
    bufs = tuple(torch.empty_like(p) for _ in range(nb))
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "fused_mix_commit", lib.eg_mix_commit,
            p.data_ptr(), g.data_ptr(), t.data_ptr(),
            _ptrs(cands), _ptrs(keeps), _ptrs(lasts),
            p_out.data_ptr(), t_out.data_ptr(), _ptrs(bufs), nb, n,
            _f32(lr), _f32(momentum), _f32(mix_weight), int(bool(mix_stale)),
            build.aligned(*named.values(), p_out, t_out, *bufs),
            build.stream_of(device),
        )
    fused_mix_commit.launches += 1
    return p_out, t_out, bufs


fused_mix_commit.launches = 0
