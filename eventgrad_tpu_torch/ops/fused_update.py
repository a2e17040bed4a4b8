"""Fused gossip-mix + momentum-SGD update (the D-PSGD tail).

Port of `eventgrad_tpu/ops/fused_update.py`: `fused_mix_sgd` — the CUDA
kernel `csrc/mix_sgd.cu`, replacing the TPU kernel `_kernel` — and its
plain version `mix_sgd_reference`:

    mixed = (p + buf_sum) * w
    trace = momentum * trace + grad
    p_new = mixed - lr * trace

The port calls it on the flat arena (one `[R, n]` tensor, one launch),
the JAX package's single-flat-leaf case; the per-leaf pytree dispatch of
the JAX function is not needed there. Its gated form (D-PSGD under
drops, death and freeze) takes `w_rows`, the f32 `[R]` mix weight
1/(1 + n_alive) of each rank in place of `mix_weight` (the caller leaves
the gated edges out of `buf_sum`): `mixed = (p + buf_sum) * w_rows`. On
a CUDA tensor it runs one grid row per rank and counts in the kernel's
launches and its `gated_launches`; with `w_rows` = float32(mix_weight)
it is bitwise the ungated form. It is the dispatcher operator
`eg::fused_mix_sgd`: the plain version is its CPU implementation and the
launch its CUDA one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.ops import build


def _f32(x: float) -> float:
    return float(np.float32(x))


def mix_sgd_reference(
    params: torch.Tensor, buf_sum: torch.Tensor, grads: torch.Tensor,
    trace: torch.Tensor, lr: float, momentum: float, mix_weight: float,
    w_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `fused_mix_sgd`."""
    w = _f32(mix_weight) if w_rows is None else w_rows[:, None]
    mixed = (params + buf_sum) * w
    new_trace = _f32(momentum) * trace + grads
    return mixed - _f32(lr) * new_trace, new_trace


def _check(params, buf_sum, grads, trace, w_rows=None):
    out = build.check_inputs(
        "fused_mix_sgd", params=params, buf_sum=buf_sum, grads=grads,
        trace=trace,
    )
    if w_rows is not None:
        if params.dim() != 2 or w_rows.shape != params.shape[:1] or \
                w_rows.dtype != torch.float32 or not w_rows.is_contiguous() \
                or w_rows.device != params.device:
            raise ValueError(
                "fused_mix_sgd: w_rows must be contiguous float32 [R] on "
                f"the device of the [R, n] arena, got {w_rows.dtype} "
                f"{tuple(w_rows.shape)} for {tuple(params.shape)}")
    return out


@torch.library.custom_op("eg::fused_mix_sgd", mutates_args=(),
                         device_types="cpu")
def _fused_mix_sgd_op(
    params: torch.Tensor, buf_sum: torch.Tensor, grads: torch.Tensor,
    trace: torch.Tensor, lr: float, momentum: float, mix_weight: float,
    w_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(params, buf_sum, grads, trace, w_rows)
    return mix_sgd_reference(params, buf_sum, grads, trace, lr, momentum,
                             mix_weight, w_rows)


@_fused_mix_sgd_op.register_kernel("cuda")
def _fused_mix_sgd_cuda(params, buf_sum, grads, trace, lr, momentum,
                        mix_weight, w_rows=None):
    device, n = _check(params, buf_sum, grads, trace, w_rows)
    p_out, t_out = torch.empty_like(params), torch.empty_like(params)
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "fused_mix_sgd", lib.eg_mix_sgd,
            params.data_ptr(), buf_sum.data_ptr(), grads.data_ptr(),
            trace.data_ptr(), p_out.data_ptr(), t_out.data_ptr(), n,
            _f32(lr), _f32(momentum), _f32(mix_weight),
            params.shape[0] if w_rows is not None else 1,
            None if w_rows is None else w_rows.data_ptr(),
            build.aligned(params, buf_sum, grads, trace, p_out, t_out),
            build.stream_of(device),
        )
    fused_mix_sgd.launches += 1
    fused_mix_sgd.gated_launches += int(w_rows is not None)
    return p_out, t_out


@_fused_mix_sgd_op.register_fake
def _fused_mix_sgd_fake(params, buf_sum, grads, trace, lr, momentum,
                        mix_weight, w_rows=None):
    return torch.empty_like(params), torch.empty_like(params)


def fused_mix_sgd(
    params: torch.Tensor,
    buf_sum: torch.Tensor,
    grads: torch.Tensor,
    trace: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
    w_rows: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused mix + SGD over f32 arenas of one shape. `buf_sum` is the
    elementwise sum of the neighbor buffers. Returns (new_params,
    new_trace). The operator `eg::fused_mix_sgd`: on CPU tensors
    `mix_sgd_reference`, on CUDA tensors a launch of `csrc/mix_sgd.cu`
    (or an error). `w_rows` selects the gated form (module docstring)."""
    return _fused_mix_sgd_op(params, buf_sum, grads, trace, float(lr),
                             float(momentum), float(mix_weight), w_rows)


fused_mix_sgd.launches = 0
fused_mix_sgd.gated_launches = 0
