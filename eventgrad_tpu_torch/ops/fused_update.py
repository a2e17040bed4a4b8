"""Fused gossip-mix + momentum-SGD update (the D-PSGD tail).

Port of `eventgrad_tpu/ops/fused_update.py`: `fused_mix_sgd` — the CUDA
kernel `csrc/mix_sgd.cu`, replacing the TPU kernel `_kernel` — and its
plain version `mix_sgd_reference`:

    mixed = (p + buf_sum) * w
    trace = momentum * trace + grad
    p_new = mixed - lr * trace

The port calls it on the flat arena (one `[R, n]` tensor, one launch),
the JAX package's single-flat-leaf case; the per-leaf pytree dispatch of
the JAX function is not needed there. It is the dispatcher operator
`eg::fused_mix_sgd`: the plain version is its CPU implementation and the
launch its CUDA one.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.ops import build


def _f32(x: float) -> float:
    return float(np.float32(x))


def mix_sgd_reference(
    params: torch.Tensor, buf_sum: torch.Tensor, grads: torch.Tensor,
    trace: torch.Tensor, lr: float, momentum: float, mix_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `fused_mix_sgd`."""
    mixed = (params + buf_sum) * _f32(mix_weight)
    new_trace = _f32(momentum) * trace + grads
    return mixed - _f32(lr) * new_trace, new_trace


def _check(params, buf_sum, grads, trace):
    return build.check_inputs(
        "fused_mix_sgd", params=params, buf_sum=buf_sum, grads=grads,
        trace=trace,
    )


@torch.library.custom_op("eg::fused_mix_sgd", mutates_args=(),
                         device_types="cpu")
def _fused_mix_sgd_op(
    params: torch.Tensor, buf_sum: torch.Tensor, grads: torch.Tensor,
    trace: torch.Tensor, lr: float, momentum: float, mix_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _check(params, buf_sum, grads, trace)
    return mix_sgd_reference(params, buf_sum, grads, trace, lr, momentum,
                             mix_weight)


@_fused_mix_sgd_op.register_kernel("cuda")
def _fused_mix_sgd_cuda(params, buf_sum, grads, trace, lr, momentum,
                        mix_weight):
    device, n = _check(params, buf_sum, grads, trace)
    p_out, t_out = torch.empty_like(params), torch.empty_like(params)
    lib = build.library()
    with torch.cuda.device(device):
        build.launch(
            "fused_mix_sgd", lib.eg_mix_sgd,
            params.data_ptr(), buf_sum.data_ptr(), grads.data_ptr(),
            trace.data_ptr(), p_out.data_ptr(), t_out.data_ptr(), n,
            _f32(lr), _f32(momentum), _f32(mix_weight),
            build.aligned(params, buf_sum, grads, trace, p_out, t_out),
            build.stream_of(device),
        )
    fused_mix_sgd.launches += 1
    return p_out, t_out


@_fused_mix_sgd_op.register_fake
def _fused_mix_sgd_fake(params, buf_sum, grads, trace, lr, momentum,
                        mix_weight):
    return torch.empty_like(params), torch.empty_like(params)


def fused_mix_sgd(
    params: torch.Tensor,
    buf_sum: torch.Tensor,
    grads: torch.Tensor,
    trace: torch.Tensor,
    lr: float,
    momentum: float,
    mix_weight: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused mix + SGD over f32 arenas of one shape. `buf_sum` is the
    elementwise sum of the neighbor buffers. Returns (new_params,
    new_trace). The operator `eg::fused_mix_sgd`: on CPU tensors
    `mix_sgd_reference`, on CUDA tensors a launch of `csrc/mix_sgd.cu`
    (or an error)."""
    return _fused_mix_sgd_op(params, buf_sum, grads, trace, float(lr),
                             float(momentum), float(mix_weight))


fused_mix_sgd.launches = 0
