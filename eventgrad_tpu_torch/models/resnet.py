"""ResNet family — port of `eventgrad_tpu/models/resnet.py` (`ResNet`,
`BasicBlock`, `Bottleneck`, `ResNet18`, `ResNet34`, `ResNet50`,
`ResNet101`, `ResNet152`).

CIFAR-adapted ResNet: 3x3 stem stride 1, no stem maxpool, stages
64/128/256/512 with strides 1/2/2/2, avg_pool(4) head, dense to
num_classes. `extra_block=True` keeps the reference's make_layer
off-by-one: the nominal {2,2,2,2} "ResNet18" has 3 blocks per stage
(86 parameter tensors, 17,444,682 parameters); ResNet-50 built of
Bottleneck blocks has 197 (29,451,082 parameters at 10 classes).

The modules mirror flax's: module and parameter names are flax's
(`stem_conv`, `BasicBlock_<i>` / `Bottleneck_<i>`, `Conv_0`, `BatchNorm_1`,
`downsample_conv`, `Dense_0`, `kernel`/`scale`/`bias`), so a dotted
parameter name is the flax path joined by dots. What differs from flax
and is matched here by hand:

  * layouts: convolution kernels are OIHW (flax HWIO) and the dense
    kernel is `(out, in)` (flax `(in, out)`); activations run NCHW
    inside, while the public input stays NHWC like the JAX model's;
  * flax "SAME" padding on a stride-2 3x3 convolution pads 0 before
    and 1 after (`F.pad`, then `padding=0`), not torch's symmetric 1;
  * BatchNorm is functional like flax's `batch_stats` collection:
    running statistics are passed in and the updated ones returned
    (momentum 0.9, eps 1e-5, the BIASED batch variance E[x²]−E[x]²
    clipped at 0 by a maximum, as flax's, statistics in at least
    float32), which is also what batching the ranks with
    `torch.func.vmap` needs;
  * initialization is flax's: lecun_normal (truncated normal, variance
    1/fan_in) for convolution and dense kernels, zero biases, unit BN
    scales — the trigger reads parameter norms, so the init changes
    the firing.

Parameters stay float32; `dtype` is the compute dtype (bfloat16 on the
card). The module is the architecture: its own parameters live on the
"meta" device by default, and the weights come from `init_variables`
(or `convert.params_from_jax`) and enter through
`torch.func.functional_call`.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.activation import relu
from eventgrad_tpu_torch.parallel.arena import flax_order

#: flax lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of flax/XLA "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv(use_bias=False, padding="SAME")`, kernel OIHW."""

    def __init__(self, cin, cout, k, stride=1, *, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.k, self.stride, self.dtype = k, stride, dtype

    def forward(self, x):
        (hb, ha), (wb, wa) = (
            _same_pads(x.shape[-2], self.k, self.stride),
            _same_pads(x.shape[-1], self.k, self.stride),
        )
        pad = 0
        if (hb, wb) == (ha, wa):
            pad = (hb, wb)
        else:
            x = F.pad(x, (wb, wa, hb, ha))
        return F.conv2d(x, self.kernel.to(self.dtype), stride=self.stride,
                        padding=pad)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over NCHW channels,
    with the running statistics threaded through explicitly: `stats`
    maps `<stat_key>.mean`/`.var` to the running values, and in train
    mode the updated ones are written into `new_stats`."""

    momentum = 0.9
    epsilon = 1e-5

    def __init__(self, c, *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c, device=device))
        self.bias = nn.Parameter(torch.empty(c, device=device))
        self.dtype = dtype
        self.stat_key = ""  # dotted module path, set by ResNet

    def forward(self, x, stats, new_stats, train: bool):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mk, vk = self.stat_key + ".mean", self.stat_key + ".var"
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.maximum(mean2 - mean * mean, torch.zeros_like(mean))
            m = self.momentum
            new_stats[mk] = m * stats[mk] + (1 - m) * mean
            new_stats[vk] = m * stats[vk] + (1 - m) * var
        else:
            mean, var = stats[mk], stats[vk]
        y = xf - mean[:, None, None]
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = y * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class Dense(nn.Module):
    """flax `nn.Dense`, kernel `(out, in)`."""

    def __init__(self, cin, cout, *, dtype, device, use_bias=True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, device=device))
        self.bias = (nn.Parameter(torch.empty(cout, device=device))
                     if use_bias else None)
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.kernel.to(self.dtype), bias)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with BN, plus a 1x1 strided projection when
    the residual's shape changes. expansion = 1."""

    expansion = 1

    def __init__(self, cin, filters, stride, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.Conv_0 = Conv(cin, filters, 3, stride, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, 1, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.has_downsample = stride != 1 or cin != filters * self.expansion
        if self.has_downsample:
            self.downsample_conv = Conv(cin, filters * self.expansion, 1,
                                        stride, **kw)
            self.downsample_bn = BatchNorm(filters * self.expansion, **kw)

    def forward(self, x, stats, new_stats, train):
        y = self.Conv_0(x)
        y = relu(self.BatchNorm_0(y, stats, new_stats, train))
        y = self.BatchNorm_1(self.Conv_1(y), stats, new_stats, train)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(
                self.downsample_conv(x), stats, new_stats, train
            )
        return relu(y + residual)


class Bottleneck(nn.Module):
    """1x1, 3x3 (carrying the stride, torchvision-style) and 1x1 to
    4 x filters, each with BN, plus a 1x1 strided projection when the
    residual's shape changes. expansion = 4."""

    expansion = 4

    def __init__(self, cin, filters, stride, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        cout = filters * self.expansion
        self.Conv_0 = Conv(cin, filters, 1, 1, **kw)
        self.BatchNorm_0 = BatchNorm(filters, **kw)
        self.Conv_1 = Conv(filters, filters, 3, stride, **kw)
        self.BatchNorm_1 = BatchNorm(filters, **kw)
        self.Conv_2 = Conv(filters, cout, 1, 1, **kw)
        self.BatchNorm_2 = BatchNorm(cout, **kw)
        self.has_downsample = stride != 1 or cin != cout
        if self.has_downsample:
            self.downsample_conv = Conv(cin, cout, 1, stride, **kw)
            self.downsample_bn = BatchNorm(cout, **kw)

    def forward(self, x, stats, new_stats, train):
        y = relu(self.BatchNorm_0(self.Conv_0(x), stats, new_stats, train))
        y = relu(self.BatchNorm_1(self.Conv_1(y), stats, new_stats, train))
        y = self.BatchNorm_2(self.Conv_2(y), stats, new_stats, train)
        residual = x
        if self.has_downsample:
            residual = self.downsample_bn(
                self.downsample_conv(x), stats, new_stats, train
            )
        return relu(y + residual)


class ResNet(nn.Module):
    """`forward(x, batch_stats, train)` takes NHWC images and returns
    float32 logits, plus the updated batch statistics in train mode."""

    #: what the training loop feeds `forward`: float32 images
    input_dtype = np.float32

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls=BasicBlock,
        num_classes: int = 10,
        num_filters: int = 64,
        extra_block: bool = True,
        dtype: torch.dtype = torch.float32,
        in_channels: int = 3,
        device="meta",
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.stem_conv = Conv(in_channels, num_filters, 3, 1, **kw)
        self.stem_bn = BatchNorm(num_filters, **kw)
        self.block_names = []
        cin, i = num_filters, 0
        for stage, blocks in enumerate(stage_sizes):
            filters = num_filters * 2**stage
            n_blocks = blocks + 1 if extra_block else blocks
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"{block_cls.__name__}_{i}"  # flax's module name
                setattr(self, name, block_cls(cin, filters, stride, **kw))
                self.block_names.append(name)
                cin, i = filters * block_cls.expansion, i + 1
        self.Dense_0 = Dense(cin, num_classes, **kw)
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                m.stat_key = name

    def check_input_shape(self, input_shape) -> None:
        cin = self.stem_conv.kernel.shape[1]
        if tuple(input_shape)[-1] != cin:
            raise ValueError(
                f"input_shape {tuple(input_shape)} (NHWC) does not match the "
                f"model's {cin} input channels"
            )

    def stat_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Batch-statistics names and shapes, in flax order."""
        shapes = {}
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                c = tuple(m.scale.shape)
                shapes[name + ".mean"] = c
                shapes[name + ".var"] = c
        return {k: shapes[k] for k in flax_order(shapes)}

    def init_variables(
        self, seed: int = 0, device=None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(params, batch_stats) initialized like flax, in flax order,
        drawn on the CPU from a generator seeded with `seed` (so the
        values do not depend on the device) and moved to `device`."""
        gen = torch.Generator().manual_seed(int(seed))
        shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        params = {}
        for name in flax_order(shapes):
            shape, leaf = shapes[name], name.rsplit(".", 1)[1]
            if leaf == "kernel":
                std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
                t = torch.empty(shape)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t.mul_(std)
            elif leaf == "scale":
                t = torch.ones(shape)
            else:
                t = torch.zeros(shape)
            params[name] = t.to(device)
        stats = {
            k: (torch.zeros(s) if k.endswith(".mean") else torch.ones(s)).to(device)
            for k, s in self.stat_shapes().items()
        }
        return params, stats

    def forward(self, x, batch_stats: Optional[Dict[str, torch.Tensor]] = None,
                train: bool = False):
        new_stats: Dict[str, torch.Tensor] = {}
        # NHWC -> NCHW, made contiguous: the CPU backward of a strided
        # convolution corrupts the heap on the channels-last strides a
        # bare permute leaves
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        x = self.stem_conv(x)
        x = relu(self.stem_bn(x, batch_stats, new_stats, train))
        for name in self.block_names:
            x = getattr(self, name)(x, batch_stats, new_stats, train)
        x = F.avg_pool2d(x, 4, 4)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC flatten
        x = self.Dense_0(x).to(torch.float32)
        if train:
            return x, {k: new_stats[k] for k in flax_order(new_stats)}
        return x


def ResNet18(**kw) -> ResNet:
    """As instantiated by the reference: {2,2,2,2} -> 3 blocks/stage with
    extra_block=True."""
    return ResNet(stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock, **kw)


def ResNet34(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=BasicBlock, **kw)


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), block_cls=Bottleneck, **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), block_cls=Bottleneck, **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), block_cls=Bottleneck, **kw)
