"""The MNIST CNNs and the CIFAR LeNet — port of
`eventgrad_tpu/models/cnn.py` (`CNN1`, `CNN2`, `LeNetCifar`).

  * CNN1 — conv(1->10, k5) pool relu, conv(10->20, k5) drop2d pool relu,
    fc 320->100 relu, dropout .5, fc 100->10, log_softmax;
  * CNN2 — the model the reference's `event` trains: conv(1->10, k3)
    pool relu, conv(10->20, k3) drop2d pool relu, fc 500->50 relu,
    dropout .5, fc 50->10, log_softmax (27,480 parameters in 8 tensors);
  * LeNetCifar — conv(3->6, k5) relu pool, conv(6->16, k5) drop2d relu
    pool, fc 400->120->84->10, log_softmax (62,006 parameters in 10
    tensors). Its first block is pool(relu(conv)); CNN1 and CNN2 apply
    relu(pool(conv)).

Convolutions are VALID with a bias, pooling is 2x2 max with stride 2,
and the output is log-probabilities. What differs from flax and is
matched here by hand: kernels are OIHW (flax HWIO) and dense kernels
`(out, in)`; activations run NCHW inside, so before the first Dense the
features are permuted back to NHWC and flattened in flax's (H, W, C)
order, and `convert.py` only transposes the Dense kernel. Dropout2d is
flax's `nn.Dropout(0.5, broadcast_dims=(1, 2))`: one keep bit per
(sample, channel). The input is made contiguous NCHW before the first
convolution (torch's CPU backward of a strided convolution corrupts the
heap on the channels-last strides a bare permute leaves).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.activation import relu
from eventgrad_tpu_torch.models.common import Classifier, dropout
from eventgrad_tpu_torch.models.resnet import Dense

RATE = 0.5


class Conv(nn.Module):
    """flax `nn.Conv(features, (k, k), padding="VALID")`, kernel OIHW."""

    def __init__(self, cin, cout, k, *, dtype, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.empty(cout, device=device))
        self.dtype = dtype

    def forward(self, x):
        return F.conv2d(x, self.kernel.to(self.dtype), self.bias.to(self.dtype))


def _pool(x):
    return F.max_pool2d(x, 2, 2)


class _ConvNet(Classifier):
    """Two VALID conv blocks (the second with Dropout2d), then dense
    layers. `ks` are the two kernel sizes, `chans` their output
    channels, `dense` the dense widths after the flatten."""

    #: conv1's block: relu(pool(conv)) (CNN1, CNN2) or pool(relu(conv))
    pool_first = True
    #: dropout .5 after the first dense layer (CNN1, CNN2)
    dense_dropout = True

    def __init__(self, ks, chans, dense, input_shape, dtype, device):
        super().__init__(input_shape, dtype)
        kw = dict(dtype=dtype, device=device)
        h, w, cin = self.input_shape
        self.Conv_0 = Conv(cin, chans[0], ks[0], **kw)
        self.Conv_1 = Conv(chans[0], chans[1], ks[1], **kw)
        for k in ks:
            h, w = (h - k + 1) // 2, (w - k + 1) // 2
        self.conv_out = (chans[1], h, w)
        widths = (chans[1] * h * w,) + tuple(dense)
        self.dense_names = []
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"Dense_{i}", Dense(a, b, **kw))
            self.dense_names.append(f"Dense_{i}")

    def dropout_sites(self, batch: int):
        sites = {"Dropout_0": ((batch, self.conv_out[0], 1, 1), RATE)}
        if self.dense_dropout:
            sites["Dropout_1"] = ((batch, self.Dense_0.kernel.shape[0]), RATE)
        return sites

    def forward(self, x, batch_stats: Optional[Dict] = None,
                train: bool = False, drop: Optional[Dict] = None):
        drop = self._checked_drop(x, train, drop)
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous()
        x = self.Conv_0(x)
        x = relu(_pool(x)) if self.pool_first else _pool(relu(x))
        x = dropout(self.Conv_1(x), drop.get("Dropout_0"), RATE)
        x = relu(_pool(x)) if self.pool_first else _pool(relu(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's NHWC flatten
        last = len(self.dense_names) - 1
        for i, name in enumerate(self.dense_names):
            x = getattr(self, name)(x)
            if i < last:
                x = relu(x)
                if i == 0 and self.dense_dropout:
                    x = dropout(x, drop.get("Dropout_1"), RATE)
        return self._out(F.log_softmax(x, dim=-1), train)


class CNN1(_ConvNet):
    def __init__(self, num_classes: int = 10,
                 input_shape: Tuple[int, int, int] = (28, 28, 1),
                 dtype: torch.dtype = torch.float32, device="meta"):
        super().__init__((5, 5), (10, 20), (100, num_classes), input_shape,
                         dtype, device)


class CNN2(_ConvNet):
    def __init__(self, num_classes: int = 10,
                 input_shape: Tuple[int, int, int] = (28, 28, 1),
                 dtype: torch.dtype = torch.float32, device="meta"):
        super().__init__((3, 3), (10, 20), (50, num_classes), input_shape,
                         dtype, device)


class LeNetCifar(_ConvNet):
    pool_first = False
    dense_dropout = False

    def __init__(self, num_classes: int = 10,
                 input_shape: Tuple[int, int, int] = (32, 32, 3),
                 dtype: torch.dtype = torch.float32, device="meta"):
        super().__init__((5, 5), (6, 16), (120, 84, num_classes), input_shape,
                         dtype, device)
