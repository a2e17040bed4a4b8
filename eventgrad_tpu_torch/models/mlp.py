"""The reference's 2-layer MNIST MLP — port of
`eventgrad_tpu/models/mlp.py` (`MLP`).

784 -> 128 ReLU -> 10, with the ReLU on the logits that the reference
applies (`relu_logits=True`, faithful to it: it changes the training
trajectory; the loss applies its own log_softmax). The NHWC input is
flattened as it comes, flax's order. 101,770 parameters in 4 tensors.
No dropout: the model draws nothing, so step tests use it wherever a
model must have no randomness.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from eventgrad_tpu_torch.models.activation import relu
from eventgrad_tpu_torch.models.common import Classifier
from eventgrad_tpu_torch.models.resnet import Dense


class MLP(Classifier):
    def __init__(
        self,
        hidden: int = 128,
        num_classes: int = 10,
        relu_logits: bool = True,
        input_shape: Tuple[int, int, int] = (28, 28, 1),
        dtype: torch.dtype = torch.float32,
        device="meta",
    ):
        super().__init__(input_shape, dtype)
        kw = dict(dtype=dtype, device=device)
        self.relu_logits = relu_logits
        self.Dense_0 = Dense(math.prod(self.input_shape), hidden, **kw)
        self.Dense_1 = Dense(hidden, num_classes, **kw)

    def forward(self, x, batch_stats: Optional[Dict] = None,
                train: bool = False):
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        x = self.Dense_1(relu(self.Dense_0(x)))
        if self.relu_logits:
            x = relu(x)
        return self._out(x, train)
