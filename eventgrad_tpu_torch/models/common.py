"""What the port's small classifiers share (`models/mlp.py`,
`models/cnn.py`): flax's initialization and flax's dropout.

Initialization is flax's defaults for `nn.Dense` and `nn.Conv`:
lecun_normal kernels (truncated normal, variance 1/fan_in, with fan_in
the product of every kernel axis but the output one) and zero biases,
drawn on the CPU from a generator seeded with `seed`, leaf by leaf in
flax order, so the values do not depend on the device.

Dropout is flax's `nn.Dropout`: `where(keep, x / keep_prob, 0)` with
`keep ~ Bernoulli(keep_prob)` drawn over the broadcast shape. The keep
bits are drawn OUTSIDE the model, from the train step's explicit
`torch.Generator` (`draw_dropout`), and passed to `forward(..., drop=)`
as inputs: the step batches the ranks with `torch.func.vmap`, which
refuses random ops inside the function, and a model without dropout
draws nothing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from eventgrad_tpu_torch.models.resnet import _TRUNC_STD
from eventgrad_tpu_torch.parallel.arena import flax_order


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
            rate: float) -> torch.Tensor:
    """flax `nn.Dropout(rate)` given its keep bits (broadcastable to
    `x`); `keep=None` is the deterministic (eval) pass."""
    if keep is None:
        return x
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(keep, x / (1.0 - rate), zero)


def draw_dropout(sites: Dict[str, Tuple[Tuple[int, ...], float]],
                 lead: Tuple[int, ...], gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """Keep bits for every dropout site of a model, `lead + shape` each
    (`lead` = (ranks,) for the rank-stacked step), drawn in site order
    from `gen` as flax draws them: uniform < keep_prob."""
    return {
        name: torch.rand(tuple(lead) + tuple(shape), generator=gen,
                         device=device) < (1.0 - rate)
        for name, (shape, rate) in sites.items()
    }


class Classifier(nn.Module):
    """Base of the small image classifiers: NHWC float32 input of one
    fixed shape, no BatchNorm, flax initialization.
    `forward(x, batch_stats, train)` (plus `drop=`, the keep bits, for
    a model with dropout) returns the output, and in train mode
    `(output, {})` (the train step's protocol; the statistics of a model
    without BatchNorm are empty). Subclasses set `input_shape` and, for
    dropout, `dropout_sites`."""

    #: what the training loop feeds `forward`: float32 images
    input_dtype = np.float32

    def __init__(self, input_shape: Tuple[int, int, int], dtype):
        super().__init__()
        self.input_shape = tuple(input_shape)
        self.dtype = dtype

    def check_input_shape(self, input_shape) -> None:
        if tuple(input_shape) != self.input_shape:
            raise ValueError(
                f"input_shape {tuple(input_shape)} (NHWC) does not match "
                f"the model's {self.input_shape}"
            )

    def stat_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def dropout_sites(self, batch: int) -> Dict[str, Tuple[Tuple[int, ...], float]]:
        """{site: (keep-bit shape for `batch` samples, rate)} in the order
        of the forward pass; empty without dropout."""
        return {}

    def init_variables(
        self, seed: int = 0, device=None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(params, {}) initialized like flax, in flax order."""
        gen = torch.Generator().manual_seed(int(seed))
        shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        params = {}
        for name in flax_order(shapes):
            shape = shapes[name]
            if name.endswith(".kernel"):
                std = math.sqrt(1.0 / math.prod(shape[1:])) / _TRUNC_STD
                t = torch.empty(shape)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t.mul_(std)
            else:
                t = torch.zeros(shape)
            params[name] = t.to(device)
        return params, {}

    def _checked_drop(self, x, train: bool, drop) -> Dict[str, torch.Tensor]:
        """The keep bits this pass uses: none in eval mode; in train mode
        a model with dropout must be handed them (never a silent
        deterministic train pass)."""
        if not train:
            return {}
        if drop is None and self.dropout_sites(x.shape[0]):
            raise ValueError(
                f"{type(self).__name__} has dropout: a train-mode forward "
                "needs its keep bits (drop=, see models.common.draw_dropout)"
            )
        return drop or {}

    def _out(self, out, train: bool):
        return (out, {}) if train else out
