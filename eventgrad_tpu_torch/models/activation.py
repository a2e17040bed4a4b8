"""`relu` with flax's derivative.

`jax.nn.relu` (flax's `nn.relu`) defines its derivative as
`select(x > 0, g, 0)`: the gradient passes where the input is positive
and is 0 elsewhere, a NaN input included. torch's own relu backward is
`where(y <= 0, 0, g)`, which passes a NaN input's gradient on. The two
agree on every finite input; on a rank whose parameters hold NaNs in
some positions only (a partial poison landed by the gossip), torch's
spreads the NaN into every upstream leaf where the reference's stops at
the relu. The port's models use this one, so their gradients match the
reference's NaN for NaN.

It is built from ATen ops, not an `autograd.Function`: under the step's
`torch.func.vmap` and `grad` a Function runs through functorch's Python
rules, which cost the host-bound ResNet-18 step 40-50% on an H100
(`PERF.md` §6)."""

from __future__ import annotations

import torch


def relu(x: torch.Tensor) -> torch.Tensor:
    """`torch.relu(x)`, bit for bit (NaN stays NaN), with the gradient
    `where(x > 0, g, 0)`: the positive inputs carry the gradient, and the
    rest take torch's relu of a detached `x`, which carries none."""
    return torch.where(x > 0, x, torch.relu(x.detach()))
