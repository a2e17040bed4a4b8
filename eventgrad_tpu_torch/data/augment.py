"""CIFAR-10 training augmentation — port of
`eventgrad_tpu/data/augment.py` (`pad_flip_crop`).

The reference's order: ConstantPad(4), RandomHorizontalFlip(p=0.5),
RandomCrop to the input size. The JAX function draws its randomness
inside; here it is two parts, so the step can draw from its explicit
generator and a test can feed the JAX function's own draws:

  * `draw_pad_flip_crop` — the per-sample draws `(flip, ox, oy)`:
    flip ~ Bernoulli(0.5), crop offsets ox (rows), oy (columns) uniform
    in [0, 2 * pad];
  * `pad_flip_crop` — a pure function of the images and those draws:
    pure data movement, so it is bitwise the JAX function given the
    same draws.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def draw_pad_flip_crop(
    lead: Tuple[int, ...], gen: torch.Generator, device, pad: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flip bool, ox int64, oy int64), each of shape `lead` (one per
    image), drawn from `gen` in that order."""
    flip = torch.rand(tuple(lead), generator=gen, device=device) < 0.5
    ox = torch.randint(0, 2 * pad + 1, tuple(lead), generator=gen,
                       device=device)
    oy = torch.randint(0, 2 * pad + 1, tuple(lead), generator=gen,
                       device=device)
    return flip, ox, oy


def pad_flip_crop(images: torch.Tensor, flip: torch.Tensor, ox: torch.Tensor,
                  oy: torch.Tensor, pad: int = 4) -> torch.Tensor:
    """images `[..., H, W, C]` -> the same shape: each image flipped
    horizontally where `flip`, zero-padded by `pad` on both spatial
    sides, and cropped back to H x W at row `ox`, column `oy` (the
    draws have the images' leading shape)."""
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
    x = images.reshape((-1, h, w, c))
    flip, ox, oy = (v.reshape(-1) for v in (flip, ox, oy))
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    padded = F.pad(x, (0, 0, pad, pad, pad, pad))
    rows = (ox[:, None] + torch.arange(h, device=x.device))[:, :, None]
    cols = (oy[:, None] + torch.arange(w, device=x.device))[:, None, :]
    b = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return padded[b, rows, cols].reshape(images.shape)
