"""Decoder-only Transformer LM — port of
`eventgrad_tpu/models/transformer.py` (`Block`, `TransformerLM`).

Attention runs in one of two modes here:

  * "full"  — exact attention with materialized scores
              (`parallel/ring_attention.full_attention`);
  * "flash" — the fused flash-attention kernels (`ops/attention.py`);
              `use_flash=True` sends "full" the same way.

"ring" and "ulysses" inside the model need a hybrid `dp x sp` topology
in the train step and wait; the stacked functions themselves are ported
(`parallel/ring_attention.py`).

The modules mirror flax's auto-naming (`Embed_0` tokens, `Embed_1`
positions, `Block_<i>` with `LayerNorm_0`, `Dense_0` QKV, `Dense_1`
output projection, `LayerNorm_1`, `Dense_2`/`Dense_3` MLP, then
`LayerNorm_0` and `Dense_0` of the head), so a dotted parameter name is
the flax path joined by dots. Flax's defaults, matched by hand where
torch's differ: LayerNorm epsilon 1e-6, the tanh approximation of GELU,
no bias on a block's first two Dense layers, dense kernels `(out, in)`
(flax `(in, out)`), lecun_normal kernels, zero biases, and embeddings
normal with std 1/sqrt(dim).

Like `models/resnet.py`, the module is the architecture: its own
parameters live on the "meta" device by default, the weights come from
`init_variables` (or `convert.params_from_jax`) and enter through
`torch.func.functional_call`, and `forward(tokens, batch_stats, train)`
follows the train step's protocol — in train mode it returns `(logits,
new_batch_stats)`, where the statistics of a model without BatchNorm
are an empty dict.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.resnet import _TRUNC_STD, Dense
from eventgrad_tpu_torch.parallel.arena import flax_order
from eventgrad_tpu_torch.parallel.ring_attention import full_attention

ATTN_MODES = ("full", "flash")


class Embed(nn.Module):
    """flax `nn.Embed`."""

    def __init__(self, n, dim, *, dtype, device):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(n, dim, device=device))
        self.dtype = dtype

    def forward(self, idx):
        return self.embedding.to(self.dtype)[idx]


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm` (epsilon 1e-6) over the last axis, statistics in
    at least float32."""

    epsilon = 1e-6

    def __init__(self, dim, *, dtype, device):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))
        self.dtype = dtype

    def forward(self, x):
        ct = torch.promote_types(x.dtype, torch.float32)
        y = F.layer_norm(x.to(ct), x.shape[-1:], self.scale.to(ct),
                         self.bias.to(ct), self.epsilon)
        return y.to(self.dtype)


class Block(nn.Module):
    """Pre-norm causal self-attention and a 4x GELU MLP, both residual."""

    def __init__(self, dim, n_heads, attn, *, dtype, device, use_flash=False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dim, self.n_heads = dim, n_heads
        self.flash = attn == "flash" or use_flash
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, 3 * dim, use_bias=False, **kw)
        self.Dense_1 = Dense(dim, dim, use_bias=False, **kw)
        self.LayerNorm_1 = LayerNorm(dim, **kw)
        self.Dense_2 = Dense(dim, 4 * dim, **kw)
        self.Dense_3 = Dense(4 * dim, dim, **kw)

    def forward(self, x):
        b, t, _ = x.shape
        h = self.n_heads
        d = self.dim // h
        qkv = self.Dense_0(self.LayerNorm_0(x))
        # three strided views of the fused projection; the flash kernels
        # read them through their strides
        q, k, v = qkv.reshape(b, t, 3 * h, d).split(h, dim=2)
        if self.flash:
            from eventgrad_tpu_torch.ops.attention import flash_attention

            o = flash_attention(q, k, v, causal=True)
        else:
            o = full_attention(q, k, v, causal=True)
        x = x + self.Dense_1(o.reshape(b, t, self.dim))
        y = self.Dense_2(self.LayerNorm_1(x))
        return x + self.Dense_3(F.gelu(y, approximate="tanh"))


class TransformerLM(nn.Module):
    """`forward(tokens, batch_stats, train)` takes integer tokens `[B, T]`
    and returns float32 logits `[B, T, vocab]`, plus an empty statistics
    dict in train mode."""

    #: what the training loop feeds `forward`: integer tokens
    input_dtype = np.int64

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 128,
        n_heads: int = 8,
        n_layers: int = 2,
        max_len: int = 1024,
        attn: str = "full",
        dtype: torch.dtype = torch.float32,
        use_flash: bool = False,
        device="meta",
    ):
        super().__init__()
        if attn in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn={attn!r} inside the model needs the hybrid dp x sp "
                "topology in the train step, which is not ported yet "
                "(ROADMAP queue 1, item 7); the stacked functions are in "
                "parallel/ring_attention.py"
            )
        if attn not in ATTN_MODES:
            raise ValueError(f"unknown attn mode {attn!r}")
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by n_heads {n_heads}")
        kw = dict(dtype=dtype, device=device)
        self.vocab, self.dim, self.max_len = vocab, dim, max_len
        self.attn, self.dtype = attn, dtype
        self.Embed_0 = Embed(vocab, dim, **kw)
        self.Embed_1 = Embed(max_len, dim, **kw)
        self.block_names = []
        for i in range(n_layers):
            name = f"Block_{i}"
            setattr(self, name, Block(dim, n_heads, attn, use_flash=use_flash,
                                      **kw))
            self.block_names.append(name)
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, vocab, **kw)

    def check_input_shape(self, input_shape) -> None:
        shape = tuple(input_shape)
        if len(shape) != 1 or not 1 <= shape[0] <= self.max_len:
            raise ValueError(
                f"input_shape {shape} is not one token sequence of at most "
                f"max_len={self.max_len} positions"
            )

    def init_variables(
        self, seed: int = 0, device=None,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(params, batch_stats) initialized like flax, in flax order,
        drawn on the CPU from a generator seeded with `seed` and moved to
        `device`; the statistics are empty (no BatchNorm)."""
        gen = torch.Generator().manual_seed(int(seed))
        shapes = {n: tuple(p.shape) for n, p in self.named_parameters()}
        params = {}
        for name in flax_order(shapes):
            shape, leaf = shapes[name], name.rsplit(".", 1)[1]
            if leaf == "kernel":
                t = torch.empty(shape)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t.mul_(math.sqrt(1.0 / shape[1]) / _TRUNC_STD)
            elif leaf == "embedding":
                t = torch.randn(shape, generator=gen) / math.sqrt(shape[1])
            elif leaf == "scale":
                t = torch.ones(shape)
            else:
                t = torch.zeros(shape)
            params[name] = t.to(device)
        return params, {}

    def forward(self, tokens, batch_stats: Optional[Dict] = None,
                train: bool = False):
        t = tokens.shape[-1]
        pos = torch.arange(t, device=tokens.device)
        x = self.Embed_0(tokens) + self.Embed_1(pos)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.Dense_0(self.LayerNorm_0(x)).to(torch.float32)
        return (x, {}) if train else x
