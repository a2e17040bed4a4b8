"""Tensor parallelism: Megatron-style sharded Transformer layers.

Port of `eventgrad_tpu/models/tp.py` (`ColParallelDense`,
`RowParallelDense`, `TPBlock`, `TPTransformerLM`):

  * `ColParallelDense` — kernel `[d_out/N, d_in]` per rank (torch's
    `(out, in)`; flax `[d_in, d_out/N]`); the output stays sharded over
    features (no collective).
  * `RowParallelDense` — kernel `[d_out, d_in/N]` per rank; the partial
    products sum over the TP axis (`collectives.axis_sum`, the JAX
    layer's `lax.psum`), which the block runs on the rank stack.
  * `TPBlock` / `TPTransformerLM` — attention heads and MLP hidden units
    sharded across the TP axis; activations enter and leave each block
    replicated. Attention is the plain `full_attention` over the local
    heads, as in the JAX block.

Parameter shards are distinct per TP rank, so the topology lists the
axis in `sharded_axes`: gossip and the gradient mean skip it, and the
shards initialize from the TP index (`init_lm_shards`).
The sharded leaves are named `tp_kernel` (the `tp_` convention of the
train step), the modules `ColParallelDense_0`, `RowParallelDense_0` and
their siblings, as flax names them, so `convert.py` carries them across
rank by rank. All TP layers are bias-free.

The model is rank-stacked (`rank_stacked`): the train step calls
`forward_stacked(params, tokens, topo)` on every rank at once; each
block's per-rank pieces run under `per_rank`, the two sums over `tp` on
the stack between them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.resnet import Dense
from eventgrad_tpu_torch.models.transformer import (
    Embed, LayerNorm, StackedLM, fcall,
)
from eventgrad_tpu_torch.parallel.collectives import axis_sum
from eventgrad_tpu_torch.parallel.ring_attention import full_attention
from eventgrad_tpu_torch.parallel.spmd import per_rank


class ColParallelDense(nn.Module):
    """`features` (global) outputs, `features / tp_size` on this rank."""

    def __init__(self, cin, features, tp_size, *, dtype, device):
        super().__init__()
        if features % tp_size:
            raise ValueError(
                f"features {features} not divisible by tp_size {tp_size}")
        self.tp_kernel = nn.Parameter(
            torch.empty(features // tp_size, cin, device=device))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.tp_kernel.to(self.dtype))


class RowParallelDense(nn.Module):
    """`features` (global) outputs from a feature-sharded input `[...,
    d_in/N]`: this rank's partial product (the caller sums it over the
    TP axis)."""

    def __init__(self, cin_local, features, *, dtype, device):
        super().__init__()
        self.tp_kernel = nn.Parameter(
            torch.empty(features, cin_local, device=device))
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.tp_kernel.to(self.dtype))


class TPBlock(nn.Module):
    """Pre-norm causal attention and a 4x GELU MLP over local heads and
    hidden units; `forward_stacked` sums each partial output over
    `axis` and returns (x, None: no auxiliary loss)."""

    def __init__(self, dim, n_heads, tp_size, *, dtype, device):
        super().__init__()
        if n_heads % tp_size:
            raise ValueError(
                f"n_heads {n_heads} not divisible by tp_size {tp_size}")
        kw = dict(dtype=dtype, device=device)
        self.dim, self.n_heads, self.tp_size = dim, n_heads, tp_size
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.ColParallelDense_0 = ColParallelDense(dim, 3 * dim, tp_size,
                                                   **kw)
        self.RowParallelDense_0 = RowParallelDense(dim // tp_size, dim, **kw)
        self.LayerNorm_1 = LayerNorm(dim, **kw)
        self.ColParallelDense_1 = ColParallelDense(dim, 4 * dim, tp_size,
                                                   **kw)
        self.RowParallelDense_1 = RowParallelDense(4 * dim // tp_size, dim,
                                                   **kw)

    def forward_stacked(self, p, x, topo, axis: str):
        b, t = x.shape[1:3]
        h_local = self.n_heads // self.tp_size
        d = self.dim // self.n_heads
        tp = self.tp_size > 1

        def attn(p, x):
            y = fcall(self, p, "LayerNorm_0", x)
            qkv = fcall(self, p, "ColParallelDense_0", y)
            q, k, v = qkv.reshape(b, t, 3 * h_local, d).split(h_local, dim=2)
            o = full_attention(q, k, v, causal=True)
            return fcall(self, p, "RowParallelDense_0",
                         o.reshape(b, t, h_local * d))

        o = per_rank(attn)(p, x)
        x = x + (axis_sum(o, topo, axis) if tp else o)

        def mlp(p, x):
            y = fcall(self, p, "ColParallelDense_1",
                      fcall(self, p, "LayerNorm_1", x))
            return fcall(self, p, "RowParallelDense_1",
                         F.gelu(y, approximate="tanh"))

        y = per_rank(mlp)(p, x)
        return x + (axis_sum(y, topo, axis) if tp else y), None


class TPTransformerLM(StackedLM):
    """Decoder-only LM with TP-sharded blocks; embeddings and head stay
    replicated (they gossip normally across dp)."""

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 128,
        n_heads: int = 8,
        n_layers: int = 2,
        max_len: int = 1024,
        axis: str = "tp",
        tp_size: int = 1,
        dtype: torch.dtype = torch.float32,
        device="meta",
    ):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by n_heads {n_heads}")
        kw = dict(dtype=dtype, device=device)
        self.vocab, self.dim, self.max_len = vocab, dim, max_len
        self.axis, self.tp_size, self.dtype = axis, tp_size, dtype
        #: the axis the `tp_` leaves shard over, and its size
        self.shard_axis, self.shard_size = axis, tp_size
        self.rank_stacked = True
        self.Embed_0 = Embed(vocab, dim, **kw)
        self.Embed_1 = Embed(max_len, dim, **kw)
        self.block_names = []
        for i in range(n_layers):
            name = f"TPBlock_{i}"
            setattr(self, name, TPBlock(dim, n_heads, tp_size, **kw))
            self.block_names.append(name)
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, vocab, **kw)

    def forward_stacked(self, params, tokens, topo):
        """Every rank's logits `[R, B, T, vocab]` (float32) from the
        rank-stacked parameters and tokens `[R, B, T]`; returns (logits,
        (): no auxiliary loss)."""
        return self._stacked(params, tokens,
                             self._blocks(params, topo, self.axis))
