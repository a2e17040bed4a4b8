"""Pipeline parallelism: the GPipe microbatch schedule over one axis.

Port of `eventgrad_tpu/models/pp.py` (`gpipe`, `_layernorm`,
`_block_apply`, `PPTransformerLM`): Transformer blocks split into
`pp_size` stages, each pp rank owns one stage's parameters, and
microbatches flow through the stages over `n_micro + pp_size - 1`
ticks with one activation shift along `pp` a tick
(`collectives.recv_from`, the JAX schedule's `lax.ppermute`).

  * Backward is autograd through the ticks: the cotangents shift back
    through the stages, the reverse GPipe schedule.
  * Stage parameters are `tp_l{i}_*` leaves (the sharded-leaf
    convention of the train step): each pp rank owns distinct values of
    the same-named leaves, in the JAX layout (`(in, out)` weights).
  * Embeddings and the LM head stay replicated across pp; every rank
    embeds the batch, only stage 0's copy enters the pipeline, and the
    last stage's output is broadcast back by a masked sum over `pp`, so
    every rank computes the same loss.

The model is rank-stacked (`rank_stacked`): `forward_stacked(params,
tokens, topo)` runs every rank's stage at once under `per_rank`, one
Python loop over the ticks.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.resnet import Dense
from eventgrad_tpu_torch.models.transformer import (
    Embed, LayerNorm, StackedLM,
)
from eventgrad_tpu_torch.parallel.collectives import (
    axis_index, axis_sum, recv_from,
)
from eventgrad_tpu_torch.parallel.events import _rows
from eventgrad_tpu_torch.parallel.ring_attention import full_attention
from eventgrad_tpu_torch.parallel.spmd import per_rank
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Topology

#: a stage's parameters, per layer
_STAGE_LEAVES = ("ln1_scale", "ln1_bias", "wqkv", "wo", "ln2_scale",
                 "ln2_bias", "wi", "wo2")


def gpipe(stage_fn: Callable, x_micro: torch.Tensor, topo: Topology,
          axis: str) -> torch.Tensor:
    """One forward pass of the GPipe schedule on the rank stack.

    `x_micro`: `[R, n_micro, micro_batch, ...]` microbatches, the same
    along `axis` (only stage 0's copy is consumed). `stage_fn` maps
    `[R, micro_batch, ...]` activations through every rank's own stage.
    Returns `[R, n_micro, ...]` stage outputs, valid on the last stage
    only (other ranks hold zeros; callers broadcast with a masked sum).

    Tick t: stage 0 feeds microbatch clip(t), every stage applies its fn
    to its current activation, the last stage banks its result from
    tick pp_size - 1, and activations shift one stage along `axis`."""
    n_micro = x_micro.shape[1]
    pp_size = topo.axis_size(axis)
    stage = axis_index(topo, axis, x_micro.device)
    first = _rows(stage == 0, x_micro[:, 0])
    last = _rows(stage == pp_size - 1, x_micro[:, 0])
    nb = NeighborSpec(axis, -1)  # stage s receives from stage s - 1
    acts = torch.zeros_like(x_micro[:, 0])
    outs = [torch.zeros_like(x_micro[:, 0]) for _ in range(n_micro)]
    n_ticks = n_micro + pp_size - 1
    for t in range(n_ticks):
        feed = x_micro[:, min(max(t, 0), n_micro - 1)]
        out = stage_fn(torch.where(first, feed, acts))
        if t >= pp_size - 1:
            o_idx = min(t - (pp_size - 1), n_micro - 1)
            outs[o_idx] = torch.where(last, out, outs[o_idx])
        if t < n_ticks - 1:
            acts = recv_from(out, topo, nb)
    return torch.stack(outs, dim=1)


def _layernorm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def _block_apply(p: Dict[str, torch.Tensor], x, n_heads: int, dtype):
    """One pre-LN Transformer block as a pure function of its parameter
    dict (the JAX layout: `x @ w`)."""
    b, t, dim = x.shape
    d = dim // n_heads
    y = _layernorm(x, p["ln1_scale"], p["ln1_bias"]).to(dtype)
    qkv = y @ p["wqkv"].to(dtype)
    q, k, v = qkv.reshape(b, t, 3 * n_heads, d).split(n_heads, dim=2)
    o = full_attention(q, k, v, causal=True)
    x = x + o.reshape(b, t, dim) @ p["wo"].to(dtype)
    y = _layernorm(x, p["ln2_scale"], p["ln2_bias"]).to(dtype)
    y = F.gelu(y @ p["wi"].to(dtype), approximate="tanh") @ p["wo2"].to(dtype)
    return x + y


class PPTransformerLM(StackedLM):
    """Decoder-only LM whose blocks are pipeline-sharded over `axis`.

    `n_layers` is the global layer count; each of the `pp_size` stages
    owns `n_layers // pp_size` consecutive blocks, stored as `tp_l{i}_*`
    leaves (the same names on every rank, distinct values). With
    pp_size 1 every layer is local and no collective runs."""

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 128,
        n_heads: int = 8,
        n_layers: int = 4,
        max_len: int = 1024,
        axis: str = "pp",
        pp_size: int = 1,
        n_micro: int = 1,
        dtype: torch.dtype = torch.float32,
        device="meta",
    ):
        super().__init__()
        if n_layers % pp_size:
            raise ValueError(
                f"n_layers {n_layers} not divisible by pp_size {pp_size}")
        if n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {n_micro}")
        kw = dict(dtype=dtype, device=device)
        self.vocab, self.dim, self.n_heads = vocab, dim, n_heads
        self.max_len, self.axis, self.pp_size = max_len, axis, pp_size
        self.n_micro, self.dtype = n_micro, dtype
        #: the axis the `tp_` leaves shard over, and its size
        self.shard_axis, self.shard_size = axis, pp_size
        self.rank_stacked = True
        self.layers_local = n_layers // pp_size
        self.Embed_0 = Embed(vocab, dim, **kw)
        self.Embed_1 = Embed(max_len, dim, **kw)
        shapes = {"ln1_scale": (dim,), "ln1_bias": (dim,),
                  "wqkv": (dim, 3 * dim), "wo": (dim, dim),
                  "ln2_scale": (dim,), "ln2_bias": (dim,),
                  "wi": (dim, 4 * dim), "wo2": (4 * dim, dim)}
        for i in range(self.layers_local):
            for leaf in _STAGE_LEAVES:
                setattr(self, f"tp_l{i}_{leaf}", nn.Parameter(
                    torch.empty(shapes[leaf], device=device)))
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, vocab, **kw)

    def _n_micro(self, b: int) -> int:
        # the GPipe output does not depend on the microbatch count, so a
        # batch of 1 (the JAX init trace) runs unsplit; any other
        # indivisible batch is a configuration error
        if b == 1:
            return 1
        if b % self.n_micro == 0:
            return self.n_micro
        raise ValueError(f"batch {b} not divisible by n_micro {self.n_micro}")

    def forward_stacked(self, params, tokens, topo):
        """Every rank's logits `[R, B, T, vocab]` (float32) from the
        rank-stacked parameters and tokens `[R, B, T]`; returns (logits,
        (): no auxiliary loss)."""
        n_micro = self._n_micro(tokens.shape[1])
        stage_params: List[Dict[str, torch.Tensor]] = [
            {leaf: params[f"tp_l{i}_{leaf}"] for leaf in _STAGE_LEAVES}
            for i in range(self.layers_local)]

        def stage(ps, h):
            for p in ps:
                h = _block_apply(p, h, self.n_heads, self.dtype)
            return h

        run_stage = lambda h: per_rank(stage)(stage_params, h)

        def body(x):
            if self.pp_size == 1:
                return run_stage(x), ()
            r, b = x.shape[:2]
            xm = x.reshape((r, n_micro, b // n_micro) + tuple(x.shape[2:]))
            y = gpipe(run_stage, xm, topo, self.axis).reshape(x.shape)
            last = axis_index(topo, self.axis, x.device) == self.pp_size - 1
            return axis_sum(torch.where(_rows(last, y), y,
                                        torch.zeros_like(y)),
                            topo, self.axis), ()

        return self._stacked(params, tokens, body)
