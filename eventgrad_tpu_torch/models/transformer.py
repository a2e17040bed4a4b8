"""Decoder-only Transformer LM — port of
`eventgrad_tpu/models/transformer.py` (`Block`, `TransformerLM`).

Attention runs in one of four modes:

  * "full"    — exact attention with materialized scores
                (`parallel/ring_attention.full_attention`);
  * "flash"   — the fused flash-attention kernels (`ops/attention.py`);
                `use_flash=True` sends "full" the same way;
  * "ring"    — ring attention over the topology's sequence-parallel
                axis (`sp_axis`, default the first axis): the K/V blocks
                rotate one hop a step, each hop through the flash kernels
                with `use_flash=True`;
  * "ulysses" — all-to-all head-sharded attention over the same axis.

A "ring" or "ulysses" model is rank-stacked (`rank_stacked`): the train
step calls `forward_stacked(params, tokens, topo)` on every rank's
parameters and `[R, B, T_local]` tokens at once, the per-rank pieces
batched with `per_rank`, the attention on the stack along the grid's
`sp` axis. Positions are global: each rank offsets its chunk by its
`sp` index times `T_local`, as the JAX model does.

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

`init_lm_shards` initializes the whole transformer family (this model
and the tensor-, pipeline- and expert-parallel ones of `models/tp.py`,
`pp.py` and `moe.py`, which share `StackedLM`) like flax. Every leaf is
drawn on the CPU, in flax order, from one of two generators: the
replicated leaves once, from one seeded with `seed`, the sharded leaves
(a path component starting with `tp_`) from one seeded with `(seed, 2,
shard)`, `shard` the rank's index along the model's sharded axis. So
replicated leaves come out identical across the whole mesh and sharded
leaves distinct per index of their axis — the contract of the JAX
package's `init_train_state_spmd` with its axis-folded initializer.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.resnet import _TRUNC_STD, Dense
from eventgrad_tpu_torch.parallel.arena import flax_order, is_sharded_leaf
from eventgrad_tpu_torch.parallel.collectives import axis_index
from eventgrad_tpu_torch.parallel.ring_attention import (
    full_attention, ring_attention, ulysses_attention,
)
from eventgrad_tpu_torch.parallel.spmd import per_rank, sub_params

ATTN_MODES = ("full", "flash", "ring", "ulysses")


def _draw_leaf(name: str, shape, gen: torch.Generator) -> torch.Tensor:
    """One leaf initialized like flax: `kernel` leaves (torch layout
    `(out, in)`) and the JAX-layout weights of the pipeline and expert
    models (`(in, out)`, `[e, in, out]`) lecun_normal over their input
    axes, embeddings normal with std 1/sqrt(dim), scales one, biases
    zero."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("scale"):
        return torch.ones(shape)
    if leaf.endswith("bias"):
        return torch.zeros(shape)
    if leaf == "embedding":
        return torch.randn(shape, generator=gen) / math.sqrt(shape[1])
    fan_in = math.prod(shape[1:] if leaf.endswith("kernel") else shape[:-1])
    # flax lecun_normal: a truncated normal of variance 1/fan_in
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def init_lm_shards(
    model: nn.Module, seed: int, shards: Sequence[int], device=None,
) -> List[Dict[str, torch.Tensor]]:
    """The params of a transformer-family model initialized like flax
    (`_draw_leaf`), in flax order and moved to `device`, for each index
    in `shards` of the model's sharded axis. The replicated leaves draw
    once, from `seed`'s generator, and every shard's dict holds the same
    tensors; the sharded leaves (`is_sharded_leaf`) draw per shard, from
    `(seed, 2, shard)`'s."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    order = flax_order(shapes)
    gen = torch.Generator().manual_seed(int(seed))
    shared = {n: _draw_leaf(n, shapes[n], gen).to(device)
              for n in order if not is_sharded_leaf(n)}
    out = []
    for shard in shards:
        sgen = torch.Generator().manual_seed(int(np.random.SeedSequence(
            [int(seed), 2, int(shard)]).generate_state(1)[0]))
        out.append({n: shared[n] if n in shared
                    else _draw_leaf(n, shapes[n], sgen).to(device)
                    for n in order})
    return out


def init_lm_variables(
    model: nn.Module, seed: int = 0, device=None, shard: int = 0,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(params, {}) of a transformer-family model, its sharded leaves
    drawn for index `shard` (`init_lm_shards`)."""
    return init_lm_shards(model, seed, (shard,), device)[0], {}


def fcall(module: nn.Module, params, name: str, *args):
    """Call submodule `name` of `module` on the entries of `params` under
    `name` (a per-rank function's dotted-name dict)."""
    return torch.func.functional_call(
        getattr(module, name), sub_params(params, name), args)


def check_token_input(input_shape, max_len: int) -> None:
    shape = tuple(input_shape)
    if len(shape) != 1 or not 1 <= shape[0] <= max_len:
        raise ValueError(
            f"input_shape {shape} is not one token sequence of at most "
            f"max_len={max_len} positions"
        )


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


def attn_qkv(call, x, n_heads: int):
    """q, k, v `[B, T, H, d]` of a block's input `x` `[B, T, dim]`:
    LayerNorm_0, then the fused Dense_0 projection split into three
    strided views (the flash kernels read them through their strides).
    `call(name, *args)` applies the block's submodule `name`."""
    b, t, dim = x.shape
    qkv = call("Dense_0", call("LayerNorm_0", x))
    return qkv.reshape(b, t, 3 * n_heads, dim // n_heads).split(n_heads,
                                                                  dim=2)


def attn_residual(call, x, o):
    """`x` plus the Dense_1 projection of the attention output `o`."""
    return x + call("Dense_1", o.reshape(x.shape))


def mlp_residual(call, x):
    """`x` plus the 4x GELU MLP (LayerNorm_1, Dense_2, Dense_3) of `x`."""
    y = call("Dense_2", call("LayerNorm_1", x))
    return x + call("Dense_3", F.gelu(y, approximate="tanh"))


class Block(nn.Module):
    """Pre-norm causal self-attention and a 4x GELU MLP, both residual."""

    def __init__(self, dim, n_heads, attn, *, dtype, device, use_flash=False):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dim, self.n_heads = dim, n_heads
        self.attn = attn
        self.flash = attn == "flash" or use_flash
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, 3 * dim, use_bias=False, **kw)
        self.Dense_1 = Dense(dim, dim, use_bias=False, **kw)
        self.LayerNorm_1 = LayerNorm(dim, **kw)
        self.Dense_2 = Dense(dim, 4 * dim, **kw)
        self.Dense_3 = Dense(4 * dim, dim, **kw)

    def _call(self, name, *args):
        return getattr(self, name)(*args)

    def forward(self, x):
        q, k, v = attn_qkv(self._call, x, self.n_heads)
        if self.flash:
            from eventgrad_tpu_torch.ops.attention import flash_attention

            o = flash_attention(q, k, v, causal=True)
        else:
            o = full_attention(q, k, v, causal=True)
        return mlp_residual(self._call, attn_residual(self._call, x, o))

    def forward_stacked(self, p, x, topo, axis: str):
        """The block on every rank at once: `p` the block's rank-stacked
        parameters, `x` `[R, B, T_local, dim]`; the projections per rank
        (`per_rank`), the attention on the stack along grid axis `axis`.
        Returns (x, None: no auxiliary loss)."""
        call = lambda p: functools.partial(fcall, self, p)
        q, k, v = per_rank(lambda p, x: attn_qkv(call(p), x, self.n_heads))(
            p, x)
        attend = ring_attention if self.attn == "ring" else ulysses_attention
        o = attend(q, k, v, topo, axis=axis, causal=True,
                   use_flash=self.flash)

        def finish(p, x, o):
            return mlp_residual(call(p), attn_residual(call(p), x, o))

        return per_rank(finish)(p, x, o), None


class StackedLM(nn.Module):
    """What the transformer family shares: integer token input, the
    flax-like initialization (`init_lm_shards`), and the rank-stacked
    forward — every rank's token and position embeddings, the model's
    body on the `[R, B, T, dim]` stack, then the LayerNorm/Dense head —
    that each model's `forward_stacked` runs with its own body."""

    #: what the training loop feeds `forward`: integer tokens
    input_dtype = np.int64

    def check_input_shape(self, input_shape) -> None:
        check_token_input(input_shape, self.max_len)

    def init_variables(
        self, seed: int = 0, device=None, shard: int = 0,
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(params, batch_stats) initialized like flax, in flax order,
        drawn on the CPU from generators seeded with `seed` and moved to
        `device`, a sharded model's `tp_` leaves for index `shard` of its
        axis (`init_lm_variables`); the statistics are empty (no
        BatchNorm)."""
        return init_lm_variables(self, seed, device, shard)

    def init_shards(self, seed: int, shards: Sequence[int], device=None
                    ) -> List[Dict[str, torch.Tensor]]:
        """The params for each index in `shards` of the sharded axis, the
        replicated leaves drawn once (`init_lm_shards`)."""
        return init_lm_shards(self, seed, shards, device)

    def _stacked(self, params, tokens, body, offset=None):
        """(float32 logits `[R, B, T, vocab]`, the auxiliary losses) from
        the rank-stacked parameters and tokens `[R, B, T]`: `body(x)`
        maps the embedded stack to (x, auxiliary losses); `offset` `[R]`
        is each rank's first global position (zero by default)."""
        r, t = tokens.shape[0], tokens.shape[-1]
        pos = torch.arange(t, device=tokens.device).expand(r, t)
        if offset is not None:
            pos = offset[:, None] + pos

        def embed(p, tok, pos):
            return fcall(self, p, "Embed_0", tok) + fcall(self, p, "Embed_1",
                                                           pos)

        x, aux = body(per_rank(embed)(params, tokens, pos))

        def head(p, x):
            return fcall(self, p, "Dense_0", fcall(self, p, "LayerNorm_0", x))

        return per_rank(head)(params, x).to(torch.float32), aux

    def _blocks(self, params, topo, axis: str):
        """`_stacked`'s body for a model of `block_names`: each block's
        `forward_stacked` in turn along grid axis `axis`; the auxiliary
        losses the blocks return (the MoE blocks' `[R]` losses) in flax
        leaf order, the order the JAX step adds its sown losses."""
        def body(x):
            auxes = {}
            for name in self.block_names:
                x, aux = getattr(self, name).forward_stacked(
                    sub_params(params, name), x, topo, axis)
                if aux is not None:
                    auxes[name] = aux
            return x, tuple(auxes[n] for n in flax_order(auxes))
        return body


class TransformerLM(StackedLM):
    """`forward(tokens, batch_stats, train)` takes integer tokens `[B, T]`
    and returns float32 logits `[B, T, vocab]`, plus an empty statistics
    dict in train mode."""

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 128,
        n_heads: int = 8,
        n_layers: int = 2,
        max_len: int = 1024,
        attn: str = "full",
        topo=None,
        sp_axis: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
        use_flash: bool = False,
        device="meta",
    ):
        super().__init__()
        if attn not in ATTN_MODES:
            raise ValueError(f"unknown attn mode {attn!r}")
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by n_heads {n_heads}")
        kw = dict(dtype=dtype, device=device)
        self.vocab, self.dim, self.max_len = vocab, dim, max_len
        self.attn, self.dtype = attn, dtype
        #: the topology the sequence-parallel modes run over (the train
        #: step refuses another) and their axis
        self.topo, self.sp_axis = topo, sp_axis
        #: ring and Ulysses attention run on every rank at once
        self.rank_stacked = attn in ("ring", "ulysses")
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

    def forward_stacked(self, params, tokens, topo):
        """Every rank's logits `[R, B, T_local, vocab]` (float32) from the
        rank-stacked parameters (dotted names, `[R, ...]` leaves) and
        tokens `[R, B, T_local]`, the sequence sharded over `sp_axis` of
        `topo`; returns (logits, (): no auxiliary loss)."""
        axis = self.sp_axis or topo.axes[0]
        if axis not in topo.axes:
            raise ValueError(f"axis {axis!r} is not an axis of {topo.axes}")
        # global positions: each rank offsets by its index on the SP axis
        offset = axis_index(topo, axis, tokens.device) * tokens.shape[-1]
        return self._stacked(params, tokens,
                             self._blocks(params, topo, axis), offset)

    def forward(self, tokens, batch_stats: Optional[Dict] = None,
                train: bool = False):
        if self.rank_stacked:
            raise ValueError(
                f"attn={self.attn!r} runs rank-stacked over a topology's "
                f"{self.sp_axis or 'first'} axis: call forward_stacked("
                "params, tokens, topo) (the train step does)")
        t = tokens.shape[-1]
        pos = torch.arange(t, device=tokens.device)
        x = self.Embed_0(tokens) + self.Embed_1(pos)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = self.Dense_0(self.LayerNorm_0(x)).to(torch.float32)
        return (x, {}) if train else x
