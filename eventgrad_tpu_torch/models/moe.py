"""Expert parallelism: Mixture-of-Experts layers with all-to-all dispatch.

Port of `eventgrad_tpu/models/moe.py` (`_dispatch_combine`,
`ExpertParallelMLP`, `MoEBlock`, `MoETransformerLM`): the experts of an
MoE MLP shard across a named axis, and tokens reach their experts
through one all-to-all pair along it (`collectives.axis_all_to_all`,
the JAX layer's `lax.all_to_all`).

  * The router is a replicated bias-free Dense in float32;
    top-`n_select` gating with renormalized probabilities, and a
    load-balancing auxiliary loss (the JAX layer sows it into "losses";
    here `forward_stacked` returns it and the train step adds it to the
    objective).
  * Dispatch and combine are dense one-hot tensors of static shape
    `[tokens, experts, capacity]`; tokens beyond an expert's capacity
    are dropped (their combine weight is zero, the residual carries
    them).
  * Expert weights live `ep_size`-way sharded: rank r owns experts
    `[r*E/N, (r+1)*E/N)` as leading slices of `tp_wi` / `tp_wo`
    (`[e_local, d, hidden]` and `[e_local, hidden, d]`, the JAX layout).

Attention in `MoEBlock` is the plain `full_attention`, as in the JAX
block. The model is rank-stacked (`rank_stacked`): `forward_stacked`
runs the per-rank pieces under `per_rank` and the all-to-all pair on the
stack between them.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from eventgrad_tpu_torch.models.resnet import Dense
from eventgrad_tpu_torch.models.transformer import (
    Embed, LayerNorm, StackedLM, attn_qkv, attn_residual, fcall,
)
from eventgrad_tpu_torch.parallel.collectives import axis_all_to_all
from eventgrad_tpu_torch.parallel.ring_attention import full_attention
from eventgrad_tpu_torch.parallel.spmd import per_rank, sub_params


def _top_k(probs: torch.Tensor, k: int):
    """`lax.top_k`: the k largest along the last axis, ties to the lower
    index (a stable descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_combine(probs: torch.Tensor, n_select: int, capacity: int,
                      dtype=torch.float32):
    """Dense dispatch/combine tensors from router probabilities.

    probs: `[S, E]` softmax router output. Returns (dispatch `[S, E, C]`
    in {0, 1}, combine `[S, E, C]` floats, routed `[S, E]` int32
    pre-capacity assignment counts for the load-balancing loss).
    Selection is top-`n_select` per token with the gate weights
    renormalized over the selected experts; capacity is granted in
    selection-priority order (every first choice before any second
    choice), each expert keeping its first `capacity` takers in token
    order."""
    s, e = probs.shape
    gate_vals, gate_idx = _top_k(probs, n_select)  # [S, K]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True),
                                            1e-9)
    experts = torch.arange(e, device=probs.device)
    onehot = (gate_idx.T[..., None] == experts).to(torch.int32)  # [K, S, E]
    flat = onehot.reshape(n_select * s, e)  # priority-major ordering
    pos = torch.cumsum(flat, dim=0, dtype=torch.int32) - flat
    keep = (pos < capacity) & (flat > 0)
    slots = torch.arange(capacity, device=probs.device, dtype=torch.int32)
    slot = (pos[..., None] == slots).to(dtype) * keep[..., None].to(dtype)
    comb = slot * gate_vals.T.reshape(-1)[:, None, None]
    dispatch = slot.reshape(n_select, s, e, capacity).sum(0)
    combine = comb.reshape(n_select, s, e, capacity).sum(0)
    return dispatch, combine, onehot.sum(0, dtype=torch.int32)


class ExpertParallelMLP(nn.Module):
    """MoE feed-forward: top-k routed experts sharded over `axis`;
    input and output `[B, T, D]` per rank."""

    def __init__(self, dim, hidden, n_experts, ep_size=1, n_select=2,
                 capacity_factor=2.0, aux_weight=1e-2, *, dtype, device):
        super().__init__()
        if n_experts % ep_size:
            raise ValueError(
                f"n_experts {n_experts} not divisible by ep_size {ep_size}")
        self.dim, self.hidden, self.n_experts = dim, hidden, n_experts
        self.ep_size, self.n_select = ep_size, n_select
        self.capacity_factor, self.aux_weight = capacity_factor, aux_weight
        self.dtype = dtype
        e_local = n_experts // ep_size
        self.router = Dense(dim, n_experts, use_bias=False,
                            dtype=torch.float32, device=device)
        self.tp_wi = nn.Parameter(torch.empty(e_local, dim, hidden,
                                              device=device))
        self.tp_wo = nn.Parameter(torch.empty(e_local, hidden, dim,
                                              device=device))

    def forward_stacked(self, p, x, topo, axis: str):
        """(`[R, B, T, D]` outputs, `[R]` weighted auxiliary loss)."""
        r, b, t, d = x.shape
        s, e, ep = b * t, self.n_experts, self.ep_size
        e_local = e // ep
        capacity = max(1, math.ceil(self.n_select * s * self.capacity_factor
                                    / e))

        def route(p, x):
            xf = x.reshape(s, d)
            logits = fcall(self, p, "router", xf.to(torch.float32))
            probs = torch.softmax(logits, dim=-1)
            dispatch, combine, routed = _dispatch_combine(
                probs, self.n_select, capacity, torch.float32)
            # GShard load balancing: E * sum_e mean_prob_e * mean_routed_e
            aux = e * torch.sum(probs.mean(0) * (
                routed.to(torch.float32) / self.n_select).mean(0))
            xin = torch.einsum("sec,sd->ecd", dispatch.to(x.dtype), xf)
            return xin, combine, self.aux_weight * aux

        xin, combine, aux = per_rank(route)(p, x)  # xin [R, E, C, D]
        if ep > 1:
            # each owner rank's expert block to its owner; my experts'
            # tokens from every source: [R, src, e_local, C, D]
            xin = axis_all_to_all(xin.reshape(r, ep, e_local, capacity, d),
                                  topo, axis)
            xin = xin.transpose(1, 2).reshape(r, e_local, ep * capacity, d)

        def experts(p, xin):
            h = torch.einsum("ecd,edh->ech", xin, p["tp_wi"].to(self.dtype))
            h = F.gelu(h, approximate="tanh")
            return torch.einsum("ech,ehd->ecd", h, p["tp_wo"].to(self.dtype))

        out = per_rank(experts)(p, xin)
        if ep > 1:
            # the expert outputs back to the token owners
            out = out.reshape(r, e_local, ep, capacity, d).transpose(1, 2)
            out = axis_all_to_all(out.contiguous(), topo, axis).reshape(
                r, e, capacity, d)
        y = torch.einsum("rsec,recd->rsd", combine.to(out.dtype), out)
        return y.reshape(r, b, t, d), aux


class MoEBlock(nn.Module):
    """Pre-LN Transformer block whose MLP is an expert-parallel MoE."""

    def __init__(self, dim, n_heads, n_experts, ep_size, n_select=2,
                 capacity_factor=2.0, *, dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dim, self.n_heads = dim, n_heads
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, 3 * dim, use_bias=False, **kw)
        self.Dense_1 = Dense(dim, dim, use_bias=False, **kw)
        self.LayerNorm_1 = LayerNorm(dim, **kw)
        self.ExpertParallelMLP_0 = ExpertParallelMLP(
            dim, 4 * dim, n_experts, ep_size, n_select, capacity_factor,
            **kw)

    def forward_stacked(self, p, x, topo, axis: str):
        """(`[R, B, T, D]` outputs, `[R]` weighted auxiliary loss)."""
        def attn(p, x):
            call = functools.partial(fcall, self, p)
            q, k, v = attn_qkv(call, x, self.n_heads)
            x = attn_residual(call, x, full_attention(q, k, v, causal=True))
            return x, call("LayerNorm_1", x)

        x, y = per_rank(attn)(p, x)
        y, aux = self.ExpertParallelMLP_0.forward_stacked(
            sub_params(p, "ExpertParallelMLP_0"), y, topo, axis)
        return x + y, aux


class MoETransformerLM(StackedLM):
    """Decoder-only LM with MoE blocks; attention and embeddings
    replicated (they gossip normally across dp), experts sharded over
    the EP axis."""

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 128,
        n_heads: int = 8,
        n_layers: int = 2,
        n_experts: int = 8,
        max_len: int = 1024,
        axis: str = "ep",
        ep_size: int = 1,
        n_select: int = 2,
        capacity_factor: float = 2.0,
        dtype: torch.dtype = torch.float32,
        device="meta",
    ):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by n_heads {n_heads}")
        kw = dict(dtype=dtype, device=device)
        self.vocab, self.dim, self.max_len = vocab, dim, max_len
        self.axis, self.ep_size, self.dtype = axis, ep_size, dtype
        #: the axis the `tp_` leaves shard over, and its size
        self.shard_axis, self.shard_size = axis, ep_size
        self.rank_stacked = True
        self.Embed_0 = Embed(vocab, dim, **kw)
        self.Embed_1 = Embed(max_len, dim, **kw)
        self.block_names = []
        for i in range(n_layers):
            name = f"MoEBlock_{i}"
            setattr(self, name, MoEBlock(dim, n_heads, n_experts, ep_size,
                                         n_select, capacity_factor, **kw))
            self.block_names.append(name)
        self.LayerNorm_0 = LayerNorm(dim, **kw)
        self.Dense_0 = Dense(dim, vocab, **kw)

    def forward_stacked(self, params, tokens, topo):
        """(every rank's logits `[R, B, T, vocab]` in float32, the tuple
        of the layers' `[R]` weighted auxiliary losses in flax leaf
        order, the order the JAX step adds its sown losses)."""
        return self._stacked(params, tokens,
                             self._blocks(params, topo, self.axis))
