"""Sequence/context parallelism: ring attention + Ulysses all-to-all.

Port of `eventgrad_tpu/parallel/ring_attention.py`: `full_attention`
(the plain softmax attention, and the plain version of
`ops/attention.flash_attention`), `_block_attend`, `_online_merge`,
`ring_attention` and `ulysses_attention`.

The JAX package writes the two sequence-parallel functions per rank and
lifts them over a named axis; here they take **rank-stacked shards**
`[R, B, T_local, H, D]` holding every rank of the topology, like every
other rank-stacked quantity of the port, and run along one axis of its
grid (`axis`, default the first): the rank with index i on that axis
owns positions `[i*T_local, (i+1)*T_local)` of its group's sequence, so
on a `dp x sp` mesh each dp replica's sequence is sharded over `sp`.

  * `lax.ppermute` of the K/V blocks is `collectives.recv_from` along
    the axis, a `torch.roll` of that grid dimension;
  * `lax.axis_index` is `collectives.axis_index`;
  * `lax.all_to_all` is `collectives.axis_all_to_all`.

On a topology lifted onto a device mesh the shards are this process's
rows, and a K/V hop whose source another process holds crosses the
process boundary (`parallel/spmd.hop`, whose backward sends the
gradient back along the inverse offset).

With `use_flash=True` the ring runs each hop through
`ops/attention.flash_attention_lse` — the ranks folded into the kernel's
batch, one (q_offset, k_offset) pair per rank — and merges the hops by
`logaddexp`, so no `[B, H, T/N, T/N]` score block reaches device memory.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from eventgrad_tpu_torch.parallel.collectives import (
    axis_all_to_all, axis_index, recv_from,
)
from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Topology


def _block_attend(q, k, v, bias):
    """Scaled dot-product scores of a Q block against one KV block.

    q: [..., Tq, H, D], k/v: [..., Tk, H, D]; bias broadcastable to
    [..., H, Tq, Tk]. Returns the scores [..., H, Tq, Tk] in float32 (at
    least), ready for the online-softmax merge.
    """
    ct = torch.promote_types(q.dtype, torch.float32)
    scores = torch.einsum("...qhd,...khd->...hqk", q.to(ct), k.to(ct))
    scores = scores * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        scores = scores + bias
    return scores


def _online_merge(m, l, o, scores, v):
    """Numerically-stable streaming softmax accumulation (the flash
    recurrence): fold one block's scores/values into running (max m
    [..., H, Tq], denominator l, unnormalized output o [..., Tq, H, D])."""
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("...hqk,...khd->...qhd", p.to(v.dtype).to(p.dtype),
                      v.to(p.dtype))
    o_new = o * correction.transpose(-1, -2)[..., None] + pv
    return m_new, l_new, o_new


def _causal_bias(q_pos, k_pos):
    """0 where `q_pos >= k_pos`, -inf elsewhere: [..., Tq, Tk]."""
    mask = q_pos[..., :, None] >= k_pos[..., None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(mask, zero, -math.inf)


def _sp_axis(topo: Topology, axis: Optional[str], x: torch.Tensor
             ) -> Tuple[str, int]:
    """(the sequence-parallel axis, its size): `axis`, or the first axis
    of the topology as the JAX functions take it."""
    axis = axis or topo.axes[0]
    if axis not in topo.axes:
        raise ValueError(f"axis {axis!r} is not an axis of {topo.axes}")
    if x.dim() != 5 or x.shape[0] != topo.n_local:
        raise ValueError(
            f"expected rank-stacked shards [{topo.n_local}, B, T_local, H, "
            f"D], got {tuple(x.shape)}"
        )
    return axis, topo.axis_size(axis)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    topo: Topology,
    axis: Optional[str] = None,
    causal: bool = False,
    use_flash: bool = False,
) -> torch.Tensor:
    """Exact attention over a sequence sharded on a ring axis.

    q/k/v: rank-stacked shards [R, B, T_local, H, D]; along `axis` (N
    ranks) the sequence length is T_local * N. Each rank keeps its Q
    shard and the (K, V) shards rotate one hop per step along the axis.
    Returns the stacked output shards [R, B, T_local, H, D] (q.dtype).

    use_flash=True computes each hop with the flash-attention kernel (out
    + logsumexp, global-position causal offsets per rank) and folds the
    hops together with the two-way online-softmax merge.
    """
    axis, n = _sp_axis(topo, axis, q)
    nb = NeighborSpec(axis, -1)  # KV block arrives from the left
    r, b, t_local, h, d = q.shape
    dev = q.device
    rank = axis_index(topo, axis, dev)
    k_cur, v_cur = k, v

    if use_flash:
        from eventgrad_tpu_torch.ops.attention import flash_attention_lse

        fold = lambda x: x.reshape((r * b,) + tuple(x.shape[2:]))
        o = torch.zeros((r, b, t_local, h, d), dtype=torch.float32, device=dev)
        lse = torch.full((r, b, t_local, h), -math.inf, dtype=torch.float32,
                         device=dev)
        for step in range(n):
            src = (rank - step) % n
            o_blk, lse_blk = flash_attention_lse(
                fold(q), fold(k_cur), fold(v_cur), causal=causal,
                q_offset=rank * t_local, k_offset=src * t_local,
            )
            o_blk = o_blk.reshape(q.shape).to(torch.float32)
            lse_blk = lse_blk.reshape(lse.shape)
            lse_new = torch.logaddexp(lse, lse_blk)
            w_old = torch.exp(lse - lse_new)[..., None]
            w_blk = torch.exp(lse_blk - lse_new)[..., None]
            o = o * w_old + o_blk * w_blk
            lse = lse_new
            k_cur, v_cur = (recv_from(x, topo, nb) for x in (k_cur, v_cur))
        return o.to(q.dtype)

    ct = torch.promote_types(q.dtype, torch.float32)
    m = torch.full((r, b, h, t_local), -math.inf, dtype=ct, device=dev)
    l = torch.zeros((r, b, h, t_local), dtype=ct, device=dev)
    o = torch.zeros((r, b, t_local, h, d), dtype=ct, device=dev)
    pos = torch.arange(t_local, device=dev)
    for step in range(n):
        # after `step` hops the resident KV block originated at rank r-step
        src = (rank - step) % n
        bias = None
        if causal:
            q_pos = rank[:, None] * t_local + pos
            k_pos = src[:, None] * t_local + pos
            bias = _causal_bias(q_pos, k_pos)[:, None, None]
        scores = _block_attend(q, k_cur, v_cur, bias)
        m, l, o = _online_merge(m, l, o, scores, v_cur)
        k_cur, v_cur = (recv_from(x, topo, nb) for x in (k_cur, v_cur))
    # guard fully-masked rows (can't happen for causal with aligned shards,
    # but keeps the primitive total)
    l = torch.clamp(l, min=1e-30)
    out = o / l.transpose(-1, -2)[..., None]
    return out.to(q.dtype)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    topo: Topology,
    axis: Optional[str] = None,
    causal: bool = False,
    use_flash: bool = False,
) -> torch.Tensor:
    """DeepSpeed-Ulysses-style SP on rank-stacked shards [R, B, T_local,
    H, D] along `axis` (N ranks): all-to-all from sequence-sharded to
    head-sharded, full local attention, all-to-all back. Requires
    H % N == 0.

    use_flash=True runs the local attention through the flash-attention
    kernel: after the all-to-all each rank holds full-sequence causal
    self-attention over its head shard, which is the kernel's contract."""
    axis, n = _sp_axis(topo, axis, q)
    r, b, t_local, h, d = q.shape
    if h % n != 0:
        raise ValueError(f"n_heads {h} not divisible by axis size {n}")
    hn, t = h // n, t_local * n

    def seq_to_heads(x):
        # [R, B, T/N, H, D] -> [R, B, T, H/N, D]: head chunk i ships to
        # the axis's rank i, received shards concatenate in rank order
        # along the sequence
        x = x.reshape(r, b, t_local, n, hn, d).permute(0, 3, 1, 2, 4, 5)
        x = axis_all_to_all(x, topo, axis)  # [R, N(src), B, T/N, H/N, D]
        return x.permute(0, 2, 1, 3, 4, 5).reshape(r, b, t, hn, d)

    def heads_to_seq(x):
        # [R, B, T, H/N, D] -> [R, B, T/N, H, D]
        x = x.reshape(r, b, n, t_local, hn, d).permute(0, 2, 1, 3, 4, 5)
        x = axis_all_to_all(x, topo, axis)  # [R, N(src), B, T/N, H/N, D]
        return x.permute(0, 2, 3, 1, 4, 5).reshape(r, b, t_local, h, d)

    qg, kg, vg = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    if use_flash:
        from eventgrad_tpu_torch.ops.attention import flash_attention

        fold = lambda x: x.reshape(r * b, t, hn, d)
        out = flash_attention(fold(qg), fold(kg), fold(vg), causal=causal)
        return heads_to_seq(out.reshape(qg.shape))
    bias = None
    if causal:
        pos = torch.arange(t, device=q.device)
        bias = _causal_bias(pos, pos)
    scores = _block_attend(qg, kg, vg, bias)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = (p / p.sum(-1, keepdim=True)).to(vg.dtype)
    out = torch.einsum("...hqk,...khd->...qhd", p.to(scores.dtype),
                       vg.to(scores.dtype))
    return heads_to_seq(out.to(q.dtype))


def full_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False,
) -> torch.Tensor:
    """Single-rank attention on [B, T, H, D] with materialized scores: the
    plain version of `ops/attention.flash_attention`."""
    t, s = q.shape[-3], k.shape[-3]
    bias = None
    if causal:
        bias = _causal_bias(torch.arange(t, device=q.device),
                            torch.arange(s, device=q.device))
    scores = _block_attend(q, k, v, bias)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("...hqk,...khd->...qhd", p.to(scores.dtype),
                       v.to(scores.dtype))
    return out.to(q.dtype)
