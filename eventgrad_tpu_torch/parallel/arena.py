"""Flat parameter arena: cached leaf metadata + flat views.

Port of `eventgrad_tpu/parallel/arena.py` (`ArenaSpec` with its
leaf-aligned `buckets`, `BucketSpec`, `arena_spec`, `carrier_dtype`,
`carrier_needs_scales`, `alloc_event_bufs` and `alloc_event_queue` for
f32 and carrier residency, monolithic or per bucket). The buckets serve
the bucketed gossip schedule (`train/steps.py`, `bucketed=K`) and the
partitioned trigger policies' geometry (`parallel/policy.py`).

Every rank-stacked quantity of the gossip hot path — parameters,
gradients, momentum trace, neighbor buffers — is ONE `[R, n]` f32
tensor. Leaves sit in the reference's leaf order: `jax.tree.flatten` of
the flax parameter dict, which sorts keys at every level, so
`BasicBlock_10` comes before `BasicBlock_2`. The `[L]` event-state
vectors are indexed by the same order. Inside a segment each leaf is
raveled in its torch layout (OIHW convolutions, `(out, in)` dense), so
sizes, starts and the segment map equal the JAX spec's while the
elements within a leaf follow torch's layout; `convert.py` maps leaves
between the two layouts.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn


def flax_axes(name: str, ndim: int) -> Optional[Tuple[int, ...]]:
    """The permutation of a torch-layout leaf's axes that gives flax's
    layout (None where they agree): convolution kernels OIHW -> HWIO,
    dense kernels `(out, in)` -> `(in, out)`."""
    if not name.endswith("kernel"):
        return None
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim)


def flax_order(names: Iterable[str]) -> Tuple[str, ...]:
    """Dotted parameter names ("BasicBlock_0.Conv_0.kernel") in the
    order `jax.tree.flatten` visits the same leaves of the nested flax
    dict: sorted by key at every level, i.e. by the path tuple."""
    return tuple(sorted(names, key=lambda s: tuple(s.split("."))))


def is_sharded_leaf(name: str) -> bool:
    """A leaf sharded over the model's parallel axis: a path component
    starts with `tp_` (the JAX package's convention, `train/steps.py`)."""
    return any(part.startswith("tp_") for part in name.split("."))


@dataclasses.dataclass(frozen=True)
class ArenaSpec:
    """Static leaf-major layout of one parameter structure (plain Python,
    hashable, computed once per structure and cached)."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    starts: Tuple[int, ...]
    n_total: int

    @property
    def n_leaves(self) -> int:
        return len(self.sizes)

    @property
    def floor(self) -> int:
        """The largest leaf: the smallest legal compact capacity."""
        return max(self.sizes) if self.sizes else 0

    def buckets(self, k: int) -> Tuple["BucketSpec", ...]:
        """Up to `k` contiguous leaf-aligned buckets of the arena: each
        interior cut lands on the leaf edge nearest `i * n_total / k`
        (ties to the earlier edge), every bucket keeps at least one
        leaf, and `k` clamps to the leaf count. Cached per (spec, k)."""
        return _buckets_cached(self, int(k))

    def sizes_tensor(self, device=None) -> torch.Tensor:
        """[L] int32 leaf sizes on `device` (cached: read only)."""
        return _device_constants(self.sizes, torch.device(device or "cpu"))[1]

    def seg_expand(self, device=None) -> torch.Tensor:
        """[n_total] int64 leaf index per flat position (the values of the
        JAX spec's `seg_expand`; int64 because torch indexes with it).
        Cached per device: read only."""
        return _device_constants(self.sizes, torch.device(device or "cpu"))[0]

    def ravel(self, tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One contiguous arena from a dict of leaves. Leading dimensions
        beyond the leaf shape (the rank dimension) are kept: leaves of
        shape `[R, *shape]` give an `[R, n_total]` arena."""
        pieces = []
        for name, shape in zip(self.names, self.shapes):
            x = tree[name]
            lead = tuple(x.shape[: x.dim() - len(shape)])
            pieces.append(x.reshape(lead + (-1,)))
        return torch.cat(pieces, dim=-1)

    def leaf_views(self, flat: torch.Tensor):
        """Per-leaf slices of the arena's last dimension (views, no copy)."""
        return [flat.narrow(-1, s, z) for s, z in zip(self.starts, self.sizes)]

    def unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Dict of per-leaf views `[*lead, *shape]` into the arena."""
        lead = tuple(flat.shape[:-1])
        return {
            name: v.reshape(lead + shape)
            for name, v, shape in zip(
                self.names, self.leaf_views(flat), self.shapes
            )
        }


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One contiguous leaf-aligned segment of an arena: leaves `[lo, hi)`
    of the parent spec, elements `[start, start + size)`, the
    bucket-local leaf sizes and starts (`starts_rel[0] == 0`), and
    `floor`, its largest leaf."""

    index: int
    lo: int
    hi: int
    start: int
    size: int
    sizes: Tuple[int, ...]
    starts_rel: Tuple[int, ...]
    floor: int

    @property
    def n_leaves(self) -> int:
        return self.hi - self.lo

    def sizes_tensor(self, device=None) -> torch.Tensor:
        """[L_b] int32 bucket-local leaf sizes (cached: read only)."""
        return _device_constants(self.sizes,
                                 torch.device(device or "cpu"))[1]

    def seg_expand(self, device=None) -> torch.Tensor:
        """[size] int64 bucket-local leaf index (0 .. L_b - 1) per element
        of the bucket (cached per device: read only)."""
        return _device_constants(self.sizes,
                                 torch.device(device or "cpu"))[0]


@functools.lru_cache(maxsize=256)
def _buckets_cached(spec: ArenaSpec, k: int) -> Tuple[BucketSpec, ...]:
    n_leaves = spec.n_leaves
    k = max(1, min(int(k), n_leaves))
    ends = [s + z for s, z in zip(spec.starts, spec.sizes)]
    cuts, prev = [], 0
    for i in range(1, k):
        target = i * spec.n_total / k
        # the leaf edge nearest the target, leaving every later bucket
        # at least one leaf
        lo_c, hi_c = prev + 1, n_leaves - (k - i)
        prev = min(range(lo_c, hi_c + 1),
                   key=lambda c: (abs(ends[c - 1] - target), c))
        cuts.append(prev)
    bounds = [0] + cuts + [n_leaves]
    out = []
    for b in range(k):
        lo, hi = bounds[b], bounds[b + 1]
        sizes = spec.sizes[lo:hi]
        base = spec.starts[lo]
        out.append(BucketSpec(
            index=b, lo=lo, hi=hi, start=base, size=int(sum(sizes)),
            sizes=sizes, starts_rel=tuple(s - base for s in spec.starts[lo:hi]),
            floor=max(sizes),
        ))
    return tuple(out)


@functools.lru_cache(maxsize=16)
def _device_constants(sizes: Tuple[int, ...], device: torch.device):
    """(segment map, sizes) of one leaf layout on one device, built once."""
    sizes_t = torch.tensor(sizes, dtype=torch.int32, device=device)
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), device=device), sizes_t.long(),
        output_size=sum(sizes),
    )
    return seg, sizes_t


@functools.lru_cache(maxsize=16)
def flax_positions(spec: "ArenaSpec", device=None) -> torch.Tensor:
    """`[n_total]` int64: the arena position of each element of the JAX
    package's flat arena, whose leaves are raveled in flax's layout —
    `flat[:, flax_positions(spec)]` is the JAX arena. Cached per device:
    read only."""
    pieces = []
    for name, shape, start, size in zip(spec.names, spec.shapes, spec.starts,
                                        spec.sizes):
        idx = torch.arange(start, start + size).reshape(shape)
        axes = flax_axes(name, len(shape))
        if axes is not None:
            idx = idx.permute(axes)
        pieces.append(idx.reshape(-1))
    return torch.cat(pieces).to(device)


@functools.lru_cache(maxsize=64)
def _spec_cached(items: Tuple[Tuple[str, Tuple[int, ...]], ...]) -> ArenaSpec:
    names = tuple(n for n, _ in items)
    shapes = tuple(s for _, s in items)
    sizes = tuple(int(math.prod(s)) if s else 1 for s in shapes)
    starts, acc = [], 0
    for z in sizes:
        starts.append(acc)
        acc += z
    return ArenaSpec(
        names=names,
        shapes=shapes,
        sizes=sizes,
        starts=tuple(starts),
        n_total=acc,
    )


def arena_spec(tree: Any) -> ArenaSpec:
    """The cached ArenaSpec of a model's parameters (an `nn.Module`) or of
    a dict mapping parameter names to per-rank shapes or tensors."""
    if isinstance(tree, nn.Module):
        shapes = {n: tuple(p.shape) for n, p in tree.named_parameters()}
    else:
        shapes = {
            n: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for n, v in tree.items()
        }
    return _spec_cached(tuple((n, shapes[n]) for n in flax_order(shapes)))


#: wire codes that have a resident carrier cheaper than f32
_CARRIER_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8}


def carrier_dtype(wire) -> "Optional[torch.dtype]":
    """Resident dtype for a wire code — the carrier the bytes crossed the
    wire in (bf16 -> bfloat16, int8 -> int8) — or None when the buffers
    stay f32 (the f32 wire has no cheaper carrier)."""
    return _CARRIER_DTYPES.get(wire)


def carrier_needs_scales(wire) -> bool:
    """int8 carriers dequantize through per-leaf f32 scales; bf16
    dequant is a pure (exact) upcast and needs none."""
    return wire == "int8"


def alloc_event_bufs(
    spec: ArenaSpec, n_neighbors: int, n_ranks: int, *, wire=None,
    device=None, buckets: int = 1,
):
    """The arena EventState.bufs allocation site. Returns `(bufs,
    buf_scales)`: per-neighbor zero `[R, n]` receive buffers in the
    resident dtype — f32, or the wire carrier under carrier residency
    (`wire` = "bf16" | "int8") — plus per-neighbor `[R, L]` f32 dequant
    scales starting at 1.0 (int8 carrier only, else None). A zero carrier
    dequantizes to exactly +0.0 under every scale, so the zero init is
    bitwise the f32 zero init (the reference's zero RMA window).
    `buckets=K` (K >= 2) gives the JAX package's per-bucket layout of the
    bucketed schedule: per neighbor a tuple of `[R, n_b]` buffers (and of
    `[R, L_b]` scales), one per bucket of `spec.buckets(K)`."""
    dt = carrier_dtype(wire) or torch.float32
    k = int(buckets) if buckets else 1
    scaled = carrier_needs_scales(wire)

    def one():
        if k > 1:
            return tuple(torch.zeros((n_ranks, b.size), dtype=dt,
                                     device=device)
                         for b in spec.buckets(k))
        return torch.zeros((n_ranks, spec.n_total), dtype=dt, device=device)

    def one_scale():
        if k > 1:
            return tuple(torch.ones((n_ranks, b.n_leaves),
                                    dtype=torch.float32, device=device)
                         for b in spec.buckets(k))
        return torch.ones((n_ranks, spec.n_leaves), dtype=torch.float32,
                          device=device)

    bufs = tuple(one() for _ in range(int(n_neighbors)))
    if not scaled:
        return bufs, None
    return bufs, tuple(one_scale() for _ in range(int(n_neighbors)))


def alloc_event_queue(
    spec: ArenaSpec, n_neighbors: int, n_ranks: int, depth: int, *,
    wire=None, device=None, buckets: int = 1,
):
    """The bounded-async delivery queues (`EventState.pending` for
    staleness=D >= 2), allocated through `alloc_event_bufs` so the
    carrier layout is declared in one place. Per neighbor, `depth` slots
    of

        (candidate, eff fire bits, sent pass, late count[, scales])

    where the candidate (and the int8 carrier's dequant scales) take the
    receive buffers' own layout — `[R, n]`, or the per-bucket tuple under
    `buckets=K`, in the wire dtype under carrier residency — the eff bits
    are bool `[R, L]` (per-bucket `[R, L_b]`), and the sent pass and late
    count int32 `[R]`. An empty slot (eff all False, sent pass 0) commits
    nothing, so the zero init is the empty queue. Every slot holds its
    own tensors."""
    k = int(buckets) if buckets else 1

    def eff0():
        if k > 1:
            return tuple(torch.zeros((n_ranks, b.n_leaves), dtype=torch.bool,
                                     device=device)
                         for b in spec.buckets(k))
        return torch.zeros((n_ranks, spec.n_leaves), dtype=torch.bool,
                           device=device)

    def slot():
        bufs, scales = alloc_event_bufs(spec, 1, n_ranks, wire=wire,
                                        device=device, buckets=k)
        stamp = lambda: torch.zeros((n_ranks,), dtype=torch.int32,
                                    device=device)
        out = (bufs[0], eff0(), stamp(), stamp())
        return out if scales is None else out + (scales[0],)

    return tuple(
        tuple(slot() for _ in range(int(depth)))
        for _ in range(int(n_neighbors))
    )
