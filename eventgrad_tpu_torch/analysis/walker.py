"""Tracing the step into an ATen graph, and counting its nodes.

Port of `eventgrad_tpu/analysis/walker.py`. `trace` is the counterpart of
`jax.make_jaxpr`: `make_fx` in real mode records every ATen op (and every
`eg::` kernel op) the step dispatches, while the same call computes its
results, so an audit reads the step's metrics from the traced run
itself. The step's arguments and results are dataclasses, dicts and
tuples of tensors (`TrainState`, `EventState`, the metrics): they are
flattened to tensors at the boundary and rebuilt inside.

`iter_nodes` walks every node, into nested graph modules; `count_ops`,
`op_census` and `count_full_ravels` are the op accounting the audit's
hygiene checks are made of, and `bucket_schedule` the machine check of
the bucketed schedule's emission order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
from torch.fx.experimental.proxy_tensor import (
    disable_proxy_modes_tracing, get_proxy_mode, make_fx,
)
from torch.fx.passes.shape_prop import _extract_tensor_metadata
from torch.overrides import TorchFunctionMode


def flatten(obj: Any) -> Tuple[List[torch.Tensor], Callable]:
    """(tensor leaves, rebuild): the tensors of a structure of
    dataclasses, dicts, tuples and lists in field order, and a function
    that puts a list of the same length back in their places. Anything
    else is a constant leaf that stays as it is."""
    if isinstance(obj, torch.Tensor):
        return [obj], lambda xs: xs[0]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = [f.name for f in dataclasses.fields(obj)]
        kids = [flatten(getattr(obj, n)) for n in names]

        def rebuild(xs):
            vals = _split(kids, xs)
            return dataclasses.replace(obj, **dict(zip(names, vals)))
    elif isinstance(obj, dict):
        keys = list(obj)
        kids = [flatten(obj[k]) for k in keys]

        def rebuild(xs):
            return dict(zip(keys, _split(kids, xs)))
    elif isinstance(obj, (tuple, list)):
        kids = [flatten(v) for v in obj]

        def rebuild(xs):
            return type(obj)(_split(kids, xs))
    else:
        return [], lambda xs: obj
    return [t for leaves, _ in kids for t in leaves], rebuild


def _split(kids, xs):
    out, i = [], 0
    for leaves, rebuild in kids:
        out.append(rebuild(xs[i:i + len(leaves)]))
        i += len(leaves)
    return out


@dataclasses.dataclass
class Trace:
    """A traced call: the ATen graph and the call's real result."""

    graph: torch.fx.GraphModule
    out: Any


class _DrawsAsConstants(TorchFunctionMode):
    """Run the step's draws from a `torch.Generator` (dropout keep bits,
    augmentation) outside the trace: they enter the graph as constants,
    as values that depend on no argument (and fx cannot record a
    generator argument)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(kwargs.get("generator"), torch.Generator):
            with disable_proxy_modes_tracing():
                return func(*args, **kwargs)
        return func(*args, **kwargs)


def trace(fn: Callable, *args) -> Trace:
    """Trace `fn(*args)` into an ATen `GraphModule` with `make_fx`
    (`tracing_mode="real"`): the call runs once, on the arguments' device,
    and its result comes back beside the graph. A read of a tensor into
    Python (`.item()`) is recorded, not refused: the audit counts it.

    Each recorded node carries the step phase it was recorded in
    (`obs.costmodel.phase_scope`, entered by the step's `_phase`) as
    `node.meta["eg_phase"]`: at every phase change the last node of the
    graph so far is marked, and after the trace the labels are laid
    along the graph's nodes in order (the order they were recorded
    in)."""
    from eventgrad_tpu_torch.obs import costmodel

    leaves, rebuild = flatten(args)
    result = {}
    marks = {}

    def on_phase(label):
        mode = get_proxy_mode()
        if mode is not None:
            marks[next(iter(reversed(mode.tracer.graph.nodes)))] = label

    def flat_fn(*xs):
        with _DrawsAsConstants():
            out = fn(*rebuild(list(xs)))
        out_leaves, out_rebuild = flatten(out)
        result["leaves"], result["rebuild"] = out_leaves, out_rebuild
        return out_leaves

    start = costmodel.current_phase()
    with costmodel.listening(on_phase):
        gm = make_fx(flat_fn, tracing_mode="real",
                     _error_on_data_dependent_ops=False)(*leaves)
    label = start
    for node in gm.graph.nodes:
        if label is not None:
            node.meta[costmodel.META_KEY] = label
        label = marks.get(node, label)
    for node in gm.graph.nodes:
        # tensors the step closed over (cached constants) enter as
        # attributes; give them the metadata the op nodes carry
        if node.op == "get_attr" and "tensor_meta" not in node.meta:
            val = getattr(gm, node.target, None)
            if isinstance(val, torch.Tensor):
                node.meta["tensor_meta"] = _extract_tensor_metadata(val)
    return Trace(gm, result["rebuild"](result["leaves"]))


def op_name(node: torch.fx.Node) -> Optional[str]:
    """`namespace::name` of a call node's operator (`aten::add`,
    `eg::masked_wire`), the Python name of any other callable
    (`getitem`), None for a node that calls nothing."""
    if node.op != "call_function":
        return None
    t = node.target
    if isinstance(t, torch._ops.OpOverload):
        return t._schema.name
    return getattr(t, "__name__", str(t))


def sub_graphs(gm: torch.fx.GraphModule) -> Iterator[Tuple[str, torch.fx.GraphModule]]:
    """Graph modules nested in `gm` (the bodies of higher-order ops)."""
    for name, mod in gm.named_children():
        if isinstance(mod, torch.fx.GraphModule):
            yield name, mod


def iter_nodes(
    gm: torch.fx.GraphModule, path: Tuple[str, ...] = ()
) -> Iterator[Tuple[torch.fx.Node, Tuple[str, ...]]]:
    """(node, path) for every node, depth-first into nested graph
    modules; `path` names the enclosing submodules."""
    for node in gm.graph.nodes:
        yield node, path
    for name, sub in sub_graphs(gm):
        yield from iter_nodes(sub, path + (name,))


def count_ops(gm: torch.fx.GraphModule, name: Optional[str] = None) -> int:
    """Call nodes in all (or the calls of operator `name`, as `op_name`
    spells it), nested graphs included."""
    return sum(
        1 for node, _ in iter_nodes(gm)
        if node.op == "call_function" and (name is None
                                           or op_name(node) == name)
    )


def op_census(gm: torch.fx.GraphModule) -> dict:
    """{operator: count} over every call node (the inventory the audit
    CLI prints with `--census`)."""
    out: dict = {}
    for node, _ in iter_nodes(gm):
        name = op_name(node)
        if name is not None:
            out[name] = out.get(name, 0) + 1
    return out


def count_full_ravels(gm: torch.fx.GraphModule, n_total: int) -> int:
    """Concatenations that materialize a full `[..., n_total]` model
    buffer: the per-step footprint of a flatten of the parameter tree.
    The rank-stacked buffer is `[R, n_total]`, so the check reads the
    trailing dimension. A model buffer holds floating-point values: an
    integer index over the arena (a cached position map built on the
    step's first call) is not one."""
    total = 0
    for node, _ in iter_nodes(gm):
        if op_name(node) != "aten::cat":
            continue
        tm = node.meta.get("tensor_meta")
        if (tm is not None and len(tm.shape) and tm.shape[-1] == n_total
                and tm.dtype.is_floating_point):
            total += 1
    return total


#: the commit + mix + SGD tails of the bucketed schedule: the pitched
#: forms of kernels 1 and 5
_BUCKET_TAILS = ("eg::fused_mix_commit_bucket",
                 "eg::fused_mix_commit_carrier_bucket")


def _last_dim(node: torch.fx.Node) -> Optional[int]:
    tm = node.meta.get("tensor_meta")
    if isinstance(tm, (list, tuple)) and tm and not hasattr(tm, "shape"):
        tm = tm[0]
    shape = getattr(tm, "shape", None)
    return int(shape[-1]) if shape is not None and len(shape) == 2 else None


def bucket_schedule(gm: torch.fx.GraphModule, wire_dims, commit_dims) -> dict:
    """Machine check of the bucketed schedule's emission order (the JAX
    walker's gate): in the traced step, at least one exchange-side op of
    bucket k must appear between update-side ops of buckets k-1 and k+1
    — the exchanges interleave with the update work instead of forming
    one prefix block (the monolithic shape).

    Exchange-side: an `aten::roll` of a `[R, d]` lane (the rank-dim roll
    of `collectives.recv_from`) with d == wire_dims[b], the bucket's value
    lane. Update-side: a bucket tail (the pitched kernel ops) whose `[R,
    d]` candidates have d == commit_dims[b], after the bucket's
    first exchange (a tail consumes its exchange and never precedes it).
    Each list must be collision-free or the attribution is refused.
    Returns {"exchange": {b: [ordinal, ...]}, "update": {...},
    "interleaved": bool, "witnesses": [(k, ordinal), ...]}."""
    wire_dims = [int(d) for d in wire_dims]
    commit_dims = [int(d) for d in commit_dims]
    if len(set(wire_dims)) != len(wire_dims):
        raise ValueError(f"wire_dims collide: {wire_dims}")
    if len(set(commit_dims)) != len(commit_dims):
        raise ValueError(f"commit_dims collide: {commit_dims}")
    k = len(wire_dims)
    ex = {b: [] for b in range(k)}
    upd = {b: [] for b in range(k)}
    for ordinal, (node, _) in enumerate(iter_nodes(gm)):
        name = op_name(node)
        if name not in ("aten::roll",) + _BUCKET_TAILS:
            continue
        if name == "aten::roll":
            d = _last_dim(node)
            if d in wire_dims:
                ex[wire_dims.index(d)].append(ordinal)
            continue
        # a tail's bucket: its candidates' `[R, d]` (the op's list output
        # carries no tensor metadata of its own)
        d = _last_dim(node.args[1][0])
        if d in commit_dims:
            upd[commit_dims.index(d)].append(ordinal)
    for b in range(k):
        upd[b] = ([o for o in upd[b] if o > min(ex[b])] if ex[b] else [])
    witnesses = []
    for b in range(1, k - 1):
        if not (ex[b] and upd[b - 1] and upd[b + 1]):
            continue
        lo, hi = min(upd[b - 1]), max(upd[b + 1])
        for e in ex[b]:
            if lo < e < hi:
                witnesses.append((b, e))
                break
    return {"exchange": ex, "update": upd, "interleaved": bool(witnesses),
            "witnesses": witnesses}
