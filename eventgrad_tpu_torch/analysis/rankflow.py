"""Rank isolation: a dataflow over the traced step's ATen graph.

Port of `eventgrad_tpu/analysis/rankflow.py` (`analyze`) for torch
graphs. The step holds every rank stacked on a leading dimension, so
nothing in the program's structure keeps one rank's values from
another's: this analysis proves it does.

Every value carries its rank layout:

  * `None` — rank-free: a constant, or data every rank shares;
  * `Rank(dim, inner, outer)` — dimension `dim` holds the rank. Its
    index `i` splits as `((o * R) + r) * inner + j`: rank `r` owns
    `inner` consecutive positions, the pattern repeats `outer` times.
    `Rank(d)` is the pure rank dimension; `inner > 1` is a rank-major
    merge (the ranks folded into a batch, or into the channels of a
    convolution by `vmap`), `outer > 1` a rank-minor one;
  * `Single(r)` — the whole value belongs to rank `r` (a piece cut from
    inside one rank's block of a merged dimension);
  * `Iota(dim)` — rank-free, and equal to its own index along `dim` (an
    `arange(R)`: `vmap`'s indexing rules pair each rank's rows with it);
  * `Grid(dim, shape)` — the rank split row-major across the
    consecutive dimensions `dim .. dim + len(shape) - 1`, which hold the
    topology's shape (`collectives.recv_from` on a torus reshapes the
    rank dimension into the `(nx, ny)` grid before it rolls).

Every op has a transfer rule. Pointwise ops broadcast layouts; views and
reshapes move the rank dimension (or merge and split it); reductions,
sorts, scans, slices and gathers must stay off it; a convolution must
keep a merged rank apart by its groups; matrix products must not
contract it. The one declared cross-rank move is `aten::roll` of the
pure rank dimension (`collectives.recv_from`), or of one dimension of
the rank grid: each such roll is an `Exchange`, classified by its grid
axis and its offset along it, with the lane's elements per rank and
dtype, which the audit reads as the wire. On a grid only reshapes (into
the grid, within it, and back to the rank dimension), rolls and
pointwise ops pass; any other op on a grid value — a slice of some grid
positions, a reduction over a grid dimension — is a violation. Kernel ops (`eg::`)
pass only with a declared layout (`analysis/kernels.py`). An op with no
rule is a violation, never a pass.

After a violation the value is tainted: later ops on it raise nothing
more, so one fault reads as one finding.

What it does not see: the aliasing of in-place ops into other views of
the same storage (an in-place op updates the layout of the tensor it is
called on only), and the values of indices (an index into a merged
dimension is trusted to stay in its rank's block, as the unbatched
program's bounds check would demand).
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from eventgrad_tpu_torch.analysis import kernels
from eventgrad_tpu_torch.analysis.walker import op_name


@dataclasses.dataclass(frozen=True)
class Rank:
    dim: int
    inner: int = 1
    outer: int = 1

    @property
    def pure(self) -> bool:
        return self.inner == 1 and self.outer == 1


@dataclasses.dataclass(frozen=True)
class Single:
    rank: int


@dataclasses.dataclass(frozen=True)
class Iota:
    dim: int


@dataclasses.dataclass(frozen=True)
class Grid:
    dim: int
    shape: Tuple[int, ...]


class _Taint:
    def __repr__(self):
        return "TAINT"


TAINT = _Taint()


@dataclasses.dataclass(frozen=True)
class Exchange:
    """One lane moved across ranks: a roll of the pure rank dimension
    (`axis` None) or of grid dimension `axis` (its offset folded on that
    axis's size)."""

    offset: int
    lane_elems: int
    dtype: str
    node: str
    axis: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Finding:
    prim: str
    reason: str
    path: Tuple[str, ...]


@dataclasses.dataclass
class RankFlowReport:
    violations: List[Finding]
    exchanges: List[Exchange]
    #: registered kernel ops reached: {op name: call count}
    kernels: Dict[str, int]


class _Violation(Exception):
    pass


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


def _meta(node) -> Optional[Any]:
    """The tensor metadata of a node holding one tensor, else None."""
    if isinstance(node, torch.fx.Node):
        tm = node.meta.get("tensor_meta")
        if hasattr(tm, "shape"):
            return tm
    return None


def _shape(node) -> Tuple[int, ...]:
    tm = _meta(node)
    return tuple(int(s) for s in tm.shape)


def _ndim(node) -> int:
    return len(_shape(node))


def _norm(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


def _named(node: torch.fx.Node) -> Dict[str, Any]:
    """The call's arguments by their schema names, defaults filled in."""
    out = {}
    for i, a in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        elif a.has_default_value():
            out[a.name] = a.default_value
        else:
            out[a.name] = None
    return out


def _seq_layout(ranks: Sequence[Tuple[int, int]], n_ranks: int) -> Optional[Rank]:
    """The `Rank(0, inner, outer)` whose pattern along a dimension is
    the run-length list `ranks` of (rank, run length), or None."""
    runs: List[List[int]] = []
    for r, n in ranks:
        if n <= 0:
            continue
        if runs and runs[-1][0] == r:
            runs[-1][1] += n
        else:
            runs.append([r, n])
    if not runs or len(runs) % n_ranks:
        return None
    inner = runs[0][1]
    for k, (r, n) in enumerate(runs):
        if n != inner or r != k % n_ranks:
            return None
    return Rank(0, inner, len(runs) // n_ranks)


class _Flow:
    def __init__(self, gm: torch.fx.GraphModule, n_ranks: int,
                 stacked: Optional[Sequence[bool]],
                 grid: Optional[Sequence[int]] = None):
        self.gm = gm
        self.R = int(n_ranks)
        self.grid = (tuple(int(g) for g in grid)
                     if grid is not None and len(grid) > 1 else None)
        self.stacked = stacked
        self.env: Dict[torch.fx.Node, Any] = {}
        self.violations: List[Finding] = []
        self.exchanges: List[Exchange] = []
        self.kernels: Dict[str, int] = {}
        self.node: Optional[torch.fx.Node] = None

    # -- helpers -----------------------------------------------------------

    def fail(self, reason: str):
        raise _Violation(reason)

    def lay(self, x) -> Any:
        if isinstance(x, torch.fx.Node):
            return self.env.get(x)
        return None

    def tensors(self, values) -> List[torch.fx.Node]:
        out = []
        for v in values:
            if isinstance(v, torch.fx.Node) and _meta(v) is not None:
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(self.tensors(v))
        return out

    def carried(self, lays) -> List[Any]:
        return [x for x in lays if x is not None and not isinstance(x, Iota)]

    def out_count(self) -> Optional[int]:
        tm = self.node.meta.get("tensor_meta")
        if isinstance(tm, (list, tuple)) and not hasattr(tm, "shape"):
            return len(tm)
        return None

    def broadcast(self, pairs, out_ndim: int) -> Any:
        """Join of (input node, layout) pairs broadcast to `out_ndim`
        dimensions (pointwise semantics)."""
        got = None
        for node, lay in pairs:
            if lay is None or isinstance(lay, Iota):
                continue
            if isinstance(lay, Single):
                cand = lay
            else:
                k = _ndim(node) if isinstance(node, torch.fx.Node) else out_ndim
                cand = dataclasses.replace(lay, dim=lay.dim + out_ndim - k)
            if got is None:
                got = cand
            elif got != cand:
                if isinstance(got, Single) or isinstance(cand, Single):
                    self.fail("combines one rank's value with another "
                              "rank's (cross-rank read)")
                self.fail(f"broadcast pairs different ranks (rank at "
                          f"{got} and {cand})")
        return got

    def pointwise(self, node) -> Any:
        args = self.tensors(list(node.args) + list(node.kwargs.values()))
        return self.broadcast([(a, self.lay(a)) for a in args], _ndim(node))

    # -- the walk ----------------------------------------------------------

    def run(self) -> RankFlowReport:
        ph = 0
        for node in self.gm.graph.nodes:
            self.node = node
            if node.op == "placeholder":
                tm = _meta(node)
                stacked = (self.stacked[ph] if self.stacked is not None
                           else tm is not None and len(tm.shape) >= 1
                           and int(tm.shape[0]) == self.R)
                self.env[node] = Rank(0) if stacked else None
                ph += 1
                continue
            if node.op in ("output", "get_attr"):
                continue
            if node.op != "call_function":
                self.violations.append(Finding(
                    node.op, f"no rank-flow rule for a {node.op} node",
                    (node.name,)))
                self.env[node] = TAINT
                continue
            try:
                self.env[node] = self.transfer(node)
            except _Violation as v:
                self.violations.append(
                    Finding(op_name(node), str(v), (node.name,)))
                self.env[node] = TAINT
        return RankFlowReport(self.violations, self.exchanges, self.kernels)

    def taint_like(self, node):
        n = self.out_count()
        return TAINT if n is None else tuple([TAINT] * n)

    def transfer(self, node) -> Any:
        t = node.target
        if t is operator.getitem:
            src, idx = node.args
            lay = self.lay(src)
            if lay is TAINT:
                return TAINT
            return lay[idx] if isinstance(lay, (tuple, list)) else lay
        if not isinstance(t, torch._ops.OpOverload):
            self.fail(f"no rank-flow rule for {op_name(node)}")
        ns = t.namespace
        name = t._schema.name.split("::", 1)[1]
        if ns == "profiler":
            return None
        args = self.tensors(list(node.args) + list(node.kwargs.values()))
        lays = [self.lay(a) for a in args]
        if ns == "eg":
            return self.kernel(node, args, lays)
        if ns != "aten":
            self.fail(f"no rank-flow rule for {ns}::{name}")
        if name.endswith("_") and not name.endswith("__"):
            base = name[:-1]
        else:
            base = name
        if any(x is TAINT for x in lays):
            a = _named(node)
            if base in _GATHERS and self.lay(a["self"]) is not TAINT:
                # a tainted index still reads across the rank axis
                _RULES[base](self, node, a)
            return self.taint_like(node)
        carried = self.carried(lays)
        if base in _FACTORY:
            return self.factory(node, base)
        if any(isinstance(x, Grid) for x in carried) and (
                base not in _GRID_OPS):
            self.fail(f"aten::{base} on the rank grid (only reshapes, rolls "
                      "and pointwise ops keep it)")
        if base not in _REASSEMBLE and carried and all(
                isinstance(x, Single) for x in carried):
            if len(set(carried)) > 1:
                self.fail("combines one rank's value with another rank's "
                          "(cross-rank read)")
            n = self.out_count()
            return carried[0] if n is None else tuple([carried[0]] * n)
        if base in _POINTWISE:
            out = self.pointwise(node)
        else:
            rule = _RULES.get(base)
            if rule is None:
                self.fail(f"no rank-flow rule for aten::{base}")
            out = rule(self, node, _named(node))
        if base != name and node.args and isinstance(node.args[0],
                                                     torch.fx.Node):
            # in-place: the mutated tensor takes the result's layout
            self.env[node.args[0]] = out
        return out

    # -- op families -------------------------------------------------------

    def factory(self, node, base):
        if base == "arange":
            a = _named(node)
            start, end, step = a.get("start"), a.get("end"), a.get("step")
            if len(node.args) == 1:
                start, end, step = 0, node.args[0], 1
            if (start in (0, None) and end == self.R and step in (1, None)
                    and _shape(node) == (self.R,)):
                return Iota(0)
        return None

    def kernel(self, node, args, lays):
        qual = op_name(node)
        sig = kernels.lookup(qual)
        if sig is None:
            self.fail(
                f"unregistered kernel '{qual}' — an opaque kernel is legal "
                "only with a declared rank-dim signature "
                "(eventgrad_tpu_torch/analysis/kernels.py; ROADMAP "
                "'Registering a kernel')")
        self.kernels[sig.name] = self.kernels.get(sig.name, 0) + 1
        if any(x is TAINT for x in lays):
            return self.taint_like(node)
        carried = self.carried(lays)
        want = None
        for lay in carried:
            ok = isinstance(lay, Rank) and lay.dim == 0 and lay.outer == 1
            if sig.layout == kernels.ARENA:
                ok = ok and lay.inner == 1
            if not ok or (want is not None and lay != want):
                self.fail(
                    f"registered kernel '{qual}' reached with its rank in "
                    f"the wrong layout ({lay}; declared {sig.layout})")
            want = lay
        # a mutated output argument (the pitched forms' p_out, t_out)
        # holds the kernel's result from here on
        for arg, val in zip(node.target._schema.arguments,
                            list(node.args) + [node.kwargs.get(a.name) for a
                                               in node.target._schema.arguments
                                               [len(node.args):]]):
            if (arg.alias_info is not None and arg.alias_info.is_write
                    and isinstance(val, torch.fx.Node)):
                self.env[val] = want
        n = self.out_count()
        return want if n is None else tuple([want] * n)

    # -- views -------------------------------------------------------------

    def grid_reshape(self, lay, in_shape, out_shape):
        """The layout after a reshape of a pure rank dimension or a grid:
        `Grid` where consecutive output dimensions hold the topology's
        shape, `Rank` where one holds all R ranks, with the same number
        of elements before and after the rank digits; None when neither
        fits."""
        if isinstance(lay, Grid):
            d, k = lay.dim, len(lay.shape)
        else:
            d, k = lay.dim, 1
        pre = math.prod(in_shape[:d])
        post = math.prod(in_shape[d + k:])
        for e in range(len(out_shape)):
            if math.prod(out_shape[:e]) != pre:
                continue
            if (self.grid is not None
                    and tuple(out_shape[e:e + len(self.grid)]) == self.grid
                    and math.prod(out_shape[e + len(self.grid):]) == post):
                return Grid(e, self.grid)
            if out_shape[e] == self.R and math.prod(out_shape[e + 1:]) == post:
                return Rank(e)
        return None

    def reshape_layout(self, lay, in_shape, out_shape):
        """The layout after a view or reshape (row-major order kept):
        the rank is the digit `(f // stride) % R` of the flat index `f`;
        find the output dimension that holds that whole digit (or, on a
        topology with a grid, the consecutive dimensions of the grid)."""
        if lay is None or isinstance(lay, Single):
            return lay
        if isinstance(lay, Grid):
            got = self.grid_reshape(lay, in_shape, out_shape)
            if got is None:
                self.fail("reshape splits the rank grid across dimensions")
            return got
        iota = isinstance(lay, Iota)
        inner = 1 if iota else lay.inner
        stride = inner * math.prod(in_shape[lay.dim + 1:])
        se = 1  # flat stride of output dimension e
        for e in range(len(out_shape) - 1, -1, -1):
            size = out_shape[e]
            if (size > 1 and stride % se == 0
                    and (se * size) % (stride * self.R) == 0):
                new_inner = stride // se
                new_outer = se * size // (stride * self.R)
                if iota:
                    return Iota(e) if new_inner == new_outer == 1 else None
                return Rank(e, new_inner, new_outer)
            se *= size
        if iota:
            return None
        if self.grid is not None and lay.pure:
            got = self.grid_reshape(lay, in_shape, out_shape)
            if got is not None:
                return got
        self.fail("reshape splits the rank axis across dimensions")

    def slice_layout(self, lay, dim, start, end, step, size):
        """Layout of positions [start, end) step `step` of dimension
        `dim`; a piece inside one rank's block is `Single`."""
        if not isinstance(lay, Rank) or lay.dim != dim:
            return lay
        if start == 0 and end >= size and step == 1:
            return lay
        if lay.pure:
            self.fail("slice selects a subset of ranks (cross-rank read)")
        period = self.R * lay.inner
        if step == 1 and start % period == 0 and end % period == 0:
            return Rank(dim, lay.inner, (end - start) // period)
        blk0, blk1 = start // lay.inner, (end - 1) // lay.inner
        if blk0 == blk1:
            return Single(blk0 % self.R)
        self.fail("slice of a merged rank axis crosses ranks")


def _dims_arg(v, ndim) -> Optional[List[int]]:
    if v is None:
        return None
    if isinstance(v, int):
        return [_norm(v, ndim)]
    v = list(v)
    if not v:
        return None
    return [_norm(int(d), ndim) for d in v]


# --- rules: each (flow, node, named args) -> layout of the result ----------


def _r_view(f, node, a):
    return f.reshape_layout(f.lay(a["self"]), _shape(a["self"]), _shape(node))


def _r_expand(f, node, a):
    x = a["self"]
    lay = f.lay(x)
    shift = _ndim(node) - _ndim(x)
    if isinstance(lay, (Rank, Iota)):
        return dataclasses.replace(lay, dim=lay.dim + shift)
    return lay


def _perm_layout(lay, perm):
    if isinstance(lay, (Rank, Iota)):
        return dataclasses.replace(lay, dim=list(perm).index(lay.dim))
    return lay


def _r_permute(f, node, a):
    nd = _ndim(a["self"])
    return _perm_layout(f.lay(a["self"]), [_norm(d, nd) for d in a["dims"]])


def _r_transpose(f, node, a):
    nd = _ndim(a["self"])
    d0, d1 = _norm(a["dim0"], nd), _norm(a["dim1"], nd)
    perm = list(range(nd))
    perm[d0], perm[d1] = perm[d1], perm[d0]
    return _perm_layout(f.lay(a["self"]), perm)


def _r_slice(f, node, a):
    x = a["self"]
    shape = _shape(x)
    dim = _norm(a["dim"], len(shape))
    size = shape[dim]
    start = a["start"] if a["start"] is not None else 0
    end = a["end"] if a["end"] is not None else size
    start = max(0, _norm(start, size) if start < 0 else start)
    end = min(size, _norm(end, size) if end < 0 else end)
    return f.slice_layout(f.lay(x), dim, start, end, a["step"] or 1, size)


def _r_select(f, node, a):
    x = a["self"]
    shape = _shape(x)
    dim = _norm(a["dim"], len(shape))
    idx = _norm(a["index"], shape[dim])
    lay = f.lay(x)
    if isinstance(lay, Rank) and lay.dim == dim:
        if lay.pure:
            f.fail("select picks one rank (cross-rank read)")
        return Single((idx // lay.inner) % f.R)
    if isinstance(lay, (Rank, Iota)) and lay.dim > dim:
        return dataclasses.replace(lay, dim=lay.dim - 1)
    if isinstance(lay, Iota) and lay.dim == dim:
        return None
    return lay


def _r_split(f, node, a):
    x = a["self"]
    shape = _shape(x)
    dim = _norm(a["dim"], len(shape))
    size = shape[dim]
    if "split_sizes" in a and a["split_sizes"] is not None:
        sizes = list(a["split_sizes"])
    else:
        step = a["split_size"]
        sizes = [min(step, size - s) for s in range(0, size, step)]
    lay, out, start = f.lay(x), [], 0
    for s in sizes:
        out.append(f.slice_layout(lay, dim, start, start + s, 1, size))
        start += s
    return tuple(out)


def _r_select_backward(f, node, a):
    g = a["grad_output"]
    lay = f.lay(g)
    dim = _norm(a["dim"], _ndim(node))
    if isinstance(lay, (Rank, Iota)) and lay.dim >= dim:
        return dataclasses.replace(lay, dim=lay.dim + 1)
    return lay


def _reduce(f, node, a, what="reduction"):
    x = a["self"]
    nd = _ndim(x)
    lay = f.lay(x)
    if not isinstance(lay, Rank):
        return None if isinstance(lay, Iota) else lay
    dims = _dims_arg(a.get("dim"), nd)
    if dims is None or lay.dim in dims:
        f.fail(f"{what} along the rank axis")
    keep = bool(a.get("keepdim") or False)
    if keep:
        return lay
    return dataclasses.replace(lay, dim=lay.dim - sum(d < lay.dim for d in dims))


def _r_reduce(f, node, a):
    out = _reduce(f, node, a)
    n = f.out_count()
    return out if n is None else tuple([out] * n)


def _along(what):
    def rule(f, node, a):
        x = a["self"]
        lay = f.lay(x)
        dim = _norm(a["dim"], _ndim(x))
        if isinstance(lay, Rank) and lay.dim == dim:
            f.fail(f"{what} along the rank axis")
        if isinstance(lay, Iota):
            lay = None
        n = f.out_count()
        return lay if n is None else tuple([lay] * n)
    return rule


def _r_softmax(f, node, a):
    src = a.get("self", a.get("grad_output"))
    dim = _norm(a["dim"], _ndim(src))
    out = f.pointwise(node)
    if isinstance(out, Rank) and out.dim == dim:
        f.fail("softmax along the rank axis")
    return out


def _r_roll(f, node, a):
    x = a["self"]
    lay = f.lay(x)
    shifts, dims = list(a["shifts"]), list(a["dims"] or [])
    if isinstance(lay, Iota):
        lay = None
    if isinstance(lay, Grid):
        if not dims:
            f.fail("roll of the flattened tensor crosses ranks")
        nd = _ndim(x)
        for s, d in zip(shifts, dims):
            axis = _norm(d, nd) - lay.dim
            if not 0 <= axis < len(lay.shape):
                continue
            n = lay.shape[axis]
            off = (-int(s)) % n
            off = off if off <= n // 2 else off - n
            f.exchanges.append(Exchange(
                off, math.prod(_shape(x)) // f.R,
                _dtype_name(_meta(node).dtype), node.name, axis))
        return lay
    if not isinstance(lay, Rank):
        return lay
    if not dims:
        f.fail("roll of the flattened tensor crosses ranks")
    nd = _ndim(x)
    for s, d in zip(shifts, dims):
        if _norm(d, nd) != lay.dim:
            continue
        if not lay.pure:
            f.fail("roll along a merged rank axis (cross-rank read)")
        off = (-int(s)) % f.R
        off = off if off <= f.R // 2 else off - f.R
        numel = 1
        for s_ in _shape(x):
            numel *= s_
        f.exchanges.append(Exchange(
            off, numel // f.R, _dtype_name(_meta(node).dtype), node.name))
    return lay


def _r_cat(f, node, a):
    parts = [t for t in a["tensors"] if isinstance(t, torch.fx.Node)]
    nd = _ndim(node)
    dim = _norm(a["dim"], nd)
    lays = [f.lay(p) for p in parts]
    if any(isinstance(x, Single) for x in lays):
        if not all(isinstance(x, Single) for x in lays):
            f.fail("concatenate mixes one rank's values with others")
        got = _seq_layout([(x.rank, _shape(p)[dim]) for x, p in
                           zip(lays, parts)], f.R)
        if got is None:
            f.fail("concatenate reassembles ranks out of order "
                   "(cross-rank read)")
        return dataclasses.replace(got, dim=dim)
    out = f.broadcast([(p, x) for p, x in zip(parts, lays)
                       if not isinstance(x, Iota)], nd)
    if isinstance(out, Rank) and out.dim == dim:
        f.fail("concatenate along the rank axis (cross-rank read)")
    return out


def _r_stack(f, node, a):
    parts = [t for t in a["tensors"] if isinstance(t, torch.fx.Node)]
    nd = _ndim(node)
    dim = _norm(a["dim"], nd)
    lays = [f.lay(p) for p in parts]
    if any(isinstance(x, Single) for x in lays):
        if not all(isinstance(x, Single) for x in lays):
            f.fail("stack mixes one rank's values with others")
        got = _seq_layout([(x.rank, 1) for x in lays], f.R)
        if got is None:
            f.fail("stack reassembles ranks out of order (cross-rank read)")
        return dataclasses.replace(got, dim=dim)
    out = None
    for p, x in zip(parts, lays):
        if not isinstance(x, Rank):
            continue
        cand = dataclasses.replace(x, dim=x.dim + (1 if x.dim >= dim else 0))
        if out is not None and out != cand:
            f.fail("stack pairs different ranks")
        out = cand
    return out


def _r_foreach(f, node, a):
    out = []
    for p in a["self"]:
        lay = f.lay(p)
        if isinstance(lay, Rank):
            f.fail("multi-tensor reduction along the rank axis")
        out.append(None if isinstance(lay, Iota) else lay)
    return tuple(out)


def _r_gather(f, node, a):
    x, idx = a["self"], a["index"]
    nd = _ndim(x)
    dim = _norm(a["dim"], nd)
    lx, li = f.lay(x), f.lay(idx)
    if isinstance(lx, Rank) and lx.dim == dim:
        f.fail("gather across the rank axis (cross-rank read)")
    lx = None if isinstance(lx, Iota) else lx
    li = None if isinstance(li, Iota) else li
    if lx is not None and li is not None and lx != li:
        f.fail("gather pairs different ranks")
    return li if li is not None else lx


def _r_scatter(f, node, a):
    x, idx = a["self"], a["index"]
    nd = _ndim(x)
    dim = _norm(a["dim"], nd)
    src = a.get("src", a.get("source"))
    lays = [f.lay(v) for v in (x, idx, src) if isinstance(v, torch.fx.Node)]
    out = None
    for lay in lays:
        if isinstance(lay, Iota) or lay is None:
            continue
        if isinstance(lay, Rank) and lay.dim == dim:
            f.fail("scatter across the rank axis (cross-rank write)")
        if out is not None and out != lay:
            f.fail("scatter pairs different ranks")
        out = lay
    return out


def _r_index_select(f, node, a):
    x, idx = a["self"], a["index"]
    dim = _norm(a["dim"], _ndim(x))
    lx, li = f.lay(x), f.lay(idx)
    if isinstance(lx, Rank) and lx.dim == dim:
        if isinstance(li, Iota):
            return lx
        f.fail("gather across the rank axis (cross-rank read)")
    if isinstance(li, Rank):
        if isinstance(lx, Rank):
            f.fail("index_select pairs different ranks")
        return Rank(dim, li.inner, li.outer)
    return None if isinstance(lx, Iota) else lx


def _index_space(f, x, indices):
    """Shape bookkeeping of advanced indexing `x[indices]`: (positions
    of the indexed dims, broadcast ndim, where the broadcast dims land,
    a map from x's other dims to result dims)."""
    nd = _ndim(x)
    pos = [i for i, t in enumerate(indices) if t is not None]
    nb = max(_ndim(indices[i]) for i in pos)
    adjacent = pos == list(range(pos[0], pos[-1] + 1))
    b0 = pos[0] if adjacent else 0
    rest = {}
    k = 0
    for d in range(nd):
        if d in pos:
            continue
        if adjacent:
            rest[d] = d if d < pos[0] else d - len(pos) + nb
        else:
            rest[d] = nb + k
        k += 1
    return pos, nb, b0, rest


def _index_result(f, x, indices, values=None):
    """Layout of `x[indices]` in its result space, or of the values an
    `index_put` writes there (`values`)."""
    pos, nb, b0, rest = _index_space(f, x, indices)
    lx = f.lay(x)
    got = None

    def join(cand):
        nonlocal got
        if got is not None and got != cand:
            f.fail("advanced indexing pairs different ranks "
                   "(cross-rank read)")
        got = cand

    iotas = {}
    for i in pos:
        li = f.lay(indices[i])
        k = _ndim(indices[i])
        if isinstance(li, Iota):
            iotas[i] = b0 + li.dim + nb - k
        elif isinstance(li, Rank):
            join(dataclasses.replace(li, dim=b0 + li.dim + nb - k))
        elif li is not None:
            f.fail(f"no rank-flow rule for an index of layout {li}")
    if isinstance(lx, Rank):
        if lx.dim in pos:
            e = iotas.get(lx.dim)
            if e is None or not lx.pure:
                f.fail("gather across the rank axis (cross-rank read)")
            join(Rank(e))
        else:
            join(dataclasses.replace(lx, dim=rest[lx.dim]))
    elif lx is not None and not isinstance(lx, Iota):
        f.fail(f"no rank-flow rule for indexing a value of layout {lx}")
    if values is not None:
        lv = f.lay(values)
        if isinstance(lv, Rank):
            # values broadcast to the result space
            res_nd = nb + len(rest)
            join(dataclasses.replace(lv, dim=lv.dim + res_nd - _ndim(values)))
    return got, pos, iotas, rest


def _r_index(f, node, a):
    got, _, _, _ = _index_result(f, a["self"], list(a["indices"]))
    return got


def _r_index_put(f, node, a):
    x = a["self"]
    got, pos, iotas, rest = _index_result(f, x, list(a["indices"]),
                                          a["values"])
    if got is None:
        return None
    # map the result-space rank back to a dimension of x
    for d, e in rest.items():
        if e == got.dim:
            return dataclasses.replace(got, dim=d)
    for d, e in iotas.items():
        if e == got.dim and got.pure:
            return Rank(d)
    f.fail("index_put scatters across the rank axis (cross-rank write)")


def _r_bmm(f, node, a):
    x, y = a["self"], a["mat2"]
    got = None

    def join(cand):
        nonlocal got
        if got is not None and got != cand:
            f.fail("batched matrix product pairs different ranks")
        got = cand

    lx, ly = f.lay(x), f.lay(y)
    if isinstance(lx, Rank):
        if lx.dim == 2:
            f.fail("batched matrix product contracts the rank axis")
        join(lx)
    if isinstance(ly, Rank):
        if ly.dim == 1:
            f.fail("batched matrix product contracts the rank axis")
        join(ly)
    return got


def _conv_channels(f, lin, c_total, o_total, groups):
    """Output-channel layout of a convolution whose input holds the rank
    in its channels (`lin`), or a violation when a group reads across
    ranks."""
    if groups % f.R or lin.inner % (c_total // groups):
        f.fail(
            f"conv contracts the rank axis across feature groups (groups "
            f"{groups} not divisible by n_ranks {f.R}) — every output "
            "channel reads every rank's channels")
    return Rank(1, lin.inner * o_total // c_total, lin.outer)


def _conv_layouts(f, x, w, groups, transposed):
    lx, lw = f.lay(x), f.lay(w)
    if transposed:
        f.fail("no rank-flow rule for a transposed convolution")
    c_total, o_total = _shape(x)[1], _shape(w)[0]
    if isinstance(lx, Rank) and lx.dim == 0:
        if isinstance(lw, Rank):
            f.fail("conv pairs every rank's inputs with every rank's "
                   "weights")
        return "batch", lx, None
    if isinstance(lx, Rank) and lx.dim == 1:
        out = _conv_channels(f, lx, c_total, o_total, groups)
    elif lx is None or isinstance(lx, Iota):
        out = None
    else:
        f.fail("conv mixes the rank axis spatially")
    wl = None if out is None else Rank(0, out.inner, out.outer)
    if isinstance(lw, Rank):
        if lw.dim != 0 or (wl is not None and lw != wl):
            f.fail("conv weights hold the rank in the wrong layout")
        wl = lw
        out = Rank(1, lw.inner, lw.outer)
        if lx is None and groups % f.R:
            f.fail(
                f"conv contracts the rank axis across feature groups "
                f"(groups {groups} not divisible by n_ranks {f.R}) — every "
                "output channel reads every rank's channels")
    return "channels", out, wl


def _r_conv(f, node, a):
    kind, out, wl = _conv_layouts(f, a["input"], a["weight"], a["groups"],
                                  a["transposed"])
    lb = f.lay(a["bias"]) if isinstance(a["bias"], torch.fx.Node) else None
    if isinstance(lb, Rank) and (wl is None or lb != wl):
        f.fail("conv bias holds the rank in the wrong layout")
    return out


def _r_conv_backward(f, node, a):
    kind, out, wl = _conv_layouts(f, a["input"], a["weight"], a["groups"],
                                  a["transposed"])
    lg = f.lay(a["grad_output"])
    mask = list(a["output_mask"])
    if kind == "batch":
        if lg != out:
            f.fail("conv backward pairs different ranks")
        if mask[1] or mask[2]:
            f.fail("conv weight gradient is a reduction along the rank "
                   "axis")
        return (out, None, None)
    if lg is not None and out is not None and lg != out:
        f.fail("conv backward pairs different ranks")
    lin = f.lay(a["input"])
    gin = lin if isinstance(lin, Rank) else (
        None if out is None else Rank(1, out.inner * _shape(a["input"])[1]
                                      // _shape(a["weight"])[0], out.outer))
    return (gin, wl, wl)


def _r_pool(f, node, a):
    x = a.get("self", a.get("input"))
    lay = f.lay(x)
    if isinstance(lay, Rank) and lay.dim >= 2:
        f.fail("pooling mixes the rank axis spatially")
    lay = None if isinstance(lay, Iota) else lay
    n = f.out_count()
    return lay if n is None else tuple([lay] * n)


def _r_pool_backward(f, node, a):
    return f.broadcast([(a["grad_output"], f.lay(a["grad_output"])),
                        (a["self"], f.lay(a["self"]))], _ndim(node))


def _r_layer_norm(f, node, a):
    x = a["input"]
    lay = f.lay(x)
    lead = _ndim(x) - len(a["normalized_shape"])
    if isinstance(lay, Rank) and lay.dim >= lead:
        f.fail("layer norm normalizes along the rank axis")
    for w in (a["weight"], a["bias"]):
        if isinstance(f.lay(w), Rank):
            f.fail("no rank-flow rule for rank-carrying layer-norm weights")
    lay = None if isinstance(lay, Iota) else lay
    return (lay, lay, lay)


def _r_layer_norm_backward(f, node, a):
    x = a["input"]
    lay = f.broadcast([(a["grad_out"], f.lay(a["grad_out"])),
                       (x, f.lay(x))], _ndim(x))
    lead = _ndim(x) - len(a["normalized_shape"])
    if isinstance(lay, Rank) and lay.dim >= lead:
        f.fail("layer norm normalizes along the rank axis")
    mask = list(a["output_mask"])
    if isinstance(lay, Rank) and (mask[1] or mask[2]):
        f.fail("layer-norm weight gradient is a reduction along the rank "
               "axis")
    return (lay, None, None)


def _r_searchsorted(f, node, a):
    seq, x = a["sorted_sequence"], a["self"]
    out = None
    for v in (seq, x):
        lay = f.lay(v)
        if isinstance(lay, Rank):
            if lay.dim == _ndim(v) - 1:
                f.fail("searchsorted along the rank axis")
            if out is not None and out != lay:
                f.fail("searchsorted pairs different ranks")
            out = lay
    return out


def _r_pad(f, node, a):
    x = a["self"]
    lay = f.lay(x)
    pad = list(a["pad"])
    nd = _ndim(x)
    if isinstance(lay, Rank):
        k = nd - 1 - lay.dim
        if 2 * k < len(pad) and (pad[2 * k] or pad[2 * k + 1]):
            f.fail("pad extends the rank axis")
    return None if isinstance(lay, Iota) else lay


def _r_free(f, node, a):
    """Ops whose result depends on no rank-carrying value, or whose
    arguments must all be rank-free."""
    for t in f.tensors(list(node.args) + list(node.kwargs.values())):
        if isinstance(f.lay(t), Rank):
            f.fail(f"no rank-flow rule for {op_name(node)} on a "
                   "rank-carrying value")
    return None


def _r_scalar(f, node, a):
    return None


_POINTWISE = frozenset("""
abs add sub mul div neg relu threshold_backward gelu gelu_backward pow
rsqrt log floor maximum clamp clamp_min clamp_max round remainder eq ne ge gt le lt
bitwise_and bitwise_or bitwise_not bitwise_xor logical_not isfinite isnan
where masked_fill _to_copy clone detach lift_fresh_copy
""".split())

_FACTORY = frozenset("""
arange zeros ones full scalar_tensor zeros_like ones_like new_zeros
empty empty_like
""".split())

#: gathers whose indexing of the rank axis is checked even with a
#: tainted index
_GATHERS = frozenset(("index_select", "index", "gather"))

#: the ops that keep a rank grid (`Grid`): reshapes, rolls, pointwise
_GRID_OPS = frozenset(("view", "_unsafe_view", "roll")) | _POINTWISE

#: ops that reassemble per-rank pieces (`Single`) into a rank layout
_REASSEMBLE = frozenset(("cat", "stack", "_foreach_norm"))

_RULES = {
    "view": _r_view, "_unsafe_view": _r_view, "squeeze": _r_view,
    "unsqueeze": _r_view,
    "expand": _r_expand, "permute": _r_permute, "transpose": _r_transpose,
    "slice": _r_slice, "select": _r_select,
    "split": _r_split, "split_with_sizes": _r_split,
    "select_backward": _r_select_backward,
    "sum": _r_reduce, "mean": _r_reduce, "argmax": _r_reduce,
    "all": _r_reduce, "any": _r_reduce,
    "linalg_vector_norm": _r_reduce,
    "cumsum": _along("cumulative op"), "sort": _along("sort"),
    "topk": _along("topk"),
    "_softmax": _r_softmax, "_log_softmax": _r_softmax,
    "_softmax_backward_data": _r_softmax,
    "_log_softmax_backward_data": _r_softmax,
    "roll": _r_roll,
    "cat": _r_cat, "stack": _r_stack, "_foreach_norm": _r_foreach,
    "gather": _r_gather, "scatter": _r_scatter, "scatter_add": _r_scatter,
    "index_select": _r_index_select, "index": _r_index,
    "index_put": _r_index_put,
    "bmm": _r_bmm,
    "convolution": _r_conv, "convolution_backward": _r_conv_backward,
    "max_pool2d_with_indices": _r_pool, "avg_pool2d": _r_pool,
    "max_pool2d_with_indices_backward": _r_pool_backward,
    "avg_pool2d_backward": _r_pool_backward,
    "native_layer_norm": _r_layer_norm,
    "native_layer_norm_backward": _r_layer_norm_backward,
    "searchsorted": _r_searchsorted, "constant_pad_nd": _r_pad,
    "repeat_interleave": _r_free, "_local_scalar_dense": _r_scalar,
}


def analyze(
    gm: torch.fx.GraphModule,
    n_ranks: int,
    stacked: Optional[Sequence[bool]] = None,
    grid: Optional[Sequence[int]] = None,
) -> RankFlowReport:
    """Run the rank-flow analysis over a traced step. `stacked[i]` says
    whether placeholder `i` holds the ranks on its leading dimension
    (default: every tensor whose leading dimension is `n_ranks`).
    `grid` is the topology's shape: on a topology of two or more axes a
    reshape of the rank dimension into it is the rank grid, whose rolls
    are the exchanges by axis."""
    return _Flow(gm, n_ranks, stacked, grid).run()
