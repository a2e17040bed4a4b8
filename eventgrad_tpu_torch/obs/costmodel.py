"""Analytic per-step cost model: FLOPs + HBM bytes from the traced step,
split by phase, combined with measured step time into MFU and a roofline
point.

Port of `eventgrad_tpu/obs/costmodel.py`. The JAX module walks the
step's jaxpr; this one walks the ATen graph of the traced step
(`analysis/walker.trace`, the auditor's walker: one walker repo-wide, so
the cost model and the wire-byte audit read one program) and counts,
per node:

  * FLOPs — matrix products exactly from shapes (`mm`, `addmm`, `bmm`,
    `baddbmm`, `matmul`, `mv`, `dot`: 2·B·M·N·K), convolutions as
    2·out·C_in/g·prod(kernel), and `convolution_backward` for each
    output its `output_mask` asks for, each from its own shapes (the
    input gradient as the transposed convolution it is,
    2·numel(input)·C_out/g·prod(kernel), the weight gradient as
    2·numel(weight)·N·prod(output spatial), the bias gradient as a
    reduction) — the JAX walk's rule for the convolutions its backward
    emits. Elementwise arithmetic counts one FLOP per output element,
    reductions one per input element; views, data movement (copies,
    selects, gathers, casts, concatenations) and compares count zero.
    A fused ATen op (softmax, a normalization) counts as one
    elementwise op: for those the count is a floor.
  * HBM bytes — operand + result bytes of every node: the NO-FUSION
    traffic ceiling, stable across runs because it depends only on the
    traced program. A view (an op whose schema aliases its input:
    `view`, `expand`, `t`, `transpose`, `slice`, `select`, `permute`,
    `_unsafe_view`, ...) moves nothing and is charged zero bytes — the
    JAX walk charges its reshapes, which XLA may or may not copy.
  * the kernel ops (`eg::`) are opaque: the graph holds the call, not
    the CUDA body. Each is charged its boundary bytes (its operands and
    results; a pitched form's whole-arena operands at the bucket's
    columns, the only ones it touches) and its FLOPs from the closed
    forms of `ops/work.py`, the functions `chip_smoke.py` takes the
    kernels' bounds from. The JAX walk descends into a `pallas_call`'s
    body once per call, not once per grid step, so its kernel FLOPs are
    no oracle for these (ROADMAP §3).

Phase attribution: the step's phases (`train/steps._phase`: grad,
gate_pack, exchange, commit_mix; a bucket's `<phase>.b<k>`) enter
`phase_scope`, which sets a module-level current phase; `walker.trace`
copies it into each recorded node's `meta["eg_phase"]`. A nested scope
keeps the outer label (the bounded-async `enqueue` stays in
commit_mix), as the JAX walk reads the outermost `egphase.` scope. The
port's grad (`vmap(grad(loss))`) runs forward AND backward inside
`_phase("grad")`, so backward work lands in the phase whose forward
produced it. Untagged nodes count under "other". Tagging is metadata
only: the traced step is bitwise identical with it disabled
(EG_PHASE_SCOPES=0 / `annotations_disabled()`).

`roofline()` turns (FLOPs, bytes, measured step seconds) plus an
`obs.devicespec.DeviceSpec` into MFU, achieved bytes/s, arithmetic
intensity and the compute/memory verdict; `record_block` is the
`costmodel` block of a perf record. `compiled_memory` is the card's
peak allocation around one call; `compile_timed` records the port's
start-up stages (step build, kernel build, first dispatch) as registry
spans. The step's Python loops unroll at trace time, so the graph has
no loops: `unbounded_loops` is always 0.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from eventgrad_tpu_torch.obs.devicespec import DeviceSpec

# --- phase annotation hooks (train/steps.py wraps its regions) -------------

#: the canonical step phases, in pipeline order; "other" absorbs
#: untagged nodes
PHASES = ("grad", "gate_pack", "exchange", "commit_mix", "other")

#: the node meta key `walker.trace` writes the phase label to
META_KEY = "eg_phase"

_annotations_on = os.environ.get("EG_PHASE_SCOPES", "1") != "0"
_current: Optional[str] = None
_listeners: List[Callable[[Optional[str]], None]] = []


def annotations_enabled() -> bool:
    return _annotations_on


@contextlib.contextmanager
def annotations_disabled():
    """Trace with phase tagging off: the untagged program, for the
    bitwise-equivalence regression test."""
    global _annotations_on
    prev, _annotations_on = _annotations_on, False
    try:
        yield
    finally:
        _annotations_on = prev


def current_phase() -> Optional[str]:
    """The phase label the step is in (None outside every phase)."""
    return _current


def _set_phase(label: Optional[str]) -> None:
    global _current
    _current = label
    for fn in tuple(_listeners):
        fn(label)


@contextlib.contextmanager
def listening(fn: Callable[[Optional[str]], None]):
    """Call `fn(label)` at every phase change inside the block (the
    walker's hook while it traces)."""
    _listeners.append(fn)
    try:
        yield
    finally:
        _listeners.remove(fn)


@contextlib.contextmanager
def phase_scope(name: str):
    """Enter step phase `name` ("grad", "exchange.b2", ...): sets the
    current phase for the block unless an outer phase is already set or
    annotations are disabled. Metadata only: never changes the
    computation, only the labels the cost model reads."""
    if not _annotations_on or _current is not None:
        yield
        return
    _set_phase(name)
    try:
        yield
    finally:
        _set_phase(None)


def phase_of(node) -> str:
    """Full phase label of a traced node ("grad", "exchange.b2", ... or
    "other")."""
    return node.meta.get(META_KEY) or "other"


# --- per-op FLOP rules -----------------------------------------------------

_MATMUL = frozenset({"mm", "addmm", "bmm", "baddbmm", "matmul", "mv",
                     "addmv", "dot"})

#: one FLOP per OUTPUT element
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn", "pow",
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sqrt",
    "rsqrt", "reciprocal", "tanh", "sin", "cos", "tan", "atan2", "erf",
    "erfc", "erfinv", "sigmoid", "floor", "ceil", "round", "trunc", "frac",
    "nextafter", "square", "maximum", "minimum", "fmax", "fmin", "clamp",
    "clamp_min", "clamp_max", "relu", "gelu", "silu", "threshold",
    "threshold_backward", "gelu_backward", "silu_backward",
    "sigmoid_backward", "tanh_backward", "addcmul", "addcdiv", "lerp",
    "remainder", "fmod", "hardtanh", "leaky_relu", "elu", "softplus",
    "xlogy", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "native_layer_norm",
    "native_layer_norm_backward", "native_batch_norm",
    "_native_batch_norm_legit", "_native_batch_norm_legit_functional",
    "_native_batch_norm_legit_no_training", "native_batch_norm_backward",
    "native_dropout", "native_dropout_backward",
})

#: one FLOP per INPUT element (reductions and scans over the operand)
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "cumsum",
    "cumprod", "cummax", "cummin", "logsumexp", "var", "std", "var_mean",
    "std_mean", "linalg_vector_norm", "norm", "any", "all",
    "nll_loss_forward", "nll_loss2d_forward",
})

#: `max` / `min` reduce one tensor, or compare two elementwise
_MAXMIN = frozenset({"max", "min"})

#: ops that alias their input without a schema alias annotation
_ALIASES = frozenset({"_unsafe_view", "alias", "lift_fresh"})


def _meta(x):
    """The tensor (fake or real) or tuple of them a node produced."""
    if isinstance(x, torch.fx.Node):
        val = x.meta.get("val")
        if val is None:
            val = x.meta.get("tensor_meta")
        return val
    return x


def _tensors(x) -> List[Any]:
    """The tensor-likes (tensors, fakes, tensor metadata) in `x`."""
    x = _meta(x)
    if isinstance(x, (list, tuple)) and not hasattr(x, "shape"):
        return [t for v in x for t in _tensors(v)]
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        return [x]
    return []


def _numel(t) -> int:
    return math.prod(int(s) for s in t.shape)


def _nbytes(t) -> float:
    dt = t.dtype
    size = (torch.finfo(dt).bits if dt.is_floating_point
            else 8 if dt == torch.bool else torch.iinfo(dt).bits) // 8
    return float(_numel(t) * size)


def _short(node) -> str:
    """`aten::add_` -> `add` (in-place ops count as their pure forms)."""
    name = node.target._schema.name.split("::", 1)[-1]
    return name[:-1] if name.endswith("_") and not name.startswith("_") \
        else name


def _is_view(node) -> bool:
    return bool(getattr(node.target, "is_view", False)) or \
        _short(node) in _ALIASES


def _matmul_flops(name: str, args) -> float:
    """2·B·M·N·K of a matrix product, from its two factors' shapes."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm", "addmv") \
        else (args[0], args[1])
    (a,), (b,) = _tensors(a), _tensors(b)
    sa, sb = [int(s) for s in a.shape], [int(s) for s in b.shape]
    if name in ("dot",):
        return 2.0 * sa[0]
    if name in ("mv", "addmv"):
        return 2.0 * sa[0] * sa[1]
    # (..., M, K) @ (..., K, N); a 1-D factor is a vector
    k = sa[-1]
    m = sa[-2] if len(sa) >= 2 else 1
    n = sb[-1] if len(sb) >= 2 else 1
    batch = math.prod(sa[:-2]) if len(sa) > 2 else (
        math.prod(sb[:-2]) if len(sb) > 2 else 1)
    return 2.0 * batch * m * n * k


def _conv_flops(args, out) -> float:
    """2 · out elements · C_in per group · prod(kernel spatial)."""
    (w,) = _tensors(args[1])
    transposed, groups = bool(args[6]), int(args[8])
    ws = [int(s) for s in w.shape]
    # weight (C_out, C_in / g, *k), or (C_in, C_out / g, *k) transposed
    in_per_group = ws[0] // groups if transposed else ws[1]
    return 2.0 * _numel(out) * in_per_group * math.prod(ws[2:])


def _conv_backward_flops(args) -> tuple:
    """(conv FLOPs, reduction FLOPs) of `convolution_backward`: each
    output `output_mask` asks for, counted from its own shapes."""
    (go,), (x,), (w,) = (_tensors(args[0]), _tensors(args[1]),
                         _tensors(args[2]))
    transposed, groups, mask = bool(args[7]), int(args[9]), args[10]
    ws = [int(s) for s in w.shape]
    out_per_group = ws[1] if transposed else ws[0] // groups
    conv = 0.0
    if mask[0]:  # grad input: the transposed convolution
        conv += 2.0 * _numel(x) * out_per_group * math.prod(ws[2:])
    if mask[1]:  # grad weight: a convolution over the batch and output
        conv += 2.0 * _numel(w) * int(go.shape[0]) * math.prod(
            int(s) for s in go.shape[2:])
    red = float(_numel(go)) if mask[2] else 0.0
    return conv, red


def _op_flops(node) -> tuple:
    """(flops, kind) of one ATen node; kind in "dot" | "conv" |
    "conv_backward" | "eltwise" | "reduce" | None."""
    name = _short(node)
    args = node.args
    outs = _tensors(node)
    if name in _MATMUL:
        f = _matmul_flops(name, args)
        return f, "dot"
    if name == "convolution":
        return _conv_flops(args, outs[0]), "conv"
    if name == "convolution_backward":
        conv, red = _conv_backward_flops(args)
        return conv + red, "conv_backward"
    if name in _MAXMIN:
        if len(_tensors(args[0])) and len(args) > 1 and _tensors(args[1]):
            return float(_numel(outs[0])), "eltwise"
        return float(_numel(_tensors(args[0])[0])), "reduce"
    if name in _ELEMENTWISE and outs:
        return float(_numel(outs[0])), "eltwise"
    if name in _REDUCTIONS:
        ins = _tensors(args[0]) if args else []
        return (float(_numel(ins[0])) if ins else 0.0), "reduce"
    return 0.0, None


# --- the kernel ops (`eg::`) -----------------------------------------------


def kernel_work(node) -> tuple:
    """(flops, bytes) of one traced `eg::` kernel op: FLOPs from the
    closed forms of `ops/work.py`, bytes from the op's boundary (operands
    and results; whole-arena operands of a pitched form at the bucket's
    n elements). Raises for an op with no closed form."""
    from eventgrad_tpu_torch.analysis import kernels
    from eventgrad_tpu_torch.ops import work

    base = kernels.base_name(node.target._schema.name)
    sig = kernels.lookup(node.target._schema.name)
    kernel = sig.counter if sig is not None else base
    args = node.args
    if kernel in work.FLASH:
        (q,) = _tensors(args[0])
        offs_i, causal_i = (3, 4) if kernel == "flash_fwd" else (6, 7)
        causal = bool(args[causal_i]) and args[offs_i] is None
        flops, _ = work.flash(kernel, q.shape, _nbytes(q) // _numel(q),
                              causal)
        n_work = None
    else:
        if kernel not in work.TAILS:
            raise ValueError(f"kernel op {base!r} has no closed form")
        first = args[1] if kernel in ("masked_wire", "masked_wire_int8") \
            else args[0]
        if kernel in ("fused_mix_commit", "fused_mix_commit_carrier"):
            cands = _tensors(args[1])
            n_work, nb = _numel(cands[0]), len(cands)
            carrier = {torch.int8: "int8", torch.bfloat16: "bf16"}.get(
                cands[0].dtype)
        else:
            n_work, nb, carrier = _numel(_tensors(first)[0]), 2, None
        flops, _ = work.tail(kernel, n_work, nb, carrier)
    nbytes = 0.0
    for arg in list(args) + [node]:
        for t in _tensors(arg):
            if n_work is not None and _numel(t) > n_work:
                # a pitched form reads (and writes) only its bucket's
                # columns of a whole-arena operand
                nbytes += _nbytes(t) * n_work / _numel(t)
            else:
                nbytes += _nbytes(t)
    return flops, nbytes


# --- the graph walk --------------------------------------------------------


def analyze_graph(gm: torch.fx.GraphModule) -> Dict[str, Any]:
    """Cost model of a traced ATen graph: totals, per-phase split, and
    the dot/conv/elementwise decomposition the oracle tests pin.

    Returns
      flops_total / hbm_bytes_total      — whole-program analytic counts
      by_phase                           — {base phase: {flops, hbm_bytes}}
                                           (bucket labels fold into their
                                           base phase here)
      phases                             — the full-label split, buckets
                                           separate ("exchange.b0", ...)
      dot_flops / conv_flops / eltwise_flops — per-rule totals
      kernel_flops / kernel_bytes        — the `eg::` ops' share
      kernels                            — {kernel op: {calls, flops,
                                           hbm_bytes}}
      n_eqns, unbounded_loops            — walk stats (0 loops: the
                                           graph has none)
    """
    from eventgrad_tpu_torch.analysis import walker

    phases: Dict[str, Dict[str, float]] = {}
    kern: Dict[str, Dict[str, float]] = {}
    out = {
        "flops_total": 0.0, "hbm_bytes_total": 0.0,
        "dot_flops": 0.0, "conv_flops": 0.0, "eltwise_flops": 0.0,
        "kernel_flops": 0.0, "kernel_bytes": 0.0,
        "n_eqns": 0, "unbounded_loops": 0,
    }
    for node, _ in walker.iter_nodes(gm):
        if node.op != "call_function" or not isinstance(
                node.target, torch._ops.OpOverload):
            continue
        out["n_eqns"] += 1
        ns = node.target._schema.name.split("::", 1)[0]
        if ns == "eg":
            flops, bytes_ = kernel_work(node)
            out["kernel_flops"] += flops
            out["kernel_bytes"] += bytes_
            slot = kern.setdefault(walker.op_name(node), {
                "calls": 0, "flops": 0.0, "hbm_bytes": 0.0})
            slot["calls"] += 1
            slot["flops"] += flops
            slot["hbm_bytes"] += bytes_
        elif ns == "aten":
            flops, kind = _op_flops(node)
            bytes_ = 0.0 if _is_view(node) else sum(
                _nbytes(t) for a in list(node.args)
                + list(node.kwargs.values()) + [node] for t in _tensors(a))
            if kind == "conv_backward":  # less its bias reduction
                out["conv_flops"] += _conv_backward_flops(node.args)[0]
            elif kind in ("dot", "conv", "eltwise"):
                out[kind + "_flops"] += flops
        else:  # profiler markers and other non-compute ops
            continue
        out["flops_total"] += flops
        out["hbm_bytes_total"] += bytes_
        slot = phases.setdefault(phase_of(node),
                                 {"flops": 0.0, "hbm_bytes": 0.0})
        slot["flops"] += flops
        slot["hbm_bytes"] += bytes_

    by_phase = {p: {"flops": 0.0, "hbm_bytes": 0.0} for p in PHASES}
    for label, slot in phases.items():
        tgt = by_phase.setdefault(label.split(".")[0],
                                  {"flops": 0.0, "hbm_bytes": 0.0})
        tgt["flops"] += slot["flops"]
        tgt["hbm_bytes"] += slot["hbm_bytes"]
    out["phases"] = phases
    out["by_phase"] = by_phase
    out["kernels"] = kern
    return out


def analyze_call(fn, *args) -> Dict[str, Any]:
    """Cost model of one call `fn(*args)`, traced (and run once, on the
    arguments' device) by `walker.trace`; the call's result rides under
    "out"."""
    from eventgrad_tpu_torch.analysis import walker

    tr = walker.trace(fn, *args)
    cm = analyze_graph(tr.graph)
    cm["out"] = tr.out
    return cm


def step_batch(x, y, topo, per_rank: int, device):
    """The rank-stacked `(x, y)` batch of one step: the first `R x
    per_rank` samples, `[R, per_rank, ...]`, on `device`."""
    n = topo.n_ranks * per_rank
    xb = torch.as_tensor(x[:n]).reshape((topo.n_ranks, per_rank)
                                        + tuple(x.shape[1:]))
    yb = torch.as_tensor(y[:n]).reshape((topo.n_ranks, per_rank)
                                        + tuple(y.shape[1:]))
    if not xb.is_floating_point():
        xb = xb.long()
    return xb.to(device), yb.long().to(device)


def analyze_step(model, topo, algo, event_cfg, x, y, per_rank: int, state,
                 *, fused_sgd=(0.05, 0.0), **step_kwargs) -> Dict[str, Any]:
    """Cost model of one full train step (all ranks) at this op-point,
    traced the way the audit traces it: the step built by
    `make_train_step` for the state's layout (`utils.flops.
    step_layout_kwargs`, unless the caller pins it), fed the first `R x
    per_rank` samples of `(x, y)` on the state's device, and run once.
    The step's metrics ride under "out" (the new state is dropped)."""
    from eventgrad_tpu_torch.train.steps import make_train_step
    from eventgrad_tpu_torch.utils.flops import step_layout_kwargs

    for k, v in step_layout_kwargs(state).items():
        step_kwargs.setdefault(k, v)
    step = make_train_step(model, topo, algo, event_cfg,
                           fused_sgd=fused_sgd, **step_kwargs)
    batch = step_batch(x, y, topo, per_rank, state.params.device)
    cm = analyze_call(step, state, batch)
    cm["out"] = cm["out"][1]
    return cm


# --- roofline accounting ---------------------------------------------------


def roofline(flops: float, hbm_bytes: float, step_s: float,
             spec: DeviceSpec) -> Dict[str, Any]:
    """MFU + roofline position of `flops`/`hbm_bytes` of work observed to
    take `step_s` seconds on a device with `spec` peaks.

    `roofline_frac` is achieved FLOP/s over the roofline CEILING at this
    arithmetic intensity — min(peak_flops, intensity · peak_bw) — i.e.
    "how close to the attainable line", the honest utilization number
    for memory-bound work where MFU alone reads unfairly low.
    """
    if not (flops and step_s):
        return {
            "mfu": None, "achieved_flops_per_s": None,
            "achieved_bytes_per_s": None, "arithmetic_intensity": None,
            "ridge_intensity": spec.ridge_intensity,
            "roofline_bound": None, "roofline_frac": None,
            "device_spec": spec.name, "nominal_spec": spec.nominal,
            "peak_flops": spec.peak_flops,
            "peak_hbm_bytes_per_s": spec.peak_hbm_bytes_per_s,
        }
    achieved_f = flops / step_s
    achieved_b = (hbm_bytes / step_s) if hbm_bytes else None
    intensity = (flops / hbm_bytes) if hbm_bytes else None
    ridge = spec.ridge_intensity
    bound = None
    ceiling = spec.peak_flops
    if intensity is not None:
        bound = "compute" if intensity >= ridge else "memory"
        ceiling = min(spec.peak_flops, intensity * spec.peak_hbm_bytes_per_s)
    return {
        "mfu": achieved_f / spec.peak_flops,
        "achieved_flops_per_s": achieved_f,
        "achieved_bytes_per_s": achieved_b,
        "arithmetic_intensity": intensity,
        "ridge_intensity": ridge,
        "roofline_bound": bound,
        "roofline_frac": achieved_f / ceiling if ceiling else None,
        "device_spec": spec.name,
        "nominal_spec": spec.nominal,
        "peak_flops": spec.peak_flops,
        "peak_hbm_bytes_per_s": spec.peak_hbm_bytes_per_s,
    }


def record_block(cm: Dict[str, Any], rl: Dict[str, Any]) -> Dict[str, Any]:
    """The `costmodel` block a perf record carries (the JAX package's
    fields, one definition)."""
    return {
        "flops_per_step": cm["flops_total"],
        "hbm_bytes_per_step": cm["hbm_bytes_total"],
        "flops_by_phase": {
            k: round(v["flops"]) for k, v in cm["by_phase"].items()
        },
        "hbm_bytes_by_phase": {
            k: round(v["hbm_bytes"]) for k, v in cm["by_phase"].items()
        },
        "mfu": round(rl["mfu"], 6) if rl["mfu"] is not None else None,
        "achieved_flops_per_s": rl["achieved_flops_per_s"],
        "achieved_bytes_per_s": rl["achieved_bytes_per_s"],
        "arithmetic_intensity": rl["arithmetic_intensity"],
        "ridge_intensity": rl["ridge_intensity"],
        "roofline_bound": rl["roofline_bound"],
        "roofline_frac": rl["roofline_frac"],
        "device_spec": rl["device_spec"],
        "nominal_spec": rl["nominal_spec"],
    }


# --- measured program facts ------------------------------------------------


def compiled_memory(fn, *args) -> Optional[Dict[str, float]]:
    """The card's memory around one call `fn(*args)`: the bytes allocated
    before it (`argument_size_in_bytes`: the live arguments and
    everything else resident), the peak during it
    (`torch.cuda.max_memory_allocated`, `peak_bytes`) and their
    difference (`temp_size_in_bytes`). None off the card (the CPU
    allocator keeps no peak). The counterpart of the JAX function, which
    reads the compiler's memory analysis."""
    from eventgrad_tpu_torch.analysis import walker

    leaves = walker.flatten(args)[0]
    device = leaves[0].device if leaves else torch.device("cpu")
    if device.type != "cuda":
        fn(*args)
        return None
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn(*args)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    return {"argument_size_in_bytes": float(before),
            "temp_size_in_bytes": float(peak - before),
            "peak_bytes": float(peak)}


def compile_timed(build: Callable[[], Callable], *args, registry=None,
                  label: str = "step"):
    """The port's start-up stages of a step, one span each (cat
    "compile") into `registry` when given: "step_build" (`build()`, the
    step factory), "kernel_build" (`ops/build.library()`: nvcc for every
    `csrc/*.cu` unless this source hash is built; CUDA only, 0 s on the
    CPU) and "first_dispatch" (the first call on `args`, synchronized).
    Returns (the built step, {stage: seconds}, memory) where `memory` is
    `compiled_memory` of the first dispatch."""
    spans: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(name):
        cm = (registry.span(name, cat="compile", label=label)
              if registry is not None else contextlib.nullcontext())
        t0 = time.perf_counter()
        with cm:
            yield
        spans[name] = time.perf_counter() - t0

    with stage("step_build"):
        fn = build()
    from eventgrad_tpu_torch.analysis import walker

    leaves = walker.flatten(args)[0]
    with stage("kernel_build"):
        if leaves and leaves[0].device.type == "cuda":
            from eventgrad_tpu_torch.ops import build as kbuild

            kbuild.library()
    with stage("first_dispatch"):
        memory = compiled_memory(fn, *args)
    return fn, spans, memory
