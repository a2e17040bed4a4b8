"""Profiling & tracing: step timings and a device trace.

Port of `eventgrad_tpu/utils/profiling.py`:

  * `timed_steps` — a step-timing harness giving the first call's
    seconds (where the kernels build and the card warms up) and the
    steady-state per-step latency percentiles. On a CUDA state each step
    is bracketed by CUDA events (device time, start to end of the step's
    work on the stream, read after a synchronize); on the CPU by the
    host clock.
  * `trace` — a context manager around `torch.profiler` writing a Chrome
    trace (Perfetto-loadable) of the host and, with a card, the device;
    a no-op with a `warnings` warning where the profiler cannot start.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch


def _device_of(state: Any) -> torch.device:
    params = getattr(state, "params", None)
    if isinstance(params, torch.Tensor):
        return params.device
    return torch.device("cpu")


def timed_steps(
    step_fn: Callable,
    state: Any,
    batches: Sequence[Any],
    warmup: int = 1,
) -> Dict[str, Any]:
    """Run step_fn(state, batch) over batches; the first call is timed
    apart (`compile_s`: kernel builds, allocator and cuDNN warm-up).

    Returns {"compile_s", "step_ms_mean", "step_ms_p50", "step_ms_p95",
    "timer", "state"}: `timer` is "cuda_events" on a CUDA state, else
    "host", and "state" holds the final state."""
    assert len(batches) > warmup, "need more batches than warmup steps"
    dev = _device_of(state)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    t0 = time.perf_counter()
    state, _ = step_fn(state, batches[0])
    sync()
    compile_s = time.perf_counter() - t0

    times = []
    for batch in batches[1:]:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step_fn(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            times.append(1000.0 * (time.perf_counter() - t0))
    ms = np.asarray(times[max(0, warmup - 1):])
    return {
        "compile_s": compile_s,
        "step_ms_mean": float(ms.mean()),
        "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_p95": float(np.percentile(ms, 95)),
        "timer": "cuda_events" if cuda else "host",
        "state": state,
    }


@contextlib.contextmanager
def trace(log_dir: str, python_tracer: bool = False):
    """`torch.profiler` scope writing `<log_dir>/trace.json` (a Chrome
    trace) on exit; degrades to a no-op with a RuntimeWarning if the
    profiler cannot start. CUDA activity is recorded when a card is
    present. `python_tracer=False` (default) keeps the Python call stacks
    out: they flood the trace and bury the device timeline."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        prof = torch.profiler.profile(activities=acts,
                                      with_stack=python_tracer)
        prof.__enter__()
    except Exception as e:
        import warnings

        prof = None
        warnings.warn(f"[profiling] trace unavailable: {e}", RuntimeWarning,
                      stacklevel=3)
    try:
        yield prof
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
