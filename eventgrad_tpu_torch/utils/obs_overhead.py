"""Telemetry overhead: the same step with obs off and on, same data.

Port of `tools/obs_overhead.py`. The step is built with
`make_train_step(..., obs=False)` and `obs=True` (the state with
`init_train_state(..., obs=...)`), both in one process, warmed up, then
timed pass by pass: each pass steps both configs on the same batch in
alternating order, each step one `Registry` span around the step and
the synchronize after it (host clock around work that ends on the
device). The overhead is the median over passes of the paired on - off
difference and ratio: on a shared host the pass time drifts by tens of
ms between processes and minutes, which the pairing leaves out. `--reps`
repeats the pair with fresh states.

Op-points:

  * `--model cnn2` (the JAX artifact's, `artifacts/obs_overhead_cpu.json`):
    CNN2 on Ring(4), 16 samples per rank, SGD lr 0.05, EventGraD with
    `EventConfig(adaptive=True, horizon=0.95, warmup_passes=5)`, 40
    timed steps, 3 reps;
  * `--model resnet18` (the card's flagship): ResNet-18 with bf16
    compute on Ring(8), global batch 256, SGD lr 0.01 momentum 0.9, the
    adaptive trigger at horizon 1.05, warmup 2, max_silence 50; the f32
    masked wire.

With `--profile N` each config also runs two windows of N passes under
`torch.profiler` (off, on, on, off) and reports the launches per pass
(CUDA kernels; on the CPU, the ATen ops), the kernels' device-busy ms
per pass and per window, the device ms of the kernels under the step's
`step/telemetry` span (both 0 on the CPU) and the host syncs per pass
(`cudaStreamSynchronize` / `cudaDeviceSynchronize` calls and
device-to-host or pageable copies).

    python -m eventgrad_tpu_torch.utils.obs_overhead --device cpu \\
        [--model cnn2|resnet18] [--steps 40] [--reps 3] [--profile N] \\
        [--out FILE]

`--device` defaults to CUDA, raising without it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

import numpy as np
import torch

from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.data.sharding import batched_epoch
from eventgrad_tpu_torch.models import CNN2
from eventgrad_tpu_torch.models.resnet import ResNet18
from eventgrad_tpu_torch.obs import Registry
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.devices import resolve_device
from eventgrad_tpu_torch.utils.metrics import median

#: model -> (constructor, one sample's shape, ranks, per-rank batch,
#: (lr, momentum), EventConfig)
OP_POINTS = {
    "cnn2": (lambda dev: CNN2(device=dev), (28, 28, 1), 4, 16, (0.05, 0.0),
             EventConfig(adaptive=True, horizon=0.95, warmup_passes=5)),
    "resnet18": (lambda dev: ResNet18(dtype=torch.bfloat16, device=dev),
                 (32, 32, 3), 8, 32, (0.01, 0.9),
                 EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                             max_silence=50)),
}
#: host syncs: the runtime's synchronizes, and the copies that block the
#: host (device to host, and host to device from pageable memory)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
SYNC_COPIES = ("DtoH", "Device -> Pageable", "Pageable -> Device")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(step, state, batches, device):
    """(state, {launches, host syncs, device-busy ms, telemetry ms}) over
    the passes of `batches` (the busy ms: the kernels' device time; the
    telemetry ms: that of the kernels under the step's `step/telemetry`
    span; both 0 on the CPU)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches:
            state, _ = step(state, b)
        _sync(device)
    evs = prof.key_averages()
    busy_ms = tel_ms = 0.0
    if device.type == "cuda":
        gpu = torch.autograd.DeviceType.CUDA
        kernels = [e for e in evs if e.device_type == gpu
                   and not e.is_user_annotation
                   and not e.key.startswith("Memcpy")
                   and not e.key.startswith("Memset")]
        launches = sum(e.count for e in kernels)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        tel_ms = sum(e.device_time_total for e in evs
                     if e.key == "step/telemetry"
                     and e.device_type != gpu) / 1e3
    else:
        launches = sum(e.count for e in evs if e.key.startswith("aten::"))
    syncs = sum(e.count for e in evs
                if e.key in SYNC_CALLS
                or (e.key.startswith("Memcpy")
                    and any(s in e.key for s in SYNC_COPIES)))
    # the profiler's own final synchronize is not the step's
    syncs -= 1 if device.type == "cuda" else 0
    return state, {"launches": launches, "syncs": syncs, "busy_ms": busy_ms,
                   "telemetry_ms": tel_ms}


def _config(obs: bool, model_name: str, device, seed: int = 0):
    """(state, step) of one config at the op-point."""
    make, shape, ranks, _, (lr, mom), cfg = OP_POINTS[model_name]
    model, topo = make(device), Ring(ranks)
    state = init_train_state(model, shape, topo, "eventgrad", cfg, seed=seed,
                             momentum=mom, obs=obs, device=device)
    step = make_train_step(model, topo, "eventgrad", cfg,
                           fused_sgd=(lr, mom), obs=obs)
    return state, step


def _summary(ms) -> Dict[str, float]:
    return {"step_ms_mean": float(np.mean(ms)),
            "step_ms_p50": float(median(ms)),
            "step_ms_p95": float(np.percentile(ms, 95))}


def measure_pair(model_name: str = "cnn2", n_steps: int = 40, device=None,
                 warmup: int = 5, profile: int = 0) -> Dict[str, Any]:
    """Both configs in one process, pass by pass: each pass steps obs off
    and obs on on the same batch, in alternating order, each step timed
    by its own span around the step and a synchronize. Returns per
    config the pass times (ms: mean, p50, p95 over `n_steps` passes after
    `warmup`) and `compile_s` (the first pass's seconds: kernel builds
    and first-call set-up), and `paired`: the median over passes of the
    on - off difference and of the on / off ratio, which the host's slow
    drift (tens of ms between processes on a shared host) leaves out.
    With `profile`, each config then runs two windows of that many more
    passes under the profiler, in the order off, on, on, off: launches,
    host syncs, device-busy ms and telemetry device ms per pass over both
    windows, and the device-busy ms of each window (off's two windows
    bracket on's, so their spread is the window-to-window noise that a
    difference of the busy ms has to clear)."""
    device = resolve_device(device)
    _, shape, ranks, per_rank, _, _ = OP_POINTS[model_name]
    timed = warmup + n_steps
    total = timed + 2 * profile
    x, y = synthetic_dataset(ranks * per_rank * total, shape, seed=3)
    xb, yb = batched_epoch(x, y.astype(np.int64), ranks, per_rank)
    xb, yb = torch.from_numpy(xb).to(device), torch.from_numpy(yb).to(device)
    batches = [(xb[:, s], yb[:, s]) for s in range(total)]
    names = ("obs_off", "obs_on")
    runs = {name: list(_config(name == "obs_on", model_name, device))
            for name in names}
    reg = Registry()
    _sync(device)
    for s in range(timed):
        for name in (names if s % 2 == 0 else names[::-1]):
            state, step = runs[name]
            with reg.span(name, cat="device", timed=s >= warmup):
                runs[name][0], _ = step(state, batches[s])
                _sync(device)
    out: Dict[str, Any] = {}
    for name in names:
        spans = [sp for sp in reg.spans if sp.name == name]
        ms = [sp.dur_us / 1e3 for sp in spans if sp.args["timed"]]
        out[name] = {"compile_s": spans[0].dur_us / 1e6, **_summary(ms)}
        out[name]["_ms"] = ms
    if profile:
        prof = {name: [] for name in names}
        for w, name in enumerate(names + names[::-1]):
            state, step = runs[name]
            lo = timed + (w // 2) * profile
            runs[name][0], p = _profile(step, state,
                                        batches[lo:lo + profile], device)
            prof[name].append(p)
        for name in names:
            n = 2 * profile
            ws = prof[name]
            out[name].update(
                launches_per_pass=sum(p["launches"] for p in ws) / n,
                host_syncs_per_pass=sum(p["syncs"] for p in ws) / n,
                device_busy_ms_per_pass=sum(p["busy_ms"] for p in ws) / n,
                device_busy_ms_per_pass_windows=[
                    p["busy_ms"] / profile for p in ws],
                telemetry_device_ms_per_pass=sum(
                    p["telemetry_ms"] for p in ws) / n)
    off, on = out["obs_off"].pop("_ms"), out["obs_on"].pop("_ms")
    out["paired"] = {
        "delta_ms_p50": float(median([b - a for a, b in zip(off, on)])),
        "ratio_p50": float(median([b / a for a, b in zip(off, on)])),
    }
    return out


def run(model_name: str = "cnn2", n_steps: int = 40, reps: int = 3,
        device=None, warmup: int = 5, profile: int = 0) -> Dict[str, Any]:
    """`reps` paired measurements (`measure_pair`, a fresh pair of states
    each); each config keeps its best-p50 rep, and the paired delta and
    ratio are the median over the reps; with `profile`, every rep's
    device-busy windows are kept too. Returns the artifact record."""
    device = resolve_device(device)
    reps_out = [measure_pair(model_name, n_steps, device, warmup, profile)
                for _ in range(reps)]
    results = {name: min((r[name] for r in reps_out),
                         key=lambda v: v["step_ms_p50"])
               for name in ("obs_off", "obs_on")}
    reg = Registry()
    for name, r in results.items():
        reg.observe_latency(r, prefix=name)
    off, on = results["obs_off"], results["obs_on"]
    delta = float(median([r["paired"]["delta_ms_p50"] for r in reps_out]))
    ratio = float(median([r["paired"]["ratio_p50"] for r in reps_out]))
    return {
        "bench": "obs_overhead",
        "model": model_name,
        "mesh": f"ring:{OP_POINTS[model_name][2]} (rank-stacked)",
        "n_timed_steps": n_steps,
        "reps": reps,
        "device": str(device),
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "results": results,
        "rep_p50_ms": {name: [r[name]["step_ms_p50"] for r in reps_out]
                       for name in ("obs_off", "obs_on")},
        **({"rep_device_busy_ms_windows": {
            name: [r[name]["device_busy_ms_per_pass_windows"]
                   for r in reps_out] for name in ("obs_off", "obs_on")}}
           if profile else {}),
        "paired_delta_ms_p50": delta,
        "overhead_pct_paired": round(100.0 * (ratio - 1.0), 2),
        "overhead_pct_p50": round(
            100.0 * (on["step_ms_p50"] / off["step_ms_p50"] - 1.0), 2),
        "overhead_pct_mean": round(
            100.0 * (on["step_ms_mean"] / off["step_ms_mean"] - 1.0), 2),
        "prometheus": reg.prometheus_text(),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: cuda, raising without it)")
    ap.add_argument("--model", choices=sorted(OP_POINTS), default="cnn2")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="profile N more passes per config (launches, "
                         "host syncs)")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    rec = run(args.model, args.steps, args.reps, args.device, args.warmup,
              args.profile)
    print(json.dumps(rec, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
