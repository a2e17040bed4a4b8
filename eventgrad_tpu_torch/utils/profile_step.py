"""Where a flagship train step's time goes on the card.

    python -m eventgrad_tpu_torch.utils.profile_step [--steps 5]
        [--model {resnet,resnet50,transformer,transformer-d128,
                  transformer-d256}] [--algos ALGO ...]
        [--wire {bf16,int8}] [--staleness D] [--carrier-resident]
        [--compact-frac F] [--bucketed K] [--chaos SPEC]
        [--integrity SPEC] [--relu {flax,torch}]

For each leg (EventGraD, then D-PSGD, or the `--algos` named: allreduce,
dpsgd, eventgrad, sp_eventgrad at top-k 10%) at the flagship op-point —
ResNet-18 with bf16 compute, global batch 256 (with `--model resnet50`,
ResNet-50 of Bottleneck blocks); or, with `--model transformer`, the LM
of 4 layers, dim 512, 8 heads of 64 with flash attention in float32 on 4
sequences of 1024 tokens per rank, with `--model transformer-d128` the
LM of 2 layers, dim 2048, 16 heads of 128 (Pythia-1.4B's attention
width) and with `--model transformer-d256` the same LM in 8 heads of 256
(Gemma-2B's attention width: the three flash kernels on their whole
form) on the same tokens — on Ring(8) stacked
on one card, SGD lr 0.01 momentum 0.9, the adaptive trigger at horizon
1.05 and max_silence 50 (warmup 2), the f32 wire unless `--wire` names
another — it runs 3 warm-up steps, then:

  * `step_ms`: the mean of `--steps` steps, host clock around work that
    ends in a synchronize;
  * a `torch.profiler` trace (CPU + CUDA) of `--steps` more steps: device
    and host time of each step phase (the spans `step/grad`,
    `step/gate_pack`, `step/exchange`, `step/commit_mix` of
    `train/steps.py`), the device busy share
    (kernel time over the traced wall time), the stream synchronizations
    the step makes the host wait on (`cudaStreamSynchronize` calls), and
    the kernels that take the most device time.

Each leg also sums the device time of the kernel families the exchange
runs (gathers and index selects, searchsorted, sorts, rolls, scans).

`--staleness`, `--carrier-resident`, `--compact-frac`, `--bucketed`,
`--chaos` and `--integrity` apply to the EventGraD leg only.
`--compact-frac F` runs it on the compact wire at the capacity
`train(compact_frac=F)` sizes, `min(n, max(floor, ceil(F * n)))` (the
floor: the largest leaf, or under `--bucketed K` the sum of the K
buckets' largest leaves). `--staleness D` (D >= 2) runs the
bounded-async queues, whose shift and merge is the `step/enqueue` span
inside `step/commit_mix`; `--chaos` takes a fault schedule
(`seed=5,slow=1@7`, `drop=0.2,seed=0`), and `--integrity` an integrity
config (`on`: the checksums and the finite checks ride
`step/exchange`, the quarantine kernel 1's gated form and the tail's
post-update check). `--relu torch` runs the models on torch's own relu
in place of `models/activation.relu` (flax's derivative, which stops a
NaN's gradient): what that repair costs a step. A bucket's spans
(`exchange.b<k>`,
`commit_mix.b<k>`) count into their phase. It prints one JSON line per
leg and, last, the card's name and power limit. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time

import torch

from eventgrad_tpu_torch.chaos.monitor import PeerHealth
from eventgrad_tpu_torch.data.datasets import (
    synthetic_dataset, synthetic_lm_dataset,
)
from eventgrad_tpu_torch.data.sharding import batched_epoch
from eventgrad_tpu_torch.models.resnet import ResNet18, ResNet50
from eventgrad_tpu_torch.models.transformer import TransformerLM
from eventgrad_tpu_torch.parallel import collectives
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.state import ALGOS, init_train_state
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils.devices import resolve_device

PHASES = ("grad", "gate_pack", "exchange", "commit_mix", "enqueue")
#: kernel families by name fragment; a kernel counts in the first family
#: whose fragment its name holds
KERNEL_FAMILIES = (
    ("gather", ("gather", "index_elementwise")),
    ("searchsorted", ("searchsorted",)),
    ("sort", ("sort",)),
    ("roll", ("roll",)),
    ("scan", ("scan",)),
)
RANKS, WARMUP = 8, 3
LM_SEQ = 1024
#: the LM op-points: 8 heads of 64, 16 heads of 128 and 8 of 256
LM_WIDTHS = {
    "transformer": dict(dim=512, n_heads=8, n_layers=4),
    "transformer-d128": dict(dim=2048, n_heads=16, n_layers=2),
    "transformer-d256": dict(dim=2048, n_heads=8, n_layers=2),
}
#: the ResNet op-points (bf16 compute, 32 images a rank)
RESNETS = {"resnet": ResNet18, "resnet50": ResNet50}


def _op_point(model_name: str, n_steps: int):
    """(model, one sample's shape, x, y) of a flagship op-point with
    `n_steps` steps of data."""
    if model_name in LM_WIDTHS:
        model = TransformerLM(vocab=256, max_len=LM_SEQ, attn="flash",
                              **LM_WIDTHS[model_name])
        per_rank = 4
        x, y = synthetic_lm_dataset(RANKS * per_rank * n_steps, LM_SEQ, 256)
        x, shape = x.astype("int64"), (LM_SEQ,)
    else:
        model = RESNETS[model_name](dtype=torch.bfloat16)
        per_rank, shape = 32, (32, 32, 3)
        x, y = synthetic_dataset(RANKS * per_rank * n_steps, shape)
    xb, yb = batched_epoch(x, y.astype("int64"), RANKS, per_rank)
    return model, shape, xb, yb


def _family(name: str):
    low = name.lower()
    for fam, frags in KERNEL_FAMILIES:
        if any(f in low for f in frags):
            return fam
    return None


def profile_leg(algo: str, steps: int, device: torch.device, top: int = 12,
                wire=None, staleness: int = 0, carrier_resident=None,
                model_name: str = "resnet", compact_frac=None,
                bucketed=None, chaos=None, integrity=None):
    n_steps = WARMUP + 2 * steps
    model, shape, xb, yb = _op_point(model_name, n_steps)
    topo = Ring(RANKS)
    cfg = EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                      max_silence=50)
    if algo != "eventgrad":
        staleness, carrier_resident, compact_frac = 0, None, None
        bucketed = chaos = integrity = None
    capacity = None
    if compact_frac is not None:
        spec = arena_spec(model)
        floor = spec.floor
        if bucketed:
            floor = max(floor, collectives.bucketed_capacity_floor(
                spec.buckets(bucketed)))
        capacity = min(spec.n_total, max(floor, math.ceil(
            compact_frac * spec.n_total)))
    step = make_train_step(model, topo, algo, cfg, fused_sgd=(0.01, 0.9),
                           wire=wire, staleness=staleness,
                           carrier_resident=carrier_resident,
                           gossip_wire="dense" if capacity is None
                           else "compact", compact_capacity=capacity,
                           bucketed=bucketed, chaos=chaos,
                           integrity=integrity, n_passes=n_steps)
    torch.cuda.reset_peak_memory_stats(device)
    state = init_train_state(
        model, shape, topo, algo, cfg, seed=0, momentum=0.9,
        resident_wire=wire if carrier_resident else None,
        bucketed=bucketed, staleness=staleness, device=device,
    )
    if chaos is not None:
        state = state.replace(chaos=PeerHealth.init(topo, device))
    xb, yb = torch.from_numpy(xb).to(device), torch.from_numpy(yb).to(device)
    batches = iter((xb[:, s], yb[:, s]) for s in range(n_steps))

    for _ in range(WARMUP):
        state, _ = step(state, next(batches))
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, next(batches))
    torch.cuda.synchronize(device)
    step_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, next(batches))
        torch.cuda.synchronize(device)
        traced_ms = 1e3 * (time.perf_counter() - t0)
    gpu, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    is_kernel = lambda e: e.device_type == gpu and not e.is_user_annotation
    busy_us = sum(e.device_time_total for e in prof.events() if is_kernel(e))
    phases, phases_host = {}, {}
    for e in prof.events():
        # a bucket's span counts into its phase
        name = e.name.removeprefix("step/").split(".b")[0]
        if e.device_type == cpu and e.name.startswith("step/") and name in PHASES:
            # device time of every kernel launched inside the span
            phases[name] = phases.get(name, 0.0) + e.device_time_total / 1e3 / steps
            phases_host[name] = (phases_host.get(name, 0.0)
                                 + e.cpu_time_total / 1e3 / steps)
    kernels = [e for e in prof.key_averages() if is_kernel(e)]
    top_k = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    families = {}
    for e in kernels:
        fam = _family(e.key)
        if fam is not None:
            families[fam] = (families.get(fam, 0.0)
                             + e.self_device_time_total / 1e3 / steps)
    return {
        "leg": algo,
        "model": model_name,
        "wire": wire,
        "staleness": staleness,
        "resident_dtype": (wire if carrier_resident else None) or "f32",
        "compact_capacity": capacity,
        "bucketed": bucketed,
        "chaos": None if chaos is None else str(chaos),
        "integrity": integrity,
        "step_ms": step_ms,
        "peak_mem_gib": torch.cuda.max_memory_allocated(device) / 2**30,
        "traced_step_ms": traced_ms / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_busy_share": busy_us / 1e3 / traced_ms,
        "phase_device_ms_per_step": phases,
        "phase_host_ms_per_step": phases_host,
        "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
        "stream_syncs_per_step": sum(
            e.count for e in prof.key_averages()
            if e.key == "cudaStreamSynchronize") / steps,
        "kernel_family_ms_per_step": families,
        "top_kernels": [
            {"name": e.key[:90], "ms_per_step":
             e.self_device_time_total / 1e3 / steps,
             "calls_per_step": e.count / steps}
            for e in top_k
        ],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--model", choices=(*RESNETS, *LM_WIDTHS),
                    default="resnet")
    ap.add_argument("--algos", nargs="+", choices=ALGOS,
                    default=["eventgrad", "dpsgd"])
    ap.add_argument("--wire", choices=("bf16", "int8"), default=None)
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--carrier-resident", action="store_true")
    ap.add_argument("--compact-frac", type=float, default=None)
    ap.add_argument("--bucketed", type=int, default=None)
    ap.add_argument("--chaos", default=None)
    ap.add_argument("--integrity", default=None)
    ap.add_argument("--relu", choices=("flax", "torch"), default="flax")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    if args.relu == "torch":
        from eventgrad_tpu_torch.models import cnn, mlp, resnet

        for mod in (cnn, mlp, resnet):
            mod.relu = torch.relu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for algo in args.algos:
        rec = profile_leg(algo, args.steps, device, wire=args.wire,
                          staleness=args.staleness,
                          carrier_resident=args.carrier_resident or None,
                          model_name=args.model,
                          compact_frac=args.compact_frac,
                          bucketed=args.bucketed, chaos=args.chaos,
                          integrity=args.integrity)
        rec["relu"] = args.relu
        print(json.dumps(rec), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
