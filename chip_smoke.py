#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`eventgrad_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. toolchain — torch, CUDA, nvcc and driver versions, the card's name and
   power limit, and the TF32 switches (both set off: float32 work on the
   card stays float32);
2. build — the hand-written kernels (`eventgrad_tpu_torch/csrc/*.cu`)
   compile with nvcc for sm_90a, one process per source, all at once;
3. kernels — each kernel at the flagship shapes (Ring(8) x ResNet-18:
   8 x 17,444,682 f32 elements, two neighbors), held bitwise against its
   plain PyTorch version on the same inputs, then timed with CUDA events
   (median of 20 after 3 warm-ups) beside its plain version, a one-call
   PyTorch yardstick where one exists, and its bound on the card;
4. reference — a small ResNet's EventGraD and D-PSGD steps on the card
   against the same steps on the CPU (plain versions), float64 compute
   and float32 state: parameters within rtol=1e-4, atol=1e-5 and equal
   fire bits, except where a leaf sat on its threshold;
5. main path — the flagship trainer through `eventgrad_tpu_torch.train`:
   full-width ResNet-18 (bf16 compute, 3 blocks per stage), Ring(8),
   global batch 256, SGD lr 0.01 momentum 0.9, the adaptive trigger at
   horizon 1.05 and max_silence 50 with warmup 2, EventGraD then D-PSGD.
   The kernels' launch counters are zeroed just before each leg and read
   just after; a leg whose kernels did not launch, or a loss that is not
   finite, fails the run;
6. summary — one JSON line of every kernel's numbers, the card's name and
   power limit, and, last, `{"ok": true, "device": {...}}`.

It needs the repository beside it (it imports the port from its own
directory) and a CUDA device; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and the
#: float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: the flagship shapes: ResNet-18 as the reference instantiates it
FLAGSHIP_PARAMS = 17_444_682
RANKS = 8
NB = 2

TIMING_REPS, TIMING_WARMUP = 20, 3
DEVICE = "cuda"


class SmokeError(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0:
        raise SmokeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0].strip()


def time_ms(fn) -> float:
    """Median device time of one call, from CUDA events around each of
    TIMING_REPS calls after TIMING_WARMUP warm-ups."""
    import torch

    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_elems: int, bytes_per_elem: int, ops_per_elem: int):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the card's float32 rate."""
    t_bytes = n_elems * bytes_per_elem / HBM_BYTES_PER_S * 1e3
    t_ops = n_elems * ops_per_elem / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> float:
    """Largest |kernel - plain| over matching outputs; raises unless every
    output is bitwise its plain version."""
    import torch

    err = 0.0
    for g, w in zip(got, want):
        err = max(err, float((g - w).abs().max()))
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise SmokeError(f"kernel output not bitwise its plain version "
                             f"(max_abs_err {err})")
    return err


def phase_toolchain():
    import torch

    from eventgrad_tpu_torch.ops import build

    log("== toolchain")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    log(f"nvcc {nvcc}: {ver[-1] if ver else '?'}")
    log(f"driver {nvidia_smi('driver_version')}")
    card = nvidia_smi("name,power.limit")
    log(f"card {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch.backends.cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} "
        f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return card


def phase_build():
    from eventgrad_tpu_torch.ops import build

    log("== build")
    path, secs, text = build.build(verbose=True)
    for line in text.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    build.library()
    log(f"built {path.relative_to(HERE) if HERE in path.parents else path} "
        f"in {secs:.2f} s")


def phase_kernels():
    """Each kernel against its plain version at the flagship shapes, then
    timed. Returns {name: partial kernel record}."""
    import torch

    from eventgrad_tpu_torch.models.resnet import ResNet18
    from eventgrad_tpu_torch.ops import arena_update, event_engine, fused_update
    from eventgrad_tpu_torch.parallel.arena import arena_spec

    log("== kernels")
    dev = torch.device(DEVICE)
    spec = arena_spec(ResNet18(dtype=torch.bfloat16))
    if spec.n_total != FLAGSHIP_PARAMS:
        raise SmokeError(f"ResNet18 has {spec.n_total} parameters, "
                         f"expected {FLAGSHIP_PARAMS}")
    n = RANKS * spec.n_total
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = lambda: torch.randn((RANKS, spec.n_total), generator=gen,
                                device=dev)
    seg = spec.seg_expand(dev)

    def keep_bits():
        # per-leaf fire bits, about half the leaves, expanded to positions
        # the way the train step hands them to the kernels
        fire = torch.rand((RANKS, spec.n_leaves), generator=gen,
                          device=dev) < 0.5
        return fire.to(torch.float32)[:, seg]

    lr, mom, w = 0.01, 0.9, 1.0 / 3.0
    recs = {}

    # masked wire: where(fire > 0, flat, 0)
    flat, fire = randn(), keep_bits()
    log(f"masked_wire: {n} elements, fire bits set on "
        f"{float(fire.mean()):.3f} of the positions")
    err = max_abs_err([event_engine.masked_wire(flat, fire)],
                      [event_engine.masked_wire_reference(flat, fire)])
    zero = torch.zeros((), device=dev)
    recs["masked_wire"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: event_engine.masked_wire(flat, fire)),
        plain_ms=time_ms(lambda: event_engine.masked_wire_reference(flat, fire)),
        library_ms=time_ms(lambda: torch.where(fire > 0, flat, zero)),
        bound=bound(n, 12, 2),
    )
    del flat, fire

    # fused commit + mix + SGD, two neighbors
    p, g, t = randn(), randn(), randn()
    cands, lasts = (randn(), randn()), (randn(), randn())
    keeps = (keep_bits(), keep_bits())
    args = (p, cands, keeps, lasts, g, t, lr, mom, w)
    k_out = arena_update.fused_mix_commit(*args)
    p_out = arena_update.mix_commit_reference(*args)
    err = max_abs_err([k_out[0], k_out[1], *k_out[2]],
                      [p_out[0], p_out[1], *p_out[2]])
    del k_out, p_out
    recs["fused_mix_commit"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: arena_update.fused_mix_commit(*args)),
        plain_ms=time_ms(lambda: arena_update.mix_commit_reference(*args)),
        library_ms=None,
        # reads p, g, t and per neighbor cand, keep, last; writes p', t'
        # and the committed buffers. Per element per neighbor a compare,
        # a select and an add, then 5 ops of mix and SGD
        bound=bound(n, 4 * (3 + 3 * NB + 2 + NB), 3 * NB + 5),
    )
    del args, cands, lasts, keeps

    # fused mix + SGD (the D-PSGD tail)
    b = randn()
    args = (p, b, g, t, lr, mom, w)
    err = max_abs_err(fused_update.fused_mix_sgd(*args),
                      fused_update.mix_sgd_reference(*args))
    recs["fused_mix_sgd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fused_update.fused_mix_sgd(*args)),
        plain_ms=time_ms(lambda: fused_update.mix_sgd_reference(*args)),
        library_ms=None,
        bound=bound(n, 24, 6),
    )
    del args, p, g, t, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in recs.items():
        log(json.dumps({"kernel": name, "elements": n, **{
            k: v for k, v in r.items() if k != "bound"},
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}))
    return recs


def phase_reference():
    """The train step on the card against the same step on the CPU."""
    import numpy as np
    import torch

    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.models.resnet import ResNet
    from eventgrad_tpu_torch.parallel.events import EventConfig
    from eventgrad_tpu_torch.parallel.topology import Ring
    from eventgrad_tpu_torch.train.state import init_train_state
    from eventgrad_tpu_torch.train.steps import make_train_step

    log("== reference: card vs CPU, small ResNet, float64 compute")
    model = ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                   dtype=torch.float64)
    topo, per_rank, passes = Ring(RANKS), 4, 4
    cfg = EventConfig(adaptive=True, horizon=0.6, warmup_passes=2,
                      max_silence=3)
    x, y = synthetic_dataset(RANKS * per_rank * passes, (32, 32, 3), seed=4)
    x = x.reshape((passes, RANKS, per_rank, 32, 32, 3))
    y = y.reshape((passes, RANKS, per_rank)).astype(np.int64)
    for algo in ("eventgrad", "dpsgd"):
        step = make_train_step(model, topo, algo, cfg, fused_sgd=(0.01, 0.9),
                               trace=True)
        st = {d: init_train_state(model, (32, 32, 3), topo, algo, cfg, 0,
                                  momentum=0.9, device=d)
              for d in (DEVICE, "cpu")}
        flips = 0
        for i in range(passes):
            batch = (torch.from_numpy(x[i]), torch.from_numpy(y[i]))
            out = {}
            for d in st:
                prev = st[d]
                st[d], m = step(prev, tuple(v.to(d) for v in batch))
                out[d] = (prev, {k: v.cpu().numpy() for k, v in m.items()})
            if not np.all(np.isfinite(out[DEVICE][1]["loss"])):
                raise SmokeError(f"reference {algo}: loss not finite")
            if algo == "eventgrad":
                fg, fc = (out[d][1]["trace_fired"] > 0 for d in (DEVICE, "cpu"))
                diff = fg != fc
                if diff.any():
                    prev = out["cpu"][0].event
                    vd = np.abs(out["cpu"][1]["trace_norm"]
                                - prev.last_sent_norm.numpy())
                    th = prev.thres.numpy() * np.float32(cfg.horizon)
                    if not np.all(np.abs(vd - th)[diff] < 1e-5 * th[diff]):
                        raise SmokeError(f"reference eventgrad pass {i + 1}: "
                                         f"fire bits differ off the threshold")
                    flips += int(diff.sum())
            if flips == 0:
                np.testing.assert_allclose(
                    st[DEVICE].params.cpu().numpy(), st["cpu"].params.numpy(),
                    rtol=1e-4, atol=1e-5,
                    err_msg=f"reference {algo} pass {i + 1}: params",
                )
        d = float((st[DEVICE].params.cpu() - st["cpu"].params).abs().max())
        log(f"reference {algo}: {passes} passes, max |card - cpu| params "
            f"{d:.3e}, fire-bit flips at the threshold: {flips}")


def phase_main_path():
    """The flagship pair through the public entry point. Returns the
    launches of each kernel summed over both legs."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset

    log("== main path: ResNet-18 (bf16 compute) x Ring(8), global batch 256")
    per_rank, steps, epochs = 32, 3, 2
    x, y = synthetic_dataset(RANKS * per_rank * steps, (32, 32, 3), seed=0)
    xt, yt = synthetic_dataset(512, (32, 32, 3), seed=0, split="test")
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    must_launch = {"eventgrad": ("masked_wire", "fused_mix_commit"),
                   "dpsgd": ("fused_mix_sgd",)}
    totals = {}
    for algo in ("eventgrad", "dpsgd"):
        model = egt.ResNet18(dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = egt.train(
            model, egt.Ring(RANKS), x, y, algo=algo, epochs=epochs,
            batch_size=per_rank, learning_rate=0.01, momentum=0.9,
            event_cfg=cfg, random_sampler=True, seed=0, x_test=xt,
            y_test=yt, device=DEVICE,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        missing = [k for k in must_launch[algo] if counts[k] == 0]
        if missing:
            raise SmokeError(f"{algo}: kernels never launched: {missing}")
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(v) for v in losses):
            raise SmokeError(f"{algo}: loss not finite: {losses}")
        if not bool(torch.isfinite(state.params).all()):
            raise SmokeError(f"{algo}: parameters not finite")
        if tuple(state.params.shape) != (RANKS, FLAGSHIP_PARAMS):
            raise SmokeError(f"{algo}: arena shape {tuple(state.params.shape)}")
        last = hist[-1]
        rec = {
            "leg": algo, "passes": state.pass_num,
            "loss": losses, "train_acc": last["train_acc"],
            "test_accuracy": last["test_accuracy"],
            # the last epoch: no first-call set-up inside it
            "step_ms": 1e3 * last["wall_s"] / last["steps"],
            "first_epoch_step_ms": 1e3 * hist[0]["wall_s"] / hist[0]["steps"],
            "leg_wall_s": wall,
            "sent_bytes_per_step_per_chip": last["sent_bytes_per_step_per_chip"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts,
        }
        if algo == "eventgrad":
            rec["msgs_saved_pct"] = last["msgs_saved_pct"]
            if not 0.0 <= last["msgs_saved_pct"] < 100.0:
                raise SmokeError(f"msgs_saved_pct {last['msgs_saved_pct']}")
        log(json.dumps(rec))
        del state, model
        torch.cuda.empty_cache()
    return totals


KERNELS = (
    ("masked_wire", "eventgrad_tpu_torch/csrc/masked_wire.cu",
     "eventgrad_tpu/ops/event_engine.py:118"),
    ("fused_mix_commit", "eventgrad_tpu_torch/csrc/mix_commit.cu",
     "eventgrad_tpu/ops/arena_update.py:58"),
    ("fused_mix_sgd", "eventgrad_tpu_torch/csrc/mix_sgd.cu",
     "eventgrad_tpu/ops/fused_update.py:50"),
)


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import eventgrad_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    if HERE not in Path(eventgrad_tpu_torch.__file__).resolve().parents:
        print("chip_smoke: eventgrad_tpu_torch was imported from outside "
              "this checkout", file=sys.stderr)
        return 2
    try:
        card = phase_toolchain()
        phase_build()
        recs = phase_kernels()
        phase_reference()
        launches = phase_main_path()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    kernels = []
    for name, source, replaces in KERNELS:
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"],
        })
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
