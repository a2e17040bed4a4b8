"""Whether the card's free memory changes the bits of a deterministic
training run.

    python -m eventgrad_tpu_torch.utils.workspace_drift [--passes 2]
        [--leave 1.25 1.1 1.0 0.9 0.8] [--out FILE]

The resume phase's op-point of `chip_smoke.py` (ResNet-18 in bf16
compute, Ring(8), global batch 256, SGD lr 0.01 momentum 0.9, the
adaptive trigger at horizon 1.05, warmup 2 passes, max silence 50;
EventGraD, one epoch on synthetic CIFAR-shaped data) under
`torch.use_deterministic_algorithms(True)` and no cuDNN autotuning: once
with the card as it is, then once for each fraction f of `--leave`, with
the card's free memory taken by a filler tensor but f times the first
run's peak, each run's final state (every tensor of `train/state.to_flat`)
compared bit for bit with the first run's. A run that cannot allocate
is recorded as such. cuDNN's plans come from its heuristics, and where a
plan's workspace cannot be allocated PyTorch runs the next plan, whose
reduction order may differ; a run that completes and differs shows that
a deterministic run's bits depend on what else holds the card. Prints
one JSON line (also written to `--out`). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess


def _run(passes: int):
    """One epoch of the op-point: its final state as CPU tensors."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.train import state as state_lib

    x, y = synthetic_dataset(8 * 32 * passes, (32, 32, 3), seed=0)
    state, _ = egt.train(
        egt.ResNet18(dtype=torch.bfloat16), egt.Ring(8), x, y,
        algo="eventgrad", epochs=1, batch_size=32, learning_rate=0.01,
        momentum=0.9,
        event_cfg=egt.EventConfig(adaptive=True, horizon=1.05,
                                  warmup_passes=2, max_silence=50),
        random_sampler=True, seed=0, pipeline=False, device="cuda")
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in state_lib.to_flat(state).items()}


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--leave", type=float, nargs="+",
                   default=[1.25, 1.1, 1.0, 0.9, 0.8],
                   help="free memory left beside the filler, as fractions "
                        "of the first run's peak")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    # deterministic cuBLAS: read when the first handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("workspace_drift needs a CUDA card")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    ref = _run(a.passes)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    legs = [{"leave": None, "status": "ran", "differ": []}]
    again = _run(a.passes)
    legs[0]["differ"] = sorted(k for k in ref
                               if not torch.equal(ref[k], again[k]))
    del again
    for f in a.leave:
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        fill = free - int(f * peak)
        filler = (torch.empty(fill, dtype=torch.uint8, device="cuda")
                  if fill > 0 else None)
        leg = {"leave": f, "free_gib": (free - max(fill, 0)) / 2**30}
        try:
            got = _run(a.passes)
            leg["status"] = "ran"
            leg["differ"] = sorted(k for k in ref
                                   if not torch.equal(ref[k], got[k]))
            del got
        except torch.cuda.OutOfMemoryError:
            leg["status"] = "out of memory"
        del filler
        legs.append(leg)
    out = {"op_point": "resnet18-bf16 ring:8 eventgrad", "passes": a.passes,
           "peak_gib": peak / 2**30, "legs": legs, "card": _card()}
    line = json.dumps(out)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
