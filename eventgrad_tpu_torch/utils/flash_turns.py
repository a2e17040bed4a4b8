"""Time the flash-attention kernels of two checkouts in turns, on one card.

    python -m eventgrad_tpu_torch.utils.flash_turns --other DIR
        [--shape B,T,H,D] [--out FILE]

`DIR` is another checkout of the repository (for example a `git archive`
of the parent commit unpacked beside this one). The kernels of the two
trees run in turns, other, this, this, other, each turn in a process of
its own that builds its tree's kernels and imports its tree's port. A
turn times the forward, dQ and dK/dV kernels at `--shape` (default the
transformer legs' B = 32, T = 1024, H = 8, D = 64; causal, q/k/v as
strided views of one fused projection), in float32 and bfloat16, as
`chip_smoke.py` does: median of 20 CUDA-event timings after 3 warm-ups.
Prints one JSON line per turn, then the card's name and power limit,
then a summary line `{"turns": [...], "card": ...}` (also written to
`--out`). Both trees must take the shape: a tree whose kernels stop at
D = 64 refuses D = 128, and one that stops at 128 refuses the wide
form's `--shape 32,1024,8,256`.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
SHAPE = (32, 1024, 8, 64)
REPS, WARMUP = 20, 3


def time_ms(fn) -> float:
    import torch

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def one_turn(root: Path, shape) -> dict:
    """The kernels of the checkout at `root`, timed at `shape`."""
    sys.path.insert(0, str(root))
    import torch

    import eventgrad_tpu_torch
    from eventgrad_tpu_torch.ops import attention as fa
    from eventgrad_tpu_torch.ops import build

    if root not in Path(eventgrad_tpu_torch.__file__).resolve().parents:
        raise RuntimeError(f"imported the port from outside {root}")
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, t, h, d = shape
    rec = {"root": str(root), "shape": list(shape)}
    with torch.no_grad():
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            qkv = torch.randn((b, t, 3 * h, d), generator=gen,
                              device="cuda").to(dtype)
            q, k, v = qkv.split(h, dim=2)
            do = torch.randn((b, t, h, d), generator=gen,
                             device="cuda").to(dtype)
            out, lse = fa.flash_fwd(q, k, v, None, True, 1)
            delta = (do.float() * out.float()).sum(-1).transpose(
                1, 2).contiguous()
            args = (q, k, v, do, lse.transpose(1, 2).contiguous(), delta,
                    None, True, 1)
            rec[f"flash_fwd_{tag}"] = time_ms(
                lambda: fa.flash_fwd(q, k, v, None, True, 1))
            rec[f"flash_dq_{tag}"] = time_ms(lambda: fa.flash_dq(*args))
            rec[f"flash_dkv_{tag}"] = time_ms(lambda: fa.flash_dkv(*args))
            del qkv, q, k, v, do, out, lse, delta, args
            torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other checkout")
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)),
                    help="B,T,H,D of q, k, v (default %(default)s)")
    ap.add_argument("--out", type=Path, help="also write the summary here")
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    shape = tuple(int(v) for v in a.shape.split(","))
    if len(shape) != 4:
        ap.error(f"--shape takes B,T,H,D, got {a.shape}")
    if a.turn is not None:
        print(json.dumps(one_turn(a.turn.resolve(), shape)), flush=True)
        return 0
    if a.other is None:
        ap.error("--other is required")
    other = a.other.resolve()
    turns = []
    for root, label in ((other, "other"), (HERE, "this"), (HERE, "this"),
                        (other, "other")):
        res = subprocess.run([sys.executable, __file__, "--turn", str(root),
                              "--shape", a.shape],
                             capture_output=True, text=True, cwd=root)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        rec = {"tree": label, **json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        turns.append(rec)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    summary = json.dumps({"turns": turns, "card": card})
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(summary + "\n")
    print(summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
