"""The straggler op-point: bounded-async EventGraD on the composed stack
under a persistent straggler, the port's counterpart of the accuracy
legs of the JAX package's `tools/straggler_ablation.py --measured`
(reference numbers in `artifacts/straggler_ablation_cpu.json`).

MLP(hidden=16) on 8x8x1 inputs, Ring(8), 45 epochs of 32 passes (1,440
passes), batch 8 per rank, the sequential sampler, SGD lr 0.05,
`synthetic_dataset(2048, seed=3)` with a test set of 512,
`EventConfig(adaptive=True, horizon=0.95, warmup_passes=5,
max_silence=20)`, the straggler `ChaosSchedule(seed=7, slow=((2, 6),))`
(every message rank 2 sends arrives 6 passes late), and the composed
config: the compact wire at `compact_frac=0.5`, the int8 wire with
carrier-resident buffers, the bucketed schedule at K = 4. Each leg runs
one staleness bound D: D = 1 is the lockstep model (the lag clamps to
the one-pass baseline), D >= 2 the bounded-async engine, whose per-edge
staleness gauge plateaus at D on the straggler's two edges and whose
late commits depend only on position (two edges, each pass's message
drained D passes after its send: 2 x (1,440 - D)).

    python -m eventgrad_tpu_torch.utils.straggler --device cpu \
        [--seeds 0 1 2] [--out FILE]

runs the three legs (D = 1, 2, 4) for each seed and prints one JSON line
per leg; `--out` writes them as one record. `chip_smoke.py` runs seed 0
on the card and holds it to the JAX package's run.

The op-point is bimodal, in both packages: the reference's ReLU on the
logits (`relu_logits=True`) can leave a class dead (its logit negative
on every input, so no gradient reaches it through the ReLU), and such a
run ends near 89% test accuracy instead of near 98%. Which runs land
there depends on the initial weights and on the trajectory: the port
draws its weights from torch's generator, so its seed 0 is another seed
of the JAX package's, and its CPU and card runs of one seed can land
apart.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict

from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import MLP
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.utils.devices import resolve_device

RANKS, EPOCHS, BATCH, N_TRAIN, N_TEST, SEED = 8, 45, 8, 2048, 512, 3
IN_SHAPE = (8, 8, 1)
BOUNDS = (1, 2, 4)
#: the straggler: rank 2's messages arrive 6 passes late
STRAGGLER = ChaosSchedule(seed=7, slow=((2, 6),))
#: the composed overlap stack of the JAX ablation's measured legs
COMPOSED = dict(gossip_wire="compact", compact_frac=0.5, wire="int8",
                carrier_resident=True, bucketed=4)


def run_leg(bound: int, device=None, seed: int = 0) -> Dict[str, Any]:
    """One staleness bound; its last record's numbers."""
    device = resolve_device(device)
    x, y = synthetic_dataset(N_TRAIN, IN_SHAPE, seed=SEED)
    xt, yt = synthetic_dataset(N_TEST, IN_SHAPE, seed=SEED, split="test")
    cfg = EventConfig(adaptive=True, horizon=0.95, warmup_passes=5,
                      max_silence=20)
    t0 = time.perf_counter()
    state, hist = train(
        MLP(hidden=16, input_shape=IN_SHAPE), Ring(RANKS), x, y,
        algo="eventgrad", epochs=EPOCHS, batch_size=BATCH,
        learning_rate=0.05, event_cfg=cfg, seed=seed, chaos=STRAGGLER,
        staleness=bound, x_test=xt, y_test=yt, device=device, **COMPOSED,
    )
    last = hist[-1]
    return {
        "staleness": bound,
        "seed": seed,
        "test_accuracy": last["test_accuracy"],
        "loss": last["loss"],
        "losses_finite": all(math.isfinite(r["loss"]) for r in hist),
        "msgs_saved_pct": last["msgs_saved_pct"],
        "edge_staleness_max": last.get("edge_staleness_max"),
        "late_commits": last.get("late_commits"),
        "compact_capacity": last.get("compact_capacity"),
        "bytes_per_step_per_chip":
            last["sent_bytes_wire_real_per_step_per_chip"],
        "passes": state.pass_num,
        "wall_s": time.perf_counter() - t0,
        "step_ms": 1e3 * last["wall_s"] / last["steps"],
        "device": str(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--bounds", nargs="+", type=int, default=list(BOUNDS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--out", default=None, help="write the legs here")
    args = ap.parse_args(argv)
    legs = []
    for seed in args.seeds:
        for bound in args.bounds:
            legs.append(run_leg(bound, args.device, seed))
            print(json.dumps(legs[-1]), flush=True)
    if args.out:
        rec = {"bench": "straggler_torch", "op_point": {
            "ranks": RANKS, "epochs": EPOCHS, "batch_size": BATCH,
            "n_synth": N_TRAIN, "model": "mlp16",
            "chaos": STRAGGLER.to_dict(), "composed": COMPOSED},
            "legs": legs}
        with open(args.out, "w") as fh:
            fh.write(json.dumps(rec, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
