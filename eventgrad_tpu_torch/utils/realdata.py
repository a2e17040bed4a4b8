"""The real-data legs: the port trained to a test accuracy on the bundled
digit scans, at the operating points of the JAX package's committed
real-data runs.

  (a) CNN2 on "digits" (28x28x1), Ring(8), batch 20 per rank, 60 epochs
      = 540 passes, SGD lr 0.05 without momentum, the sequential
      sampler: EventGraD with the reference-pure trigger
      `EventConfig(adaptive=True, horizon=1.0, warmup_passes=30)`, and
      D-PSGD (the JAX package's `tools/realdata_digits.py`, reference
      numbers in `artifacts/realdata_digits_r3_cpu.json`);
  (b) LeNetCifar on "digits32" (32x32x3), the same ring and schedule,
      SGD lr 0.01 momentum 0.9, pad/flip/crop augmentation, the random
      sampler: sparsified EventGraD at top-k 10% with the same trigger,
      and D-PSGD (`tools/realdata_cifar.py`, reference numbers in
      `artifacts/realdata_cifar_r4_cpu.json`, "lenetcifar").

Each leg runs through `train.loop.train` and scores the consensus model
(the ranks' mean, rank 0's statistics) with `evaluate` on the 357 test
scans. The port's weights, dropout and augmentation come from other
random streams than the JAX package's, so a leg behaves like another
seed of the reference run.

    python -m eventgrad_tpu_torch.utils.realdata --device cpu --seeds 0 1 2

runs the four legs per seed (on the CPU: the plain versions of the
kernels) and prints one JSON line per leg, then the spread per leg.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, Optional

from eventgrad_tpu_torch.data.datasets import load_or_synthesize
from eventgrad_tpu_torch.models import CNN2, LeNetCifar
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import (
    consensus_params, evaluate, rank0_slice, train,
)
from eventgrad_tpu_torch.utils.devices import resolve_device

RANKS, BATCH, EPOCHS = 8, 20, 60
#: the reference-pure trigger of both runs
REFPURE = dict(adaptive=True, horizon=1.0, warmup_passes=30)

#: leg -> (dataset, model, algo, train() options)
LEGS: Dict[str, tuple] = {
    "digits-eventgrad": ("digits", CNN2, "eventgrad", dict(
        learning_rate=0.05, random_sampler=False)),
    "digits-dpsgd": ("digits", CNN2, "dpsgd", dict(
        learning_rate=0.05, random_sampler=False)),
    "digits32-sp_eventgrad": ("digits32", LeNetCifar, "sp_eventgrad", dict(
        learning_rate=0.01, momentum=0.9, augment=True, random_sampler=True,
        sparse_cfg=SparseConfig(10.0))),
    "digits32-dpsgd": ("digits32", LeNetCifar, "dpsgd", dict(
        learning_rate=0.01, momentum=0.9, augment=True, random_sampler=True)),
}


def run_leg(name: str, seed: int = 0, device=None) -> Dict[str, Any]:
    """Train one leg from `seed` (weights, sampler, dropout and
    augmentation streams) and score the consensus model."""
    device = resolve_device(device)
    dataset, make_model, algo, kw = LEGS[name]
    x, y = load_or_synthesize(dataset, None, "train")
    xt, yt = load_or_synthesize(dataset, None, "test")
    event_cfg = EventConfig(**REFPURE) if algo != "dpsgd" else None
    t0 = time.perf_counter()
    state, hist = train(
        make_model(), Ring(RANKS), x, y, algo=algo, epochs=EPOCHS,
        batch_size=BATCH, event_cfg=event_cfg, seed=seed,
        log_every_epoch=False, device=device, **kw,
    )
    test = evaluate(make_model(), consensus_params(state.params),
                    rank0_slice(state.batch_stats), xt, yt, device=device)
    losses = [r["loss"] for r in hist]
    last = hist[-1]
    rec = {
        "leg": name, "algo": algo, "seed": seed, "passes": state.pass_num,
        "device": str(device),
        "test_accuracy": test["accuracy"], "test_loss": test["loss"],
        "final_loss": losses[-1],
        "losses_finite": all(math.isfinite(v) for v in losses),
        "msgs_saved_pct": last.get("msgs_saved_pct"),
        "sent_bytes_per_step_per_chip": last["sent_bytes_per_step_per_chip"],
        # the last epoch: no first-call set-up inside it
        "step_ms": 1e3 * last["wall_s"] / last["steps"],
        "wall_s": time.perf_counter() - t0,
    }
    return rec


def _spread(recs, key) -> Optional[Dict[str, float]]:
    vals = [r[key] for r in recs if r[key] is not None]
    if not vals:
        return None
    return {"min": min(vals), "max": max(vals),
            "mean": sum(vals) / len(vals), "values": vals}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--out", default=None, help="also write the records here")
    args = ap.parse_args(argv)
    recs = []
    for seed in args.seeds:
        for leg in LEGS:
            rec = run_leg(leg, seed, args.device)
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    summary = {
        leg: {k: _spread([r for r in recs if r["leg"] == leg], k)
              for k in ("test_accuracy", "msgs_saved_pct")}
        for leg in LEGS
    }
    print(json.dumps({"spread": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"records": recs, "spread": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
