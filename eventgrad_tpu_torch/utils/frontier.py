"""The frontier op-point: the four trigger policies at one shared compact
capacity, the port's counterpart of the JAX package's
`tools/frontier_sweep.py` (reference numbers in
`artifacts/frontier_cpu.json`).

LeNetCifar (62,006 parameters in 10 leaves) on Ring(8), 14 epochs of
32 passes, batch 8 per rank, the sequential sampler, SGD lr 0.01
momentum 0.9, `synthetic_dataset(2048, seed=3)` with a test set of 512,
`EventConfig(adaptive=True, horizon=0.95, warmup_passes=5,
max_silence=20)`. The capacity C is the largest of the 8 partitions,
`policy.max_partition_elems(spec, 8)` = 48,000: norm_delta, micro and
hybrid run eventgrad on the compact wire at `compact_frac = C / n`;
topk runs sp_eventgrad at `topk_percent = 100 C / n` (its top-k lanes
are the compact wire). Each leg's bytes are the step's
`sent_bytes_wire_real_per_step_per_chip`, exact by construction; micro's
sends depend only on position, so its msgs-saved-% (86.71875) and
fired_frac (0.125) are exact too.

    python -m eventgrad_tpu_torch.utils.frontier --device cpu

runs the eight legs (four policies, the f32 and int8 wires) and prints
one JSON line per leg.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict

from eventgrad_tpu_torch.data.datasets import synthetic_dataset
from eventgrad_tpu_torch.models import LeNetCifar
from eventgrad_tpu_torch.parallel import policy as policy_lib
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.topology import Ring
from eventgrad_tpu_torch.train.loop import train
from eventgrad_tpu_torch.utils.devices import resolve_device

RANKS, EPOCHS, BATCH, N_TRAIN, N_TEST, SEED = 8, 14, 8, 2048, 512, 3
POLICIES = ("norm_delta", "topk", "micro", "hybrid")
#: wire name -> train()'s wire
WIRES = {"f32": None, "int8": "int8"}


def capacity() -> int:
    """The shared element budget: LeNetCifar's largest partition."""
    return policy_lib.max_partition_elems(arena_spec(LeNetCifar()), RANKS)


def leg_kwargs(pol: str) -> Dict[str, Any]:
    """train() options of one policy at the shared capacity."""
    n = arena_spec(LeNetCifar()).n_total
    if pol == "topk":
        return dict(algo="sp_eventgrad", trigger_policy="topk",
                    gossip_wire="compact",
                    sparse_cfg=SparseConfig(100.0 * capacity() / n))
    return dict(algo="eventgrad", trigger_policy=pol, gossip_wire="compact",
                compact_frac=capacity() / n)


def run_leg(pol: str, wire_name: str, device=None) -> Dict[str, Any]:
    """One policy x wire leg; its last record's numbers."""
    device = resolve_device(device)
    x, y = synthetic_dataset(N_TRAIN, (32, 32, 3), seed=SEED)
    xt, yt = synthetic_dataset(N_TEST, (32, 32, 3), seed=SEED, split="test")
    cfg = EventConfig(adaptive=True, horizon=0.95, warmup_passes=5,
                      max_silence=20)
    t0 = time.perf_counter()
    state, hist = train(
        LeNetCifar(), Ring(RANKS), x, y, epochs=EPOCHS, batch_size=BATCH,
        learning_rate=0.01, momentum=0.9, event_cfg=cfg, seed=0,
        wire=WIRES[wire_name], x_test=xt, y_test=yt, device=device,
        **leg_kwargs(pol),
    )
    last = hist[-1]
    return {
        "policy": pol,
        "wire": wire_name,
        "algo": last["algo"],
        "gossip_wire": last["gossip_wire"],
        "compact_capacity": last.get("compact_capacity"),
        "bytes_per_step_per_chip":
            last["sent_bytes_wire_real_per_step_per_chip"],
        "test_accuracy": last["test_accuracy"],
        "loss": last["loss"],
        "losses_finite": all(math.isfinite(r["loss"]) for r in hist),
        "msgs_saved_pct": last["msgs_saved_pct"],
        "fired_frac": last["fired_frac"],
        "passes": state.pass_num,
        "wall_s": time.perf_counter() - t0,
        "device": str(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--policies", nargs="+", choices=POLICIES,
                    default=list(POLICIES))
    ap.add_argument("--wires", nargs="+", choices=sorted(WIRES),
                    default=sorted(WIRES))
    args = ap.parse_args(argv)
    for pol in args.policies:
        for wire_name in args.wires:
            print(json.dumps(run_leg(pol, wire_name, args.device)),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
