"""How far the device-mesh lift drifts from the stacked simulator, pass
by pass, and how far a wrong exchange would move it.

    python -m eventgrad_tpu_torch.utils.mesh_drift [--device cuda|cpu]
        [--num-filters 64] [--per-rank 32] [--passes 4] [--threads N]
        [--out FILE]

The ResNet-18 op-point of `chip_smoke.py`'s mesh phase (Ring(8), SGD lr
0.01 momentum 0.9, the adaptive trigger at horizon 1.05, warmup 2 passes,
max silence 50 for EventGraD), EventGraD and D-PSGD, step by step on
synthetic CIFAR-shaped batches. Two processes of four rows each (a gloo
group on a local TCP store; `gloo-host` on the card) each run the
simulator (all eight rows), the mesh from the seed, and the mesh from
the simulator's state after pass 2; process 0 then runs the simulator
again, from parameters perturbed by 1e-7 of themselves, and from its
pass-2 state with `recv_from` sending to the +-2 neighbours (a seeded
fault). Each comparison gives, per pass, the largest |a - b| and the
relative norm error of the parameters and the momentum trace, of the
per-rank losses, the largest difference of the BatchNorm statistics and
whether the fire counts agree. Prints one JSON line (also written to
`--out`). On the CPU with one thread (`--threads 1`) the mesh is bitwise
the simulator; with several, or on the card, a four-row stack rounds its
reductions otherwise than an eight-row one, and the line shows how far
that drifts.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _data(a):
    import numpy as np
    import torch

    from eventgrad_tpu_torch.data.datasets import synthetic_dataset

    x, y = synthetic_dataset(8 * a.per_rank * a.passes, (32, 32, 3), seed=0)
    shape = (8, a.passes, a.per_rank)
    return (torch.from_numpy(x).reshape(shape + (32, 32, 3)).to(a.device),
            torch.from_numpy(np.asarray(y, np.int64)).reshape(shape).to(
                a.device))


def _run(a, algo, mesh, batches, init=None, first=0, eps=0.0):
    """Passes `first`.. of `algo` (on `mesh`, or the simulator with
    None): (per-pass summaries of the full state, the simulator's full
    state after pass 2)."""
    import torch

    from eventgrad_tpu_torch.models import ResNet18
    from eventgrad_tpu_torch.parallel import multihost, spmd
    from eventgrad_tpu_torch.parallel.events import EventConfig
    from eventgrad_tpu_torch.parallel.topology import Ring
    from eventgrad_tpu_torch.train.state import init_train_state
    from eventgrad_tpu_torch.train.steps import make_train_step

    topo, model = Ring(8), ResNet18(num_filters=a.num_filters)
    kw = {"max_silence": 50} if algo == "eventgrad" else {}
    cfg = EventConfig(adaptive=True, horizon=1.05, warmup_passes=2, **kw)
    state = init if init is not None else init_train_state(
        model, (32, 32, 3), topo, algo, cfg, seed=0, momentum=0.9,
        device=a.device)
    if eps:
        g = torch.Generator(device=a.device).manual_seed(1)
        state = state.replace(params=state.params * (1 + eps * torch.randn(
            state.params.shape, generator=g, device=a.device)))
    step = make_train_step(model, topo, algo, cfg, fused_sgd=(0.01, 0.9),
                           mesh=mesh)
    lifted = spmd.lift(topo, mesh)
    state = multihost.put_stacked(state, mesh)
    xb, yb = batches
    out, mid = [], None
    for s in range(first, a.passes):
        state, m = step(state, (lifted.local_rows(xb[:, s]),
                                lifted.local_rows(yb[:, s])))
        full = state if mesh is None else multihost.to_host(state, mesh)
        m = m if mesh is None else multihost.to_host(m, mesh)
        out.append({"params": full.params.cpu(), "trace": full.trace.cpu(),
                    "bs": {k: v.cpu() for k, v in full.batch_stats.items()},
                    "loss": m["loss"].cpu(),
                    "fires": m["num_events"].cpu() if "num_events" in m
                    else None})
        if s == 1 and mesh is None:
            mid = full
    return out, mid


def _compare(a, b):
    """Per pass: [largest |a - b|, relative norm error] of the
    parameters, trace and losses; the BatchNorm statistics' largest
    difference; whether the fire counts agree."""
    import torch

    res = []
    for pa, pb in zip(a, b):
        d = {}
        for k in ("params", "trace", "loss"):
            diff = (pa[k].double() - pb[k].double())
            ref = float(pb[k].double().norm())
            d[k] = [float(diff.abs().max()),
                    float(diff.norm()) / ref if ref else float(diff.norm())]
        d["batch_stats"] = max((float((pa["bs"][k].double()
                                       - pb["bs"][k].double()).abs().max())
                                for k in pb["bs"]), default=0.0)
        if pb["fires"] is not None:
            d["fires_equal"] = bool(torch.equal(pa["fires"], pb["fires"]))
        res.append(d)
    return res


def child(a, pid: int, port: int) -> None:
    import torch

    from eventgrad_tpu_torch.parallel import collectives, multihost, spmd
    from eventgrad_tpu_torch.parallel.topology import NeighborSpec, Ring

    if a.threads:
        torch.set_num_threads(a.threads)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    multihost.init(f"127.0.0.1:{port}", 2, pid, device=a.device)
    batches = _data(a)
    sims, meshes = {}, {}
    for algo in ("eventgrad", "dpsgd"):
        sims[algo] = _run(a, algo, None, batches)
        mesh = spmd.build_mesh(Ring(8), a.device)
        meshes[algo] = (_run(a, algo, mesh, batches)[0],
                        _run(a, algo, mesh, batches, init=sims[algo][1],
                             first=2)[0])
        if pid:
            sims[algo] = meshes[algo] = None
    multihost.shutdown()
    if pid:
        return
    out = {"device": a.device, "num_filters": a.num_filters,
           "per_rank": a.per_rank, "passes": a.passes, "threads": a.threads,
           "legs": {}}
    for algo in ("eventgrad", "dpsgd"):
        sim, mid = sims.pop(algo)
        again = _run(a, algo, None, batches)[0]
        perturbed = _run(a, algo, None, batches, eps=1e-7)[0]
        right = collectives.recv_from
        collectives.recv_from = lambda x, topo, nb: right(
            x, topo, NeighborSpec(nb.axis, 2 * nb.offset))
        try:
            wrong = _run(a, algo, None, batches, init=mid, first=2)[0]
        finally:
            collectives.recv_from = right
        from_seed, from_pass2 = meshes.pop(algo)
        out["legs"][algo] = {
            "mesh_vs_sim": _compare(from_seed, sim),
            "mesh_from_sim_pass2_vs_sim": _compare(from_pass2, sim[2:]),
            "sim_vs_sim": _compare(again, sim),
            "sim_perturbed_1e-7_vs_sim": _compare(perturbed, sim),
            "wrong_exchange_from_pass2_vs_sim": _compare(wrong, sim[2:])}
    if a.device != "cpu":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    line = json.dumps(out)
    print(line, flush=True)
    if a.out:
        Path(a.out).write_text(line + "\n")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-filters", type=int, default=64)
    ap.add_argument("--per-rank", type=int, default=32)
    ap.add_argument("--passes", type=int, default=4)
    ap.add_argument("--threads", type=int, default=0,
                    help="torch threads a process (0: torch's default)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    import socket

    a = _parser().parse_args(argv)
    if a.passes < 3:
        raise SystemExit("--passes must be at least 3 (the windows start "
                         "after pass 2)")
    if a.child is not None:
        child(a, a.child, a.port)
        return 0
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE), os.environ.get("PYTHONPATH", "")]),
        NVIDIA_TF32_OVERRIDE="0", CUBLAS_WORKSPACE_CONFIG=os.environ.get(
            "CUBLAS_WORKSPACE_CONFIG", ":4096:8"))
    base = [sys.executable, "-m", "eventgrad_tpu_torch.utils.mesh_drift",
            *(argv if argv is not None else sys.argv[1:])]
    procs = [subprocess.Popen(base + ["--child", str(p), "--port",
                                      str(port)], env=env, cwd=str(HERE))
             for p in (0, 1)]
    try:
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
