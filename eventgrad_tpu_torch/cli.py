"""Command-line launcher of the port for all four training algorithms.

Port of `eventgrad_tpu/cli.py`: the same flags (names, choices, defaults
and types, so an argv the JAX launcher parses parses here too), the same
guards with the same words, in the same order, then `train` on the card.
Reference argv semantics (event.cpp:88-100, spevent.cpp:47-60):

    argv[1] file_write   -> --log-file (JSONL instead of send{r}.txt)
                            and --trace-file (the per-pass send/recv trace)
    argv[2] thres_type   -> --thres-mode {adaptive,constant}
    argv[3] horizon|const-> --horizon / --constant
    argv[4] topk_percent -> --topk-percent

plus what MPI provided implicitly:

    mpirun -np N         -> --mesh ring:N | torus:XxY | dp:N,sp:M ...
                            (the ranks stacked on one device, or with
                            --backend mesh spread over W processes of a
                            torch.distributed group, R / W each)
    MPI_Init             -> --coordinator host:port --num-processes W
                            --process-id p (or EG_COORDINATOR /
                            EG_NUM_PROCESSES / EG_PROCESS_ID)

A hybrid mesh (`dp:4,sp:2`, `dp:2,tp:2`, `dp:2,pp:2`, `dp:2,ep:2`,
`dp:2,ddp:2`, ...) gossips along dp, shards the transformers' weights
along tp, pp or ep (`--model transformer_tp|transformer_pp|
transformer_moe`), shards each replica's sequence along sp (`--attn
ring|ulysses`) and forms synchronous allreduce subgroups along ddp; its
run reports its final train metrics instead of a consensus eval.

One flag is the port's own: `--device {cuda,cpu}` (default cuda, which
raises when CUDA is absent; the tests pass `--device cpu`).

`--backend mesh` runs the device-mesh lift (`parallel/spmd.py`): with
`--coordinator` (or EG_COORDINATOR) the process joins a group of
`--num-processes` first, under the JAX launcher's guards, and only the
primary logs, evaluates the gathered consensus model and exports; on the
card the final record also carries the kernels' launches summed over the
processes and each process's peak memory. `--backend sim` is the
stacked simulator; `auto` takes the mesh when a group of several
processes is joined, else the simulator. Every model, `--attn` and
`--chaos` runs on the mesh as on the simulator (the tensor-, pipeline-
and expert-parallel transformers and Ulysses attention with their
collectives across processes); the mesh refuses what the JAX loop
refuses there, in its words: the integrity sentinel/rollback engine,
membership and device-resident data. `--arena off`, the JAX package's
tree path, is not queued, by design, and refused before any data is
built. `--fused` is accepted with the JAX guards that name it and
selects nothing: the port's gossip tail is always the fused CUDA
kernel.

Examples:
    python -m eventgrad_tpu_torch.cli --algo eventgrad --mesh ring:8 \\
        --dataset mnist --data-dir DIR --model cnn2 --epochs 10 \\
        --batch-size 64 --lr 0.05 --thres-mode adaptive --horizon 0.95
    python -m eventgrad_tpu_torch.cli --algo sp_eventgrad --mesh ring:4 \\
        --dataset cifar10 --data-dir DIR --model resnet18 --topk-percent 10
    python -m eventgrad_tpu_torch.cli --device cpu --algo eventgrad \\
        --mesh ring:4 --model mlp --epochs 2
    python -m eventgrad_tpu_torch.cli --device cpu --mesh dp:2,sp:2 \\
        --model transformer --attn ring --dim 32 --heads 2 --seq-len 16
    python -m eventgrad_tpu_torch.cli --backend mesh --mesh ring:8 \\
        --coordinator HOST:PORT --num-processes 2 --process-id 0
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

from eventgrad_tpu_torch.chaos.crashpoint import GracefulPreemption
from eventgrad_tpu_torch.chaos.integrity import IntegrityEscalation
from eventgrad_tpu_torch.data.datasets import (
    load_or_synthesize, synthetic_dataset, synthetic_lm_dataset,
)
from eventgrad_tpu_torch.exitcodes import INTEGRITY_ABORT_EXIT, PREEMPTED_EXIT
from eventgrad_tpu_torch.models import MODEL_REGISTRY
from eventgrad_tpu_torch.parallel import multihost
from eventgrad_tpu_torch.parallel import policy as policy_lib
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.spmd import resolve_backend
from eventgrad_tpu_torch.parallel.topology import Ring, Topology, Torus
from eventgrad_tpu_torch.train.loop import (
    ARENA_OFF_REFUSAL, consensus_params, evaluate, rank0_slice, train,
)
from eventgrad_tpu_torch.train.state import ALGOS
from eventgrad_tpu_torch.utils.devices import resolve_device
from eventgrad_tpu_torch.utils.metrics import JsonlLogger


#: axes that shard parameters (tensor/pipeline/expert parallelism); any
#: other non-dp axis (e.g. "sp") replicates parameters and is aux
_SHARDED_AXES = ("tp", "pp", "ep")

#: transformer LM family, constructed from --dim/--heads/--layers/...
#: (unlike MODEL_REGISTRY's image models)
LM_MODELS = ("transformer", "transformer_tp", "transformer_pp",
             "transformer_moe")


def build_lm_model(args, topo: Topology):
    """Construct the requested transformer over the mesh's parallel axes
    (the JAX launcher's `build_lm_model`, with its words)."""
    from eventgrad_tpu_torch.models.moe import MoETransformerLM
    from eventgrad_tpu_torch.models.pp import PPTransformerLM
    from eventgrad_tpu_torch.models.tp import TPTransformerLM
    from eventgrad_tpu_torch.models.transformer import TransformerLM

    def need(axis: str):
        if axis not in topo.axes:
            raise SystemExit(
                f"--model {args.model} needs a {axis!r} axis in --mesh "
                f"(e.g. --mesh dp:2,{axis}:2); got {topo.axes}"
            )
        return topo.axis_size(axis)

    common = dict(vocab=args.vocab, dim=args.dim, n_heads=args.heads,
                  n_layers=args.layers, max_len=args.seq_len)
    if args.model == "transformer":
        if args.attn in ("ring", "ulysses"):
            need("sp")
            return TransformerLM(**common, attn=args.attn, topo=topo,
                                 sp_axis="sp")
        return TransformerLM(**common, attn=args.attn)
    if args.model == "transformer_tp":
        return TPTransformerLM(**common, axis="tp", tp_size=need("tp"))
    if args.model == "transformer_pp":
        return PPTransformerLM(**common, axis="pp", pp_size=need("pp"))
    return MoETransformerLM(**common, n_experts=args.n_experts, axis="ep",
                            ep_size=need("ep"))


def parse_mesh(spec: str):
    kind, _, dims = spec.partition(":")
    try:
        if kind == "ring":
            return Ring(int(dims))
        if kind == "torus":
            nx, ny = dims.lower().split("x")
            return Torus(int(nx), int(ny))
        if "," in spec or kind in ("dp", "ddp", "sp") + _SHARDED_AXES:
            # hybrid grammar: comma-separated axis:N pairs, e.g.
            # "dp:4,sp:2" or "dp:2,tp:2" — dp gossips, tp/pp/ep shard
            # parameters, ddp forms allreduce subgroups that shard data,
            # sp is a replicated aux axis sharing its group's batch
            axes, shape = [], []
            for part in spec.split(","):
                name, _, n = part.partition(":")
                name = name.strip()
                if name not in ("dp", "ddp", "sp") + _SHARDED_AXES:
                    raise ValueError(f"unknown axis {name!r}")
                axes.append(name)
                shape.append(int(n))
            if len(set(axes)) != len(axes):
                raise ValueError(f"duplicate axis in {spec!r}")
            return Topology(
                axes=tuple(axes),
                shape=tuple(shape),
                gossip_axes=tuple(a for a in axes if a == "dp"),
                sharded_axes=tuple(a for a in axes if a in _SHARDED_AXES),
                data_aux_axes=tuple(a for a in axes if a == "ddp"),
            )
    except (ValueError, TypeError) as e:
        raise argparse.ArgumentTypeError(f"bad mesh spec {spec!r}: {e}")
    raise argparse.ArgumentTypeError(
        f"bad mesh spec {spec!r} (ring:N, torus:XxY, or axis:N[,axis:N...] "
        f"with axes dp/ddp/sp/tp/pp/ep)"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="eventgrad-tpu-torch",
                                description=__doc__)
    p.add_argument("--algo", choices=ALGOS, default="eventgrad")
    p.add_argument("--mesh", type=parse_mesh, default="ring:4",
                   help="ring:N or torus:XxY")
    p.add_argument("--backend", choices=["sim", "mesh", "auto"], default="sim",
                   help="sim = stack all ranks on one device; mesh = the "
                        "ranks spread over the processes of a "
                        "torch.distributed group (R / W rows a process; "
                        "one process without --coordinator); auto = mesh "
                        "whenever a group of several processes is joined, "
                        "else sim")
    p.add_argument("--dataset",
                   choices=["mnist", "cifar10", "digits", "digits32",
                            "synthetic", "synthetic-lm",
                            "synthetic-imagenet"],
                   default=None,
                   help="default: mnist for image models, synthetic-lm for "
                        "transformers; mnist / cifar10 read --data-dir "
                        "(idx files; the JPEG tree, binary or pickle "
                        "batches) and fall back to the synthetic stand-in "
                        "without it; digits = the bundled real handwritten "
                        "scans (MNIST geometry; digits32 = the same scans "
                        "at the 32x32x3 CIFAR geometry); synthetic-imagenet "
                        "is the ImageNet-shaped scale-stress stand-in "
                        "(--image-size/--num-classes)")
    p.add_argument("--image-size", type=int, default=64,
                   help="side length for --dataset synthetic-imagenet "
                        "(224 = true ImageNet shape)")
    p.add_argument("--num-classes", type=int, default=10,
                   help="label count for synthetic-imagenet (resnet models "
                        "only)")
    p.add_argument("--num-filters", type=int, default=64,
                   help="resnet stem width (64 = faithful; smaller for "
                        "smoke runs)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--model",
                   choices=sorted(MODEL_REGISTRY) + sorted(LM_MODELS),
                   default="cnn2")
    # LM / transformer knobs (--model transformer*)
    p.add_argument("--seq-len", type=int, default=128,
                   help="global sequence length")
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--attn", choices=["full", "flash", "ring", "ulysses"],
                   default="full",
                   help="attention mode for --model transformer; flash = "
                        "the hand-written CUDA kernels; ring/ulysses need "
                        "an sp axis in --mesh (e.g. dp:2,sp:2) and shard "
                        "each replica's sequence over it")
    p.add_argument("--n-experts", type=int, default=8,
                   help="experts for --model transformer_moe")
    p.add_argument("--epochs", type=int, default=10)          # event.cpp:255
    p.add_argument("--batch-size", type=int, default=64)      # event.cpp:145 (per rank)
    p.add_argument("--global-batch", type=int, default=None,
                   help="if set, per-rank batch = global/N (dcifar10 style, "
                        "event.cpp:89-91)")
    p.add_argument("--lr", type=float, default=0.05)          # event.cpp:227
    p.add_argument("--momentum", type=float, default=0.0)     # 0.9 on CIFAR (:196-200)
    p.add_argument("--thres-mode", choices=["adaptive", "constant"],
                   default="adaptive")
    p.add_argument("--horizon", type=float, default=0.95)
    p.add_argument("--constant", type=float, default=0.0)
    p.add_argument("--warmup-passes", type=int, default=30)   # event.cpp:262
    p.add_argument("--history", type=int, default=2)          # event.cpp:103
    p.add_argument("--max-silence", type=int, default=0,
                   help="bounded staleness (beyond reference): force a "
                   "parameter to fire after N silent passes; 0 = off, "
                   "1 = exact D-PSGD. Stabilizes aggressive horizons")
    p.add_argument("--topk-percent", type=float, default=10.0)
    p.add_argument("--trigger-policy",
                   choices=["norm_delta", "topk", "micro", "hybrid"],
                   default=None,
                   help="registered trigger policy (parallel/policy.py) "
                        "driving the event trigger: norm_delta = the "
                        "EventGraD trigger (eventgrad default), topk = "
                        "sp_eventgrad's selection (its default), micro = "
                        "rotating owned-partition sends, index-free "
                        "(MiCRO, arXiv:2310.00967), hybrid = norm-delta "
                        "gate x owned partition. Default: the algo's "
                        "own policy")
    p.add_argument("--augment", action="store_true",
                   help="CIFAR pad4+flip+crop32")
    p.add_argument("--staleness", type=int, default=0,
                   help="1 = mix with the previous step's received buffers "
                        "(event algorithms only). D >= 2 = the bounded-"
                        "async gossip engine: per-edge delivery queues, a "
                        "rank runs up to D passes ahead of a late neighbor "
                        "(chaos lag=/slow= clauses schedule the lag)")
    p.add_argument("--wire", choices=["bf16", "int8"], default=None,
                   help="compress gossip payloads on the wire: bf16 = half "
                        "the reference's f32 wire bytes, int8 = a quarter "
                        "(per-leaf absmax quantization); local params and "
                        "event state stay full precision (gossip algos "
                        "only)")
    p.add_argument("--wire-bf16", action="store_true",
                   help="shorthand for --wire bf16")
    p.add_argument("--gossip-wire", choices=["dense", "compact"],
                   default="dense",
                   help="compact = budgeted compacted exchange (eventgrad; "
                        "sp_eventgrad takes it as a no-op alias): only fired "
                        "leaves' elements ride the wire, through a static "
                        "buffer autotuned from the post-warmup fire rate; "
                        "dense = the masked full-payload exchange (default)")
    p.add_argument("--compact-frac", type=float, default=None,
                   metavar="F",
                   help="explicit compact buffer capacity as a fraction "
                        "of the parameter count (0 < F <= 1); default: "
                        "autotune from the observed fire rate (requires "
                        "--gossip-wire compact)")
    p.add_argument("--arena", choices=["auto", "on", "off"], default="auto",
                   help="the flat parameter arena (parallel/arena.py): the "
                        "port's only layout, so auto and on run it; off "
                        "(the JAX package's tree path) is not queued, by "
                        "design")
    p.add_argument("--carrier-resident", action="store_true",
                   help="keep the event exchange's receive buffers "
                        "resident in the wire carrier dtype (needs "
                        "eventgrad + --wire): bitwise-identical training, "
                        "the carrier commit kernel")
    p.add_argument("--bucketed", type=int, default=0, metavar="K",
                   help="bucketed gossip schedule: K leaf-aligned buckets "
                        "of the flat arena, each with its own wire, "
                        "exchange and tail (the kernels' pitched forms); "
                        "bitwise-identical training. eventgrad and "
                        "sp_eventgrad; 0/1 = monolithic (the default)")
    p.add_argument("--pipeline", choices=["auto", "on", "off"],
                   default="auto",
                   help="the dispatch pipeline (train/loop.py): launch "
                        "block B+1, then run block B's host work (records, "
                        "eval readback, checkpoint serialization) while "
                        "the card computes — training is bitwise-identical "
                        "either way. auto (default) enables it for runs "
                        "without --fault-inject, membership or the "
                        "integrity sentinel; off = the serial schedule")
    p.add_argument("--fused", action="store_true",
                   help="the JAX package's Pallas fused gossip-mix+SGD "
                        "tail; accepted for the same argv, selects nothing "
                        "here: the port's tail is always its fused CUDA "
                        "kernel")
    p.add_argument("--random-sampler", action="store_true")
    p.add_argument("--sync-bn", action="store_true")
    p.add_argument("--seed", type=int, default=0)             # torch::manual_seed(0)
    p.add_argument("--log-file", default=None, help="JSONL metrics path")
    p.add_argument("--trace-file", default=None,
                   help="per-pass per-param send-trace JSONL (the "
                        "reference's file_write=1 send{r}.txt, "
                        "event.cpp:337-391)")
    p.add_argument("--n-synth", type=int, default=4096)
    p.add_argument("--coordinator", default=None,
                   help="host:port of process 0 — joins a multi-host run "
                        "(mpirun's role; requires --backend mesh)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="snapshot the full gossip TrainState here")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every N epochs (0 = final epoch only)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest snapshot from --checkpoint-dir")
    p.add_argument("--fault-inject", default=None, metavar="MODE:N",
                   help="elastic-recovery drill: crash:N exits 13 after "
                        "epoch N (post-snapshot), hang:N stops making "
                        "progress — pair with eventgrad_tpu_torch.supervise")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic gossip fault injection (chaos/): "
                        "e.g. 'drop=0.2,seed=7,flaky=100-200@0.8,"
                        "delay=3,die=3@500,preempt=6@2' — per-edge drop "
                        "probability, flaky windows [start-end)@p, "
                        "k-pass delivery thinning, permanent peer "
                        "death, scheduled graceful preemption (drain + "
                        f"snapshot + exit {PREEMPTED_EXIT}); gossip "
                        "algos (dpsgd/eventgrad) only. Replayable: the "
                        "schedule is serialized into the first history "
                        "record")
    p.add_argument("--membership", default=None, metavar="SPEC",
                   help="elastic membership schedule (chaos/membership.py): "
                        "e.g. 'leave=1@3,join=1@5' — rank 1 leaves after "
                        "epoch 3, a newcomer joins at position 1 after "
                        "epoch 5, bootstrapping its full gossip state from "
                        "a neighbor's snapshot; every transition force-"
                        "fires the next exchange. Replayable: the schedule "
                        "rides the first history record. Single-process "
                        "ring gossip runs (dpsgd/eventgrad) only; join=/"
                        "leave= clauses inside --chaos are equivalent")
    p.add_argument("--integrity", default=None, metavar="SPEC",
                   help="integrity engine (chaos/integrity.py): 'on', "
                        "'off', or field=value clauses (e.g. 'checksum=1,"
                        "quarantine=1,sentinel=1,rollback=1,"
                        "max_rollbacks=1'). on = wire checksums, non-"
                        "finite quarantine and the divergence sentinel "
                        "with rollback-to-last-good. A trip beyond "
                        f"max_rollbacks exits {INTEGRITY_ABORT_EXIT} and "
                        "the supervisor gives up without a restart. off "
                        "is bitwise-identical to no flag")
    p.add_argument("--chaos-sync-after", type=int, default=0, metavar="N",
                   help="recovery: an edge silent N passes makes the "
                        "receiver request a forced full sync from that "
                        "peer (eventgrad + --chaos; use N > "
                        "--max-silence)")
    p.add_argument("--chaos-freeze-after", type=int, default=0, metavar="N",
                   help="recovery: an edge silent N passes leaves the "
                        "mix with renormalized weights until it speaks "
                        "again (requires --chaos)")
    p.add_argument("--profile-dir", default=None,
                   help="capture a torch.profiler trace (Chrome trace) of "
                        "the training run into this directory")
    p.add_argument("--obs", choices=["off", "block", "epoch"],
                   default="off",
                   help="on-device telemetry: per-leaf fire/deferral "
                        "counts, threshold and drift sums, silence "
                        "histograms, per-edge wire bytes and the message "
                        "ledger, read to the host once per dispatch block; "
                        "block = summaries ride block-end epoch records, "
                        "epoch = every epoch; off = bit-identical to a "
                        "telemetry-free run")
    p.add_argument("--obs-dir", default=None, metavar="DIR",
                   help="export host observability artifacts into DIR at "
                        "exit: trace.json (Chrome-trace spans of dispatch "
                        "blocks, eval, checkpoint, telemetry flushes) and "
                        "metrics.prom (Prometheus textfile gauges)")
    p.add_argument("--log-fsync", action="store_true",
                   help="fsync the --log-file after every record — "
                        "crash-safe JSONL artifacts")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the run goes: cuda (default; raises when "
                        "CUDA is absent) or cpu (the kernels' plain "
                        "PyTorch versions)")
    return p


def _item_refusals(args) -> None:
    """What the port does not run, refused before any data is built."""
    if args.arena == "off":
        raise SystemExit(f"--arena off: {ARENA_OFF_REFUSAL}")


def _card_report(device, mesh=None) -> dict:
    """On the card, for the final record: the kernels' launches of the run
    summed over the group's processes, and each process's peak device
    memory in GiB (a collective: every process calls it); on a mesh also
    the bytes its collectives sent across processes, summed, by
    "collective:axis" (`spmd.Mesh.crossed`). Empty on the CPU, where no
    kernel launches."""
    if device is not None:
        return {}
    import torch

    from eventgrad_tpu_torch import ops

    crossed = {} if mesh is None else {
        f"{kind}:{axis}": v for (kind, axis), v in mesh.crossed.items()}
    mine = ({k: v for k, v in ops.launch_counts().items() if v},
            torch.cuda.max_memory_allocated() / 2**30, crossed)
    every = multihost.all_gather_object(mine)
    launches, sent = {}, {}
    for counts, _, cross in every:
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        for k, v in cross.items():
            sent[k] = sent.get(k, 0) + v
    out = {"kernel_launches": launches,
           "peak_mem_gib": [peak for _, peak, _ in every]}
    if mesh is not None:
        out["mesh_crossed_bytes"] = sent
    return out


def build_image_model(args, sample_shape):
    """The registry's image model for samples of `sample_shape` (the
    port's models take their input geometry; flax infers it)."""
    kw = {}
    if args.model.startswith("resnet"):
        kw["in_channels"] = int(sample_shape[-1])
        if args.num_classes != 10 or args.num_filters != 64:
            # resnet-only, validated in main
            kw.update(num_classes=args.num_classes,
                      num_filters=args.num_filters)
    else:
        kw["input_shape"] = tuple(int(d) for d in sample_shape)
    return MODEL_REGISTRY[args.model](**kw)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    topo = args.mesh  # argparse already applied parse_mesh (also to the default)

    device = None if args.device == "cuda" else args.device
    if args.coordinator:
        if args.backend != "mesh":
            raise SystemExit("--coordinator requires --backend mesh")
        multihost.init(args.coordinator, args.num_processes,
                       args.process_id, device=device)
    elif os.environ.get("EG_COORDINATOR"):
        # the environment twin of the flag (EG_COORDINATOR /
        # EG_NUM_PROCESSES / EG_PROCESS_ID): the same contract, checked
        # before joining the group (an "auto" that quietly fell back to
        # the simulator would run W independent whole-ring simulations)
        if args.backend != "mesh":
            raise SystemExit("EG_COORDINATOR requires --backend mesh")
        multihost.init_from_env(device=device)
    try:
        return _main(args, topo)
    finally:
        multihost.shutdown()


def _main(args, topo) -> int:
    # only the primary logs and exports (every process holds the records)
    primary = multihost.is_primary()
    logger = JsonlLogger(args.log_file if primary else None, echo=primary,
                         fsync=args.log_fsync)
    registry = None
    if args.obs != "off" or args.obs_dir:
        from eventgrad_tpu_torch.obs import Registry

        # the registry wraps (not owns) the logger: every record gains
        # the obs_schema stamp; spans/gauges export at exit via --obs-dir
        registry = Registry(
            logger=logger,
            run_meta={"algo": args.algo, "model": args.model},
        )
    emit = registry.record if registry is not None else logger.log
    try:
        return _run(args, topo, logger, registry, emit)
    finally:
        logger.close()


def _run(args, topo, logger, registry, emit) -> int:
    is_lm = args.model in LM_MODELS
    if args.dataset is None:
        args.dataset = "synthetic-lm" if is_lm else "mnist"
    if is_lm != (args.dataset == "synthetic-lm"):
        raise SystemExit(
            "--dataset synthetic-lm pairs with the transformer models "
            "(--model transformer*) and vice versa"
        )
    if is_lm and args.augment:
        raise SystemExit("--augment is an image transform; not for LM")
    if args.algo != "allreduce" and not topo.gossip_axes:
        raise SystemExit(
            f"--algo {args.algo} needs a gossip axis (dp) in --mesh; "
            f"{tuple(topo.axes)} has none (did you mean dp instead of ddp?)"
        )
    if args.wire_bf16:
        if args.wire and args.wire != "bf16":
            raise SystemExit(
                f"--wire-bf16 conflicts with --wire {args.wire}"
            )
        args.wire = "bf16"
    if args.wire and args.algo == "allreduce":
        raise SystemExit(
            "--wire applies to gossip exchanges; allreduce gradients "
            "keep full precision"
        )
    # the trigger policy the run will use, and the wires it declares
    cli_pol = None
    if args.algo in policy_lib.DEFAULT_FOR_ALGO or args.trigger_policy:
        try:
            cli_pol = policy_lib.resolve(args.trigger_policy, args.algo)
        except ValueError as e:
            raise SystemExit(str(e))
    if args.gossip_wire == "compact" and (
        cli_pol is None or "compact" not in cli_pol.gossip_wires
    ):
        raise SystemExit(
            "--gossip-wire compact rides the statically-sized wire of "
            "an event trigger policy (--algo eventgrad / sp_eventgrad); "
            f"--algo {args.algo} has no compactable payload"
        )
    if args.compact_frac is not None:
        if args.gossip_wire != "compact":
            raise SystemExit("--compact-frac requires --gossip-wire compact")
        if not (0.0 < args.compact_frac <= 1.0):
            raise SystemExit(
                f"--compact-frac must be in (0, 1], got {args.compact_frac}"
            )
        if cli_pol is not None and not cli_pol.compact_needs_capacity:
            raise SystemExit(
                "--compact-frac sizes the capacity autotune; the "
                f"{cli_pol.name!r} policy's compact wire is capacity-"
                "free (its top-k lanes are already statically sized)"
            )
    if args.max_silence < 0:
        raise SystemExit(
            "--max-silence must be >= 0 (0 disables the bound; a "
            "negative value would be silently inert)"
        )
    if args.max_silence and args.algo not in ("eventgrad", "sp_eventgrad"):
        raise SystemExit("--max-silence applies to the event algorithms only")
    if args.staleness < 0:
        raise SystemExit(
            "--staleness must be >= 0 (0 = synchronous, 1 = one-pass-"
            "stale, D >= 2 = the bounded-async gossip engine)"
        )
    if args.staleness:
        if args.algo not in ("eventgrad", "sp_eventgrad"):
            raise SystemExit("--staleness applies to the event algorithms only")
        if args.trace_file:
            raise SystemExit(
                "--trace-file records the synchronous exchange; not "
                "available with --staleness"
            )
    membership = None
    if args.membership is not None:
        from eventgrad_tpu_torch.chaos import MembershipSchedule

        try:
            membership = MembershipSchedule.parse(args.membership)
        except ValueError as e:
            raise SystemExit(f"--membership: {e}")

    def _membership_guards(flag: str):
        """The same guards whether the events arrived via --membership or
        a --chaos spec's join=/leave= clauses."""
        if args.algo not in ("dpsgd", "eventgrad"):
            raise SystemExit(
                f"{flag} rides the gossip exchange (dpsgd/eventgrad); "
                f"--algo {args.algo} has no ring to re-shape"
            )
        if args.trace_file:
            raise SystemExit(
                "--trace-file carries rank-shaped recv staleness; not "
                f"available with {flag}"
            )
        if args.pipeline == "on":
            raise SystemExit(
                f"--pipeline on cannot honor {flag} (transitions "
                "re-shape the state between blocks, which needs the "
                "serial schedule); use --pipeline auto or off"
            )

    if membership is not None:
        _membership_guards("--membership")
    chaos_sched = None
    chaos_policy = None
    if args.chaos is not None:
        from eventgrad_tpu_torch.chaos import ChaosSchedule, RecoveryPolicy

        if args.algo not in ("dpsgd", "eventgrad"):
            raise SystemExit(
                "--chaos injects loss into the gossip exchange; "
                f"--algo {args.algo} has no maskable edges"
            )
        if args.fused:
            raise SystemExit(
                "--chaos is not combinable with --fused (the Pallas tail "
                "bakes in the uniform mix weight)"
            )
        try:
            chaos_sched = ChaosSchedule.parse(args.chaos)
        except ValueError as e:
            raise SystemExit(f"--chaos: {e}")
        if chaos_sched.membership:
            if membership is not None:
                raise SystemExit(
                    "membership events given both via --membership and "
                    "the --chaos spec's join=/leave= clauses; pass one"
                )
            _membership_guards("--chaos join=/leave=")
        if args.chaos_sync_after and args.algo != "eventgrad":
            raise SystemExit(
                "--chaos-sync-after rides the event fire decision; "
                "dpsgd already sends everything every pass — a dropped "
                "message there is final (use --chaos-freeze-after)"
            )
        if args.chaos_sync_after or args.chaos_freeze_after:
            try:
                chaos_policy = RecoveryPolicy(
                    sync_after=args.chaos_sync_after,
                    freeze_after=args.chaos_freeze_after,
                )
                chaos_policy.validate_against(args.max_silence)
            except ValueError as e:
                raise SystemExit(
                    f"--chaos-sync-after/--chaos-freeze-after: {e}")
    elif args.chaos_sync_after or args.chaos_freeze_after:
        raise SystemExit(
            "--chaos-sync-after/--chaos-freeze-after need --chaos (use "
            "--chaos 'drop=0' for recovery monitoring without injected "
            "faults)"
        )
    if args.pipeline == "on" and args.fault_inject:
        raise SystemExit(
            "--pipeline on cannot honor --fault-inject (the fault must "
            "land at an exact post-snapshot epoch boundary, which needs "
            "the serial schedule); use --pipeline auto or off"
        )
    integrity_cfg = None
    if args.integrity is not None:
        from eventgrad_tpu_torch.chaos import integrity as chaos_integrity

        try:
            integrity_cfg = chaos_integrity.resolve(args.integrity)
        except ValueError as e:
            raise SystemExit(f"--integrity: {e}")
    if integrity_cfg is not None:
        if (
            (integrity_cfg.checksum or integrity_cfg.quarantine)
            and args.algo != "eventgrad"
        ):
            raise SystemExit(
                "--integrity checksums/quarantine ride the event "
                f"exchange; --algo {args.algo} has none (pass "
                "'checksum=0,quarantine=0,...' for the sentinel alone)"
            )
        if args.fused:
            raise SystemExit(
                "--integrity is not combinable with --fused (the Pallas "
                "update tail bypasses the guarded update path)"
            )
        if args.pipeline == "on" and integrity_cfg.sentinel:
            raise SystemExit(
                "--pipeline on cannot honor the --integrity sentinel/"
                "rollback engine (the verdict on block B gates what "
                "block B+1 may dispatch); use --pipeline auto or off, "
                "or pass 'sentinel=0,rollback=0,...'"
            )
    if not is_lm and not args.model.startswith("resnet") and (
        args.num_classes != 10 or args.num_filters != 64
    ):
        raise SystemExit(
            "--num-classes/--num-filters apply to resnet models only "
            "(the reference's small CNNs have fixed heads)"
        )
    _item_refusals(args)
    # the port's device rule: the card unless --device cpu, and an error
    # (before any data is built) when CUDA is absent
    device = None if args.device == "cuda" else args.device
    resolve_device(device)

    n_test = max(512, args.n_synth // 8)
    if is_lm:
        x, y = synthetic_lm_dataset(
            args.n_synth, args.seq_len, args.vocab, args.seed
        )
        xt, yt = synthetic_lm_dataset(
            n_test, args.seq_len, args.vocab, args.seed, split="test"
        )
    elif args.dataset == "synthetic-imagenet":
        # ImageNet-shaped scale stress: class-prototype images at
        # --image-size, --num-classes labels
        shape = (args.image_size, args.image_size, 3)
        x, y = synthetic_dataset(
            args.n_synth, shape, num_classes=args.num_classes, seed=args.seed
        )
        xt, yt = synthetic_dataset(
            n_test, shape, num_classes=args.num_classes,
            seed=args.seed, split="test",
        )
    else:
        # --dataset synthetic means "hermetic stand-in even if real data
        # exists": drop data_dir so load_or_synthesize can't pick up
        # on-disk files
        dataset = "mnist" if args.dataset == "synthetic" else args.dataset
        data_dir = None if args.dataset == "synthetic" else args.data_dir
        x, y = load_or_synthesize(dataset, data_dir, "train", args.n_synth,
                                  args.seed)
        xt, yt = load_or_synthesize(dataset, data_dir, "test", n_test,
                                    args.seed)

    # the data-parallel degree is the data axes' extent: gossip ranks
    # plus any ddp subgroups split the batch; sp/tp/pp/ep ranks replicate
    # or chunk it instead
    hybrid = topo.is_hybrid
    batch = args.batch_size
    if args.global_batch:
        batch = max(1, args.global_batch // topo.n_data_ranks)

    if is_lm:
        model = build_lm_model(args, topo)
    else:
        model = build_image_model(args, np.shape(x)[1:])

    event_cfg = EventConfig(
        adaptive=args.thres_mode == "adaptive",
        horizon=args.horizon,
        constant=args.constant,
        warmup_passes=args.warmup_passes,
        history=args.history,
        max_silence=args.max_silence,
    )
    from eventgrad_tpu_torch.utils import profiling

    scope = (
        profiling.trace(args.profile_dir) if args.profile_dir
        else contextlib.nullcontext()
    )
    hist = []
    try:
        # the mesh the run lifts onto (None: the simulator), built here so
        # that the final record can read what crossed its processes
        mesh = resolve_backend(args.backend, topo, device)
        try:
            with scope:
                state, hist = train(
                    model, topo, x, y,
                    algo=args.algo, epochs=args.epochs, batch_size=batch,
                    learning_rate=args.lr, momentum=args.momentum,
                    event_cfg=event_cfg,
                    sparse_cfg=SparseConfig(args.topk_percent),
                    augment=args.augment, random_sampler=args.random_sampler,
                    sync_bn=args.sync_bn, backend=args.backend, mesh=mesh,
                    seed=args.seed, x_test=xt, y_test=yt,
                    checkpoint_dir=args.checkpoint_dir,
                    save_every=args.save_every,
                    resume=args.resume, trace_file=args.trace_file,
                    wire=args.wire, staleness=args.staleness,
                    gossip_wire=args.gossip_wire,
                    compact_frac=args.compact_frac,
                    trigger_policy=args.trigger_policy,
                    fused_update=args.fused, fault_inject=args.fault_inject,
                    chaos=chaos_sched, chaos_policy=chaos_policy,
                    membership=membership, integrity=integrity_cfg,
                    obs=args.obs, registry=registry,
                    arena={"auto": None, "on": True}[args.arena],
                    bucketed=args.bucketed or None,
                    carrier_resident=args.carrier_resident or None,
                    pipeline={
                        "auto": None, "on": True, "off": False
                    }[args.pipeline],
                    on_epoch=emit,  # records stream as epochs finish: live
                    # metrics for the user, a liveness signal for supervise
                    device=device,
                )
        except GracefulPreemption as e:
            # the loop drained, snapshotted at the block boundary and
            # left the PREEMPTED marker: exit the reserved code so the
            # supervisor relaunches at once without charging its budget
            emit({"preempted": True, **e.info})
            print(f"preempted: {e}", file=sys.stderr, flush=True)
            return PREEMPTED_EXIT
        except IntegrityEscalation as e:
            # the retained last-known-good state cannot outrun this
            # fault: exit the reserved code so the supervisor gives up
            # instead of replaying the same divergence
            emit({"integrity_abort": True, "reason": str(e)})
            print(f"integrity abort: {e}", file=sys.stderr, flush=True)
            return INTEGRITY_ABORT_EXIT

        card = _card_report(device, mesh)
        if hybrid:
            # a consensus average across sp/tp/pp/ep ranks would mix
            # differently sharded parameters: the final train metrics
            # instead (no history when resuming a final-epoch snapshot)
            rec = {"final": True, "consensus_eval": False}
            if hist:
                rec.update(loss=hist[-1]["loss"],
                           train_acc=hist[-1]["train_acc"])
            emit({**rec, **card})
        else:
            # the consensus model (the mean over the ranks, gathered from
            # every process) on rank 0's BatchNorm statistics, evaluated
            # once by the primary
            params = multihost.to_host(state.params)
            stats = multihost.to_host(state.batch_stats)
            if multihost.is_primary():
                final = evaluate(model, consensus_params(params),
                                 rank0_slice(stats), xt, yt,
                                 device=params.device)
                emit({"final": True, **final, **card})
    finally:
        # exporters land even on an exception path — a crashed run's
        # spans are exactly the ones worth reading — but they are
        # best-effort: an unwritable --obs-dir must not mask the real
        # exception
        try:
            if registry is not None and args.obs_dir and (
                    multihost.is_primary()):
                # final-state gauges for the textfile collector
                if hist:
                    last = hist[-1]
                    registry.gauge("epochs_completed", last["epoch"])
                    for k in (
                        "loss", "msgs_saved_pct", "test_accuracy",
                        "sent_bytes_per_step_per_chip",
                        "sent_bytes_wire_real_per_step_per_chip",
                    ):
                        if isinstance(last.get(k), (int, float)):
                            registry.gauge(f"last_{k}", last[k])
                os.makedirs(args.obs_dir, exist_ok=True)
                registry.write_chrome_trace(
                    os.path.join(args.obs_dir, "trace.json")
                )
                registry.write_prometheus(
                    os.path.join(args.obs_dir, "metrics.prom")
                )
        except OSError as e:
            import warnings

            warnings.warn(f"--obs-dir export failed: {e}", RuntimeWarning)
    return 0


if __name__ == "__main__":
    sys.exit(main())
