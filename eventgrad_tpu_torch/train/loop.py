"""Training loop, evaluation and consensus helpers.

Port of `eventgrad_tpu/train/loop.py`: `train` (dispatch blocks of K
epochs, each launching its K x steps passes with no synchronize between
its epochs, the block prefetcher or the device-resident dataset, and the
dispatch pipeline: block B's host work after block B+1's launches, the
eval deferred, the snapshots serialized in the background; the compact
wire's warmup-then-rebuild capacity autotune; the bucketed schedule, the
bounded-async staleness D >= 2, the chaos schedule's fault clauses with
the recovery policies, the integrity engine's sentinel and rollback;
crash-safe snapshots, resume, graceful preemption and the crash sites;
the on-device telemetry with the message ledger's audit, and the
registry's spans and gauges; the elastic membership transitions at
epoch ends), `DeviceEvaluator`, `evaluate`, `consensus_params` and
`rank0_slice`.
History records carry the JAX records' keys for the fields the slice
computes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from eventgrad_tpu_torch.chaos import crashpoint
from eventgrad_tpu_torch.chaos import integrity as chaos_integrity
from eventgrad_tpu_torch.chaos import membership as chaos_membership
from eventgrad_tpu_torch.chaos import monitor as chaos_monitor
from eventgrad_tpu_torch.chaos.membership import force_refresh
from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy
from eventgrad_tpu_torch.chaos.schedule import resolve as resolve_chaos
from eventgrad_tpu_torch.data.prefetch import CudaTransfer, EpochPrefetcher
from eventgrad_tpu_torch.data.sharding import (
    epoch_index_plan, epoch_steps, expand_to_mesh,
)
from eventgrad_tpu_torch.obs import OBS_MODES
from eventgrad_tpu_torch.obs import device as obs_device
from eventgrad_tpu_torch.obs import ledger as obs_ledger
from eventgrad_tpu_torch.parallel import collectives, multihost, spmd
from eventgrad_tpu_torch.parallel import policy as policy_lib
from eventgrad_tpu_torch.parallel.arena import arena_spec
from eventgrad_tpu_torch.parallel.events import EventConfig
from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
from eventgrad_tpu_torch.parallel.spmd import resolve_backend
from eventgrad_tpu_torch.parallel.topology import Topology
from eventgrad_tpu_torch.train import state as state_lib
from eventgrad_tpu_torch.train.state import (
    EVENT_ALGOS, TrainState, init_train_state,
)
from eventgrad_tpu_torch.train.steps import make_train_step
from eventgrad_tpu_torch.utils import checkpoint
from eventgrad_tpu_torch.utils.devices import resolve_device
from eventgrad_tpu_torch.utils.metrics import msgs_saved_pct


def consensus_params(stacked: Any) -> Any:
    """Average the per-rank models (a `[R, n]` arena, or a dict of
    rank-stacked tensors) into the consensus model."""
    if isinstance(stacked, dict):
        return {k: torch.mean(v, dim=0) for k, v in stacked.items()}
    return torch.mean(stacked, dim=0)


def rank0_slice(tree: Any) -> Any:
    """Rank 0's slice of a rank-stacked tensor or dict of tensors."""
    if isinstance(tree, dict):
        return {k: v[0] for k, v in tree.items()}
    return tree[0]


def _as_input(model, x) -> np.ndarray:
    """Model inputs as a contiguous array of the model's `input_dtype`:
    float32 images, int64 tokens (what torch indexes with)."""
    return np.ascontiguousarray(x, model.input_dtype)


def _step_mean(per_step: np.ndarray) -> float:
    """Rank 0's mean over the epoch's steps of a `[steps, R]` float32
    byte count, summed in float64: the counts are exact integers in
    float32 (up to 2^24 per ulp step), and a float32 sum of 27,912,332
    three times already rounds (the JAX loop's float32 mean reads
    27,912,330 for it)."""
    return float(per_step[..., 0].mean(dtype=np.float64))


#: post-warmup steps of fired sizes the capacity autotune observes
#: before it sizes the compact buffer
COMPACT_MIN_SAMPLES = 16


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _clone(x):
    """A deep copy of a train state (the integrity engine's in-memory
    last-known-good, and a rollback's owned copy of it): tensors cloned,
    a generator as a new one in the same state, the nesting
    (dataclasses, tuples, lists, dicts) kept."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.Generator):
        g = torch.Generator(device=x.device)
        g.set_state(x.get_state())
        return g
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _clone(getattr(x, f.name))
            for f in dataclasses.fields(x)})
    return x


def _clone_carry(carry: Optional[Dict[str, np.ndarray]]):
    return None if carry is None else {k: v.copy() for k, v in carry.items()}


def _known_added(path: str) -> bool:
    """State fields added after a snapshot could have been written, which
    a resume may fill from their initial values (the JAX loop's list)."""
    return (path == "state/event/num_deferred"
            or path.startswith("state/telemetry")
            or path.startswith("trace_carry"))


def _loss_record(pass_base: int, s_i: int, r: int,
                 loss_all: np.ndarray) -> Dict[str, Any]:
    """Per-(pass, rank) loss record: the shared schema of the send
    trace's train{r}.txt rider and the non-event values{r}.txt stream
    (the JAX loop's)."""
    return {
        "pass": pass_base + s_i + 1,
        "rank": r,
        "loss": round(float(loss_all[s_i, r]), 6),
    }


def _write_trace(path: str, m: Dict[str, np.ndarray], pass_base: int,
                 topo: Topology, names: List[str],
                 carry: Dict[str, np.ndarray]) -> None:
    """Append the reference's file_write=1 instrumentation as JSONL, as
    the JAX loop writes it.

    Send side (send{r}.txt, event.cpp:337-339,385-391): one record per
    (pass, rank) with the per-leaf norm / thres / fired vectors in leaf
    order, plus the step's train loss (train{r}.txt). Receive side
    (recv{r}.txt, event.cpp:418-425,446-461): one record per (pass, rank,
    neighbour) with the received buffer's norm and a changed bit, derived
    from the sender's fire bit, with `carry` holding the stale norm
    between messages (the buffers start as zeros). A header record names
    the leaves (`names`, flax order, `/`-joined) and the neighbour
    directions on the first write to an empty file."""
    n_ranks = topo.n_ranks
    fired_all = np.asarray(m["trace_fired"])
    norm_all = np.asarray(m["trace_norm"])
    thres_all = np.asarray(m["trace_thres"])
    loss_all = np.asarray(m["loss"])
    specs = topo.neighbors
    last = carry["recv_norm"]
    srcs = [
        [topo.neighbor_source(r, nb) for r in range(n_ranks)] for nb in specs
    ]
    first = not os.path.exists(path) or os.path.getsize(path) == 0
    with open(path, "a") as tf:
        if first:
            tf.write(json.dumps({
                "trace_params": list(names),
                "trace_neighbors": [nb.name for nb in specs],
            }) + "\n")
        steps = fired_all.shape[0]
        for s_i in range(steps):
            for r in range(n_ranks):
                rec = _loss_record(pass_base, s_i, r, loss_all)
                rec.update(
                    norm=[round(float(v), 6) for v in norm_all[s_i, r]],
                    thres=[round(float(v), 6) for v in thres_all[s_i, r]],
                    fired=[int(v) for v in fired_all[s_i, r]],
                )
                tf.write(json.dumps(rec) + "\n")
            for k, nb in enumerate(specs):
                for r in range(n_ranks):
                    src = srcs[k][r]
                    ch = fired_all[s_i, src]
                    last[k, r] = np.where(ch, norm_all[s_i, src], last[k, r])
                    tf.write(
                        json.dumps(
                            {
                                "pass": pass_base + s_i + 1,
                                "rank": r,
                                "recv": nb.name,
                                "changed": [int(v) for v in ch],
                                "norm": [round(float(v), 6)
                                         for v in last[k, r]],
                            }
                        )
                        + "\n"
                    )


def _write_loss_stream(path: str, loss_all: np.ndarray, pass_base: int,
                       n_ranks: int) -> None:
    """The non-event algorithms' trace: per-step per-rank loss records,
    the (epoch, loss) stream cent/decent call values{r}.txt (cent.cpp:124,
    decent.cpp:166)."""
    with open(path, "a") as tf:
        for s_i in range(loss_all.shape[0]):
            for r in range(n_ranks):
                tf.write(json.dumps(_loss_record(
                    pass_base, s_i, r, loss_all)) + "\n")


#: why the port refuses the JAX package's tree path (`arena=False`,
#: the CLI's `--arena off`)
ARENA_OFF_REFUSAL = (
    "the JAX package's tree path is not in the port, which runs the flat "
    "arena only; not queued, by design (ROADMAP queue 1, \"Not queued, by "
    "design\"); use the arena (None or True, --arena auto or on)")

#: the trace carry's path in a snapshot (the JAX snapshot's
#: `trace_carry` leaf)
TRACE_CARRY = "trace_carry/recv_norm"


def _resume(found: str, template: TrainState, *, algo: str, staleness: int,
            resident_wire: Optional[str], bucketed_k: int, device,
            trace_carry: Optional[Dict[str, np.ndarray]] = None
            ) -> Tuple[TrainState, int]:
    """(the state restored from the snapshot `found`, its epoch). A
    snapshot of another algorithm or written on another device type
    raises. The three layout guards run next, both directions, with the
    JAX loop's causes: the queue depth D, the receive buffers' resident
    dtype and the bucket count K are checkpoint layout. Then the restore
    onto `template`; a snapshot that lacks only known-added fields
    resumes with them at their initial values, loudly. Anything else
    raises. A `trace_carry` (a traced run's receive-side carry) is
    filled in place from the snapshot's, or, where the snapshot has
    none, stays at zeros, loudly."""
    raw, meta = checkpoint.peek(found, device=device)
    lay = meta["layout"]
    if lay["algo"] != algo:
        raise RuntimeError(
            f"checkpoint restore failed with algo={algo!r}: this snapshot "
            f"was written by an algo={lay['algo']!r} run, and the "
            "algorithm fixes the state's layout (trigger state, receive "
            "buffers); resume with the snapshot's algorithm")
    if meta["device"] != device.type:
        raise RuntimeError(
            f"checkpoint restore failed on device {device.type!r}: this "
            f"snapshot was written on {meta['device']!r}, and a snapshot "
            "restores onto the device type it was written on (the random "
            "stream's state is the device's generator's)")
    snap_depth = int(lay["staleness_depth"])
    if snap_depth != (staleness if staleness >= 2 else 0) and algo in (
            "eventgrad", "sp_eventgrad"):
        snap_word = (
            f"staleness={snap_depth} (bounded-async, "
            f"{snap_depth}-deep per-edge delivery queues)"
            if snap_depth else "staleness<=1 (no delivery queues)"
        )
        raise RuntimeError(
            f"checkpoint restore failed with staleness="
            f"{staleness}: this snapshot was written by a "
            f"{snap_word} run, and the bounded-async queue "
            "depth D is part of the state layout (EventState"
            ".pending / SparseState.pending) — "
            "resuming across a different D would "
            + ("silently drop the snapshot's in-flight "
               "messages" if snap_depth else
               "fabricate empty in-flight queues")
            + "; resume with the snapshot's original "
            f"staleness={'%d' % snap_depth if snap_depth >= 2 else '0/1'}"
            " setting, then re-snapshot to migrate"
        )
    snap_res = (None if lay["resident_dtype"] == "f32"
                else lay["resident_dtype"])
    if snap_res != resident_wire and algo == "eventgrad":
        res_word = (f"carrier-resident wire={snap_res!r}" if snap_res
                    else "f32-resident")
        raise RuntimeError(
            "checkpoint restore failed with carrier_resident="
            f"{'on (wire=%r)' % resident_wire if resident_wire else 'off'}: "
            f"this snapshot was written by a "
            f"{res_word} run, and the resident dtype "
            "of the EventState receive buffers is part of the "
            "checkpoint layout — a cross-resident restore would "
            "silently cast the buffers (and orphan or fabricate "
            "the int8 dequant scales); resume with the "
            "snapshot's original carrier_resident/wire setting, "
            "then re-snapshot to migrate"
        )
    snap_k = int(lay["buckets"])
    if snap_k != bucketed_k and algo == "eventgrad":
        snap_kword = (
            f"bucketed={snap_k} (per-bucket EventState buffers)"
            if snap_k > 1 else
            "monolithic (bucketed off) layout"
        )
        raise RuntimeError(
            "checkpoint restore failed with bucketed="
            f"{bucketed_k if bucketed_k > 1 else 'off'}: this "
            f"snapshot was written by a {snap_kword} run, and "
            "the bucket count K is part of the EventState "
            "layout (receive buffers, dequant scales, and "
            "bounded-async delivery queues are carried "
            "per-bucket) — resume with the snapshot's original "
            "bucketed="
            f"{'%d' % snap_k if snap_k > 1 else 'off'} setting, "
            "then re-snapshot to migrate"
        )
    tmpl = state_lib.to_flat(template)
    if trace_carry is not None:
        tmpl[TRACE_CARRY] = torch.from_numpy(trace_carry["recv_norm"])
    flat, missing = checkpoint.restore_with_fill(raw, tmpl)
    if trace_carry is not None:
        trace_carry["recv_norm"][...] = flat.pop(TRACE_CARRY).cpu().numpy()
    unknown = [m for m in missing if not _known_added(m)]
    if unknown:
        raise ValueError(f"snapshot lacks leaves {unknown}")
    if missing:
        warnings.warn(f"snapshot predates state fields {missing}; they "
                      "resume from init values")
    return state_lib.from_flat(template, flat), int(meta["epoch"])


class DeviceEvaluator:
    """The test pass of one model with the test set kept on the device.

    The set is uploaded once, cut to whole batches (unless it is smaller
    than one batch); `dispatch(params, batch_stats)` launches the pass
    and returns two device scalars (correct labels, summed NLL), and
    `result` reads them back as {"accuracy", "loss"}. The loop dispatches
    the eval at a block's end and reads it a block later when pipelined;
    serial and pipelined runs share this one implementation, so their
    numbers agree. `params` is a `[n]` parameter arena (e.g.
    `consensus_params(state.params)`), `batch_stats` a dict of `[C]`
    running statistics (empty without BatchNorm); `x` is images with one
    label each, or integer tokens `[n, T]` with a label per token."""

    def __init__(self, model, x, y, batch_size: int = 1000, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.spec = arena_spec(model)
        x = _as_input(model, x)
        y = np.asarray(y, np.int64)
        self.batch = batch_size if len(x) >= batch_size else len(x)
        self.n = (len(x) // self.batch) * self.batch
        # labels scored: samples, or every token of a language model
        self.n_labels = self.n * int(np.prod(y.shape[1:]))
        self.x = torch.from_numpy(np.ascontiguousarray(x[:self.n])).to(
            self.device)
        self.y = torch.from_numpy(np.ascontiguousarray(y[:self.n])).to(
            self.device)

    @torch.no_grad()
    def dispatch(self, params, batch_stats):
        """Launch the pass; returns (correct, summed NLL) on the device."""
        pdict = self.spec.unravel(params.to(self.device))
        stats = {k: v.to(self.device) for k, v in batch_stats.items()}
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        nll = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(0, self.n, self.batch):
            xb, yb = self.x[i:i + self.batch], self.y[i:i + self.batch]
            out = torch.func.functional_call(self.model, pdict,
                                             (xb, stats, False))
            logp = torch.log_softmax(out.to(torch.float32), dim=-1)
            nll = nll - torch.gather(logp, -1, yb[..., None]).sum()
            correct = correct + (out.argmax(-1) == yb).sum()
        return correct, nll

    def result(self, fut) -> Dict[str, float]:
        """{"accuracy", "loss"} of a `dispatch`'s scalars (blocking)."""
        correct, nll = fut
        return {
            "accuracy": 100.0 * int(correct) / self.n_labels,
            "loss": float(nll) / self.n_labels,
        }


def evaluate(model, params, batch_stats, x, y, batch_size: int = 1000,
             device=None) -> Dict[str, float]:
    """One test pass (`DeviceEvaluator`, dispatched and read at once):
    `params` a `[n]` parameter arena, `batch_stats` a dict of `[C]`
    running statistics. Returns {"accuracy", "loss"}."""
    ev = DeviceEvaluator(model, x, y, batch_size, device=device)
    return ev.result(ev.dispatch(params, batch_stats))


def _host_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t` that does not block: on the card a pinned
    buffer filled by a non-blocking copy (valid once the stream has
    passed it), on the CPU the tensor itself (CPU work is done when its
    call returns)."""
    if t.device.type != "cuda":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int64 index array on `device`, copied from pinned memory
    without blocking the host on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.int64))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def train(
    model,
    topo: Topology,
    x_train: np.ndarray,
    y_train: np.ndarray,
    *,
    algo: str = "dpsgd",
    epochs: int = 2,
    batch_size: int = 64,
    learning_rate: float = 0.05,
    momentum: float = 0.0,
    event_cfg: Optional[EventConfig] = None,
    sparse_cfg: Optional[SparseConfig] = None,
    augment: bool = False,
    random_sampler: bool = False,
    sync_bn: bool = False,
    mesh=None,
    backend: Optional[str] = None,
    seed: int = 0,
    x_test: Optional[np.ndarray] = None,
    y_test: Optional[np.ndarray] = None,
    log_every_epoch: bool = True,
    trigger_policy: Optional[str] = None,
    wire: Optional[str] = None,
    staleness: int = 0,
    carrier_resident: Optional[bool] = None,
    gossip_wire: str = "dense",
    compact_frac: Optional[float] = None,
    bucketed: Optional[int] = None,
    arena: Optional[bool] = None,
    chaos=None,
    chaos_policy: Optional[RecoveryPolicy] = None,
    integrity=None,
    checkpoint_dir: Optional[str] = None,
    save_every: int = 0,
    resume: bool = False,
    trace_file: Optional[str] = None,
    fused_update: bool = False,
    fault_inject: Optional[str] = None,
    on_epoch: Optional[Callable[[Dict[str, Any]], None]] = None,
    obs: str = "off",
    registry: Optional[Any] = None,
    membership=None,
    epochs_per_dispatch: int = 1,
    pipeline: Optional[bool] = None,
    device_data: Optional[bool] = None,
    device=None,
) -> Tuple[TrainState, List[Dict[str, Any]]]:
    """Run the training job on `device` (None = CUDA, raising without it);
    returns (final_state, per-epoch history). `batch_size` is per rank.
    `x_train` is float images with `y_train` one label each, or integer
    tokens `[n, T]` with next-token labels `[n, T]` (`train_acc` then
    counts tokens).
    On a hybrid mesh (`topo.is_hybrid`: sp, tp, pp or ep axes beside the
    data axes) the batches shard over the data ranks and
    `data.sharding.expand_to_mesh` lifts them onto every rank (an sp rank
    takes its chunk of the tokens, a tp/pp/ep rank its group's batch),
    the model's input is one sp chunk, and the run keeps the host data
    path and skips the per-epoch consensus eval and the consensus-error
    probe, as the JAX loop does (a consensus average would mix
    differently sharded parameters). Every rank trains on the flat arena,
    one row per rank.
    Each record carries `loss`, `train_acc`, `sent_bytes_per_step_per_chip`,
    `steps`, `dispatch_block` (the 0-based dispatch block),
    `dispatch_cold` (the first block of its size, wire mode and rank
    count: block 0, a remainder block, the first compact block), `wall_s`
    (the block's seconds over its epochs: from its first pass to the end
    of its last, before the riders that read it: the
    metric readback, the probe, the eval; on the card the device's clock,
    CUDA events around the passes, so that under the pipeline each
    block's time is its own),
    `wire`, `resident_dtype` ("f32" | "bf16" | "int8") and `staleness`,
    plus `policy`, `num_events`, `num_deferred`, `msgs_saved_pct` and
    `fired_frac` for eventgrad and sp_eventgrad, and, on the record of a
    block's last epoch, `test_accuracy` / `test_loss` when a test set is
    given and `log_every_epoch` (`DeviceEvaluator`, the test set on the
    device).

    `epochs_per_dispatch=K` runs dispatch blocks of K epochs: the block's
    passes launch back to back, its metrics are stacked on the device
    and read back in one copy, then split into per-epoch records. K
    resolves as the JAX loop's: 1 under membership and with
    `obs="epoch"`; at most `total_epochs // 2` (two blocks at least); on
    the host data path at most `EG_HOST_BLOCK_MAX_BYTES` (1.5e9) over
    twice the dataset's bytes; then the largest divisor of `save_every`
    not above it, and blocks split at every multiple of `save_every`.
    `device_data` (None = on for CUDA runs without membership whose
    data is at most `EG_DEVICE_DATA_MAX_BYTES`, 1.5e9 bytes) uploads the
    dataset once and gathers each pass's batch on the device from the
    block's index plan; off, `data/prefetch.EpochPrefetcher` assembles
    block B+1 (and on the card uploads it, pinned, on a side stream) on
    a worker thread while block B runs; `True` with membership raises.
    `pipeline` (None = on without membership and the integrity sentinel;
    `True` with either raises the JAX loop's cause) runs block B's host
    work (readback, telemetry flush, records, eval readback) after block
    B+1's launches: everything it reads (the packed metrics and
    counters, the consensus-error probe, the eval's two scalars) is
    enqueued before B+1 launches and copied to pinned host memory
    without blocking. A block with a due save, and the compact wire's
    dense autotune, drain at once. A due save's tensors are copied on
    the device and serialized by `utils/checkpoint.AsyncWriter` behind
    the next block's compute, and swapped in as soon as it is on disk;
    the next save, a preemption drain and the end join it. The state
    and every record
    value but `wall_s` and `dispatch_*` are bitwise the serial K = 1
    run's (the block-end riders land on each block's last epoch).

    `algo` is one of "allreduce", "dpsgd", "eventgrad", "sp_eventgrad";
    `sparse_cfg` sets sp_eventgrad's top-k percent (default 10%), and
    `augment=True` pads, flips and crops every rank's images each step.
    `sync_bn=True` averages the BatchNorm running statistics over every
    rank after each update (a model without BatchNorm is unchanged).

    The JAX loop's launcher arguments: `backend` (None, "vmap", "sim":
    the stacked simulator; "mesh" / "shard_map": the device-mesh lift,
    `parallel/spmd.build_mesh` over the initialised process group, or
    one process holding every rank; "auto": the mesh when a group of
    more than one process is initialised, else the simulator) and
    `mesh` (a `spmd.Mesh`; "vmap" beside it raises). On a mesh each
    process builds the whole initial state (or reads the whole
    snapshot) and keeps its rows, steps on them with the collectives
    routed through the group, and gathers the per-rank metrics (and the
    telemetry, the consensus-error probe's parameters) at each block's
    readback, so every process holds the simulator's records; the first
    record names the `transport` and the `mesh_processes`. Only the
    primary calls `on_epoch`, writes the trace file and the snapshots
    (gathered, then a barrier); a resume reads the shared snapshot. The
    returned state is this process's rows (`multihost.to_host` gathers
    it). A multi-process run skips the per-epoch consensus eval and
    keeps the serial schedule, as the JAX loop does; refused on a mesh
    with the JAX loop's words: the integrity sentinel/rollback engine,
    membership, `pipeline=True` (more than one process) and
    `device_data=True`. Everything else runs on a mesh as on the
    simulator: the tensor-, pipeline- and expert-parallel models,
    Ulysses attention, and the fault clauses with the in-step integrity
    riders and the recovery policy (the health counters and verdicts
    gathered with the metrics).
    `arena` (None or True:
    the flat arena, the port's only layout, True refused for the algos
    the JAX arena does not serve as the JAX loop refuses it; False, the
    JAX tree path, raises: not queued, by design); `fused_update` is
    accepted and selects nothing: the port's gossip tail is always the
    fused CUDA kernel (the plain version on CPU tensors).
    `trace_file` appends the reference's `file_write=1` instrumentation
    as JSONL: on the event algorithms a header naming the leaves (flax
    order) and neighbours, then per pass the send-side record of every
    rank (loss, per-leaf norm, threshold, fire bit) and the receive-side
    record of every (rank, neighbour) (changed bits, the buffer's norm,
    carried between messages and saved with each snapshot); on the other
    algorithms one loss record per (pass, rank). Refused with membership.
    `fault_inject` ("crash:N" or "hang:N") kills (exit
    `exitcodes.FAULT_INJECT_EXIT`, 13) or wedges the process at the end
    of epoch N, after its snapshot, for a supervisor's drills; it pins
    one-epoch blocks and the serial schedule (`pipeline=True` with it
    raises). A resumed run past epoch N does not fire it again.

    `wire` (None = f32, "bf16", "int8") compresses the gossip exchange;
    `staleness=1` (eventgrad) mixes with the previous step's buffers;
    `carrier_resident=True` (eventgrad, bf16/int8 wire; None = off)
    keeps the receive buffers in the wire dtype, bitwise the f32-resident
    run (see `train/steps.make_train_step`).

    `gossip_wire="compact"` (eventgrad; `trigger_policy` norm_delta,
    micro or hybrid) runs dense through the trigger's warmup, then sizes
    a static capacity once and rebuilds the step on the same state: with
    `compact_frac`, `min(n, max(largest leaf, ceil(frac * n)))` at the
    first epoch whose last pass is past warmup; else
    `collectives.choose_capacity` of the post-warmup peak of fired
    elements over at least 16 steps, and if that reaches the whole model
    the run stays dense (`compact_skipped`). sp_eventgrad's top-k wire
    takes "compact" as a no-op alias from the first step. Records then
    carry `gossip_wire` ("dense" until the switch), `compact_capacity`,
    and on the first compact epoch `compact_autotuned` (plus
    `compact_fired_peak_elems`, and `compact_skipped` where it stayed
    dense).

    `bucketed=K` (eventgrad, sp_eventgrad) runs the bucketed schedule
    (records add `buckets` and `sent_bytes_wire_real_per_bucket`; the
    compact capacity is at least the bucketed floor, the sum of the
    buckets' largest leaves). `staleness=D >= 2` (eventgrad,
    sp_eventgrad) runs the bounded-async delivery queues; eventgrad's
    records add `edge_staleness_max` (the end-of-epoch per-edge peak)
    and `late_commits` (cumulative). `chaos` (a `ChaosSchedule`, spec
    string or dict; eventgrad, dpsgd) injects its faults and lags: the
    first record carries the schedule as `chaos` (and `chaos_policy`, the
    `RecoveryPolicy` of forced sync and edge freeze), every record the
    per-edge `edge_silence_max`, `edge_status`, `chaos_drops` and the
    end-of-epoch consensus error `consensus_err_max` / `_mean`. Unlike
    the JAX loop, a bucketed run never demotes to the monolithic fused
    tail: the kernels are the card path, with pitched forms per
    bucket.

    `integrity` (an `IntegrityConfig`, spec or dict) runs the integrity
    engine: the step's checksums and quarantine (eventgrad), and the
    divergence sentinel, which judges each block by its mean loss and
    its end's consensus error. With `rollback` an
    in-memory last-known-good snapshot follows every healthy block; a
    trip restores it, re-arms every event buffer
    (`membership.force_refresh`), with `escalate` rebuilds the step
    hardened (checksums and quarantine on) and replays from the next
    epoch; a trip beyond `max_rollbacks` (or with rollback off) raises
    `IntegrityEscalation`. Records add `wire_rejects`,
    `quarantined_steps` and `integrity_rollbacks`, the first one the
    config as `integrity`, the first after a rollback
    `integrity_rollback` (reason, tripped and restored epochs, hardened).

    With a `checkpoint_dir` the whole state (`train/state.to_flat`:
    parameters, trace, BatchNorm statistics, pass counter, the event
    state with its buffers, scales and queues, the top-k state, the peer
    health and the random stream) is snapshotted to
    `<checkpoint_dir>/ckpt` every `save_every` epochs and at the end
    (`utils/checkpoint.save`, crash-safe). `resume=True` restores the
    newest complete snapshot (`latest`, falling back to `ckpt.prev`, and
    loudly from a corrupt primary to its twin) after the layout guards:
    a snapshot of another queue depth D, resident dtype or bucket count
    K raises RuntimeError with the JAX loop's cause. The run then goes
    on from the snapshot's epoch + 1 (no snapshot: from the start), and
    is bitwise the run that never stopped, except that the compact
    wire's capacity autotune starts again (the snapshot holds no
    autotune state, as the JAX snapshot holds none: a resumed compact
    run is dense until it re-decides). A drained predecessor's
    PREEMPTED marker is consumed at start. With the integrity rollback
    on, a healthy block where a save is due is also retained in
    `<checkpoint_dir>/good` (`RollingRetention`, the newest
    `keep_good`); the rollback itself restores the in-memory copy.

    Graceful preemption: with a `checkpoint_dir`, SIGTERM / SIGINT set a
    flag (`chaos.crashpoint.PreemptGuard`, the previous handlers back on
    exit), and the first `preempt=E@S` notice of the chaos schedule past
    the start epoch arrives in epoch E. Either drains at the end of the
    block: a snapshot of it, the PREEMPTED marker,
    then `chaos.GracefulPreemption` (`info`: reason, epoch, snapshot,
    drain_s, marker), for the exit code `exitcodes.PREEMPTED_EXIT`.
    `EG_CRASHPOINT=site[:n]` arms a hard kill at a named seam
    (`chaos/crashpoint.py`): `loop.block_dispatched` after a block's
    passes launched and before any readback, `loop.block_end` after the
    block's host work (drained, or deferred when pipelined) and any due
    save (committed, or handed to the writer), `integrity.rollback`
    between a rollback's restore and its replay, `writer.bg_save` on the
    writer thread, and the three sites of `checkpoint.save` (on the
    writer thread when pipelined); the
    first record then carries `crashpoint`
    ({site, hit}). `on_epoch(rec)` is called with each record as it is
    appended.

    `obs` ("off" | "block" | "epoch") turns on the on-device telemetry
    (`obs/device.py`: per-leaf fire and deferral counts, threshold and
    drift sums, the silence histogram, per-edge and per-bucket wire
    bytes, the integrity and bounded-async counters, and the
    message-lifecycle ledger). The counters are cumulative device tensors
    in `state.telemetry`, part of every snapshot, and are read to the
    host once per dispatch block, in one copy: no host sync is added to
    any pass. "epoch" pins K to 1, so that every epoch ends a block and
    its flush window. The record of a block's last epoch then carries
    `rec["obs"]` (`window_record` of the block, the
    first one with `meta`: leaves, edges, silence buckets, ranks,
    neighbours, wire) and, on the gossip algorithms, the block's
    conservation audit `rec["obs"]["ledger_audit"]`
    (`obs.ledger.audit_window`); the consensus error is probed at each
    block end. "off" leaves the run exactly as without telemetry.

    `registry` (an `obs.Registry`) records the loop's host spans: `train`
    (the root), `data`, `dispatch_block` (the block's launches, and in
    serial mode the synchronize after them), `block_ready` (the wait for
    the block's readback), `obs_flush`, `eval`, `eval_readback`,
    `checkpoint` (a serial save) or `ckpt_snapshot` (the device copy of
    a pipelined one) and `preempt_drain`; and after each block the
    gauges `active_ranks`, `prefetch_misses_total` (host data path),
    `membership_transitions_total` (with membership),
    `edge_staleness{edge}` and `late_commits_total` (staleness D >= 2),
    `ledger_disposition_total{disposition}`, `ledger_in_flight` and
    `ledger_audit_failures_total` (telemetry on a gossip algorithm), and
    `wire_rejects_total`, `quarantined_steps_total` and
    `integrity_rollbacks_total` (with `integrity`). The loop never closes
    the registry.

    `membership` (a `chaos.MembershipSchedule`, spec string like
    "leave=1@2,join=1@4" or dict; dpsgd and eventgrad on a single-axis
    ring) runs the elastic membership engine (`chaos/membership.py`): at
    the end of each named epoch, after its records and before any
    snapshot, a leave re-slices the survivors onto `Ring(n-1)` and a join
    bootstraps a newcomer's row from a neighbour's (through
    `<checkpoint_dir>/bootstrap` when there is a checkpoint_dir) onto
    `Ring(n+1)`; the step is rebuilt for the new ring and every receive
    buffer force-refreshes on the next pass. The chaos spec's inline
    `leave=` / `join=` clauses are the same schedule (both given: they
    must agree). Steps per epoch follow the rank count; msgs-saved-% is
    counted against cumulative rank-passes. Every record carries
    `active_ranks`; the first also the schedule as `membership`, the
    first after a transition `membership_transitions` (a transition at
    the last epoch rides the last record). A resume rebuilds the
    topology from the schedule at the snapshot's epoch. Refused with
    `die=`, staleness D >= 2 and the integrity rollback, as the JAX loop
    refuses them."""
    device = resolve_device(device)
    # the backend resolution: an explicit mesh wins; a backend request
    # with no mesh builds one; "vmap" beside a mesh contradicts it
    if backend is not None:
        if mesh is not None and backend in ("vmap", "sim"):
            raise ValueError(
                "backend='vmap' contradicts an explicit mesh= argument; "
                "drop one of them"
            )
        if mesh is None:
            mesh = resolve_backend(backend, topo, device)
    multi = mesh is not None and mesh.n_procs > 1
    primary = multihost.is_primary()
    if mesh is not None:
        # the run's device stays as given: "cuda" is this process's
        # current card, which `multihost.init` sets for NCCL
        if mesh.device.type != device.type:
            raise ValueError(
                f"the mesh runs on {mesh.device}, the run on {device}")
    if arena is False:
        raise NotImplementedError(f"arena=False: {ARENA_OFF_REFUSAL}")
    if arena and algo not in ("dpsgd", "eventgrad"):
        raise ValueError(
            f"arena=True is a no-op for algo={algo!r} — only "
            f"{('dpsgd', 'eventgrad')} route through the flat arena; use "
            "arena=None (auto) or False"
        )
    if obs not in OBS_MODES:
        raise ValueError(f"obs must be one of {OBS_MODES}, got {obs!r}")
    obs_on = obs != "off"

    def _span(name: str, **args):
        # without a registry a span is a null context: the control flow
        # is the same either way
        if registry is None:
            return contextlib.nullcontext()
        return registry.span(name, **args)

    if gossip_wire not in ("dense", "compact"):
        raise ValueError(
            f"gossip_wire must be 'dense' or 'compact', got {gossip_wire!r}"
        )
    pol = None
    if algo in EVENT_ALGOS or trigger_policy is not None:
        pol = policy_lib.resolve(trigger_policy, algo)
    if gossip_wire == "compact":
        policy_lib.check_compact(pol, algo)
    # a capacity-free compact wire (sp_eventgrad's top-k lanes) is
    # statically sized from the first step: no dense warmup, no autotune
    compact_static = (gossip_wire == "compact"
                      and not pol.compact_needs_capacity)
    if compact_frac is not None and compact_static:
        raise ValueError(
            f"compact_frac sizes the capacity autotune; the "
            f"{pol.name!r} policy's compact wire is capacity-free "
            "(its top-k lanes are already statically sized)"
        )
    if compact_frac is not None:
        if gossip_wire != "compact":
            raise ValueError("compact_frac needs gossip_wire='compact'")
        if not 0.0 < float(compact_frac) <= 1.0:
            raise ValueError(
                f"compact_frac must be in (0, 1], got {compact_frac}"
            )
    if algo in EVENT_ALGOS:
        event_cfg = event_cfg or EventConfig()
    if save_every < 0:
        raise ValueError(f"save_every must be >= 0, got {save_every}")
    if resume and checkpoint_dir is None:
        raise ValueError("resume=True needs a checkpoint_dir to resume from")
    ckpt_path = (os.path.join(checkpoint_dir, "ckpt") if checkpoint_dir
                 else None)
    if checkpoint_dir and primary:
        # a drained predecessor's PREEMPTED marker: this run supersedes it
        crashpoint.consume_marker(checkpoint_dir)
    # the armed crash drill, stamped on the first record
    crash_armed = crashpoint.armed()
    chaos_sched = resolve_chaos(chaos) if chaos is not None else None
    integ_cfg = chaos_integrity.resolve(integrity)
    integ_engine_on = integ_cfg is not None and integ_cfg.sentinel
    integ_rollback_on = integ_engine_on and integ_cfg.rollback
    if integ_cfg is not None:
        if (integ_cfg.checksum or integ_cfg.quarantine) and algo != "eventgrad":
            raise ValueError(
                "integrity checksums/quarantine ride the event exchange "
                f"(algo='eventgrad'); got algo={algo!r} — for the host-"
                "side sentinel alone pass IntegrityConfig(checksum="
                "False, quarantine=False)"
            )
        if integ_rollback_on and integ_cfg.escalate and algo != "eventgrad":
            raise ValueError(
                "integrity escalate=True hardens the event exchange "
                "after a rollback (checksums + quarantine on), which "
                f"needs algo='eventgrad'; got algo={algo!r} — pass "
                "escalate=False"
            )
    if integ_engine_on and mesh is not None:
        raise ValueError(
            "the integrity sentinel/rollback engine needs the single-"
            "process path (a rollback restores host-retained state "
            "between blocks); in-step defenses alone "
            "(IntegrityConfig(sentinel=False, rollback=False)) compose "
            "with any backend"
        )
    integ_now = integ_cfg
    fault_mode, fault_epoch = None, -1
    if fault_inject:
        fault_mode, _, n_fault = fault_inject.partition(":")
        if fault_mode not in ("crash", "hang") or not n_fault.isdigit():
            raise ValueError(f"bad fault_inject spec {fault_inject!r}")
        fault_epoch = int(n_fault)
    bucketed_k = int(bucketed) if bucketed else 1
    x = _as_input(model, x_train)
    y = np.ascontiguousarray(y_train, np.int64)
    # labels per sample: 1 for a classifier, T for a language model
    labels_per_sample = int(np.prod(y.shape[1:]))

    # --- elastic membership (chaos/membership.py) -------------------------
    memb_sched = (chaos_membership.resolve(membership)
                  if membership is not None else None)
    if chaos_sched is not None and chaos_sched.membership:
        inline = chaos_sched.membership_schedule()
        # identical events are no conflict: a chaos-inline run stamps both
        # riders, and a replay from its own log feeds both back
        if (memb_sched is not None and not memb_sched.is_noop
                and memb_sched.events != inline.events):
            raise ValueError(
                "membership events arrived both via membership= and "
                "the chaos spec's join=/leave= clauses, and they "
                "disagree; pass one schedule"
            )
        memb_sched = inline
    memb_on = memb_sched is not None and not memb_sched.is_noop
    memb_engine = None
    memb_base_n = topo.n_ranks
    if memb_on:
        if algo not in ("dpsgd", "eventgrad"):
            raise ValueError(
                "membership transitions ride the gossip exchange "
                f"(dpsgd, eventgrad); got algo={algo!r}"
            )
        if len(topo.axes) != 1:
            raise ValueError(
                "membership transitions handle single-axis gossip rings; "
                f"got axes {topo.axes}"
            )
        if mesh is not None:
            raise ValueError(
                "membership needs the single-process vmap path (a "
                "transition re-shapes the stacked state between blocks)"
            )
        if trace_file:
            raise ValueError(
                "trace_file carries rank-shaped recv staleness; not "
                "available under membership transitions"
            )
        if chaos_sched is not None and chaos_sched.death:
            raise ValueError(
                "chaos die= events are rank-indexed in the traced step "
                "and do not compose with membership re-indexing; script "
                "the removal as a membership leave= event"
            )
        if staleness >= 2:
            raise ValueError(
                f"staleness={staleness} does not compose with "
                "membership transitions: a joining rank would inherit "
                "its bootstrap source's in-flight delivery queues — "
                "run bounded-async without membership, or staleness<=1"
            )
        if integ_rollback_on:
            raise ValueError(
                "integrity rollback does not compose with membership "
                "transitions (a retained snapshot's rank count can disagree "
                "with the post-transition ring); run the sentinel without "
                "rollback (IntegrityConfig(rollback=False)) or drop the "
                "membership schedule"
            )
        # fail fast on a schedule that ever shrinks the ring below 2 or
        # names an index/src outside the ring it will meet
        memb_sched.validate(topo.n_ranks)
        beyond = [e for e in memb_sched.events if e.epoch > epochs]
        if beyond:
            warnings.warn(
                f"{len(beyond)} membership event(s) land beyond "
                f"epochs={epochs} (first: {beyond[0].kind}@"
                f"{beyond[0].epoch}) and will not apply in this run",
                RuntimeWarning,
            )
        if ckpt_path and resume:
            # the snapshot's rank count follows from the membership log
            # at its epoch: build the state (and the step) at that ring
            found = checkpoint.latest(ckpt_path)
            if found:
                topo = memb_sched.topology_at(
                    topo, int(checkpoint.peek(found)[1]["epoch"]))
        memb_engine = chaos_membership.MembershipEngine(
            memb_sched, event_cfg=event_cfg, bootstrap_dir=checkpoint_dir)
    n_ranks = topo.n_ranks
    # data shards across the data axes (gossip plus any ddp subgroups);
    # sp ranks hold sequence chunks and tp/pp/ep ranks the same batch
    # (`data.sharding.expand_to_mesh`)
    n_data, hybrid = topo.n_data_ranks, topo.is_hybrid
    steps = epoch_steps(len(x), n_data, batch_size)
    input_shape = tuple(x.shape[1:])
    n_sp = topo.axis_size("sp") if "sp" in topo.axes else 1
    if n_sp > 1:
        if not np.issubdtype(x.dtype, np.integer):
            raise ValueError(
                "sequence parallelism (sp axis) chunks the TRAILING input "
                f"dimension (here size {input_shape[-1]} of shape "
                f"{input_shape}) as a token sequence, but the inputs are "
                f"{np.asarray(x_train).dtype} — for image data that "
                "dimension is channels and must not be sliced; use an "
                "integer token dataset with sp"
            )
        if input_shape[-1] % n_sp:
            raise ValueError(
                f"sequence length {input_shape[-1]} not divisible by sp={n_sp}"
            )
        input_shape = input_shape[:-1] + (input_shape[-1] // n_sp,)
    # targets a rank scores a sample: an sp rank its chunk of the tokens
    labels_per_rank = labels_per_sample // n_sp

    # the step runs on the topology lifted onto the mesh (this process's
    # rows); the state is built whole and sliced
    topo_all, topo = topo, spmd.lift(topo, mesh)

    def build(wire_mode: str, capacity: Optional[int] = None):
        return make_train_step(
            model, topo, algo, event_cfg,
            fused_sgd=(learning_rate, momentum),
            trigger_policy=trigger_policy, wire=wire, staleness=staleness,
            carrier_resident=carrier_resident, sparse_cfg=sparse_cfg,
            augment=augment, gossip_wire=wire_mode,
            compact_capacity=capacity, bucketed=bucketed, chaos=chaos_sched,
            chaos_policy=chaos_policy, integrity=integ_now,
            n_passes=epochs * steps, obs=obs_on, sync_bn=sync_bn,
            trace=trace_file is not None,
        )

    # make_train_step checks the wire/staleness/carrier combination
    # before the state layout (carrier-resident or f32) is built from it.
    # A capacity-budgeted compact run starts dense: warmup fires
    # everything, and the autotune needs post-warmup fired sizes
    step = build("compact" if compact_static else "dense")
    resident_wire = wire if carrier_resident else None
    state = init_train_state(
        model, input_shape, topo_all, algo, event_cfg, seed,
        momentum=momentum, resident_wire=resident_wire,
        bucketed=bucketed_k, staleness=staleness, sparse_cfg=sparse_cfg,
        obs=obs_on, device=device,
    )
    if chaos_sched is not None:
        # every rank's health, sliced with the rest of the state below
        state = state.replace(chaos=chaos_monitor.PeerHealth.init(topo_all,
                                                                  device))
    spec = arena_spec(model)
    # the receive-side trace carry (the stale norm each neighbour's buffer
    # holds between messages), part of a traced run's snapshots so a
    # resumed trace continues the interrupted one
    trace_carry = ({"recv_norm": np.zeros((topo.n_neighbors, topo.n_ranks,
                                           spec.n_leaves))}
                   if trace_file else None)
    trace_names = [n.replace(".", "/") for n in spec.names]
    start_epoch = 0
    if ckpt_path and resume:
        found = checkpoint.latest(ckpt_path)
        if found:
            state, start_epoch = _resume(
                found, state, algo=algo, staleness=staleness,
                resident_wire=resident_wire, bucketed_k=bucketed_k,
                device=device, trace_carry=trace_carry)
    state = multihost.put_stacked(state, mesh)
    # a hybrid mesh skips the consensus eval: averaging across its
    # sp/tp/pp/ep ranks would mix differently sharded parameters
    # a multi-process run evaluates once at the end, on the gathered
    # parameters (the JAX loop's rule)
    eval_on = (x_test is not None and log_every_epoch and not hybrid
               and not multi)
    history: List[Dict[str, Any]] = []

    # --- the dispatch resolution: device-resident data, pipeline, K ----
    # membership re-shards the data and reshapes the state between
    # blocks, so it keeps the host data path, the serial schedule and
    # one-epoch blocks
    data_bytes = x.size * 4
    if device_data is None:
        device_data = (
            not memb_on and not hybrid and mesh is None
            and device.type == "cuda"
            and data_bytes <= int(os.environ.get(
                "EG_DEVICE_DATA_MAX_BYTES", str(1_500_000_000))))
    elif device_data and (memb_on or hybrid or mesh is not None):
        raise ValueError(
            "device_data requires the single-process, non-hybrid, "
            "mesh=None path without membership transitions (hybrid/"
            "multihost runs shard batches on host; membership re-shards "
            "the resident plan per transition)"
        )
    device_data = bool(device_data)
    if pipeline is None:
        pipeline_on = (not memb_on and not integ_engine_on
                       and fault_mode is None and not multi)
    else:
        pipeline_on = bool(pipeline)
        if pipeline_on and multi:
            raise ValueError(
                "pipeline=True needs the single-process path — multi-"
                "process runs keep the serial schedule (collective and "
                "checkpoint ordering is cross-process); use pipeline="
                "None/False"
            )
        if pipeline_on and fault_mode is not None:
            raise ValueError(
                "pipeline=True cannot honor fault_inject (the fault must "
                "land at an exact post-snapshot epoch boundary, which "
                "needs the serial schedule); use pipeline=None/False"
            )
        if pipeline_on and memb_on:
            raise ValueError(
                "pipeline=True cannot honor membership transitions (they "
                "re-shape the state between blocks, which needs the "
                "serial schedule); use pipeline=None/False"
            )
        if pipeline_on and integ_engine_on:
            raise ValueError(
                "pipeline=True cannot honor the integrity sentinel/"
                "rollback engine (the verdict on block B gates what "
                "block B+1 may dispatch); use pipeline=None/False, or "
                "keep only the in-step defenses (IntegrityConfig("
                "sentinel=False, rollback=False))"
            )
    K = max(1, int(epochs_per_dispatch))
    if fault_mode is not None or memb_on or obs == "epoch":
        # every epoch end is a block boundary (the fault's, a
        # transition's, or the per-epoch telemetry flush's)
        K = 1
    total_epochs = max(0, epochs - start_epoch)
    # at least two blocks, so a warm block exists beside the cold one
    K = min(K, total_epochs // 2) if total_epochs >= 2 else 1
    if not device_data and K > 1:
        # the host path holds two K-epoch blocks at once (the one running
        # and the one the prefetcher assembles): cap their bytes
        K = max(1, min(K, int(os.environ.get(
            "EG_HOST_BLOCK_MAX_BYTES", str(1_500_000_000)
        )) // max(1, 2 * data_bytes)))
    if save_every and K > 1:
        # blocks split at save points: a divisor of save_every keeps the
        # block sizes repeating across save segments
        K = max(d for d in range(1, K + 1) if save_every % d == 0)

    def blocks_from(first: int) -> List[Tuple[int, int]]:
        """Consecutive (first, last) epoch blocks of up to K epochs, split
        so that every multiple of `save_every` ends a block."""
        out, e = [], first
        while e <= epochs:
            be = min(e + K - 1, epochs)
            if save_every:
                nxt = ((e + save_every - 1) // save_every) * save_every
                if e <= nxt <= be:
                    be = nxt
            out.append((e, be))
            e = be + 1
        return out

    blocks = blocks_from(start_epoch + 1)
    x_dev = y_dev = None
    prefetcher = transfer = None

    def expand(xb, yb):
        """A block's batches on every rank of a hybrid mesh, then this
        process's rows of them on a device mesh."""
        if hybrid:
            xb, yb = expand_to_mesh(xb, yb, topo)
        if mesh is not None:
            xb, yb = (np.ascontiguousarray(topo.local_rows(v))
                      for v in (xb, yb))
        return xb, yb

    def make_prefetcher():
        return EpochPrefetcher(
            x, y, n_data, batch_size, random=random_sampler, seed=seed,
            last_epoch=epochs, transfer=transfer,
            expand=expand if hybrid or mesh is not None else None)

    if device_data:
        # the dataset is uploaded once; a block ships only its index plan
        x_dev = torch.from_numpy(x).to(device)
        y_dev = torch.from_numpy(y).to(device)
    else:
        transfer = CudaTransfer(device) if device.type == "cuda" else None
        prefetcher = make_prefetcher()
    evaluator = (DeviceEvaluator(model, x_test, y_test, device=device)
                 if eval_on else None)
    writer = (checkpoint.AsyncWriter() if ckpt_path and pipeline_on
              else None)
    # the compact autotune: sized once, then the step is rebuilt once
    compact_capacity: Optional[int] = None
    compact_done = gossip_wire != "compact" or compact_static
    compact_note: Optional[Dict[str, Any]] = None
    compact_fired_peak, compact_post_steps = 0.0, 0
    warmup_passes = (event_cfg or EventConfig()).warmup_passes
    # the integrity engine (chaos/integrity.py): the sentinel judges each
    # block; the last-known-good starts as the initial state, so a trip
    # in the first block rolls back to the start
    probe_on = (chaos_sched is not None or integ_cfg is not None
                or obs_on) and not hybrid
    sentinel = (chaos_integrity.DivergenceSentinel(integ_cfg)
                if integ_engine_on else None)
    # the telemetry flush: the previous cumulative host snapshot (the diff
    # base), the one-time meta rider, and the count of flush windows whose
    # conservation audit failed
    obs_prev = None
    obs_meta_pending = obs_on
    ledger_audit_fails = 0
    integ_totals = {"wire_rejects": 0, "quarantined_steps": 0}
    good = None
    if integ_rollback_on:
        good = {"state": _clone(state), "epoch": start_epoch, "next_bi": 0,
                "sentinel": sentinel.snapshot(), "obs_prev": obs_prev,
                "carry": _clone_carry(trace_carry)}
    # the on-disk retention of healthy blocks at checkpoint cadence
    retention = (checkpoint.RollingRetention(
        os.path.join(checkpoint_dir, "good"), keep=integ_cfg.keep_good)
        if integ_rollback_on and checkpoint_dir else None)
    rollbacks, rollback_info = 0, None
    # the first preempt= notice past the start epoch is this
    # incarnation's (a resume ignores the notices its drained
    # predecessor honoured)
    preempt_at = None
    if chaos_sched is not None and chaos_sched.preempt:
        preempt_at = next(((e, s) for e, s in chaos_sched.preempt
                           if e > start_epoch), None)

    def snapshot(epoch: int):
        """The save payload at a block boundary: the state's
        (`state_lib.payload`; on a mesh the rows of every process,
        gathered) plus, on a traced run, the trace carry."""
        tensors, meta = state_lib.payload(
            multihost.to_host(state, mesh) if mesh is not None else state,
            epoch, algo)
        if trace_carry is not None:
            tensors = dict(tensors)
            tensors[TRACE_CARRY] = torch.from_numpy(
                trace_carry["recv_norm"].copy())
        return tensors, meta

    def save(tensors, meta) -> None:
        """A serial save: the primary writes the gathered snapshot, and
        every process waits for it."""
        if primary:
            checkpoint.save(ckpt_path, tensors, meta)
        multihost.barrier("eg-ckpt-promote")

    def flush(tel_host_buf, tel_like, blk: int) -> Dict[str, Any]:
        """The block's telemetry window: the one device-to-host read of
        the cumulative counters (packed into one buffer), diffed on the
        host against the previous snapshot, plus the ledger's
        conservation audit of the window and, on the first flush, the run
        meta."""
        nonlocal obs_prev, obs_meta_pending, ledger_audit_fails
        with _span("obs_flush", cat="obs", block=blk):
            tel_host = obs_device.unpack(tel_host_buf.numpy(), tel_like)
            obs_rec = obs_device.window_record(tel_host, obs_prev)
            if tel_host.ledger is not None:
                obs_rec["ledger_audit"] = obs_ledger.audit_window(
                    tel_host.ledger,
                    None if obs_prev is None else obs_prev.ledger, topo)
                if not obs_rec["ledger_audit"]["ok"]:
                    ledger_audit_fails += 1
            obs_prev = tel_host
        if obs_meta_pending:
            obs_rec["meta"] = {
                "leaves": [n.replace(".", "/") for n in spec.names],
                "edges": [nb.name for nb in topo.neighbors],
                "silence_buckets": int(tel_host.silence_hist.shape[-1]),
                "n_ranks": n_ranks,
                "n_neighbors": topo.n_neighbors,
                "wire": wire,
            }
            obs_meta_pending = False
        return obs_rec

    def gauges(m_last, obs_rec) -> None:
        """The registry's gauges after a block's records (`m_last`: the
        metrics of its last epoch)."""
        registry.gauge("active_ranks", n_ranks)
        if prefetcher is not None:
            registry.gauge("prefetch_misses_total", float(prefetcher.misses))
        if "edge_staleness" in m_last:
            # the per-edge staleness (max over ranks at the block's last
            # pass) and the cumulative late commits
            es = m_last["edge_staleness"][-1]
            for k, nb in enumerate(topo.neighbors):
                registry.gauge("edge_staleness", float(es[..., k].max()),
                               labels={"edge": nb.name})
            registry.gauge("late_commits_total",
                           float(m_last["late_commits"][-1].sum()))
        if obs_rec is not None and "message_ledger" in obs_rec:
            cum = np.asarray(obs_prev.ledger.counts, np.int64)
            for name, ri in obs_ledger.ROW.items():
                registry.gauge("ledger_disposition_total",
                               float(cum[:, ri, :].sum()),
                               labels={"disposition": name})
            registry.gauge("ledger_in_flight",
                           float(sum(obs_rec["message_ledger"]["in_flight"])))
            registry.gauge("ledger_audit_failures_total",
                           float(ledger_audit_fails))
        if integ_cfg is not None:
            registry.gauge("wire_rejects_total",
                           float(integ_totals["wire_rejects"]))
            registry.gauge("quarantined_steps_total",
                           float(integ_totals["quarantined_steps"]))
            registry.gauge("integrity_rollbacks_total", float(rollbacks))

    # cumulative rank-passes: msgs-saved-%'s denominator under membership,
    # where the rank count and the steps per epoch change at transitions
    # (a resumed run rebuilds it from the schedule)
    rank_passes = sum(
        epoch_steps(len(x), nr, batch_size) * nr
        for e in range(1, start_epoch + 1)
        for nr in (memb_sched.n_ranks_at(memb_base_n, e - 1),)
    ) if memb_on else 0
    # transitions applied at the last boundary, for the next record
    memb_pending: List[Dict[str, Any]] = []
    # (epochs, wire mode, ranks) of every block dispatched so far: the
    # first block of each is cold
    seen_blocks: set = set()

    def capture(ms, hw) -> None:
        """Every read of block B's results, enqueued before block B+1
        launches: the metrics stacked on the device and packed into one
        buffer, the telemetry packed, the consensus-error probe and the
        eval's two scalars, each copied to the host without blocking
        (into pinned memory on the card), then one event the drain waits
        on. Nothing the drain reads is a tensor a later block writes."""
        dev = state.params.device
        keys = list(ms[0])
        parts = [torch.stack([m[k] for m in ms]) for k in keys]
        if mesh is not None:
            # every process's rows: the records reduce over all R ranks
            # in the simulator's order
            parts = [mesh.gather(p, dim=1) for p in parts]
        hw["m_layout"] = [(k, p.dtype, tuple(p.shape))
                          for k, p in zip(keys, parts)]
        # float64 holds every float32 and int32 metric exactly
        dev_bufs = {"m": torch.cat([p.to(torch.float64).reshape(-1)
                                    for p in parts])}
        if obs_on:
            tel = multihost.to_host(state.telemetry, mesh)
            dev_bufs["tel"] = obs_device.pack(tel)
            hw["tel_like"] = tel
        if probe_on:
            dev_bufs["probe"] = chaos_monitor.consensus_error(
                multihost.to_host(state.params, mesh))
        if evaluator is not None:
            with _span("eval", cat="device", epoch=hw["blk_end"]):
                c, nll = evaluator.dispatch(consensus_params(state.params),
                                            rank0_slice(state.batch_stats))
            dev_bufs["eval_correct"], dev_bufs["eval_nll"] = c, nll
        hw["host"] = {k: _host_async(v) for k, v in dev_bufs.items()}
        hw["ready"] = None
        if dev.type == "cuda":
            hw["ready"] = torch.cuda.Event()
            hw["ready"].record()

    def drain(hw) -> Optional[str]:
        """Block B's host work: the readback, the telemetry flush, the
        records, the eval result, the registry's gauges, the sentinel's
        verdict (returned) and the compact autotune. Serial mode runs it
        right after the block; the pipelined one after block B+1's
        launches, while the card computes B+1."""
        nonlocal compact_note, compact_fired_peak
        nonlocal compact_post_steps, compact_capacity, compact_done, step
        nonlocal rollback_info, rank_passes
        blk, blk_start, blk_end = hw["blk_i"], hw["blk_start"], hw["blk_end"]
        n_e = blk_end - blk_start + 1
        steps_b, nr_b = hw["steps"], hw["n_ranks"]
        with _span("block_ready", cat="device", block=blk):
            dt = hw["clock"]
            if isinstance(dt, tuple):
                dt[1].synchronize()
                dt = dt[0].elapsed_time(dt[1]) / 1e3
            if hw["ready"] is not None:
                hw["ready"].synchronize()
        host = hw["host"]
        flat_m = host["m"].numpy()
        m, off = {}, 0
        for k, dt_k, shape in hw["m_layout"]:
            size = int(np.prod(shape))
            m[k] = flat_m[off:off + size].reshape(shape).astype(
                torch.empty((), dtype=dt_k).numpy().dtype)
            off += size
        obs_rec = flush(host["tel"], hw["tel_like"], blk) if obs_on else None
        m_last = None
        for j, epoch in enumerate(range(blk_start, blk_end + 1)):
            m_e = {k: v[j * steps_b:(j + 1) * steps_b] for k, v in m.items()}
            m_last = m_e
            total_passes = hw["pass_base"] + (j + 1) * steps_b
            rec = {
                "epoch": epoch,
                "algo": algo,
                "steps": steps_b,
                # the 0-based dispatch block, and whether it was the
                # first of its size (steady-state step math drops those)
                "dispatch_block": blk,
                "dispatch_cold": hw["cold"],
                "active_ranks": nr_b,
                "wall_s": dt / n_e,
                "loss": float(m_e["loss"].mean()),
                "train_acc": 100.0 * float(m_e["correct"].sum())
                / (nr_b * steps_b * batch_size * labels_per_rank),
                "sent_bytes_per_step_per_chip": _step_mean(
                    m_e["sent_bytes"]),
                "sent_bytes_wire_real_per_step_per_chip": _step_mean(
                    m_e["sent_bytes_wire_real"]
                ),
                "n_params": spec.n_total,
                "arena": True,
                "wire": wire,
                "resident_dtype": resident_wire or "f32",
                "staleness": int(staleness),
                "device": str(device),
            }
            if bucketed_k > 1:
                rec["buckets"] = min(bucketed_k, spec.n_leaves)
                if "sent_bytes_wire_real_per_bucket" in m_e:
                    rec["sent_bytes_wire_real_per_bucket"] = [
                        float(v) for v in
                        m_e["sent_bytes_wire_real_per_bucket"][-1, 0]]
            if gossip_wire == "compact":
                rec["gossip_wire"] = hw["mode"]
                if compact_capacity is not None:
                    rec["compact_capacity"] = int(compact_capacity)
                if compact_note is not None:
                    rec.update(compact_note)
                    compact_note = None
            if algo in EVENT_ALGOS:
                rec["policy"] = pol.name
                events_total = int(m_e["num_events"][-1].sum())
                rec["num_deferred"] = int(m_e["num_deferred"][-1].sum())
                rec["num_events"] = events_total
                if memb_on:
                    # cumulative RANK-passes: a departed rank takes its
                    # events with it, a newcomer starts at zero
                    rec["msgs_saved_pct"] = msgs_saved_pct(
                        events_total, hw["rank_base"] + (j + 1) * steps_b
                        * nr_b, spec.n_leaves, hw["n_nb"], 1,
                    )
                else:
                    rec["msgs_saved_pct"] = msgs_saved_pct(
                        events_total, total_passes, spec.n_leaves,
                        hw["n_nb"], nr_b,
                    )
                rec["fired_frac"] = float(m_e["fired_frac"].mean())
                if "edge_staleness" in m_e:
                    # the end-of-epoch per-edge staleness peak and the
                    # cumulative late commits
                    rec["edge_staleness_max"] = int(
                        m_e["edge_staleness"][-1].max())
                    rec["late_commits"] = int(m_e["late_commits"][-1].sum())
            if memb_on:
                if not history:  # the log alone replays the run bitwise
                    rec["membership"] = memb_sched.to_dict()
                if j == 0 and hw["memb"]:
                    rec["membership_transitions"] = hw["memb"]
            if crash_armed is not None and not history:
                rec["crashpoint"] = dict(crash_armed)
            if mesh is not None and not history:
                # where the exchange's bytes went
                rec["transport"] = mesh.transport
                rec["mesh_processes"] = mesh.n_procs
            if chaos_sched is not None:
                if not history:
                    rec["chaos"] = chaos_sched.to_dict()
                    if chaos_policy is not None:
                        rec["chaos_policy"] = chaos_policy.to_dict()
                rec.update(chaos_monitor.health_record(
                    m_e["edge_silence"][-1], m_e["chaos_drops"][-1],
                    event_cfg.max_silence if event_cfg else 0))
            if integ_cfg is not None:
                if not history:
                    rec["integrity"] = integ_cfg.to_dict()
                rec["wire_rejects"] = int(m_e["integrity_wire_reject"].sum())
                rec["quarantined_steps"] = int(
                    m_e["integrity_quarantined"].sum())
                integ_totals["wire_rejects"] += rec["wire_rejects"]
                integ_totals["quarantined_steps"] += rec["quarantined_steps"]
                rec["integrity_rollbacks"] = rollbacks
                if rollback_info is not None:
                    rec["integrity_rollback"] = rollback_info
                    rollback_info = None
            if trace_file and primary and "trace_fired" in m_e:
                _write_trace(trace_file, m_e, total_passes - steps_b, topo,
                             trace_names, trace_carry)
            elif trace_file and primary:
                _write_loss_stream(trace_file, m_e["loss"],
                                   total_passes - steps_b, nr_b)
            if epoch == blk_end:
                # the block end's riders: the telemetry window, the
                # consensus error ||p_r - mean(p)|| (the drift that tells
                # quiet links from a partition) and the eval
                if obs_rec is not None:
                    rec["obs"] = obs_rec
                if "probe" in host:
                    cerr = host["probe"].numpy()
                    rec["consensus_err_max"] = float(cerr.max())
                    rec["consensus_err_mean"] = float(cerr.mean())
                if "eval_correct" in host:
                    with _span("eval_readback", cat="host", epoch=epoch):
                        test = evaluator.result((host["eval_correct"],
                                                 host["eval_nll"]))
                    rec.update({"test_" + k: v for k, v in test.items()})
            history.append(rec)
            if on_epoch is not None and primary:
                on_epoch(rec)
        if registry is not None:
            gauges(m_last, obs_rec)
        verdict = None
        if sentinel is not None:
            # the block's mean loss and its end's consensus error
            verdict = sentinel.observe(
                float(np.asarray(m["loss"], np.float64).mean()),
                float(host["probe"].numpy().max()) if "probe" in host
                else None)
        if not compact_done:
            # the capacity is one static number for every rank: the peak
            # is over the ranks of the post-warmup steps (pass ==
            # warmup_passes is already real trigger data)
            pnums = hw["pass_base"] + 1 + np.arange(n_e * steps_b)
            keep = pnums >= warmup_passes
            if hw["memb"]:
                # a block that opens with a membership force-fire is
                # transient (the full-fire rewire pass, then the
                # thresholds re-adapt): sampling it would size the
                # budget toward the whole model
                keep[:] = False
            post = m["fired_elems"][keep]
            if post.size:
                compact_fired_peak = max(compact_fired_peak,
                                         float(post.max()))
                compact_post_steps += int(post.shape[0])
            if compact_frac is None:
                enough = compact_post_steps >= COMPACT_MIN_SAMPLES
            else:
                enough = bool(pnums[-1] >= warmup_passes)
            if enough:
                n = spec.n_total
                floor = collectives.compact_capacity_floor(spec.sizes)
                if bucketed_k > 1 and algo == "eventgrad":
                    # every bucket must fit its own largest leaf
                    floor = max(floor, collectives.bucketed_capacity_floor(
                        spec.buckets(bucketed_k)))
                autotuned = compact_frac is None
                if autotuned:
                    cap = collectives.choose_capacity(
                        n, compact_fired_peak, floor)
                    compact_note = {
                        "compact_autotuned": True,
                        "compact_fired_peak_elems": compact_fired_peak,
                    }
                else:
                    cap = min(n, max(floor, int(math.ceil(
                        float(compact_frac) * n))))
                    compact_note = {"compact_autotuned": False}
                if autotuned and cap >= n:
                    # fire rate ~1: the budget would be the whole model
                    compact_note["compact_skipped"] = (
                        "observed fire rate needs capacity >= n_params"
                    )
                else:
                    compact_capacity = cap
                    step = build("compact", cap)
                compact_done = True
        return verdict

    pending = None
    try:
        with _span("train", cat="run", algo=algo, pipelined=pipeline_on), \
                crashpoint.PreemptGuard(enabled=ckpt_path is not None) \
                as guard:
            bi = 0
            while bi < len(blocks):
                blk = bi
                blk_start, blk_end = blocks[bi]
                n_e = blk_end - blk_start + 1
                mode_now = ("compact" if compact_capacity is not None
                            or compact_static else "dense")
                # the first block of each (epochs, wire mode, ranks) is
                # cold (the JAX loop's compile rule)
                cold = (n_e, mode_now, n_ranks) not in seen_blocks
                seen_blocks.add((n_e, mode_now, n_ranks))
                with _span("data", cat="host", block=blk):
                    if device_data:
                        idx = np.concatenate([
                            epoch_index_plan(
                                len(x), n_ranks, batch_size,
                                random=random_sampler, seed=seed, epoch=e)
                            for e in range(blk_start, blk_end + 1)], axis=1)
                        idx_dev = _upload(idx, device)  # [R, n_e*steps, B]
                    else:
                        nxt = blocks[bi + 1] if bi + 1 < len(blocks) else None
                        xb, yb = prefetcher.get_block(blk_start, blk_end,
                                                      next_span=nxt)
                        if transfer is not None:
                            xb, yb = transfer.consume(xb), transfer.consume(yb)
                        else:
                            xb = torch.from_numpy(xb).to(device)
                            yb = torch.from_numpy(yb).to(device)
                hw = {"blk_i": blk, "blk_start": blk_start,
                      "blk_end": blk_end, "cold": cold, "mode": mode_now,
                      "steps": steps, "n_ranks": n_ranks,
                      "n_nb": topo.n_neighbors, "pass_base": state.pass_num,
                      "rank_base": rank_passes, "memb": memb_pending}
                memb_pending = []
                # wall_s: the block's first pass to the end of its last,
                # ahead of capture's riders; on the card the device's
                # clock, so a pipelined block's time is its own
                t0 = time.perf_counter()
                if device.type == "cuda":
                    clock = (torch.cuda.Event(enable_timing=True),
                             torch.cuda.Event(enable_timing=True))
                    clock[0].record()
                with _span("dispatch_block", cat="device", block=blk,
                           epochs=n_e, cold=cold, wire=mode_now,
                           pipelined=pipeline_on):
                    ms = []
                    for s in range(n_e * steps):
                        if device_data:
                            ib = idx_dev[:, s]
                            batch = (x_dev[ib], y_dev[ib])
                        else:
                            batch = (xb[:, s], yb[:, s])
                        state, m = step(state, batch)
                        ms.append(m)
                    if device.type == "cuda":
                        clock[1].record()
                        hw["clock"] = clock
                    else:
                        hw["clock"] = time.perf_counter() - t0
                    if not pipeline_on:
                        _sync(device)
                # the block's passes are launched; none of its host work
                # has run (pipeline on and off both pass here)
                crashpoint.hit("loop.block_dispatched")
                capture(ms, hw)
                del ms
                rank_passes += n_e * steps * n_ranks
                if pending is not None:  # the previous block's host work
                    drain(pending)
                    pending = None
                ckpt_due = bool(ckpt_path and (
                    blk_end == epochs
                    or (save_every and blk_end % save_every == 0)))
                verdict = None
                if not pipeline_on or ckpt_due or not compact_done:
                    # serial drain: serial mode, a due save (its block's
                    # records land before the snapshot), or a compact
                    # autotune decision that gates the next block
                    verdict = drain(hw)
                else:
                    pending = hw
                if verdict is not None:
                    if not integ_rollback_on or rollbacks >= integ_cfg.max_rollbacks:
                        raise chaos_integrity.IntegrityEscalation(
                            f"divergence sentinel tripped ({verdict}) at epoch "
                            f"{blk_end} with "
                            + ("rollback disarmed" if not integ_rollback_on
                               else "the rollback budget spent "
                               f"({rollbacks}/{integ_cfg.max_rollbacks})")
                            + "; the retained last-known-good state cannot "
                            "outrun this fault — restarting would replay the "
                            "same divergence")
                    rollbacks += 1
                    # every rank from last-known-good, every event buffer
                    # re-armed: the next pass force-fires every exchange
                    state = force_refresh(_clone(good["state"]), event_cfg)
                    # restored in memory, the replay not yet started
                    crashpoint.hit("integrity.rollback")
                    hardened = False
                    if integ_cfg.escalate and integ_now.hardened() != integ_now:
                        # the replay meets the same pass-keyed faults: without
                        # checksums and quarantine it would diverge again
                        integ_now = integ_now.hardened()
                        hardened = True
                        step = build(mode_now, compact_capacity)
                        seen_blocks.clear()
                    if prefetcher is not None:
                        # the worker speculates forward; a rewind needs a
                        # fresh one at the replay's start
                        prefetcher.close()
                        prefetcher = make_prefetcher()
                    sentinel.rewind(good["sentinel"])
                    # the telemetry diff base and the trace carry follow
                    # the restored state
                    obs_prev = good["obs_prev"]
                    trace_carry = _clone_carry(good["carry"])
                    rollback_info = {"reason": verdict,
                                     "tripped_epoch": blk_end,
                                     "restored_epoch": good["epoch"],
                                     "hardened": hardened}
                    bi = good["next_bi"]
                    continue
                if integ_rollback_on:
                    good = {"state": _clone(state), "epoch": blk_end,
                            "next_bi": bi + 1,
                            "sentinel": sentinel.snapshot(),
                            "obs_prev": obs_prev,
                            "carry": _clone_carry(trace_carry)}
                    if retention is not None and ckpt_due:
                        retention.save_good(blk_end, *state_lib.payload(
                            good["state"], blk_end, algo))
                if memb_engine is not None and memb_engine.events_at(blk_end):
                    # transitions land after the block's host work and
                    # before any snapshot, so snapshots are always
                    # post-transition
                    for ev in memb_engine.events_at(blk_end):
                        state, topo, info = memb_engine.apply(state, topo, ev)
                        memb_pending.append(info)
                        if registry is not None:
                            registry.gauge("membership_transitions_total",
                                           float(len(memb_engine.log)))
                        if obs_prev is not None:
                            # the telemetry diff base follows the state's rows
                            obs_prev = (
                                chaos_membership.take_rows_host(
                                    obs_prev, tuple(info["survivors"]))
                                if ev.kind == "leave" else
                                chaos_membership.insert_zero_row_host(
                                    obs_prev, ev.index))
                    n_ranks = n_data = topo.n_ranks
                    steps = epoch_steps(len(x), n_ranks, batch_size)
                    if blk_end < epochs:
                        # a new ring: the step and the data shards are
                        # rebuilt for it
                        step = build(
                            "compact" if compact_capacity is not None
                            or compact_static else "dense", compact_capacity)
                        if prefetcher is not None:
                            prefetcher.close()
                            prefetcher = make_prefetcher()
                if ckpt_due:
                    tensors, meta = snapshot(blk_end)
                    if writer is not None:
                        # fresh device copies, made before the next block
                        # launches (a later block may write the state's
                        # buffers), serialized on the writer thread behind
                        # the next block's compute
                        with _span("ckpt_snapshot", cat="host",
                                   epoch=blk_end):
                            tensors = {k: v.clone()
                                       for k, v in tensors.items()}
                            ready = None
                            if device.type == "cuda":
                                ready = torch.cuda.Event()
                                ready.record()
                        writer.save(ckpt_path, tensors, meta, ready=ready)
                        del tensors
                    else:
                        with _span("checkpoint", cat="host", epoch=blk_end):
                            save(tensors, meta)
                # graceful preemption: a signal since the last boundary,
                # or a notice scheduled in this block, drains here
                preempt_reason = None
                if guard.requested is not None:
                    preempt_reason = f"signal:{guard.requested}"
                elif preempt_at is not None and blk_end >= preempt_at[0]:
                    preempt_reason = (
                        f"schedule:{preempt_at[0]}@{preempt_at[1]}")
                if preempt_reason is not None:
                    t_drain = time.perf_counter()
                    with _span("preempt_drain", cat="host", epoch=blk_end):
                        if pending is not None:
                            drain(pending)
                            pending = None
                        if writer is not None:
                            writer.wait()
                        if ckpt_path and not ckpt_due:
                            save(*snapshot(blk_end))
                    info = {"reason": preempt_reason, "epoch": int(blk_end),
                            "snapshot": bool(ckpt_path),
                            "drain_s": round(time.perf_counter() - t_drain,
                                             4)}
                    if checkpoint_dir and primary:
                        info["marker"] = crashpoint.write_marker(
                            checkpoint_dir, info)
                    raise crashpoint.GracefulPreemption(info)
                if blk_end == fault_epoch:  # the serial schedule under it
                    crashpoint.inject_fault(fault_mode)
                # the boundary is processed: host work drained or
                # deferred, any due save committed or on the writer
                crashpoint.hit("loop.block_end")
                bi += 1
            if pending is not None:
                drain(pending)
                pending = None
            if writer is not None:
                writer.wait()  # the exit barrier; re-raises its error
    finally:
        if writer is not None:
            writer.close(raise_errors=False)
        if prefetcher is not None:
            prefetcher.close()
    if memb_pending and history:
        # transitions at the final boundary have no next record to ride
        history[-1].setdefault("membership_transitions", [])
        history[-1]["membership_transitions"] += memb_pending
    return state, history
