#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`eventgrad_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. toolchain — torch, CUDA, nvcc and driver versions, the card's name and
   power limit, and the TF32 switches (both set off: float32 work on the
   card stays float32);
2. build — the hand-written kernels (`eventgrad_tpu_torch/csrc/*.cu`)
   compile with nvcc for sm_90a, one process per source, all at once;
   each flash instantiation's registers, spills and shared memory
   (`-Xptxas -v`), and, where the toolkit has cuobjdump, its count of
   tensor-core instructions (HMMA for mma.sync, HGMMA for wgmma): the
   run fails if an instantiation is missing or has none of its own kind
   (`ops/flash_plan.instantiations`: the mma.sync form's forward, dQ and
   dK/dV in float32 and bfloat16 at DMAX 32, 64, 128 and the wide form;
   the wgmma form's bfloat16 forward, dQ and dK/dV at D 64, 128, 256,
   HGMMA; the whole form's float32 forward, dQ and dK/dV at D 256);
3. kernels — each gossip-tail kernel at the flagship shapes (Ring(8) x
   ResNet-18: 8 x 17,444,682 elements, two neighbors), held bitwise
   against its plain PyTorch version on the same inputs (bit patterns
   compared at each dtype's width), then timed with CUDA events (median
   of 20 after 3 warm-ups) beside its plain version, a one-call PyTorch
   yardstick where one exists, and its bound on the card. The carrier
   commit runs on int8 carriers (with scales) and on bf16 carriers, and
   on int8 it must equal the f32 commit kernel fed the dequantized
   buffers, bitwise (p', t' and the dequantized committed buffers).
   Then the pitched (bucket) forms of kernels 1, 2, 3 and 5 over the
   ResNet-18 arena cut into 4 leaf-aligned buckets, as the bucketed step
   calls them (the arenas read and written in place at each bucket's
   columns): each bucket bitwise its plain version, the four launches
   timed beside the plain versions and the contiguous form. Then the
   gated forms of kernels 1, 4 and 5 (per-row mix weights, edge gates,
   poison and quarantine) on a mixed pattern — rank 1's first edge off,
   rank 3 quarantined, rank 5 poisoned — each bitwise its plain version
   (NaNs read as one pattern), the quarantined row the mixed one, and
   with null or all-open operands bitwise the ungated launch; timed
   beside the plain versions, against the ungated kernel's bound. Then
   the gated pitched forms of kernels 1 and 5 (the bucketed schedule
   under the fault clauses) over the 4 buckets on the same pattern,
   each bucket bitwise its plain version, the four launches timed
   beside the plain versions, the ungated pitched and the gated
   whole-arena forms, against the bound of their work with the per-row
   operands (`ops/work.gated_tail`).
   Then the three flash-attention kernels (forward, dQ, dK/dV) at the
   transformer legs' shapes (B = 32 = 8 ranks x 4, T = 1024, and H = 8,
   D = 64, H = 16, D = 128 or H = 8, D = 256; causal, q/k/v as strided
   views of one fused projection), in
   float32 and in bfloat16, each against its plain version on the same
   inputs and, in float32, the autograd Function end to end against
   autograd through the plain attention: float32 forward atol = rtol =
   2e-5, float32 gradients atol = 5e-5, rtol = 5e-4, bfloat16 atol =
   rtol = 5e-2 element by element and, as a whole, ||got - want|| /
   ||want|| <= BF16_REL_NORM (the element-wise limit is the size of a
   typical bfloat16 gradient element there, so a lost K/V tile can pass
   it; the norm cannot); timed beside the plain versions and
   `scaled_dot_product_attention` (forward, and its whole backward), with
   the bound from the products' flops on the tensor cores (bfloat16: 989
   TFLOP/s; float32: three TF32 products each at 495 TFLOP/s, the least
   work that keeps float32 accuracy) or the bytes at 3.35 TB/s,
   whichever is larger (every bound: the work of `ops/work.py` over the
   H100 row of `obs/devicespec.py`). Each main shape's record names the
   form that served each kernel (`ops/flash_plan.py`: bfloat16 on
   wgmma, float32 at D = 256 on the whole form, the rest on mma.sync)
   and its launches; the run fails if a launch took another form (small
   cases included), or if the C dispatcher (`eg_flash_form`) and the
   Python mirror disagree on a case's form or shared memory. Small cases
   follow in
   float32 and bfloat16, at D = 24-64, again at D = 80, 96 and 128 (the DMAX = 128 kernels;
   80 and 96 on zero-filled columns) and at D = 160, 256, 320 and 512
   (the wide form; 160 and 320 on zero-filled columns of their last
   128-column chunk): non-causal, ragged T = 160 (also
   with rows only 4-byte aligned: 4-byte copies in float32, plain loads
   in bfloat16), one row, the offset variant on a fully visible, a
   diagonal, a past-the-diagonal (keys 40 ahead) and a fully masked hop
   (output and gradients exactly 0), per-group offsets, each with the
   cotangent of lse; then head dimensions 160 and 512 through the
   autograd Function against autograd through the plain attention (no
   width is refused). Last, kernel 9, the auditor's seeded
   unregistered kernel (`eg::leak_kernel`, `csrc/audit_leak.cu`),
   bitwise `x * 2.0` at the JAX fixture's (8, 128) block and at 8 x
   17,444,682 elements, timed beside `x * 2.0` and `torch.mul` over
   LEAK_BATCH calls in a row (the card's time a call, not one call's
   host dispatch);
4. reference — a small ResNet's EventGraD, D-PSGD, int8
   carrier-resident EventGraD, allreduce and sparsified EventGraD (top-k
   10%, f32 and int8 wires) steps on Ring(8), and its EventGraD step on
   Torus(2, 4), on the card against the same steps on the CPU (plain
   versions), float64 compute and float32 state: parameters within
   rtol=1e-4, atol=1e-5 and equal fire bits, except where a leaf sat on
   its threshold; int8 carriers within one quantum. The same for its
   compact-wire EventGraD steps (f32, and int8 carrier-resident, at a
   third of the arena: the gate defers) and its micro step on the
   compact wire (capacity the largest of 8 partitions).
   The same for a small transformer (flash attention, float32 compute,
   T = 96), and stacked ring attention through the flash kernels over 4
   shards (D = 32, 128 and 256) against plain attention on the whole
   sequence, forward and gradients;
5. main path — the flagship trainer through `eventgrad_tpu_torch.train`:
   full-width ResNet-18 (bf16 compute, 3 blocks per stage), Ring(8),
   global batch 256, SGD lr 0.01 momentum 0.9, the adaptive trigger at
   horizon 1.05 and max_silence 50 with warmup 2, nine legs of 3 steps x
   2 epochs: EventGraD and D-PSGD on the f32 wire, EventGraD on the int8
   wire with carrier-resident buffers, its D-PSGD int8 twin, EventGraD on
   the bf16 wire with carrier-resident buffers, sparsified EventGraD at
   top-k 10% on the f32 wire, allreduce, and EventGraD on the compact
   wire at `compact_frac=0.375` (dense through the first epoch, compact
   in the second), f32 and int8 carrier-resident, each logged beside
   its masked twin (step_ms, peak memory). Then ResNet-50 (Bottleneck
   blocks, `MODEL_REGISTRY["resnet50"]`: 29,451,082 parameters in 197
   leaves) on the same op-point, EventGraD and D-PSGD on the dense
   masked f32 wire, 3 steps x 2 epochs each. Then six
   transformer legs at the same optimizer and trigger: EventGraD and
   D-PSGD on `TransformerLM(vocab=256, dim=512, n_heads=8, n_layers=4,
   max_len=1024, attn="flash")` (13,389,056 parameters per rank in 46
   leaves), on `TransformerLM(vocab=256, dim=2048, n_heads=16,
   n_layers=2, max_len=1024, attn="flash")`, the `transformer-d128` legs
   (heads of 128: Pythia-1.4B's attention width, cut to 2 layers;
   103,850,240 parameters in 26 leaves), and on the same LM in 8 heads
   of 256, the `transformer-d256` legs (Gemma-2B's attention width, cut
   to 2 of its 18 layers; the same parameters), in float32, 4 sequences
   of 1024 tokens per rank, the f32 wire. The kernels' launch counters
   are zeroed just before each leg and read just after (the
   `transformer-d128` legs' flash launches report as the DMAX = 128
   records "flash_*_d128", the `transformer-d256` legs' as
   "flash_*_d256", and each leg fails unless every forward and dK/dV
   launch took the form the rule names for float32 at its head width:
   mma.sync at 64 and 128, the whole form at 256); a leg whose kernels
   did not launch, whose receive buffers are not in the carrier dtype, whose byte counts
   are not exact (D-PSGD int8 34,890,052 sent bytes per step per chip,
   EventGraD int8 34,890,224 wire-real bytes, sparsified EventGraD f32
   2 x (8 x sum of the leaves' k + 86) wire-real bytes, allreduce 4 x
   17,444,682 sent bytes: each derived from the model's leaf sizes; on
   the LM and ResNet-50, D-PSGD's sent and wire-real bytes both 2 x 4 B
   per parameter (ResNet-50: 235,608,656) and EventGraD's wire-real that
   plus the fire bytes, as the step reckons it in float32 (ResNet-50:
   235,609,056), with the fired payload at most that), whose
   flash kernels did not launch once per layer per step (forward: plus
   once per layer per test pass), or whose loss is not finite fails the
   run; a compact leg fails unless its last epoch ran the compact wire
   at capacity ceil(0.375 x 17,444,682) = 6,541,756 with wire-real bytes
   exactly 2 x (4 B x capacity + 86) = 52,334,220 (f32) or 2 x (capacity
   + 86 + 4 x 86) = 13,084,372 (int8), derived from the record's
   capacity and the leaf sizes;
6. real data — the port trained to a test accuracy on the bundled
   digit scans (`eventgrad_tpu_torch/utils/realdata.py`), seed 0, 540
   passes per leg on Ring(8): CNN2 on "digits" (EventGraD with the
   reference-pure trigger, and D-PSGD) and LeNetCifar on "digits32"
   with augmentation (sparsified EventGraD at top-k 10%, and D-PSGD),
   held to the JAX package's committed runs of the same operating
   points (`artifacts/realdata_digits_r3_cpu.json`,
   `artifacts/realdata_cifar_r4_cpu.json`): every leg's test accuracy
   at least the reference leg's less 4.0 points, the event legs'
   msgs-saved-% within 6.0 points of the reference's, every loss
   finite, and the kernels of each algorithm launched (counters zeroed
   just before each leg and read just after);
7. frontier — the JAX package's frontier op-point
   (`tools/frontier_sweep.py`; `eventgrad_tpu_torch/utils/frontier.py`):
   LeNetCifar on Ring(8), 14 epochs, the four trigger policies
   (norm_delta, topk, micro, hybrid) at one compact capacity (the
   largest of 8 partitions, 48,000 elements) on the f32 and int8 wires,
   8 legs, held to `artifacts/frontier_cpu.json`: bytes per step per
   chip exact (norm_delta, micro, hybrid 384,020 / 96,100; topk 768,100
   / 480,150), micro's msgs-saved-% exactly 86.71875 and fired_frac
   0.125, the other legs' msgs-saved-% within 6.0 points of the
   reference leg's, every test accuracy at least the reference leg's
   less 4.0 points, every loss finite, the kernels launched;
8. bucketed + bounded-async — on the flagship op-point (ResNet-18 in
   bf16, Ring(8), global batch 256, SGD lr 0.01 momentum 0.9, the
   adaptive trigger; 6 passes a leg through `train`), under
   `torch.use_deterministic_algorithms(True)` (CUBLAS_WORKSPACE_CONFIG
   set before CUDA is first used; the setting restored after): (a)
   EventGraD masked f32 and masked int8 carrier-resident at K = 4
   buckets against the monolithic schedule, bitwise (parameters, trace,
   trigger state, receive buffers and scales, records), the bucketed
   kernels launched 4 times a pass on the bucket's columns (the pitched
   forms), wire-real exactly 139,557,632 / 34,890,224; (b) D = 2 at the
   baseline lag against staleness 1 on both wires, bitwise, no late
   commits; (c) the composed stack, K = 4 x compact int8 carrier at
   compact_frac 0.375 (capacity raised to the bucketed floor 7,667,712)
   x D = 4 under `slow=1@7`: the staleness gauge exactly 4 on the edges
   rank 1 feeds and 1 elsewhere, late commits > 0, wire-real 34,890,224
   (dense first epoch) then exactly 15,336,284, and a second run
   bitwise the first (queues included); (d) sparsified EventGraD top-k
   10% at K = 4: D = 2 against staleness 1 bitwise, wire-real exactly
   27,912,332. Then (e) the straggler op-point
   (`eventgrad_tpu_torch/utils/straggler.py`: MLP 16, 1,440 passes,
   the composed stack, `slow=2@6`, D = 1, 2, 4): late commits exactly
   the JAX artifact's (`artifacts/straggler_ablation_cpu.json`: 2,876 /
   2,872), the gauge exactly D, msgs-saved-% within 6.0 points of the
   JAX legs, test accuracy at least the JAX leg's less 4.0 points
   (98.05 / 98.24 / 98.44) and the bounded legs' at least the lockstep
   leg's less 4.0, every loss finite;
9. chaos + integrity — the fault clauses, the recovery policies and
   the integrity engine on the gossip path. On the flagship op-point
   with the JAX bench's 30 warmup passes (6 passes a leg, under
   deterministic algorithms): (a) EventGraD f32 with `ChaosSchedule()`
   and a recovery policy that never trips, and D-PSGD with
   `ChaosSchedule()`, bitwise `chaos=None` (parameters, trace, trigger
   state, buffers, records) while the gated kernels launch every pass;
   (b) D-PSGD under `die=5@2` with `freeze_after=2` through kernel 4's
   gated form (the mix weight 1/2 on the dead rank's neighbours, 1 on
   the dead rank), EventGraD f32 and int8 carrier-resident at
   `drop=0.2,seed=0` (kernels 1 and 5 gated): `chaos_drops` exactly the
   host delivery table's undelivered edges (every edge sends in warmup);
   (c) EventGraD f32 with integrity on under
   `bitflip=1-7@0.3,nanstep=2@4`: rejections exactly the corruption
   table's (0 silent acceptances), exactly one quarantined step, every
   parameter finite, and one step with rank 2 poisoned whose p' row is
   bitwise the mixed row (`mix_weighted`) and t' row the old trace. Then
   (d) the chaos sweep (`eventgrad_tpu_torch/utils/chaos_sweep.py`:
   mlp32, Ring(4), 192 passes; drop 0 / 0.2 / 0.5, the flaky window,
   the ring heal of `die=2@15`) and (e) the integrity leg
   (`utils/integrity_sweep.py`: `bitflip=64-128@0.15,nanstep=2@144`,
   checksums on, quarantine off, rollback and escalation), drawn in the
   artifacts' Threefry layout and held to
   `artifacts/chaos_sweep_cpu.json` (drop 0 bitwise and 0 drops, drops
   at most the table's and within 10% of 284 / 623, survivors [0, 1,
   3], detection within 5 passes of pass 29, msgs-saved-% within 6.0,
   each point's accuracy cost against the same run's fault-free
   baseline at most the artifact's cost plus 4.0, and each point's
   accuracy at least the port's CPU seeds 0-9 minimum at that point
   less 4.0, `artifacts/torch_chaos_seeds_cpu.json`) and
   `artifacts/integrity_cpu.json` (83 injected = 83 rejected, 0 silent,
   1 rollback, 1 quarantined step, the fault-free leg above the same
   seeds' floor, the faulted leg's accuracy gap at most the artifact's
   0.39 plus 4.0, the replay and the off leg bitwise). The op-point's ReLU logits make its accuracy multimodal
   (a dead class ends near 90%): the accuracy bands hold the cost of
   the faults, not one seed's mode. Then (f) the bucketed schedule
   (K = 4) under `drop=0.2,seed=0,flaky=2-4@0.5,die=5@3` with the idle
   freeze policy, on the f32 wire with `nanstep=2@4` and on the int8
   carrier: every pass's tail is the gated pitched form of kernel 1
   (or 5), 4 launches a pass and no other form, and the state (NaNs by
   their bits), the peer health and the records are bitwise the
   monolithic twin's (one gated whole-arena launch a pass);
10. dispatch — the dispatch pipeline on the flagship (EventGraD masked
   f32, bf16 compute, Ring(8), global batch 256, 2,048 samples: 8
   passes an epoch, 4 epochs, a 512-sample test set, deterministic
   algorithms): the serial twin (one epoch a block, the pipeline off,
   the block prefetcher uploading pinned blocks on its own stream) and
   `epochs_per_dispatch=2` pipelined with the dataset on the device,
   both with a snapshot every 2 epochs, then K = 2 pipelined on the
   prefetcher without saves: every state tensor, every record value
   but `wall_s` and `dispatch_*`, the snapshots of epochs 2 and 4 as
   they are staged and the final snapshots on disk bitwise the serial
   twin's; kernels 1 and 2 once a pass; logs the wall per epoch, the
   prefetcher's misses and host syncs per pass (the obs phase's count,
   from twins at 4 passes an epoch under the profiler);
11. resume — checkpoint/resume, graceful preemption and the crash
   drills on the flagship op-point at 2 passes an epoch (512 samples),
   3 epochs, under deterministic algorithms (cuDNN benchmark off): (a)
   EventGraD on the masked f32 wire, run uninterrupted in this process,
   then with a save every epoch in a child process armed at
   `ckpt.mid_swap:2` (forked from the crash matrix's forkserver), which
   must exit 83 leaving `ckpt.prev` and no primary, then relaunched with
   `resume=True`: every state tensor (parameters, trace, buffers,
   thresholds, the CUDA generator's bytes) bitwise the uninterrupted
   run's, the records of epochs 2-3 value for value; (b) the int8
   carrier-resident leg: its snapshot restored onto the card bitwise
   (buffers and scales included), and resumes into an f32-resident run
   and into `bucketed=4` raising the JAX loop's causes; (c) D-PSGD under
   `drop=0,seed=1,preempt=2@1`: `GracefulPreemption` at epoch 2 with the
   marker on disk, the resume consuming it, recomputing no epoch and
   bitwise the run under `drop=0,seed=1`; (d) the chaos phase's
   integrity leg with a `checkpoint_dir` (`keep_good=1`): bitwise the
   leg without one, one snapshot retained; (e) the crash matrix
   (`eventgrad_tpu_torch/utils/crash_matrix.py --device cuda`: 23 cells,
   `arena_pipe`'s 6 with the writer's `writer.bg_save` among them, and
   2 preemption legs in child processes on the card, on 6 worker
   threads beside (a)'s kill child and relaunch and (d); the timed
   saves of (a)-(c) run before it starts), every verdict
   equal to `artifacts/crash_matrix_cpu.json`'s. Each leg logs its
   launches, snapshot bytes and save (fsync included) and restore
   seconds beside the card's name and power limit;
12. audit — the static-analysis path on the card: the audit CLI
   (`python -m eventgrad_tpu_torch.analysis.audit --device cuda`, in a
   child process beside the flagship op-point's traces here) over
   the 31 cells of the JAX auditor's matrix and its 15 oracles (the
   mesh lift's among them, on a one-process mesh),
   plus the lint: every cell clean (rank isolation, the declared ring
   offsets, bytes per neighbour derived from the traced exchange lanes
   == the accounting formula == the step's `sent_bytes_wire_real`,
   exactly), each cell's traced `eg::` kernel ops equal to the launches
   the same call made, every oracle detected and kernel 9 launched by
   the unregistered-kernel oracle. Then the flagship op-point audited:
   Ring(8), ResNet-18 in bf16, global batch 256, one step each of
   EventGraD on the masked f32 wire, D-PSGD f32, EventGraD compact f32
   and compact int8 carrier-resident at capacity 6,541,756, each clean
   with derived bytes per neighbour 69,778,814 / 69,778,728 /
   26,167,110 / 6,542,186 equal to the formula, and the float32 metric
   139,557,632 / 139,557,456 / 52,334,220 / 13,084,372;
13. obs — the on-device telemetry, the message-lifecycle ledger and the
   host registry on the flagship op-point (3 passes x 2 epochs a leg,
   each with `obs="off"` and `obs="epoch"`, under deterministic
   algorithms): (a) EventGraD masked f32 with a `Registry`, (b) D-PSGD,
   (c) EventGraD int8 carrier-resident: every state tensor bitwise the
   obs-off run's, the records equal but for `obs`, the consensus probe
   and `wall_s`, every window's ledger audit clean with proposed =
   suppressed + deferred + fired exactly, (a)'s fire counts x 2
   neighbours = its num_events change per window, (b)'s census exactly
   86 x 3 x 8 messages fired and delivered per edge per window, kernels
   1-5 launched as their legs say; (d) the composed ledger op-point
   (`eventgrad_tpu_torch/utils/ledger_audit.py`: MLP 16, Ring(4), D = 2,
   compact 0.5, drops, bitflips, lags, nansteps, checksums and
   quarantine): 0 violations, every disposition row above 0, both seeded
   leaks caught naming their law, obs off bitwise on, kernel 1's gated
   form launched; the silence bucket of 0..2^20 on the card against the
   CPU's, equal but at s = 8192 (card 13, CPU 12); (e) the overhead
   (`utils/obs_overhead.measure_pair`): obs off and on in one process,
   pass by pass on the same batches, 10 timed passes after 3 warm-ups,
   then two windows of 3 profiled passes each (off, on, on, off): pass
   ms, the paired difference, launches, device-busy ms per window, the
   telemetry span's device ms and host syncs per pass, which must be
   equal off and on; (f) (a)'s Chrome trace written,
   reloaded and every span inside `train`, the bubble decomposition, the
   run report from (a)'s JSONL (`obs/report.py`) and the Prometheus
   ledger gauges; the phase's launches and seconds;
14. costmodel — the analytic cost model (`obs/costmodel.py`) on the
   card: one step each of the ResNet-18 flagship (EventGraD and D-PSGD;
   Ring(8), bf16 compute, global batch 256), ResNet-50 (EventGraD) and
   the `transformer-d256` LM (EventGraD; Gemma-2B's attention width, 8
   heads of 256, 4 sequences of 1024 a rank) traced by `analyze_step`,
   then timed over 4 more passes (CUDA events): FLOPs and no-fusion
   bytes per step and per phase, the step time, MFU and roofline
   against `device_spec()`, beside the card's name and power limit;
   fails unless `device_spec()` is the H100 row, the phases sum to the
   totals, each traced `eg::` op is charged its closed form
   (`ops/work.py`, the bounds of phase 3) times its calls, and every MFU
   and roofline share lies in (0, 1];
15. membership — elastic membership on the flagship (the resume phase's
   op-point: 2 passes an epoch at 8 ranks and at 7, under deterministic
   algorithms): EventGraD and D-PSGD under `leave=1@2,join=1@4` over 6
   epochs, the join's row streamed through `<checkpoint_dir>/bootstrap`,
   each again with the row handed over in memory, bitwise the first
   (every state tensor, the records); kernels 1 and 2 (EventGraD) and 4
   (D-PSGD) launched once every pass of every epoch, at 7 rows and at 8;
   the transitions the schedule's; every loss finite; then the first
   pass after each transition (the run cut at epochs 2 and 4, the
   step rebuilt on the new ring) fires every leaf on every rank, the
   exact forced count 2 x 86 messages a rank;
16. cli — the port started the way the system starts, on files the
   phase writes: the native data library built from this checkout under
   `build/` (`data/native.py`; `available()` and `jpeg_supported()`
   printed; with libjpeg, 64 JPEGs decoded through the CIFAR-10 JPEG
   tree loader, else a line saying why that leg did not run); the
   flagship through `eventgrad_tpu_torch.cli.main` (full-width ResNet-18
   in float32, Ring(8), global batch 256, lr 0.01 momentum 0.9, horizon
   1.05, warmup 2, 2 epochs on `--dataset cifar10 --data-dir` five
   binary batches of 256 records and a test batch: the loaded arrays
   bitwise the bytes times float32 1/255), EventGraD with max silence
   50, D-PSGD and EventGraD on the int8 carrier: kernels 1 and 2, 4, 3
   and 5 launched once a pass, the bytes exact, a record an epoch and a
   final one; the LM through the CLI (dim 512, 8 heads of 64, 2 layers,
   T = 1024, 16 sequences a rank, one pass): the flash launches by form
   and kernels 1 and 2; the supervisor's drills as child processes on
   the card (the MLP on MNIST idx files the phase writes): a crash under
   `python -m eventgrad_tpu_torch.supervise` and a hang it must kill,
   each resumed to a last snapshot bitwise the uninterrupted run's;
17. hybrid — EventGraD over the hybrid meshes, 8 ranks stacked on the
   card at the width of the d128 LM legs (d_model 2048, 16 heads of
   128: Pythia-1.4B's width; 2 layers, T = 1024, vocab 256, float32):
   `dp:4,sp:2` with ring attention through the flash kernels (forward,
   dQ and dK/dV launched once a hop, two hops a layer a pass) and its
   D-PSGD twin (kernel 4); `dp:4,tp:2` `TPTransformerLM` through
   `cli.main --device cuda`; `dp:4,pp:2` `PPTransformerLM` (4
   microbatches); `dp:2,ep:4` `MoETransformerLM` (8 experts, top-2,
   capacity factor 2.0, 2 sequences a rank). Each leg's memory is
   reckoned and logged before it runs; the ring legs first hold ring
   attention through the flash kernels against plain attention over
   the whole sequence, forward and the three gradients, on the card at
   their own shape (`_hybrid_ring_check`); one pass (the ring leg two,
   warmup 1, so the second pass's fire bits are the trigger's) is held
   against the same pass on the CPU (plain versions) from the same
   state, parameters and each leaf's update, cut to 1 layer (the
   pipeline leg's 2, one a stage) and one sequence of 32 tokens a data
   rank (`_reference_steps`); then 2 epochs of 2 passes:
   the loss falls, every loss and parameter is finite, the bytes and
   msgs-saved-% are exactly the formula's for the two dp neighbours,
   the leg's kernels launched; step ms, peak GiB and launches printed;
18. mesh — the device-mesh lift (`parallel/spmd.py`,
   `parallel/multihost.py`), ranks in separate processes on the one
   card: (a) the ResNet-18 flagship (float32 compute: the CLI has no
   compute-dtype flag; Ring(8), global batch 256, lr 0.01 momentum 0.9,
   horizon 1.05, warmup 2, EventGraD with max silence 50 and D-PSGD, 2
   epochs of 2 passes) as two processes of four rows each, started as
   the user starts them (`python -m eventgrad_tpu_torch.cli --backend
   mesh --coordinator 127.0.0.1:<port> --num-processes 2 --process-id
   p`, what runs after a preamble setting deterministic algorithms,
   `MESH_CLI`, with TF32 off through NVIDIA_TF32_OVERRIDE=0), over
   `gloo-host` (pinned host buffers: two processes share the card);
   held against the simulator of the same argv in this process, under
   the same switches and the mesh's schedule (`--pipeline off`, host
   data), one epoch at a time from the same state: epoch 1 from the
   seed, then epoch 2 resumed (`--resume`) from the simulator's epoch-1
   snapshot on both sides. Each epoch's record: the first record's
   transport, events, msgs-saved-% and both byte counts equal, the loss
   within MESH_LOSS_RTOL; each epoch's snapshot: the parameters within
   MESH_PARAMS_TOL, the momentum trace within MESH_TRACE_TOL, every
   integer tensor equal; kernels 1 and 2 (EventGraD) or 4 (D-PSGD)
   launched once a pass in each process (the final records' summed
   launches). One epoch from the same state, not the whole run: the
   ResNet's gradient at these passes moves ~1e3 times as far as its
   parameters (a 1e-7 perturbation of them moves the trace 6e-3), so
   the rounding of a four-row stack against an eight-row one grows
   from 3e-9 of the parameters after one pass to 9e-4 after four,
   while an exchange with the wrong neighbours moves two passes 3e-4
   (`PERF.md` §6, the mesh lift); (b) the `sp:2,dp:4` ring-attention LM at the
   hybrid phase's width, cut to 1 layer (EventGraD, 2 epochs of 2
   passes; sp outer, so every K/V hop and its gradient cross the
   process boundary) as two
   `python -c` children (`mesh_lm_child`, once (a)'s have ended: beside
   them the card ran out of memory), against its simulator here:
   events, msgs-saved-% and bytes equal, parameters within
   MESH_LM_TOL, flash forward, dQ and dK/dV once a hop in each process
   on the float32 D = 128 form, kernels 1 and 2 once a pass; (c) a
   one-process NCCL group holding all 8 rows of the MLP
   (`mesh_nccl_child`, beside (a)): allreduce and EventGraD bitwise the
   simulator in the same process (every state tensor and record); (d)
   leg (a)'s flagship under the fault clauses (MESH_CHAOS: EventGraD
   under drops, flips in transit and a poisoned rank with the in-step
   checksums and quarantine and the edge freeze; D-PSGD under drops
   with the freeze), the simulator's two epochs here while (b)'s
   processes run, then the mesh's second from the simulator's first,
   both algorithms' processes at once beside (b)'s simulator here,
   held as (a)'s epoch is and with the drops, rejections, quarantines
   and per-edge silence equal, the gated tails (kernel 1's, kernel 4's)
   once a pass in each process. Then, in a phase of its own
   (`phase_mesh_hybrid`), (e)-(h): the tensor-parallel transformer
   through the command line (`tp:2,dp:4`), the pipeline (`pp:2,dp:4`, 2
   layers, one a stage), the MoE (`ep:4,dp:2`, 2 sequences a data rank)
   and Ulysses attention through the flash kernels (`sp:2,dp:4`), at the
   hybrid phase's width cut to MESH_LM_LAYERS, the sharded (or sequence)
   axis outer so that every one of its collectives crosses the process
   boundary, 2 epochs of one pass, warmup 1: every leg's simulator here
   first, then (e)'s two command-line processes, then one pair of
   processes running (f)-(h) in turn (`mesh_hybrid_child`, each holding
   its parameter rows against the simulator's), each alone on the
   card: events, msgs-saved-% and bytes equal, parameters within
   MESH_LM_TOL, kernels 1 and 2 once a pass in each process, Ulysses'
   flash forward, dQ and dK/dV once a layer a pass on the float32 D =
   128 form, and the collectives that crossed the processes exactly the
   leg's (MESH_HYBRID_CROSSED, from `spmd.Mesh.crossed`: the dp gossip
   stays inside a process). A child that fails or passes
   MESH_CHILD_TIMEOUT fails the phase at once. Each leg prints its
   transport, step ms, peak GiB a process (legs (e)-(h) beside the peak
   reckoned from their arenas), the bytes that crossed and launches
   beside the card's name and power limit; the children's launches go
   into the summary's counts;
19. summary — one JSON line of every kernel's numbers, the card's name and
   power limit, and, last, `{"ok": true, "device": {...}}`.

The phases do not run in the order of this list. Phases 1-3 run first,
alone, so that the kernels' times are the card's own; then the phases
that hold 25-42 GiB of the card or time the steps their figures divide
(`HEAVY`: the ResNet-50 and d128/d256 LM legs of phase 5, and phase 14);
then the rest in three streams at once (`STREAMS`: this process runs
the first, a child process each other one, `stream_child`), with phase
17's references on the CPU (`phase_hybrid_reference`) and phase 2's
cuobjdump counts (`phase_sass`) among them, since their time is the
host's; last, alone again, the hybrid legs and the mesh's two phases
(`TAIL`). The
step times of the streamed phases are taken beside one another. A
stream that fails fails the run; it is stopped, with every process it
started, when the run ends. Each phase's seconds are logged as it ends,
and a child's log follows once its stream has ended.

It needs the repository beside it (it imports the port from its own
directory) and a CUDA device; it never falls back to the CPU.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent


#: the flagship shapes: ResNet-18 as the reference instantiates it
FLAGSHIP_PARAMS = 17_444_682
RANKS = 8
NB = 2

#: the flash-attention shapes of the transformer legs: batch 8 ranks x 4
#: sequences, T = 1024, 8 heads of 64 (dim 512), causal
FLASH_SHAPE = (RANKS * 4, 1024, 8, 64)
#: ... and of the legs at head dimension 128: 16 heads of 128 (dim 2048,
#: the attention width of Pythia-1.4B)
FLASH_SHAPE_D128 = (RANKS * 4, 1024, 16, 128)
#: ... and at head dimension 256: 8 heads of 256 (dim 2048, the attention
#: width of Gemma-2B), the kernels' wide form
FLASH_SHAPE_D256 = (RANKS * 4, 1024, 8, 256)
LM = dict(vocab=256, dim=512, n_heads=8, n_layers=4, max_len=1024)
LM_PARAMS, LM_LEAVES, LM_PER_RANK = 13_389_056, 46, 4
#: the legs at head dimension 128: Pythia-1.4B's attention width
#: (EleutherAI; d_model 2048, 16 heads of 128) in the repo's GPT-style
#: block, cut to 2 layers, vocab 256
LM_D128 = dict(vocab=256, dim=2048, n_heads=16, n_layers=2, max_len=1024)
LM_D128_PARAMS, LM_D128_LEAVES = 103_850_240, 26
#: the legs at head dimension 256: Gemma-2B's attention width (google;
#: d_model 2048, 8 heads of 256) in the same block, cut to 2 of its 18
#: layers, vocab 256: the d128 legs' parameters in other heads
LM_D256 = dict(vocab=256, dim=2048, n_heads=8, n_layers=2, max_len=1024)

TIMING_REPS, TIMING_WARMUP = 20, 3
#: kernel 9 and its rivals are timed over this many calls in a row, so
#: each call's host dispatch (~30-40 us for the custom operator) hides
#: behind the last call's 0.38 ms on the card
LEAK_BATCH = 20
#: the bfloat16 flash outputs' limit on ||got - want|| / ||want|| against
#: their plain versions (which compute in float32 from the same bfloat16
#: inputs). On the H100 sound kernels read 2.1e-3-2.6e-3 at the main
#: shapes and at most 3.0e-3 in the small cases (the rounding of p and ds
#: to bfloat16 before their products); a wgmma dQ at D = 256 that skips
#: the sweep's last K tile read 0.69, one that skips one K tile in the
#: three heaviest query blocks 0.058
BF16_REL_NORM = 1e-2
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


def time_ms(fn, batch: int = 1) -> float:
    """Median device time of one call, from CUDA events around each of
    TIMING_REPS runs of `batch` calls in a row after TIMING_WARMUP
    warm-ups, divided by `batch`."""
    import torch

    for _ in range(TIMING_WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def card_spec():
    """The card's row of the port's one peak table
    (`eventgrad_tpu_torch/obs/devicespec.py`, the H100 SXM's published
    peaks: HBM3 bandwidth, the dense bf16 and TF32 tensor-core rates and
    the float32 rate outside the tensor cores): the kernels' bounds here
    and the cost model's MFU divide by the same numbers."""
    from eventgrad_tpu_torch.obs.devicespec import H100

    return H100


def bound(flops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the float32 operations over the card's float32 rate."""
    spec = card_spec()
    t_bytes = nbytes / spec.peak_hbm_bytes_per_s * 1e3
    t_ops = flops / spec.peak_f32_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tail_bound(kernel: str, n_elems: int, carrier=None):
    """The bound of one elementwise kernel call over `n_elems` elements
    with NB neighbours: its work from `eventgrad_tpu_torch/ops/work.py`,
    the closed form the cost model charges the same call."""
    from eventgrad_tpu_torch.ops import work

    return bound(*work.tail(kernel, n_elems, NB, carrier))


def max_abs_err(got, want, what="its plain version") -> float:
    """Largest |kernel - plain| over matching outputs; raises unless every
    output is bitwise `want`: bit patterns compared through a view of
    each dtype's width (int32 for f32, int16 for bf16, int8 as is)."""
    import torch

    width = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
             torch.int8: torch.int8}
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise SmokeError(f"kernel output {g.dtype}{tuple(g.shape)} vs "
                             f"{w.dtype}{tuple(w.shape)} of {what}")
        err = max(err, float((g.float() - w.float()).abs().max()))
        if not torch.equal(g.view(width[g.dtype]), w.view(width[w.dtype])):
            raise SmokeError(f"kernel output not bitwise {what} "
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


#: a flash kernel instantiation in a mangled name: the mma.sync form's
#: (kernel, type, DMAX, wide form 0 or 1) ...
FLASH_INST = re.compile(
    r"(flash_(?:fwd|dq|dkv))_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E")
#: ... and the wgmma (bf16) and whole (float32) forms' (kernel, form, D)
FLASH_FORM_INST = re.compile(
    r"(flash_(?:fwd|dq|dkv))_(wgmma|whole)_kernelILi(\d+)E")


def flash_inst(mangled: str):
    """(kernel, form, element bytes, D, wide) of a flash instantiation's
    mangled name, or None."""
    m = FLASH_INST.search(mangled)
    if m:
        kernel, ty, dmax, wide = m.groups()
        return kernel, "mma", 4 if ty == "f" else 2, int(dmax), wide == "1"
    m = FLASH_FORM_INST.search(mangled)
    if m:
        kernel, form, d = m.groups()
        return kernel, form, 2 if form == "wgmma" else 4, int(d), False
    return None


def inst_name(inst) -> str:
    """"flash_fwd<bf16, 128, wide>" (the mma.sync form) or
    "flash_fwd_wgmma<bf16, 256>"."""
    kernel, form, elem, d, wide = inst
    ty = "float" if elem == 4 else "bf16"
    if form == "mma":
        return f"{kernel}<{ty}, {d}{', wide' if wide else ''}>"
    return f"{kernel}_{form}<{ty}, {d}>"


def flash_smem_bytes(kernel: str, form: str, elem: int, d: int,
                     wide: bool) -> int:
    """Dynamic shared memory of one flash instantiation, as its launch
    sizes it: `eventgrad_tpu_torch/ops/flash_plan.smem_bytes`, which the
    CPU tests hold under the card's 232,448 bytes and the flash phase
    holds against the C dispatcher's sizes."""
    from eventgrad_tpu_torch.ops import flash_plan

    return flash_plan.smem_bytes(kernel, form, elem, d, wide)


def ptxas_report(text: str):
    """Per flash instantiation, ptxas's registers and spills (-Xptxas -v)
    beside its dynamic shared memory."""
    inst = None
    for line in text.splitlines():
        if "warning" in line:
            log(f"  {line.strip()}")
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            inst = flash_inst(m.group(1))
            continue
        if inst is None:
            continue
        name = inst_name(inst)
        if "spill" in line:
            log(f"  ptxas {name}: {line.strip()}")
        elif "Used" in line:
            smem = flash_smem_bytes(*inst)
            log(f"  ptxas {name}: {line.split(':', 1)[1].strip()}; "
                f"{smem} bytes dynamic shared memory")


def hmma_counts(lib_path) -> dict:
    """{instantiation: {"HMMA": n, "HGMMA": m}} of the flash kernels in
    the built library, from cuobjdump's SASS (mma.sync shows as HMMA,
    wgmma as HGMMA); {} without cuobjdump."""
    from eventgrad_tpu_torch.ops import build

    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300).stdout
    counts, inst = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            found = flash_inst(m.group(1))
            inst = inst_name(found) if found else None
            if inst:
                counts.setdefault(inst, {"HMMA": 0, "HGMMA": 0})
        elif inst and "HGMMA" in line:
            counts[inst]["HGMMA"] += 1
        elif inst and "HMMA" in line:
            counts[inst]["HMMA"] += 1
    return counts


def phase_build():
    from eventgrad_tpu_torch.ops import build

    log("== build")
    path, secs, text = build.build(verbose=True)
    if not text:
        log("  (library already built from these sources: no ptxas report)")
    ptxas_report(text)
    build.library()
    log(f"built {path.relative_to(HERE) if HERE in path.parents else path} "
        f"in {secs:.2f} s")


def phase_sass():
    """Each flash instantiation's tensor-core instructions in the built
    library (module docstring, phase 2): cuobjdump's work is the host's,
    so it runs beside other phases. Returns no launches."""
    from eventgrad_tpu_torch.ops import build, flash_plan

    log("== sass: tensor-core instructions of the built library")
    counts = hmma_counts(build.library_path())
    if counts:
        log(f"tensor-core instructions per flash instantiation: "
            f"{json.dumps(counts)}")
        # every instantiation the forms compile is in use: the wgmma form
        # must issue wgmma (HGMMA), the others mma.sync (HMMA)
        idle = []
        for inst in flash_plan.instantiations():
            op = "HGMMA" if inst[1] == "wgmma" else "HMMA"
            if counts.get(inst_name(inst), {}).get(op, 0) == 0:
                idle.append(f"{inst_name(inst)} ({op})")
        if idle:
            raise SmokeError(f"no tensor-core instructions in {sorted(idle)}")
    else:
        log("cuobjdump not in the toolkit: HMMA / HGMMA counts skipped")
    return {}


def phase_kernels():
    """Each kernel against its plain version at the flagship shapes, then
    timed. Returns {name: partial kernel record}."""
    import torch

    from eventgrad_tpu_torch.models.resnet import ResNet18
    from eventgrad_tpu_torch.ops import arena_update, event_engine, fused_update
    from eventgrad_tpu_torch.parallel import collectives
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

    def leaf_bits():
        # per-leaf fire bits, about half the leaves
        return torch.rand((RANKS, spec.n_leaves), generator=gen,
                          device=dev) < 0.5

    def expand(bits):
        # to positions, the way the train step hands them to the kernels
        return bits.to(torch.float32)[:, seg]

    def keep_bits():
        return expand(leaf_bits())

    def leaf_scales():
        # per-leaf int8 scales as the wire makes them (absmax / 127,
        # truncated to 17 significand bits)
        return collectives._contract_safe(torch.rand(
            (RANKS, spec.n_leaves), generator=gen, device=dev) * 0.05 + 1e-3)

    def int8_carrier():
        return torch.randint(-127, 128, (RANKS, spec.n_total), generator=gen,
                             device=dev, dtype=torch.int8)

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
        bound=tail_bound("masked_wire", n),
    )

    # int8 masked wire: clip(rint(where(fire > 0, flat, 0) / scale), ±127)
    # against the scales the wire derives from this arena
    fire_leaf = leaf_bits()
    fire = expand(fire_leaf)
    scale = collectives._masked_scales(
        collectives._leaf_absmax(flat, spec), fire_leaf)[:, seg]
    args = (flat, fire, scale)
    err = max_abs_err([event_engine.masked_wire_int8(*args)],
                      [event_engine.masked_wire_reference(*args)])
    recs["masked_wire_int8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: event_engine.masked_wire_int8(*args)),
        plain_ms=time_ms(lambda: event_engine.masked_wire_reference(*args)),
        library_ms=None,
        # reads flat, fire and scale, writes out (f32 each); a compare, a
        # select, a division, a rounding and two clip compares
        bound=tail_bound("masked_wire_int8", n),
    )
    del flat, fire, scale, args

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
        bound=tail_bound("fused_mix_commit", n),
    )
    del args, cands, lasts, keeps

    # carrier-resident commit on int8 carriers: per-leaf keeps and
    # scales, the committed scales expanded for the mix, as the step
    # hands them over
    effs = (leaf_bits(), leaf_bits())
    keeps = tuple(expand(e) for e in effs)
    cq, lq = (int8_carrier(), int8_carrier()), (int8_carrier(), int8_carrier())
    cs, ls = (leaf_scales(), leaf_scales()), (leaf_scales(), leaf_scales())
    new_s = collectives.commit_carrier_scales(cs, effs, ls)
    kw = dict(mix_scales=tuple(sc[:, seg] for sc in new_s))
    args = (p, cq, keeps, lq, g, t, lr, mom, w)
    fmc = arena_update.fused_mix_commit_carrier
    k_out = fmc(*args, **kw)
    p_out = arena_update.mix_commit_carrier_reference(*args, **kw)
    err = max_abs_err([k_out[0], k_out[1], *k_out[2]],
                      [p_out[0], p_out[1], *p_out[2]])
    del p_out
    # the carrier contract: the f32 commit kernel on the dequantized
    # buffers gives the same p', t' and (dequantized) committed buffers
    deq = lambda bufs, scales: collectives.dequant_carrier_bufs(
        bufs, scales, spec)
    f_out = arena_update.fused_mix_commit(
        p, deq(cq, cs), keeps, deq(lq, ls), g, t, lr, mom, w)
    max_abs_err([k_out[0], k_out[1], *deq(k_out[2], new_s)],
                [f_out[0], f_out[1], *f_out[2]],
                "the f32 commit kernel on the dequantized buffers")
    log("carrier contract: int8 carrier commit == f32 commit on the "
        "dequantized buffers, bitwise")
    del k_out, f_out
    recs["fused_mix_commit_carrier"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fmc(*args, **kw)),
        plain_ms=time_ms(
            lambda: arena_update.mix_commit_carrier_reference(*args, **kw)),
        library_ms=None,
        # reads p, g, t (f32), per neighbor cand and last (int8), keep
        # and scale (f32); writes p', t' (f32) and the committed buffers
        # (int8). Per element per neighbor a compare, a select, a
        # conversion, a multiply and an add, then 5 ops of mix and SGD
        bound=tail_bound("fused_mix_commit_carrier", n, "int8"),
    )
    del args, kw, cq, lq, cs, ls, new_s

    # the same kernel on bf16 carriers (no scales)
    cb = tuple(randn().to(torch.bfloat16) for _ in range(NB))
    lb = tuple(randn().to(torch.bfloat16) for _ in range(NB))
    args = (p, cb, keeps, lb, g, t, lr, mom, w)
    k_out = fmc(*args)
    p_out = arena_update.mix_commit_carrier_reference(*args)
    err = max_abs_err([k_out[0], k_out[1], *k_out[2]],
                      [p_out[0], p_out[1], *p_out[2]])
    del k_out, p_out
    recs["fused_mix_commit_carrier"]["max_abs_err"] = max(
        recs["fused_mix_commit_carrier"]["max_abs_err"], err)
    recs["fused_mix_commit_carrier_bf16"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: fmc(*args)),
        plain_ms=time_ms(
            lambda: arena_update.mix_commit_carrier_reference(*args)),
        library_ms=None,
        bound=tail_bound("fused_mix_commit_carrier", n, "bf16"),
    )
    del args, cb, lb, keeps

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
        bound=tail_bound("fused_mix_sgd", n),
    )
    del args, p, g, t, b
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in recs.items():
        log(json.dumps({"kernel": name, "elements": n, **{
            k: v for k, v in r.items() if k != "bound"},
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}))
    recs["pitched"] = _pitched_kernels(spec, gen, recs)
    recs.update(_gated_kernels(spec, gen, recs))
    recs.update(_pitched_gated_kernels(spec, gen, recs))
    return recs


def _same_or_nan(got, want, what) -> float:
    """`max_abs_err` with every NaN read as one canonical pattern: a
    poisoned row is NaN in both, and the kernel and the plain version
    need not agree on a NaN's payload bits. Logs whether they did."""
    import torch

    canon = lambda x: torch.where(torch.isnan(x), torch.full_like(
        x, float("nan")), x)
    raw = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
              for g, w in zip(got, want) if g.dtype == torch.float32)
    err = max_abs_err([canon(g) if g.is_floating_point() else g
                       for g in got],
                      [canon(w) if w.is_floating_point() else w
                       for w in want], what)
    log(f"{what}: bitwise (NaN payloads {'equal' if raw else 'differ'})")
    return err


def _gated_kernels(spec, gen, recs):
    """The gated forms of kernels 1, 4 and 5 at the flagship shapes with a
    mixed pattern — rank 1's first edge gated off (weight 1/2), rank 3
    quarantined, rank 5 poisoned (NaN), the rest open — each bitwise its
    plain version; and with null operands and with every gate open
    (weight float32(1/3), poison 1, no quarantine) bitwise the ungated
    launch. The quarantined row of kernel 1 must equal the mixed row the
    plain version computes (its new trace the old one). Timed beside the
    plain versions; the per-row operands add no bytes worth counting, so
    the bound is the ungated kernel's. Returns {name_gated: record}."""
    import torch

    from eventgrad_tpu_torch.ops import arena_update, fused_update
    from eventgrad_tpu_torch.parallel import collectives

    dev = torch.device(DEVICE)
    log("== gated forms (kernels 1, 4, 5): rank 1 edge 0 off, rank 3 "
        "quarantined, rank 5 poisoned")
    seg = spec.seg_expand(dev)
    randn = lambda: torch.randn((RANKS, spec.n_total), generator=gen,
                                device=dev)
    keep = lambda: (torch.rand((RANKS, spec.n_leaves), generator=gen,
                               device=dev) < 0.5).to(torch.float32)[:, seg]
    lr, mom, w = 0.01, 0.9, 1.0 / 3.0
    gate = torch.ones((RANKS, NB), dtype=torch.bool, device=dev)
    gate[1, 0] = False
    w_rows = collectives.mix_weights(gate)
    if float(w_rows[1]) != 0.5 or float(w_rows[0]) != float(
            torch.tensor(w, dtype=torch.float32)):
        raise SmokeError(f"mix weights {w_rows.tolist()}")
    poison = torch.ones(RANKS, device=dev)
    poison[5] = float("nan")
    quar = torch.zeros(RANKS, dtype=torch.bool, device=dev)
    quar[3] = True
    open_kw = dict(w_rows=collectives.mix_weights(torch.ones_like(gate)),
                   gate=torch.ones_like(gate), poison=torch.ones_like(poison),
                   quar=torch.zeros_like(quar))
    out = {}

    p, g, t = randn(), randn(), randn()
    cands, lasts = (randn(), randn()), (randn(), randn())
    keeps = (keep(), keep())
    args = (p, cands, keeps, lasts, g, t, lr, mom, w)
    kw = dict(w_rows=w_rows, gate=gate, poison=poison, quar=quar)
    fmc = arena_update.fused_mix_commit
    k_out = fmc(*args, **kw)
    p_out = arena_update.mix_commit_reference(*args, **kw)
    err = _same_or_nan([k_out[0], k_out[1], *k_out[2]],
                       [p_out[0], p_out[1], *p_out[2]],
                       "fused_mix_commit gated")
    mixed = collectives.mix_weighted(p, p_out[2], gate)
    _same_bits(k_out[0][3], mixed[3], "fused_mix_commit quarantined row")
    _same_bits(k_out[1][3], t[3], "fused_mix_commit quarantined trace")
    if not (torch.isnan(k_out[0][5]).all() and torch.isnan(k_out[1][5]).all()
            and torch.isfinite(k_out[0][[0, 1, 2, 3, 4, 6, 7]]).all()):
        raise SmokeError("fused_mix_commit gated: poison not on rank 5 only")
    ungated = fmc(*args)
    for name, gk in (("null", {}), ("open", open_kw)):
        got = fmc(*args, **gk)
        max_abs_err([got[0], got[1], *got[2]],
                    [ungated[0], ungated[1], *ungated[2]],
                    f"the ungated launch ({name} operands)")
    del k_out, p_out, ungated, got, mixed
    out["fused_mix_commit_gated"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fmc(*args, **kw)),
        plain_ms=time_ms(
            lambda: arena_update.mix_commit_reference(*args, **kw)),
        ungated_ms=recs["fused_mix_commit"]["ms"], library_ms=None,
        bound=recs["fused_mix_commit"]["bound"])
    del args, cands, lasts

    # kernel 5 on int8 carriers: gate and w_rows
    int8 = lambda: torch.randint(-127, 128, (RANKS, spec.n_total),
                                 generator=gen, device=dev, dtype=torch.int8)
    scales = lambda: collectives._contract_safe(torch.rand(
        (RANKS, spec.n_total), generator=gen, device=dev) * 0.05 + 1e-3)
    cq, lq = (int8(), int8()), (int8(), int8())
    args = (p, cq, keeps, lq, g, t, lr, mom, w)
    ckw = dict(mix_scales=(scales(), scales()))
    gkw = dict(w_rows=w_rows, gate=gate)
    fcc = arena_update.fused_mix_commit_carrier
    k_out = fcc(*args, **ckw, **gkw)
    p_out = arena_update.mix_commit_carrier_reference(*args, **ckw, **gkw)
    err = max_abs_err([k_out[0], k_out[1], *k_out[2]],
                      [p_out[0], p_out[1], *p_out[2]])
    ungated = fcc(*args, **ckw)
    for name, gk in (("null", {}), ("open", dict(
            w_rows=open_kw["w_rows"], gate=open_kw["gate"]))):
        got = fcc(*args, **ckw, **gk)
        max_abs_err([got[0], got[1], *got[2]],
                    [ungated[0], ungated[1], *ungated[2]],
                    f"the ungated carrier launch ({name} operands)")
    del k_out, p_out, ungated, got
    out["fused_mix_commit_carrier_gated"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fcc(*args, **ckw, **gkw)),
        plain_ms=time_ms(lambda: arena_update.mix_commit_carrier_reference(
            *args, **ckw, **gkw)),
        ungated_ms=recs["fused_mix_commit_carrier"]["ms"], library_ms=None,
        bound=recs["fused_mix_commit_carrier"]["bound"])
    del args, cq, lq, ckw, keeps

    # kernel 4: w_rows, the gated buf_sum built outside as the step does
    bufs = (randn(), randn())
    zero = torch.zeros((), device=dev)
    b = torch.zeros_like(p)
    for i, x in enumerate(bufs):
        b = b + torch.where(gate[:, i:i + 1], x, zero)
    args = (p, b, g, t, lr, mom, w)
    fms = fused_update.fused_mix_sgd
    err = max_abs_err(fms(*args, w_rows=w_rows),
                      fused_update.mix_sgd_reference(*args, w_rows=w_rows))
    max_abs_err(fms(*args, w_rows=open_kw["w_rows"]), fms(*args),
                "the ungated launch (open weights)")
    out["fused_mix_sgd_gated"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fms(*args, w_rows=w_rows)),
        plain_ms=time_ms(lambda: fused_update.mix_sgd_reference(
            *args, w_rows=w_rows)),
        ungated_ms=recs["fused_mix_sgd"]["ms"], library_ms=None,
        bound=recs["fused_mix_sgd"]["bound"])
    del args, p, g, t, b, bufs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(json.dumps({"kernel": name, **{
            k: v for k, v in r.items() if k != "bound"},
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}))
    return out


#: buckets of the bucketed schedule on the flagship legs
BUCKETS = 4


def _pitched_kernels(spec, gen, recs):
    """The pitched (bucket) forms of kernels 1, 2, 3 and 5 over the
    ResNet-18 arena cut into BUCKETS leaf-aligned buckets, as the
    bucketed step calls them: the arena operands whole `[8, n]` arenas
    read (and written) at each bucket's columns, the bucket operands `[8,
    n_b]`. Each bucket's outputs are held bitwise against the plain
    version on the same inputs; the four launches together (the whole
    arena) are timed beside the plain versions and the contiguous form.
    Returns {kernel: record}."""
    import torch

    from eventgrad_tpu_torch.ops import arena_update, event_engine
    from eventgrad_tpu_torch.parallel import collectives

    dev = torch.device(DEVICE)
    buckets = spec.buckets(BUCKETS)
    log(f"== pitched forms: {BUCKETS} buckets of "
        f"{[b.size for b in buckets]} columns (offsets "
        f"{[b.start for b in buckets]})")
    arena = lambda: torch.randn((RANKS, spec.n_total), generator=gen,
                                device=dev)
    per_b = lambda make: [make(b) for b in buckets]
    randb = lambda b: torch.randn((RANKS, b.size), generator=gen, device=dev)
    bitsb = lambda b: (torch.rand((RANKS, b.size), generator=gen, device=dev)
                       < 0.5).to(torch.float32)
    int8b = lambda b: torch.randint(-127, 128, (RANKS, b.size), generator=gen,
                                    device=dev, dtype=torch.int8)
    scaleb = lambda b: collectives._contract_safe(torch.rand(
        (RANKS, b.size), generator=gen, device=dev) * 0.05 + 1e-3)
    lr, mom, w = 0.01, 0.9, 1.0 / 3.0
    view = lambda x, b: x[:, b.start:b.start + b.size]
    out = {}

    flat = arena()
    fire, scale = per_b(bitsb), per_b(scaleb)
    err = 0.0
    for i, b in enumerate(buckets):
        err = max(err, max_abs_err(
            [event_engine.masked_wire(flat, fire[i], off=b.start)],
            [event_engine.masked_wire_reference(view(flat, b), fire[i])]))
    out["masked_wire"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: [event_engine.masked_wire(flat, fire[i],
                                                     off=b.start)
                            for i, b in enumerate(buckets)]),
        plain_ms=time_ms(lambda: [event_engine.masked_wire_reference(
            view(flat, b), fire[i]) for i, b in enumerate(buckets)]))
    err = 0.0
    for i, b in enumerate(buckets):
        err = max(err, max_abs_err(
            [event_engine.masked_wire_int8(flat, fire[i], scale[i],
                                           off=b.start)],
            [event_engine.masked_wire_reference(view(flat, b), fire[i],
                                                scale[i])]))
    out["masked_wire_int8"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: [event_engine.masked_wire_int8(
            flat, fire[i], scale[i], off=b.start)
            for i, b in enumerate(buckets)]),
        plain_ms=time_ms(lambda: [event_engine.masked_wire_reference(
            view(flat, b), fire[i], scale[i])
            for i, b in enumerate(buckets)]))
    del flat, fire, scale

    p, g, t = arena(), arena(), arena()
    cands = [per_b(randb) for _ in range(NB)]
    keeps = [per_b(bitsb) for _ in range(NB)]
    lasts = [per_b(randb) for _ in range(NB)]
    nbr = lambda xs, i: tuple(x[i] for x in xs)
    p_out, t_out = torch.empty_like(p), torch.empty_like(p)

    def commit_all():
        for i, b in enumerate(buckets):
            arena_update.fused_mix_commit(
                p, nbr(cands, i), nbr(keeps, i), nbr(lasts, i), g, t, lr,
                mom, w, off=b.start, out=(p_out, t_out))

    def commit_plain():
        for i, b in enumerate(buckets):
            arena_update.mix_commit_reference(
                view(p, b), nbr(cands, i), nbr(keeps, i), nbr(lasts, i),
                view(g, b), view(t, b), lr, mom, w)

    err = 0.0
    for i, b in enumerate(buckets):
        _, _, bufs = arena_update.fused_mix_commit(
            p, nbr(cands, i), nbr(keeps, i), nbr(lasts, i), g, t, lr, mom,
            w, off=b.start, out=(p_out, t_out))
        pr, tr, br = arena_update.mix_commit_reference(
            view(p, b), nbr(cands, i), nbr(keeps, i), nbr(lasts, i),
            view(g, b), view(t, b), lr, mom, w)
        err = max(err, max_abs_err(
            [view(p_out, b).contiguous(), view(t_out, b).contiguous(), *bufs],
            [pr, tr, *br]))
    out["fused_mix_commit"] = dict(max_abs_err=err, ms=time_ms(commit_all),
                                   plain_ms=time_ms(commit_plain))
    del cands, lasts

    cq = [per_b(int8b) for _ in range(NB)]
    lq = [per_b(int8b) for _ in range(NB)]
    sc = [per_b(scaleb) for _ in range(NB)]
    fmc = arena_update.fused_mix_commit_carrier

    def carrier_all():
        for i, b in enumerate(buckets):
            fmc(p, nbr(cq, i), nbr(keeps, i), nbr(lq, i), g, t, lr, mom, w,
                mix_scales=nbr(sc, i), off=b.start, out=(p_out, t_out))

    def carrier_plain():
        for i, b in enumerate(buckets):
            arena_update.mix_commit_carrier_reference(
                view(p, b), nbr(cq, i), nbr(keeps, i), nbr(lq, i),
                view(g, b), view(t, b), lr, mom, w, mix_scales=nbr(sc, i))

    err = 0.0
    for i, b in enumerate(buckets):
        _, _, bufs = fmc(p, nbr(cq, i), nbr(keeps, i), nbr(lq, i), g, t, lr,
                         mom, w, mix_scales=nbr(sc, i), off=b.start,
                         out=(p_out, t_out))
        pr, tr, br = arena_update.mix_commit_carrier_reference(
            view(p, b), nbr(cq, i), nbr(keeps, i), nbr(lq, i), view(g, b),
            view(t, b), lr, mom, w, mix_scales=nbr(sc, i))
        err = max(err, max_abs_err(
            [view(p_out, b).contiguous(), view(t_out, b).contiguous(), *bufs],
            [pr, tr, *br]))
    out["fused_mix_commit_carrier"] = dict(
        max_abs_err=err, ms=time_ms(carrier_all),
        plain_ms=time_ms(carrier_plain))
    del p, g, t, keeps, cq, lq, sc, p_out, t_out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in out.items():
        r["contiguous_ms"] = recs[name]["ms"]
        r["bound_ms"] = recs[name]["bound"][0]
        log(json.dumps({"pitched": name, "buckets": BUCKETS,
                        "launches": BUCKETS, **r}))
    return out


def _pitched_gated_kernels(spec, gen, recs):
    """The gated pitched forms of kernels 1 and 5 (the bucketed schedule
    under the fault clauses) over the ResNet-18 arena cut into BUCKETS
    buckets, with `_gated_kernels`'s mixed pattern (rank 1's first edge
    off, rank 3 quarantined and rank 5 poisoned on kernel 1; the edge
    gate and weights on kernel 5's int8 carriers): each bucket bitwise
    its plain version (NaNs read as one pattern), the four launches
    timed beside the plain versions, the ungated pitched form and the
    gated whole-arena form, against the bound of their work with the
    per-row operands (`ops/work.gated_tail`, summed over the buckets).
    Returns {"<kernel>_pitched_gated": record}."""
    import torch

    from eventgrad_tpu_torch.ops import arena_update, work
    from eventgrad_tpu_torch.parallel import collectives

    dev = torch.device(DEVICE)
    buckets = spec.buckets(BUCKETS)
    log(f"== gated pitched forms (kernels 1, 5): {BUCKETS} buckets, rank 1 "
        "edge 0 off, rank 3 quarantined, rank 5 poisoned")
    arena = lambda: torch.randn((RANKS, spec.n_total), generator=gen,
                                device=dev)
    randb = lambda b: torch.randn((RANKS, b.size), generator=gen, device=dev)
    bitsb = lambda b: (torch.rand((RANKS, b.size), generator=gen, device=dev)
                       < 0.5).to(torch.float32)
    int8b = lambda b: torch.randint(-127, 128, (RANKS, b.size), generator=gen,
                                    device=dev, dtype=torch.int8)
    scaleb = lambda b: collectives._contract_safe(torch.rand(
        (RANKS, b.size), generator=gen, device=dev) * 0.05 + 1e-3)
    per_b = lambda make: [make(b) for b in buckets]
    nbr = lambda xs, i: tuple(x[i] for x in xs)
    view = lambda x, b: x[:, b.start:b.start + b.size]
    lr, mom, w = 0.01, 0.9, 1.0 / 3.0
    gate = torch.ones((RANKS, NB), dtype=torch.bool, device=dev)
    gate[1, 0] = False
    w_rows = collectives.mix_weights(gate)
    poison = torch.ones(RANKS, device=dev)
    poison[5] = float("nan")
    quar = torch.zeros(RANKS, dtype=torch.bool, device=dev)
    quar[3] = True
    out = {}

    def bound_of(kernel, carrier=None):
        flops = nbytes = 0.0
        for b in buckets:
            f, nb_ = work.gated_tail(kernel, RANKS * b.size, RANKS, NB,
                                     carrier)
            flops, nbytes = flops + f, nbytes + nb_
        return bound(flops, nbytes)

    p, g, t = arena(), arena(), arena()
    p_out, t_out = torch.empty_like(p), torch.empty_like(p)
    keeps = [per_b(bitsb) for _ in range(NB)]
    cands = [per_b(randb) for _ in range(NB)]
    lasts = [per_b(randb) for _ in range(NB)]
    kw = dict(w_rows=w_rows, gate=gate, poison=poison, quar=quar)
    fmc = arena_update.fused_mix_commit

    def commit_all():
        for i, b in enumerate(buckets):
            fmc(p, nbr(cands, i), nbr(keeps, i), nbr(lasts, i), g, t, lr,
                mom, w, off=b.start, out=(p_out, t_out), **kw)

    def commit_plain():
        for i, b in enumerate(buckets):
            arena_update.mix_commit_reference(
                view(p, b), nbr(cands, i), nbr(keeps, i), nbr(lasts, i),
                view(g, b), view(t, b), lr, mom, w, **kw)

    err = 0.0
    for i, b in enumerate(buckets):
        _, _, bufs = fmc(p, nbr(cands, i), nbr(keeps, i), nbr(lasts, i), g,
                         t, lr, mom, w, off=b.start, out=(p_out, t_out), **kw)
        pr, tr, br = arena_update.mix_commit_reference(
            view(p, b), nbr(cands, i), nbr(keeps, i), nbr(lasts, i),
            view(g, b), view(t, b), lr, mom, w, **kw)
        err = max(err, _same_or_nan(
            [view(p_out, b).contiguous(), view(t_out, b).contiguous(), *bufs],
            [pr, tr, *br], f"fused_mix_commit pitched gated, bucket {i}"))
    _same_bits(t_out[3], t[3], "pitched gated quarantined trace")
    if not (torch.isnan(p_out[5]).all() and torch.isfinite(
            p_out[[0, 1, 2, 3, 4, 6, 7]]).all()):
        raise SmokeError("pitched gated: poison not on rank 5 only")
    out["fused_mix_commit_pitched_gated"] = dict(
        max_abs_err=err, ms=time_ms(commit_all),
        plain_ms=time_ms(commit_plain), library_ms=None,
        pitched_ms=recs["pitched"]["fused_mix_commit"]["ms"],
        gated_ms=recs["fused_mix_commit_gated"]["ms"],
        bound=bound_of("fused_mix_commit"))
    del cands, lasts

    cq = [per_b(int8b) for _ in range(NB)]
    lq = [per_b(int8b) for _ in range(NB)]
    sc = [per_b(scaleb) for _ in range(NB)]
    gkw = dict(w_rows=w_rows, gate=gate)
    fcc = arena_update.fused_mix_commit_carrier

    def carrier_all():
        for i, b in enumerate(buckets):
            fcc(p, nbr(cq, i), nbr(keeps, i), nbr(lq, i), g, t, lr, mom, w,
                mix_scales=nbr(sc, i), off=b.start, out=(p_out, t_out),
                **gkw)

    def carrier_plain():
        for i, b in enumerate(buckets):
            arena_update.mix_commit_carrier_reference(
                view(p, b), nbr(cq, i), nbr(keeps, i), nbr(lq, i),
                view(g, b), view(t, b), lr, mom, w, mix_scales=nbr(sc, i),
                **gkw)

    err = 0.0
    for i, b in enumerate(buckets):
        _, _, bufs = fcc(p, nbr(cq, i), nbr(keeps, i), nbr(lq, i), g, t, lr,
                         mom, w, mix_scales=nbr(sc, i), off=b.start,
                         out=(p_out, t_out), **gkw)
        pr, tr, br = arena_update.mix_commit_carrier_reference(
            view(p, b), nbr(cq, i), nbr(keeps, i), nbr(lq, i), view(g, b),
            view(t, b), lr, mom, w, mix_scales=nbr(sc, i), **gkw)
        err = max(err, max_abs_err(
            [view(p_out, b).contiguous(), view(t_out, b).contiguous(), *bufs],
            [pr, tr, *br]))
    out["fused_mix_commit_carrier_pitched_gated"] = dict(
        max_abs_err=err, ms=time_ms(carrier_all),
        plain_ms=time_ms(carrier_plain), library_ms=None,
        pitched_ms=recs["pitched"]["fused_mix_commit_carrier"]["ms"],
        gated_ms=recs["fused_mix_commit_carrier_gated"]["ms"],
        bound=bound_of("fused_mix_commit_carrier", "int8"))
    del p, g, t, keeps, cq, lq, sc, p_out, t_out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for name, r in out.items():
        log(json.dumps({"kernel": name, "buckets": BUCKETS,
                        "launches": BUCKETS, **{
                            k: v for k, v in r.items() if k != "bound"},
                        "bound_ms": r["bound"][0],
                        "bound_by": r["bound"][1]}))
    return out


def rel_norm_err(got, want) -> float:
    """||got - want|| / ||want|| over the whole tensor (0 where both are
    0, inf where only `want` is)."""
    g, w = got.detach().double(), want.detach().double()
    diff, ref = float((g - w).norm()), float(w.norm())
    return diff / ref if ref > 0 else 0.0 if diff == 0 else float("inf")


def within(got, want, atol, rtol, what, rel_norm=None) -> float:
    """Largest |got - want|; raises unless |got - want| <= atol + rtol *
    |want| everywhere, `got` is finite and, given `rel_norm`, ||got -
    want|| / ||want|| <= rel_norm. The message reads both measures."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    err = float((g - w).abs().max())
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise SmokeError(f"{what}: shape {tuple(g.shape)} against "
                         f"{tuple(w.shape)}, or not finite")
    elem = bool(((g - w).abs() <= atol + rtol * w.abs()).all())
    rel = rel_norm_err(g, w) if rel_norm is not None else None
    if not elem or (rel is not None and not rel <= rel_norm):
        raise SmokeError(
            f"{what}: max_abs_err {err} "
            f"{'within' if elem else 'outside'} atol={atol}, rtol={rtol}"
            + ("" if rel is None else
               f"; relative norm error {rel} "
               f"{'within' if rel <= rel_norm else 'outside'} {rel_norm}"))
    return err


def flash_bound(kernel: str, shape, dtype):
    """(bound_ms, bound_by) of one causal flash kernel: its matrix
    products (2*T*T*D flops each per (batch, head), halved by the causal
    mask) on the tensor cores (bfloat16: the card's dense bf16 rate;
    float32: three TF32 products each at the TF32 rate, the least that
    keeps float32 accuracy), against its [B, T, H, D] tensors and f32
    [B, H, T] rows moved once — the work of `ops/work.flash`, the closed
    form the cost model charges."""
    import torch

    from eventgrad_tpu_torch.ops import work

    spec = card_spec()
    flops, nbytes = work.flash(kernel, shape, torch.finfo(dtype).bits // 8)
    t_ops = (3 * flops / spec.peak_tf32_flops if dtype == torch.float32
             else flops / spec.peak_flops) * 1e3
    t_bytes = nbytes / spec.peak_hbm_bytes_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check_form(kernel: str, tensors, what: str) -> str:
    """The form `ops/flash_plan.tensor_form` names for a forward (q, k,
    v), dQ or dK/dV (q, k, v, dO) launch on `tensors`, held against the C
    dispatcher's choice (`eg_flash_form`) and its shared memory against
    `flash_plan.smem_bytes`."""
    import ctypes

    import torch

    from eventgrad_tpu_torch.ops import build, flash_plan

    form = flash_plan.tensor_form(*tensors)
    ptrs = (ctypes.c_void_p * len(tensors))(*[x.data_ptr() for x in tensors])
    flat = [st for x in tensors for st in x.stride()[:3]]
    smem = ctypes.c_int64(0)
    f32 = tensors[0].dtype == torch.float32
    d = tensors[0].shape[-1]
    code = build.library().eg_flash_form(
        ("flash_fwd", "flash_dq", "flash_dkv").index(kernel), ptrs,
        (ctypes.c_int64 * len(flat))(*flat), d, 0 if f32 else 1,
        ctypes.byref(smem))
    want = (0 if form == "mma" else
            flash_plan.smem_bytes(kernel, form, 4 if f32 else 2, d))
    if flash_plan.FORMS[code] != form or smem.value != want:
        raise SmokeError(f"{what}: the C dispatcher picks "
                         f"{flash_plan.FORMS[code]} ({smem.value} bytes), "
                         f"ops/flash_plan.py {form} ({want} bytes)")
    return form


def _flash_main_shape(shape, suffix, gen):
    """The three flash kernels at one main shape (causal, q/k/v as strided
    views of one fused projection), float32 and bfloat16: each against
    its plain version on the same inputs, in float32 the autograd
    Function end to end against autograd through the plain attention,
    then timed beside the plain versions and
    `scaled_dot_product_attention`. Returns {name + dtype tag + suffix:
    partial kernel record}."""
    import torch
    import torch.nn.functional as F

    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.ops import attention as fa

    dev = torch.device(DEVICE)
    b, t, h, d = shape
    recs = {}
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        f32 = dtype == torch.float32
        ops.reset_launch_counts()
        # f32: tests/test_flash_attention.py's tolerances; bf16: one part
        # in 20 (8 significand bits through two products and a softmax)
        # bfloat16 also as a whole: ||got - want|| / ||want||
        tol_o = (dict(atol=2e-5, rtol=2e-5) if f32 else
                 dict(atol=5e-2, rtol=5e-2, rel_norm=BF16_REL_NORM))
        tol_g = (dict(atol=5e-5, rtol=5e-4) if f32 else
                 dict(atol=5e-2, rtol=5e-2, rel_norm=BF16_REL_NORM))
        tag += suffix
        # q, k, v as the model hands them over: strided views of one
        # fused projection [B, T, 3H, D]
        qkv = torch.randn((b, t, 3 * h, d), generator=gen, device=dev).to(dtype)
        q, k, v = qkv.split(h, dim=2)
        do = torch.randn((b, t, h, d), generator=gen, device=dev).to(dtype)
        forms = {"flash_fwd": _check_form("flash_fwd", (q, k, v),
                                          f"flash_fwd{tag}"),
                 "flash_dq": _check_form("flash_dq", (q, k, v, do),
                                         f"flash_dq{tag}"),
                 "flash_dkv": _check_form("flash_dkv", (q, k, v, do),
                                          f"flash_dkv{tag}")}

        out, lse = fa.flash_fwd(q, k, v, None, True, 1)
        ref_out, ref_lse = fa.lse_reference(q, k, v, None, True, 1)
        err_f = within(out, ref_out, what=f"flash_fwd{tag} out", **tol_o)
        within(lse, ref_lse, what=f"flash_fwd{tag} lse", **tol_o)
        within(out, fa.flash_attention_reference(q, k, v, causal=True),
               what=f"flash_fwd{tag} vs full_attention", **tol_o)
        # the backward kernels on the plain forward's (out, lse), each
        # against its plain version on the same inputs
        lse_bht = ref_lse.transpose(1, 2).contiguous()
        delta = (do.float() * ref_out.float()).sum(-1).transpose(
            1, 2).contiguous()  # rowsum(dO * O) as [B, H, T]
        bargs = (q, k, v, do, lse_bht, delta, None, True, 1)
        dq = fa.flash_dq(*bargs)
        dk, dv = fa.flash_dkv(*bargs)
        rq = fa.dq_reference(*bargs)
        err_q = within(dq, rq, what=f"flash_dq{tag}", **tol_g)
        rk, rv = fa.dkv_reference(*bargs)
        err_kv = max(within(dk, rk, what=f"flash_dkv{tag} dk", **tol_g),
                     within(dv, rv, what=f"flash_dkv{tag} dv", **tol_g))
        # the relative norm errors, logged with each record
        rel = {} if f32 else {
            "flash_fwd": rel_norm_err(out, ref_out),
            "flash_dq": rel_norm_err(dq, rq),
            "flash_dkv": max(rel_norm_err(dk, rk), rel_norm_err(dv, rv))}
        del rq, rk, rv, ref_out, ref_lse
        if f32:
            # end to end: the autograd Function against autograd through
            # the plain attention
            leaf = qkv.clone().requires_grad_()
            g_k, = torch.autograd.grad(
                fa.flash_attention(*leaf.split(h, dim=2), causal=True), leaf,
                do)
            g_p, = torch.autograd.grad(
                fa.flash_attention_reference(*leaf.split(h, dim=2),
                                             causal=True), leaf, do)
            e = within(g_k, g_p, what=f"flash backward{tag} vs autograd",
                       **tol_g)
            err_q, err_kv = max(err_q, e), max(err_kv, e)
            del leaf, g_k, g_p
        torch.cuda.empty_cache()

        # the library yardstick: one fused call, [B, H, T, D] views
        lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(lq, lk, lv,
                                                      is_causal=True)
        lib_out = sdpa()
        lib_do = do.transpose(1, 2)
        lib_fwd = time_ms(lambda: sdpa())
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            lib_out, (lq, lk, lv), lib_do, retain_graph=True))
        del lib_out
        with torch.no_grad():
            recs["flash_fwd" + tag] = dict(
                max_abs_err=err_f,
                ms=time_ms(lambda: fa.flash_fwd(q, k, v, None, True, 1)),
                plain_ms=time_ms(
                    lambda: fa.lse_reference(q, k, v, None, True, 1)),
                library_ms=lib_fwd,
                # reads q, k, v, writes out and lse; two products
                bound=flash_bound("flash_fwd", shape, dtype),
            )
            recs["flash_dq" + tag] = dict(
                max_abs_err=err_q,
                ms=time_ms(lambda: fa.flash_dq(*bargs)),
                plain_ms=time_ms(lambda: fa.dq_reference(*bargs)),
                library_ms=lib_bwd,  # the library's whole backward
                # reads q, k, v, dO, lse, delta, writes dQ; three products
                bound=flash_bound("flash_dq", shape, dtype),
            )
            recs["flash_dkv" + tag] = dict(
                max_abs_err=err_kv,
                ms=time_ms(lambda: fa.flash_dkv(*bargs)),
                plain_ms=time_ms(lambda: fa.dkv_reference(*bargs)),
                library_ms=lib_bwd,  # the library's whole backward
                # reads q, k, v, dO, lse, delta, writes dK, dV; four products
                bound=flash_bound("flash_dkv", shape, dtype),
            )
        # which form served each kernel, and its launches (the checks and
        # the timings): every launch went to the form the rule names
        counts = fa.form_counts()
        for kname, form in forms.items():
            got = counts[kname]
            if got[form] == 0 or sum(got.values()) != got[form]:
                raise SmokeError(f"{kname}{tag}: launches by form {got}, "
                                 f"the rule names {form}")
            recs[kname + tag].update(form=form, form_launches=got[form])
            if kname in rel:
                recs[kname + tag]["rel_norm_err"] = rel[kname]
        del qkv, q, k, v, do, out, lse, dq, dk, dv, bargs, lq, lk, lv
        torch.cuda.empty_cache()
    return recs


def _flash_small_cases():
    """(name, B, T, H, D, causal, q_offset, k_offset, lead) of the small
    cases; bfloat16 pads D to the k16 step of its products. `lead` head
    elements before each q/k/v row: 1 leaves the rows only 4-byte aligned
    (4-byte copies in float32, plain loads in bfloat16)."""
    import torch

    def offs(*v):
        return torch.tensor(v, dtype=torch.int32, device=DEVICE)

    cases = [
        ("one row", 1, 1, 1, 16, True, 0, 0, 0),
    ]
    # D = 24 and 32 run the DMAX = 32 instantiation; 64 the DMAX = 64;
    # 80, 96 (zero-filled columns) and 128 the DMAX = 128; 160 (the second
    # chunk zero-filled past 32 columns), 256, 320 and 512 the wide form
    for d_ragged, d_hop, d_group in ((24, 32, 64), (80, 80, 80),
                                     (96, 96, 96), (128, 128, 128),
                                     (160, 160, 160), (256, 256, 256),
                                     (320, 320, 320), (512, 512, 512)):
        cases += [
            ("non-causal", 2, 160, 2, d_ragged, False, 0, 0, 0),
            ("ragged causal", 2, 160, 2, d_ragged, True, 0, 0, 0),
            ("ragged causal, rows 4-byte aligned", 2, 160, 2, d_ragged,
             True, 0, 0, 1),
            ("hop fully visible", 2, 96, 2, d_hop, True, 96, 0, 0),
            ("hop diagonal", 2, 96, 2, d_hop, True, 96, 96, 0),
            # keys 40 ahead: the first 40 rows see nothing, the sweep
            # ends off the tile grid
            ("hop past the diagonal", 2, 160, 2, d_hop, True, 0, 40, 0),
            ("hop fully masked", 2, 96, 2, d_hop, True, 0, 96, 0),
            # two groups of two batch rows, each with its own offset pair
            ("per-group offsets", 4, 80, 2, d_group, True, offs(80, 40),
             offs(40, 80), 0),
        ]
    return cases


def flash_suffix(d: int) -> str:
    """The record suffix a head dimension's small cases count under:
    "_d256" above 128 (the main shape's D = 256; other widths run the
    wide form), "_d128" for DMAX = 128."""
    return "_d256" if d > 128 else "_d128" if d > 64 else ""


def phase_flash_kernels():
    """The three flash-attention kernels against their plain versions:
    at the transformer legs' shapes (head dimensions 64, 128 and 256) in
    float32 (the legs' dtype) and bfloat16, timed; then small cases in
    both dtypes at D from 16 to 512 (non-causal, ragged T and D, the
    offset variant's three kinds of hop, the lse cotangent, per-group
    offsets); then head dimensions 160 and 512 through the autograd
    Function against autograd through the plain attention. Returns
    {name: partial kernel record}: D = 128's under names ending in
    "_d128", D = 256's (and the wider cases') in "_d256"."""
    import torch

    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.ops import attention as fa

    log("== flash-attention kernels")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    recs = _flash_main_shape(FLASH_SHAPE, "", gen)
    recs.update(_flash_main_shape(FLASH_SHAPE_D128, "_d128", gen))
    recs.update(_flash_main_shape(FLASH_SHAPE_D256, "_d256", gen))

    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        f32 = dtype == torch.float32
        tol_o = (2e-5, 2e-5) if f32 else (5e-2, 5e-2)
        tol_g = (5e-5, 5e-4) if f32 else (5e-2, 5e-2)
        rel_norm = None if f32 else BF16_REL_NORM
        for name, cb, ct, ch, cd, causal, qo, ko, lead in _flash_small_cases():
            ins = [torch.randn((cb, ct, ch, lead + cd), generator=gen,
                               device=dev).to(dtype)[..., lead:].detach()
                   .requires_grad_() for _ in range(3)]
            w_o = torch.randn((cb, ct, ch, cd), generator=gen,
                              device=dev).to(dtype)
            w_l = torch.randn((cb, ct, ch), generator=gen, device=dev)
            what = f"{name}{tag} D{cd}"
            # the backward kernels read dO = w_o beside q, k, v
            want_forms = {"flash_fwd": _check_form("flash_fwd", ins, what),
                          "flash_dq": _check_form("flash_dq", (*ins, w_o),
                                                  what),
                          "flash_dkv": _check_form("flash_dkv", (*ins, w_o),
                                                   what)}
            ops.reset_launch_counts()
            got = fa.flash_attention_lse(*ins, causal, qo, ko)
            want = fa.attention_lse_reference(*ins, causal, qo, ko)
            errs = [within(got[0], want[0], *tol_o, f"{what}: out",
                           rel_norm),
                    within(got[1], want[1], *tol_o, f"{what}: lse")]
            # the cotangent of lse rides along (it folds into delta)
            g_k = torch.autograd.grad(got, ins, (w_o, w_l))
            g_p = torch.autograd.grad(want, ins, (w_o, w_l))
            errs += [within(a, c, *tol_g, f"{what}: grad", rel_norm)
                     for a, c in zip(g_k, g_p)]
            rels = ([] if f32 else
                    [rel_norm_err(got[0], want[0])]
                    + [rel_norm_err(a, c) for a, c in zip(g_k, g_p)])
            if name == "hop fully masked" and (
                    any(bool(g.any()) for g in g_k) or bool(got[0].any())):
                raise SmokeError(f"{what}: output or gradients not exactly 0")
            suffix = flash_suffix(cd)
            for kname, err in (("flash_fwd", max(errs[:2])),
                               ("flash_dq", errs[2]),
                               ("flash_dkv", max(errs[3:]))):
                r = recs[kname + tag + suffix]
                r["max_abs_err"] = max(r["max_abs_err"], err)
            ran = {k: [f for f, n in v.items() if n]
                   for k, v in fa.form_counts().items()}
            for kname, form in want_forms.items():
                if ran[kname] != [form]:
                    raise SmokeError(f"{what}: {kname} launches by form "
                                     f"{ran[kname]}, the rule names {form}")
            log(f"flash {what}: B{cb} T{ct} H{ch} max_abs_err "
                f"{max(errs):.3e}"
                + (f", relative norm error {max(rels):.3e}" if rels else "")
                + f"; forms {json.dumps(ran)}")

    # no width is refused: D = 160 (once refused) and 512 through the
    # autograd Function, against autograd through the plain attention
    for cd in (160, 512):
        ins = [torch.randn((2, 72, 2, cd), generator=gen, device=dev)
               .requires_grad_() for _ in range(3)]
        w_o = torch.randn((2, 72, 2, cd), generator=gen, device=dev)
        got = fa.flash_attention(*ins, causal=True)
        want = fa.flash_attention_reference(*ins, causal=True)
        errs = [within(got, want, 2e-5, 2e-5, f"D{cd} flash_attention")]
        errs += [within(a, c, 5e-5, 5e-4, f"D{cd} flash_attention grad")
                 for a, c in zip(torch.autograd.grad(got, ins, w_o),
                                 torch.autograd.grad(want, ins, w_o))]
        log(f"D={cd} runs: flash_attention vs full_attention, max_abs_err "
            f"{max(errs):.3e}")
    torch.cuda.synchronize()
    shapes = {"": FLASH_SHAPE, "_d128": FLASH_SHAPE_D128,
              "_d256": FLASH_SHAPE_D256}
    for name, r in recs.items():
        shape = shapes[name[-5:] if name[-5:] in shapes else ""]
        log(json.dumps({"kernel": name, "shape": list(shape), **{
            k: v for k, v in r.items() if k != "bound"},
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}))
    return recs


def _reference_steps(name, model, algo, kw, cfg, batches, tol, topo=None,
                     update_rtol=None):
    """`len(batches)` train steps on the card against the same steps on
    the CPU (plain versions) from one initial state, on `topo` (default
    Ring(8)). Given `update_rtol`, each pass's update p' - p is held
    leaf by leaf too: |card - CPU| <= update_rtol x the leaf's largest
    CPU update, plus two ulps of the parameter (p' and p each rounded).
    Returns {"max_abs_err": the largest |card - CPU| of the parameters,
    and with `update_rtol` "update_max" (the largest |p' - p| on the
    CPU), "update_leaf_min" (the smallest leaf's largest |p' - p|) and
    "update_err_over_limit" (the largest |card - CPU| of an update over
    its limit; at most 1)}."""
    import numpy as np
    import torch

    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.parallel.topology import Ring
    from eventgrad_tpu_torch.train.state import init_train_state
    from eventgrad_tpu_torch.train.steps import EVENT_ALGOS, make_train_step

    topo = topo or Ring(RANKS)
    step = make_train_step(model, topo, algo, cfg, fused_sgd=(0.01, 0.9),
                           trace=True, **kw)
    resident = kw.get("wire") if kw.get("carrier_resident") else None
    st = {d: init_train_state(model, batches[0][0].shape[2:], topo, algo, cfg,
                              0, momentum=0.9, resident_wire=resident,
                              device=d)
          for d in (DEVICE, "cpu")}
    flips = 0
    upd = {"update_max": 0.0, "update_leaf_min": math.inf,
           "update_err_over_limit": 0.0}
    seg = arena_spec(model).seg_expand()
    for i, (xb, yb) in enumerate(batches):
        batch = (torch.from_numpy(xb), torch.from_numpy(yb))
        out = {}
        for d in st:
            prev = st[d]
            st[d], m = step(prev, tuple(v.to(d) for v in batch))
            out[d] = (prev, {k: v.cpu().numpy() for k, v in m.items()})
        if not np.all(np.isfinite(out[DEVICE][1]["loss"])):
            raise SmokeError(f"reference {name}: loss not finite")
        if algo in EVENT_ALGOS:
            fg, fc = (out[d][1]["trace_fired"] > 0 for d in (DEVICE, "cpu"))
            diff = fg != fc
            if diff.any():
                prev = out["cpu"][0].event
                vd = np.abs(out["cpu"][1]["trace_norm"]
                            - prev.last_sent_norm.numpy())
                th = prev.thres.numpy() * np.float32(cfg.horizon)
                if not np.all(np.abs(vd - th)[diff] < 1e-5 * th[diff]):
                    raise SmokeError(f"reference {name} pass {i + 1}: "
                                     f"fire bits differ off the threshold")
                flips += int(diff.sum())
        if flips == 0:
            # rank by rank, so the host holds one row's copies at a time
            for r, want in enumerate(st["cpu"].params):
                got = st[DEVICE].params[r].cpu()
                err = (got - want).abs()
                if bool((err > tol["atol"] + tol["rtol"] * want.abs()).any()):
                    raise SmokeError(
                        f"reference {name} pass {i + 1}: rank {r}'s "
                        f"parameters off by {float(err.max()):.3e}")
                if update_rtol is None:
                    continue
                d_cpu = want - out["cpu"][0].params[r]
                d_dev = got - out[DEVICE][0].params[r].cpu()
                scale = torch.zeros(int(seg[-1]) + 1).scatter_reduce_(
                    0, seg, d_cpu.abs(), "amax")
                off = (d_dev - d_cpu).abs()
                limit = (update_rtol * scale[seg]
                         + 2 * torch.finfo(want.dtype).eps * want.abs())
                over = float((off / limit.clamp_min(1e-30)).max())
                if over > 1:
                    raise SmokeError(
                        f"reference {name} pass {i + 1}: rank {r}'s "
                        f"update off by {float(off.max()):.3e} against "
                        f"its largest {float(d_cpu.abs().max()):.3e}")
                upd["update_max"] = max(upd["update_max"],
                                        float(scale.max()))
                upd["update_leaf_min"] = min(upd["update_leaf_min"],
                                             float(scale.min()))
                upd["update_err_over_limit"] = max(
                    upd["update_err_over_limit"], over)
            if resident:
                # parameters agree to rounding, so a carrier lane may
                # sit one quantum over at a rounding boundary
                for bg, bc in zip(st[DEVICE].event.bufs,
                                  st["cpu"].event.bufs):
                    if bg.dtype != torch.int8:
                        raise SmokeError(f"reference {name}: buffers "
                                         f"are {bg.dtype}")
                    dq = (bg.cpu().float() - bc.float()).abs().max()
                    if float(dq) > 1:
                        raise SmokeError(f"reference {name} pass "
                                         f"{i + 1}: carriers differ by "
                                         f"{float(dq)} quanta")
    d = max(float((st[DEVICE].params[r].cpu() - want).abs().max())
            for r, want in enumerate(st["cpu"].params))
    res = {"max_abs_err": d}
    if update_rtol is not None:
        res.update(upd)
    log(f"reference {name}: {len(batches)} passes, max |card - cpu| params "
        f"{d:.3e}, fire-bit flips at the threshold: {flips}"
        + ("" if update_rtol is None else
           f"; update: largest {upd['update_max']:.3e}, smallest leaf's "
           f"largest {upd['update_leaf_min']:.3e}, |card - cpu| at most "
           f"{upd['update_err_over_limit']:.3f} of its limit ({update_rtol:g}"
           f" x the leaf's largest + 2 ulps; the parameter atol is "
           f"{tol['atol']:g})"))
    return res


def phase_reference():
    """The train step on the card against the same step on the CPU, for
    a small ResNet and a small transformer; then stacked ring attention
    through the flash kernels against plain attention on the whole
    sequence."""
    import numpy as np
    import torch

    from eventgrad_tpu_torch.data.datasets import (
        synthetic_dataset, synthetic_lm_dataset,
    )
    from eventgrad_tpu_torch.models.resnet import ResNet
    from eventgrad_tpu_torch.models.transformer import TransformerLM
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.parallel.events import EventConfig
    from eventgrad_tpu_torch.parallel.policy import max_partition_elems
    from eventgrad_tpu_torch.parallel.ring_attention import (
        full_attention, ring_attention,
    )
    from eventgrad_tpu_torch.parallel.sparsify import SparseConfig
    from eventgrad_tpu_torch.parallel.topology import Ring, Torus

    log("== reference: card vs CPU, small ResNet, float64 compute")
    model = ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                   dtype=torch.float64)
    per_rank, passes = 4, 4
    cfg = EventConfig(adaptive=True, horizon=0.6, warmup_passes=2,
                      max_silence=3)
    x, y = synthetic_dataset(RANKS * per_rank * passes, (32, 32, 3), seed=4)
    x = x.reshape((passes, RANKS, per_rank, 32, 32, 3))
    y = y.reshape((passes, RANKS, per_rank)).astype(np.int64)
    batches = list(zip(x, y))
    tol = dict(rtol=1e-4, atol=1e-5)
    top10 = SparseConfig(10.0)
    spec = arena_spec(model)
    # compact: a third of the arena (the gate defers), and micro's floor
    compact = dict(gossip_wire="compact",
                   compact_capacity=max(spec.floor, spec.n_total // 3))
    for name, algo, kw in (
            ("eventgrad", "eventgrad", {}), ("dpsgd", "dpsgd", {}),
            ("eventgrad-int8-carrier", "eventgrad",
             dict(wire="int8", carrier_resident=True)),
            ("allreduce", "allreduce", {}),
            ("sp_eventgrad", "sp_eventgrad", dict(sparse_cfg=top10)),
            ("sp_eventgrad-int8", "sp_eventgrad",
             dict(sparse_cfg=top10, wire="int8")),
            ("eventgrad-compact", "eventgrad", compact),
            ("eventgrad-int8-carrier-compact", "eventgrad",
             dict(compact, wire="int8", carrier_resident=True)),
            ("micro-compact", "eventgrad",
             dict(trigger_policy="micro", gossip_wire="compact",
                  compact_capacity=max_partition_elems(spec, RANKS)))):
        _reference_steps(name, model, algo, kw, cfg, batches, tol)
    _reference_steps("eventgrad-torus2x4", model, "eventgrad", {}, cfg,
                     batches, tol, topo=Torus(2, 4))

    # float32 compute (the flash kernels take float32 and bfloat16); T = 96
    # leaves a ragged second tile. The same tolerance holds: the net has
    # no ReLU for a rounding to flip
    log("== reference: card vs CPU, small transformer (flash), float32")
    seq, per_rank = 96, 2
    lm = TransformerLM(vocab=64, dim=64, n_heads=4, n_layers=2, max_len=seq,
                       attn="flash")
    x, y = synthetic_lm_dataset(RANKS * per_rank * passes, seq, 64, seed=4)
    x = x.reshape((passes, RANKS, per_rank, seq)).astype(np.int64)
    y = y.reshape((passes, RANKS, per_rank, seq)).astype(np.int64)
    for algo in ("eventgrad", "dpsgd"):
        _reference_steps(f"transformer-{algo}", lm, algo, {}, cfg,
                         list(zip(x, y)), tol)

    log("== reference: stacked ring attention (flash hops) vs full attention")
    n, b, t_local = 4, 2, 96
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    # head dimension 32, 128 (the DMAX = 128 kernels) and 256 (the wide
    # form)
    for h, d in ((4, 32), (2, 128), (2, 256)):
        qs, ks, vs = (torch.randn((n, b, t_local, h, d), generator=gen,
                                  device=DEVICE).requires_grad_()
                      for _ in range(3))
        w = torch.randn((b, n * t_local, h, d), generator=gen, device=DEVICE)
        whole = lambda z: z.permute(1, 0, 2, 3, 4).reshape(b, n * t_local,
                                                           h, d)
        for causal in (True, False):
            got = whole(ring_attention(qs, ks, vs, Ring(n), causal=causal,
                                       use_flash=True))
            want = full_attention(whole(qs), whole(ks), whole(vs),
                                  causal=causal)
            errs = [within(got, want, 2e-5, 2e-5, "ring attention: out")]
            errs += [within(a, c, 5e-5, 5e-4, "ring attention: grad")
                     for a, c in zip(
                         torch.autograd.grad(got, (qs, ks, vs), w),
                         torch.autograd.grad(want, (qs, ks, vs), w))]
            log(f"ring attention causal={causal}: {n} shards x T_local "
                f"{t_local}, H{h} D{d}, max_abs_err {max(errs):.3e}")


#: the main path's legs: (name, algo, train() options — "topk_percent"
#: becomes a SparseConfig —, kernels that must launch, receive-buffer
#: dtype of an EventGraD leg)
LEGS = (
    ("eventgrad", "eventgrad", {}, ("masked_wire", "fused_mix_commit"),
     "float32"),
    ("dpsgd", "dpsgd", {}, ("fused_mix_sgd",), None),
    ("eventgrad-int8-carrier", "eventgrad",
     dict(wire="int8", carrier_resident=True),
     ("masked_wire_int8", "fused_mix_commit_carrier"), "int8"),
    ("dpsgd-int8", "dpsgd", dict(wire="int8"), ("fused_mix_sgd",), None),
    ("eventgrad-bf16-carrier", "eventgrad",
     dict(wire="bf16", carrier_resident=True),
     ("masked_wire", "fused_mix_commit_carrier"), "bfloat16"),
    ("sp_eventgrad", "sp_eventgrad", dict(topk_percent=10.0),
     ("fused_mix_sgd",), None),
    ("allreduce", "allreduce", {}, ("fused_mix_sgd",), None),
    ("eventgrad-compact", "eventgrad",
     dict(gossip_wire="compact", compact_frac=0.375),
     ("masked_wire", "fused_mix_commit"), "float32"),
    ("eventgrad-int8-carrier-compact", "eventgrad",
     dict(wire="int8", carrier_resident=True, gossip_wire="compact",
          compact_frac=0.375),
     ("masked_wire_int8", "fused_mix_commit_carrier"), "int8"),
)

#: the compact legs' masked twins
COMPACT_TWINS = {"eventgrad-compact": "eventgrad",
                 "eventgrad-int8-carrier-compact": "eventgrad-int8-carrier"}
#: exact wire-real bytes per step per chip of the compact legs: two
#: neighbors x (capacity lanes + 86 fire bits (+ 86 int8 scales)), at
#: capacity ceil(0.375 x 17,444,682) = 6,541,756
COMPACT_WIRE_REAL = {"eventgrad-compact": 52_334_220,
                     "eventgrad-int8-carrier-compact": 13_084_372}

#: exact int8 byte counts per step per chip at the flagship: two
#: neighbors x (17,444,682 one-byte lanes + 86 f32 scales), plus on the
#: event wire the 86 one-byte fire bits
DPSGD_INT8_SENT = 2 * (FLAGSHIP_PARAMS + 4 * 86)
EVENTGRAD_INT8_WIRE_REAL = 2 * (FLAGSHIP_PARAMS + 86 + 4 * 86)


def phase_main_path():
    """The flagship legs through the public entry point. Returns the
    launches of each kernel summed over the legs."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel.arena import arena_spec

    log("== main path: ResNet-18 (bf16 compute) x Ring(8), global batch 256")
    spec = arena_spec(egt.ResNet18())
    top10 = egt.SparseConfig(10.0)
    k_total = sum(top10.ks(spec))
    # exact per step per chip, from the leaf sizes: the top-k lanes (f32
    # value + int32 index) and one fire byte per leaf to two neighbors;
    # allreduce's full-precision gradients
    exact = {
        "sp_eventgrad": ("sent_bytes_wire_real_per_step_per_chip",
                         NB * (8 * k_total + spec.n_leaves)),
        "allreduce": ("sent_bytes_per_step_per_chip", 4 * spec.n_total),
    }
    log(f"ResNet-18: {spec.n_total} parameters in {spec.n_leaves} leaves, "
        f"sum of top-10% k {k_total}; exact bytes {exact}")
    per_rank, steps, epochs = 32, 3, 2
    x, y = synthetic_dataset(RANKS * per_rank * steps, (32, 32, 3), seed=0)
    xt, yt = synthetic_dataset(512, (32, 32, 3), seed=0, split="test")
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    totals, test_acc, recs = {}, {}, {}
    for leg, algo, wire_kw, must_launch, buf_dtype in LEGS:
        if "topk_percent" in wire_kw:
            wire_kw = {"sparse_cfg": egt.SparseConfig(wire_kw["topk_percent"])}
        model = egt.ResNet18(dtype=torch.bfloat16)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = egt.train(
            model, egt.Ring(RANKS), x, y, algo=algo, epochs=epochs,
            batch_size=per_rank, learning_rate=0.01, momentum=0.9,
            event_cfg=cfg, random_sampler=True, seed=0, x_test=xt,
            y_test=yt, device=DEVICE, **wire_kw,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        missing = [k for k in must_launch if counts[k] == 0]
        if missing:
            raise SmokeError(f"{leg}: kernels never launched: {missing}")
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(v) for v in losses):
            raise SmokeError(f"{leg}: loss not finite: {losses}")
        if not bool(torch.isfinite(state.params).all()):
            raise SmokeError(f"{leg}: parameters not finite")
        if tuple(state.params.shape) != (RANKS, FLAGSHIP_PARAMS):
            raise SmokeError(f"{leg}: arena shape {tuple(state.params.shape)}")
        last = hist[-1]
        rec = {
            "leg": leg, "passes": state.pass_num,
            "wire": last["wire"], "resident_dtype": last["resident_dtype"],
            "loss": losses, "train_acc": last["train_acc"],
            "test_accuracy": last["test_accuracy"],
            # the last epoch: no first-call set-up inside it
            "step_ms": 1e3 * last["wall_s"] / last["steps"],
            "first_epoch_step_ms": 1e3 * hist[0]["wall_s"] / hist[0]["steps"],
            "leg_wall_s": wall,
            "sent_bytes_per_step_per_chip": last["sent_bytes_per_step_per_chip"],
            "sent_bytes_wire_real_per_step_per_chip":
                last["sent_bytes_wire_real_per_step_per_chip"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts,
        }
        if algo in ("eventgrad", "sp_eventgrad"):
            rec["msgs_saved_pct"] = last["msgs_saved_pct"]
            if not 0.0 <= last["msgs_saved_pct"] < 100.0:
                raise SmokeError(f"msgs_saved_pct {last['msgs_saved_pct']}")
        if algo == "eventgrad":
            dts = {str(b.dtype).removeprefix("torch.")
                   for b in state.event.bufs}
            if dts != {buf_dtype}:
                raise SmokeError(f"{leg}: receive buffers are {dts}, "
                                 f"expected {buf_dtype}")
        if leg == "dpsgd-int8" and any(
                r[k] != DPSGD_INT8_SENT for r in hist
                for k in ("sent_bytes_per_step_per_chip",
                          "sent_bytes_wire_real_per_step_per_chip")):
            raise SmokeError(f"{leg}: sent bytes {rec} != {DPSGD_INT8_SENT}")
        if leg == "eventgrad-int8-carrier" and any(
                r["sent_bytes_wire_real_per_step_per_chip"]
                != EVENTGRAD_INT8_WIRE_REAL for r in hist):
            raise SmokeError(f"{leg}: wire-real bytes != "
                             f"{EVENTGRAD_INT8_WIRE_REAL}")
        if leg in exact:
            key, want = exact[leg]
            if any(r[key] != want for r in hist):
                raise SmokeError(f"{leg}: {key} {[r[key] for r in hist]} "
                                 f"!= {want}")
        if leg == "allreduce" and not bool(
                (state.params == state.params[:1]).all()):
            raise SmokeError("allreduce: the ranks' parameters differ")
        if leg in COMPACT_WIRE_REAL:
            _check_compact_leg(leg, hist, spec)
            rec["compact_capacity"] = last["compact_capacity"]
        test_acc[leg] = last["test_accuracy"]
        recs[leg] = rec
        log(json.dumps(rec))
        del state, model
        torch.cuda.empty_cache()
    log(json.dumps({"test_accuracy_gap_vs_dpsgd": {
        "f32": test_acc["eventgrad"] - test_acc["dpsgd"],
        "int8": test_acc["eventgrad-int8-carrier"] - test_acc["dpsgd-int8"],
    }}))
    log(json.dumps({"compact_vs_masked": {
        leg: {k: [recs[leg][k], recs[twin][k]]
              for k in ("step_ms", "peak_mem_gib",
                        "sent_bytes_wire_real_per_step_per_chip",
                        "msgs_saved_pct", "test_accuracy")}
        for leg, twin in COMPACT_TWINS.items()}}))
    return totals


def _check_compact_leg(leg, hist, spec):
    """A compact leg: dense through the first epoch, then the compact
    wire at ceil(0.375 n) lanes, its wire-real bytes exact."""
    last = hist[-1]
    cap = last.get("compact_capacity")
    if [r["gossip_wire"] for r in hist] != ["dense", "compact"]:
        raise SmokeError(f"{leg}: wire modes "
                         f"{[r['gossip_wire'] for r in hist]}")
    if cap != min(spec.n_total, max(spec.floor,
                                    math.ceil(0.375 * spec.n_total))):
        raise SmokeError(f"{leg}: compact capacity {cap}")
    int8 = last["wire"] == "int8"
    want = NB * ((1 if int8 else 4) * cap + spec.n_leaves
                 + (4 * spec.n_leaves if int8 else 0))
    got = last["sent_bytes_wire_real_per_step_per_chip"]
    if not got == want == COMPACT_WIRE_REAL[leg]:
        raise SmokeError(f"{leg}: wire-real bytes {got}, derived {want}, "
                         f"stated {COMPACT_WIRE_REAL[leg]}")


#: the transformer legs: (name, algo, gossip kernels that must launch)
LM_LEGS = (
    ("eventgrad", "eventgrad", ("masked_wire", "fused_mix_commit")),
    ("dpsgd", "dpsgd", ("fused_mix_sgd",)),
)


def _dense_legs(prefix, make_model, data, per_rank, n_params, n_leaves,
                flash_layers=0, flash_form=None):
    """One leg per entry of LM_LEGS through the public entry point, on
    the dense masked f32 wire at the flagship's optimizer and trigger: 3
    steps x 2 epochs of `make_model()` on `data` = (x, y, x_test,
    y_test), `per_rank` samples a rank. Each leg's counters are zeroed
    just before it and read just after; it fails unless its gossip
    kernels launched, the passes ran, loss and parameters are finite,
    the arena is `[8, n_params]` and the bytes are exact
    (`_check_dense_bytes`). With `flash_layers`, each flash kernel must
    launch once per layer per step (the forward also once per layer per
    test pass), and with `flash_form` every forward, dQ and dK/dV launch
    must have taken that form (`ops/flash_plan.py`). Returns the
    launches of each kernel summed over the legs."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops

    steps, epochs = 3, 2
    x, y, xt, yt = data
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    totals = {}
    for leg, algo, must_launch in LM_LEGS:
        leg = f"{prefix}-{leg}"
        model = make_model()
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
        missing = [k for k in must_launch if counts[k] == 0]
        if missing:
            raise SmokeError(f"{leg}: kernels never launched: {missing}")
        passes = state.pass_num
        if passes != steps * epochs:
            raise SmokeError(f"{leg}: {passes} passes")
        if flash_layers:
            # per step one launch per layer of each flash kernel (the
            # ranks fold into the batch); each epoch's test pass adds one
            # forward per layer
            want = {"flash_fwd": flash_layers * (passes + epochs),
                    "flash_dq": flash_layers * passes,
                    "flash_dkv": flash_layers * passes}
            if any(counts[k] != n for k, n in want.items()):
                raise SmokeError(f"{leg}: flash launches {counts}, "
                                 f"expected {want}")
        forms = None
        if flash_form:
            from eventgrad_tpu_torch.ops import attention as fa

            forms = fa.form_counts()
            for k in ("flash_fwd", "flash_dq", "flash_dkv"):
                if forms[k][flash_form] != counts[k] or counts[k] == 0:
                    raise SmokeError(f"{leg}: {k} launches by form "
                                     f"{forms[k]}, expected all "
                                     f"{counts[k]} in {flash_form}")
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(v) for v in losses):
            raise SmokeError(f"{leg}: loss not finite: {losses}")
        if not bool(torch.isfinite(state.params).all()):
            raise SmokeError(f"{leg}: parameters not finite")
        if (tuple(state.params.shape) != (RANKS, n_params)
                or hist[-1]["n_params"] != n_params):
            raise SmokeError(f"{leg}: arena shape {tuple(state.params.shape)}")
        last = hist[-1]
        rec = {
            "leg": leg, "passes": passes, "loss": losses,
            "train_acc": last["train_acc"],
            "test_accuracy": last["test_accuracy"],
            "test_loss": last.get("test_loss"),
            # the last epoch: no first-call set-up inside it
            "step_ms": 1e3 * last["wall_s"] / last["steps"],
            "first_epoch_step_ms": 1e3 * hist[0]["wall_s"] / hist[0]["steps"],
            "leg_wall_s": wall,
            "sent_bytes_per_step_per_chip": last["sent_bytes_per_step_per_chip"],
            "sent_bytes_wire_real_per_step_per_chip":
                last["sent_bytes_wire_real_per_step_per_chip"],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            "launches": counts,
        }
        if forms:
            rec["flash_forms"] = forms
        _check_dense_bytes(leg, algo, hist, n_params, n_leaves, rec)
        log(json.dumps(rec))
        del state, model
        torch.cuda.empty_cache()
    return totals


def _lm_legs(prefix, lm, n_params, n_leaves):
    """The transformer LM `lm` through the public entry point, flash
    attention on, 4 sequences of 1024 tokens a rank (`_dense_legs`)."""
    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset
    from eventgrad_tpu_torch.parallel.arena import arena_spec

    seq = lm["max_len"]
    log(f"== main path: TransformerLM dim {lm['dim']} x {lm['n_heads']} heads "
        f"of {lm['dim'] // lm['n_heads']} x {lm['n_layers']} layers, T={seq}, "
        f"flash attention (f32) x Ring(8), {LM_PER_RANK} sequences per rank")
    x, y = synthetic_lm_dataset(RANKS * LM_PER_RANK * 3, seq, lm["vocab"],
                                seed=0)
    xt, yt = synthetic_lm_dataset(32, seq, lm["vocab"], seed=0, split="test")
    spec = arena_spec(egt.TransformerLM(attn="flash", **lm))
    if (spec.n_total, spec.n_leaves) != (n_params, n_leaves):
        raise SmokeError(f"TransformerLM has {spec.n_total} parameters in "
                         f"{spec.n_leaves} leaves, expected {n_params} in "
                         f"{n_leaves}")
    from eventgrad_tpu_torch.ops import flash_plan

    # the legs run float32: the form is the rule's at the head width
    form = flash_plan.flash_form("float32", lm["dim"] // lm["n_heads"], (), ())
    return _dense_legs(prefix, lambda: egt.TransformerLM(attn="flash", **lm),
                       (x, y, xt, yt), LM_PER_RANK, n_params, n_leaves,
                       flash_layers=lm["n_layers"], flash_form=form)


def _check_dense_bytes(leg, algo, hist, n_params, n_leaves, rec):
    """Bytes per step per chip of a leg on the dense masked f32 wire, as
    the step reckons them in float32: D-PSGD's sent and wire-real bytes
    both the f32 payload to two neighbors, 2 x 4 B x n_params; EventGraD's
    wire-real that plus the fire byte of each leaf, float32(2) x
    float32(4 n_params + n_leaves), and its fired payload at most that.
    Sets rec["msgs_saved_pct"] on an EventGraD leg."""
    import numpy as np

    dense = NB * 4 * n_params
    event_wire = float(np.float32(NB) * np.float32(4 * n_params + n_leaves))
    sent = [r["sent_bytes_per_step_per_chip"] for r in hist]
    real = [r["sent_bytes_wire_real_per_step_per_chip"] for r in hist]
    if algo == "eventgrad":
        last = hist[-1]
        rec["msgs_saved_pct"] = last["msgs_saved_pct"]
        if not 0.0 <= last["msgs_saved_pct"] < 100.0:
            raise SmokeError(f"msgs_saved_pct {last['msgs_saved_pct']}")
        # the dense wire moves every lane; the fired payloads are a part
        # of it
        if any(r != event_wire for r in real) or any(
                a > b for a, b in zip(sent, real)):
            raise SmokeError(f"{leg}: sent {sent}, wire-real {real}, "
                             f"expected wire-real {event_wire}")
    elif any(a != dense or b != dense for a, b in zip(sent, real)):
        raise SmokeError(f"{leg}: sent {sent}, wire-real {real}, "
                         f"expected both {dense}")


def phase_main_path_lm():
    """The transformer LM legs at 8 heads of 64. Returns the launches of
    each kernel summed over the legs."""
    return _lm_legs("transformer", LM, LM_PARAMS, LM_LEAVES)


def phase_main_path_lm_d128():
    """The transformer LM legs at 16 heads of 128 (the DMAX = 128 flash
    kernels). Returns the launches of each kernel summed over the legs,
    the flash kernels' under names ending in "_d128"."""
    totals = _lm_legs("transformer-d128", LM_D128, LM_D128_PARAMS,
                      LM_D128_LEAVES)
    return {k + ("_d128" if k.startswith("flash_") else ""): v
            for k, v in totals.items()}


def phase_main_path_lm_d256():
    """The transformer LM legs at 8 heads of 256 (the flash kernels' wide
    form; the d128 legs' parameters). Returns the launches of each kernel
    summed over the legs, the flash kernels' under names ending in
    "_d256"."""
    totals = _lm_legs("transformer-d256", LM_D256, LM_D128_PARAMS,
                      LM_D128_LEAVES)
    return {k + ("_d256" if k.startswith("flash_") else ""): v
            for k, v in totals.items()}


#: ResNet-50 as the reference instantiates it (3/4/6/3 Bottleneck stages,
#: each with the extra block) at 32 x 32 inputs and 10 classes
RESNET50_PARAMS, RESNET50_LEAVES = 29_451_082, 197
#: ... its bytes per step per chip on the dense masked f32 wire
#: (`_check_dense_bytes`): D-PSGD 2 x 4 B x 29,451,082 = 235,608,656 sent
#: and wire-real; EventGraD wire-real float32(2) x float32(4 x 29,451,082
#: + 197) = 235,609,056 (the exact 235,609,050 as float32 keeps it)
RESNET50_DPSGD_BYTES, RESNET50_EVENT_WIRE = 235_608_656, 235_609_056


def phase_main_path_resnet50():
    """ResNet-50 (Bottleneck blocks, bf16 compute) on the flagship
    op-point through the public entry point: Ring(8), global batch 256,
    SGD lr 0.01 momentum 0.9, the adaptive trigger at horizon 1.05, the
    dense masked f32 wire; EventGraD and D-PSGD, 3 steps x 2 epochs each
    like the ResNet-18 legs. Returns the launches of each kernel summed
    over the legs."""
    import numpy as np
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel.arena import arena_spec

    log("== main path: ResNet-50 (bf16 compute) x Ring(8), global batch 256")
    spec = arena_spec(egt.MODEL_REGISTRY["resnet50"]())
    if (spec.n_total, spec.n_leaves) != (RESNET50_PARAMS, RESNET50_LEAVES):
        raise SmokeError(f"ResNet-50 has {spec.n_total} parameters in "
                         f"{spec.n_leaves} leaves")
    if (NB * 4 * spec.n_total != RESNET50_DPSGD_BYTES
            or float(np.float32(NB) * np.float32(4 * spec.n_total
                                                 + spec.n_leaves))
            != RESNET50_EVENT_WIRE):
        raise SmokeError("ResNet-50's byte formula disagrees with the "
                         "stated numbers")
    x, y = synthetic_dataset(RANKS * 32 * 3, (32, 32, 3), seed=0)
    xt, yt = synthetic_dataset(512, (32, 32, 3), seed=0, split="test")
    return _dense_legs(
        "resnet50",
        lambda: egt.MODEL_REGISTRY["resnet50"](dtype=torch.bfloat16),
        (x, y, xt, yt), 32, RESNET50_PARAMS, RESNET50_LEAVES)


#: the real-data band, stated before the first card run: each leg's test
#: accuracy at least the reference leg's less ACC_BAND points, an event
#: leg's msgs-saved-% within MSGS_BAND points of the reference leg's
ACC_BAND, MSGS_BAND = 4.0, 6.0

#: real-data leg -> (artifact, section, reference leg tag, kernels that
#: must launch)
REALDATA = {
    "digits-eventgrad": ("realdata_digits_r3_cpu.json", None, "refpure",
                         ("masked_wire", "fused_mix_commit")),
    "digits-dpsgd": ("realdata_digits_r3_cpu.json", None, "dpsgd",
                     ("fused_mix_sgd",)),
    "digits32-sp_eventgrad": ("realdata_cifar_r4_cpu.json", "lenetcifar",
                              "spevent", ("fused_mix_sgd",)),
    "digits32-dpsgd": ("realdata_cifar_r4_cpu.json", "lenetcifar", "dpsgd",
                       ("fused_mix_sgd",)),
}


def phase_realdata():
    """The real-data legs (seed 0) against the JAX package's committed
    runs of the same operating points, within the band. Returns the
    launches of each kernel summed over the legs."""
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.utils import realdata

    log("== real data: CNN2 on digits, LeNetCifar on digits32, Ring(8), "
        "540 passes per leg")
    totals, failures = {}, []
    for leg, (artifact, section, tag, must_launch) in REALDATA.items():
        ref = json.loads((HERE / "artifacts" / artifact).read_text())
        ref = ref[section] if section else ref
        want_acc = ref[f"test_acc_{tag}"]
        want_msgs = ref.get(f"msgs_saved_pct_{tag}")
        ops.reset_launch_counts()
        rec = realdata.run_leg(leg, seed=0, device=DEVICE)
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        rec.update(reference_test_accuracy=want_acc,
                   reference_msgs_saved_pct=want_msgs,
                   launches={k: v for k, v in counts.items() if v})
        log(json.dumps(rec))
        if not rec["losses_finite"]:
            failures.append(f"{leg}: a loss is not finite")
        missing = [k for k in must_launch if counts[k] == 0]
        if missing:
            failures.append(f"{leg}: kernels never launched: {missing}")
        if not rec["test_accuracy"] >= want_acc - ACC_BAND:
            failures.append(f"{leg}: test accuracy {rec['test_accuracy']:.2f} "
                            f"< {want_acc} - {ACC_BAND}")
        if want_msgs is not None and not (
                abs(rec["msgs_saved_pct"] - want_msgs) <= MSGS_BAND):
            failures.append(f"{leg}: msgs_saved_pct "
                            f"{rec['msgs_saved_pct']:.2f} not within "
                            f"{MSGS_BAND} of {want_msgs}")
    if failures:
        raise SmokeError("real data outside the band: " + "; ".join(failures))
    return totals


#: frontier policy -> exact bytes per step per chip on the f32 and int8
#: wires (two neighbors; 10 leaves, capacity 48,000): 4 B or 1 B a lane
#: plus the fire bits (plus the int8 scales); topk's lanes carry an int32
#: index each
FRONTIER_BYTES = {
    "norm_delta": (384_020, 96_100), "micro": (384_020, 96_100),
    "hybrid": (384_020, 96_100), "topk": (768_100, 480_150),
}
#: micro's sends depend only on position: exact over 448 passes
MICRO_MSGS_SAVED, MICRO_FIRED_FRAC = 86.71875, 0.125


def phase_frontier():
    """The JAX package's frontier op-point through the port: four
    policies x the f32 and int8 wires, held to the committed reference
    run. Returns the launches of each kernel summed over the legs."""
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.utils import frontier

    log("== frontier: LeNetCifar x Ring(8), 14 epochs, four policies at "
        f"capacity {frontier.capacity()}, f32 and int8 wires")
    ref = json.loads((HERE / "artifacts" / "frontier_cpu.json").read_text())
    if frontier.capacity() != ref["capacity"]:
        raise SmokeError(f"frontier capacity {frontier.capacity()} != "
                         f"{ref['capacity']}")
    ref_legs = {(l["policy"], l["wire"]): l for l in ref["legs"]}
    totals, failures = {}, []
    for pol in frontier.POLICIES:
        for i, wire_name in enumerate(("f32", "int8")):
            # the event legs' first epoch runs the masked wire
            must_launch = (("fused_mix_sgd",) if pol == "topk" else (
                "fused_mix_commit",
                "masked_wire_int8" if i else "masked_wire"))
            want = ref_legs[(pol, wire_name)]
            ops.reset_launch_counts()
            rec = frontier.run_leg(pol, wire_name, device=DEVICE)
            counts = ops.launch_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            rec.update(reference_test_accuracy=want["test_accuracy"],
                       reference_msgs_saved_pct=want["msgs_saved_pct"],
                       launches={k: v for k, v in counts.items() if v})
            log(json.dumps(rec))
            leg = f"{pol}/{wire_name}"
            if not rec["losses_finite"]:
                failures.append(f"{leg}: a loss is not finite")
            missing = [k for k in must_launch if counts[k] == 0]
            if missing:
                failures.append(f"{leg}: kernels never launched: {missing}")
            got_b = rec["bytes_per_step_per_chip"]
            if not got_b == FRONTIER_BYTES[pol][i] == want[
                    "bytes_per_step_per_chip"]:
                failures.append(f"{leg}: bytes {got_b}, stated "
                                f"{FRONTIER_BYTES[pol][i]}, reference "
                                f"{want['bytes_per_step_per_chip']}")
            if rec["gossip_wire"] != "compact":
                failures.append(f"{leg}: ended on the {rec['gossip_wire']} "
                                "wire")
            if pol == "micro":
                if (rec["msgs_saved_pct"] != MICRO_MSGS_SAVED
                        or rec["fired_frac"] != MICRO_FIRED_FRAC):
                    failures.append(
                        f"{leg}: msgs_saved_pct {rec['msgs_saved_pct']} and "
                        f"fired_frac {rec['fired_frac']} are not exactly "
                        f"{MICRO_MSGS_SAVED} and {MICRO_FIRED_FRAC}")
            elif not abs(rec["msgs_saved_pct"]
                         - want["msgs_saved_pct"]) <= MSGS_BAND:
                failures.append(f"{leg}: msgs_saved_pct "
                                f"{rec['msgs_saved_pct']:.3f} not within "
                                f"{MSGS_BAND} of {want['msgs_saved_pct']}")
            if not rec["test_accuracy"] >= want["test_accuracy"] - ACC_BAND:
                failures.append(f"{leg}: test accuracy "
                                f"{rec['test_accuracy']:.2f} < "
                                f"{want['test_accuracy']} - {ACC_BAND}")
    if failures:
        raise SmokeError("frontier outside the reference: "
                         + "; ".join(failures))
    return totals


#: the composed leg (c): K = 4, compact int8 carrier at compact_frac
#: 0.375, D = 4, rank 1 a straggler 7 passes late. At K = 4 the bucketed
#: floor (the four buckets' largest leaves, 7,667,712) is above
#: ceil(0.375 n) = 6,541,756, and train() raises the capacity to it as
#: the JAX loop does: wire-real 2 x (7,667,712 + 86 + 4 x 86)
COMPOSED_CAPACITY = 7_667_712
COMPOSED_WIRE_REAL = 2 * (COMPOSED_CAPACITY + 86 + 4 * 86)
#: wire-real of the masked f32 / int8 legs and sparsified EventGraD at
#: top-k 10%, per step per chip
MASKED_F32_WIRE_REAL = 139_557_632
SP_TOP10_WIRE_REAL = 27_912_332


def _same_bits(a, b, what):
    import torch

    if a is None and b is None:
        return
    if isinstance(a, (tuple, list)):
        if len(a) != len(b):
            raise SmokeError(f"{what}: structure differs")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{what}[{i}]")
        return
    width = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
            a.view(width.get(a.dtype, a.dtype)),
            b.view(width.get(b.dtype, b.dtype))):
        raise SmokeError(f"{what}: not bitwise equal")


def _flat_bufs(bufs):
    import torch

    return tuple(torch.cat(b, dim=-1) if isinstance(b, tuple) else b
                 for b in bufs)


def _same_state(a, b, what, bufs=True):
    """Parameters, momentum trace, trigger state (and receive buffers and
    scales, in either layout) bitwise."""
    _same_bits(a.params, b.params, f"{what} params")
    _same_bits(a.trace, b.trace, f"{what} trace")
    for f in ("thres", "last_sent_norm", "last_sent_iter", "slopes",
              "num_events", "num_deferred"):
        _same_bits(getattr(a.event, f), getattr(b.event, f), f"{what} {f}")
    if bufs and a.event.bufs:
        _same_bits(_flat_bufs(a.event.bufs), _flat_bufs(b.event.bufs),
                   f"{what} bufs")
        if a.event.buf_scales is not None:
            _same_bits(_flat_bufs(a.event.buf_scales),
                       _flat_bufs(b.event.buf_scales), f"{what} scales")


#: the riders of a block's last epoch, which a K-epoch block's other
#: epochs lack
BLOCK_END_RIDERS = ("test_accuracy", "test_loss", "consensus_err_max",
                    "consensus_err_mean")


def _same_records(ha, hb, what, keys=("loss", "train_acc", "msgs_saved_pct",
                                      "sent_bytes_per_step_per_chip",
                                      "sent_bytes_wire_real_per_step_per_chip",
                                      "num_events", "num_deferred"),
                  skip=()):
    """The records equal, epoch by epoch, on `keys`, or with `keys=None`
    on every key of either record but `skip` (a block-end rider may be
    missing from `hb`'s). A NaN (a nanstep's loss) equals a NaN."""
    for ra, rb in zip(ha, hb):
        names = keys
        if keys is None:
            names = sorted((set(ra) | set(rb)) - set(skip)
                           - (set(BLOCK_END_RIDERS) - set(rb)))
        for k in names:
            a, b = ra.get(k), rb.get(k)
            if a != b and not (a != a and b != b):
                raise SmokeError(f"{what}: epoch {ra.get('epoch')} record "
                                 f"{k} {a} != {b}")


def phase_bucketed_async():
    """The bucketed schedule and bounded-async EventGraD on the flagship:
    bitwise legs under deterministic algorithms, the composed stack under
    a straggler, sparsified EventGraD's payload queue, and the straggler
    op-point's accuracy legs. Returns the launches of each kernel."""
    import os

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.chaos import inject
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel import collectives
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.utils import straggler

    log(f"== bucketed + bounded-async: ResNet-18 (bf16 compute) x Ring(8), "
        f"global batch 256, K = {BUCKETS}")
    spec = arena_spec(egt.ResNet18())
    buckets = spec.buckets(BUCKETS)
    floor = collectives.bucketed_capacity_floor(buckets)
    cap = min(spec.n_total, max(spec.floor, floor,
                                math.ceil(0.375 * spec.n_total)))
    if cap != COMPOSED_CAPACITY or floor != COMPOSED_CAPACITY:
        raise SmokeError(f"bucketed floor {floor}, capacity {cap}")
    per_rank, steps, epochs = 32, 3, 2
    passes = steps * epochs
    x, y = synthetic_dataset(RANKS * per_rank * steps, (32, 32, 3), seed=0)
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    totals, recs = {}, {}

    def run(leg, algo="eventgrad", must=None, **kw):
        if "topk_percent" in kw:
            kw["sparse_cfg"] = egt.SparseConfig(kw.pop("topk_percent"))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, hist = egt.train(
            egt.ResNet18(dtype=torch.bfloat16), egt.Ring(RANKS), x, y,
            algo=algo, epochs=epochs, batch_size=per_rank,
            learning_rate=0.01, momentum=0.9, event_cfg=cfg,
            random_sampler=True, seed=0, device=DEVICE, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for k, n in (must or {}).items():
            if counts[k] != n:
                raise SmokeError(f"{leg}: {k} launched {counts[k]} times, "
                                 f"expected {n}")
        if not all(math.isfinite(r["loss"]) for r in hist):
            raise SmokeError(f"{leg}: a loss is not finite")
        last = hist[-1]
        rec = {"leg": leg, "step_ms": 1e3 * last["wall_s"] / last["steps"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "wire_real": [r["sent_bytes_wire_real_per_step_per_chip"]
                             for r in hist],
               "launches_per_step": {k: v / passes for k, v in counts.items()
                                     if v},
               **{k: last[k] for k in ("loss", "msgs_saved_pct",
                                       "edge_staleness_max", "late_commits",
                                       "compact_capacity", "buckets")
                  if k in last}}
        recs[leg] = rec
        log(json.dumps(rec))
        return state, hist

    def wire_real(leg, hist, want):
        got = [r["sent_bytes_wire_real_per_step_per_chip"] for r in hist]
        if got != list(want):
            raise SmokeError(f"{leg}: wire-real {got} != {list(want)}")

    # bitwise legs: deterministic convolutions and reductions for the
    # phase (CUBLAS_WORKSPACE_CONFIG is set before CUDA is first used)
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        raise SmokeError("CUBLAS_WORKSPACE_CONFIG unset: the bitwise legs "
                         "need deterministic cuBLAS")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        k4 = {"bucketed": BUCKETS}
        # (a) the bucketed schedule is the monolithic one, bitwise; its
        # kernels launch once per bucket, on the bucket's columns
        for wire, kw, wr, wk, ck in (
                ("f32", {}, MASKED_F32_WIRE_REAL, "masked_wire",
                 "fused_mix_commit"),
                ("int8-carrier", dict(wire="int8", carrier_resident=True),
                 EVENTGRAD_INT8_WIRE_REAL, "masked_wire_int8",
                 "fused_mix_commit_carrier")):
            s_m, h_m = run(f"eventgrad-{wire}", must={wk: passes,
                                                      ck: passes}, **kw)
            s_b, h_b = run(f"eventgrad-{wire}-k4",
                           must={wk: BUCKETS * passes,
                                 ck: BUCKETS * passes}, **kw, **k4)
            _same_state(s_m, s_b, f"(a) {wire} K=4 vs monolithic")
            _same_records(h_m, h_b, f"(a) {wire}")
            wire_real(f"(a) {wire}", h_m, [wr] * epochs)
            wire_real(f"(a) {wire} K=4", h_b, [wr] * epochs)
            del s_m, s_b
            # (b) D = 2 at the baseline lag is staleness 1, bitwise
            s_1, h_1 = run(f"eventgrad-{wire}-d1", staleness=1, **kw)
            s_2, h_2 = run(f"eventgrad-{wire}-d2", staleness=2, **kw)
            _same_state(s_1, s_2, f"(b) {wire} D=2 vs staleness 1",
                        bufs=False)
            _same_records(h_1, h_2, f"(b) {wire}")
            if h_2[-1]["late_commits"] != 0 or h_2[-1][
                    "edge_staleness_max"] != 1:
                raise SmokeError(f"(b) {wire}: late commits or staleness "
                                 f"at the baseline lag: {recs}")
            del s_1, s_2
            torch.cuda.empty_cache()
        # (c) the composed stack under the straggler, twice
        composed = dict(bucketed=BUCKETS, gossip_wire="compact",
                        compact_frac=0.375, wire="int8",
                        carrier_resident=True, staleness=4,
                        chaos="seed=5,slow=1@7")
        s_c, h_c = run("composed-d4", must={
            "masked_wire_int8": BUCKETS * steps,
            "fused_mix_commit_carrier": BUCKETS * passes}, **composed)
        s_r, h_r = run("composed-d4-replay", **composed)
        _same_state(s_c, s_r, "(c) replay")
        _same_bits(s_c.event.pending, s_r.event.pending, "(c) replay queue")
        _same_records(h_c, h_r, "(c) replay", keys=(
            "loss", "msgs_saved_pct", "edge_staleness_max", "late_commits"))
        wire_real("(c)", h_c, [EVENTGRAD_INT8_WIRE_REAL, COMPOSED_WIRE_REAL])
        if h_c[-1]["compact_capacity"] != COMPOSED_CAPACITY:
            raise SmokeError(f"(c) capacity {h_c[-1]['compact_capacity']}")
        stale = s_c.pass_num - s_c.event.edge_clock.cpu()
        srcs = inject.rank_and_sources(egt.Ring(RANKS))[1]
        if int(stale.max()) != 4 or not torch.equal(stale == 4, srcs == 1):
            raise SmokeError(f"(c) the gauge {stale.tolist()} is not 4 "
                             "exactly on the edges fed by rank 1")
        if not h_c[-1]["late_commits"] > 0:
            raise SmokeError("(c) no late commits")
        del s_c, s_r
        torch.cuda.empty_cache()
        # (d) sparsified EventGraD's payload queue, bucketed
        s_1, h_1 = run("sp-top10-k4-d1", "sp_eventgrad", topk_percent=10.0,
                       staleness=1, **k4)
        s_2, h_2 = run("sp-top10-k4-d2", "sp_eventgrad", topk_percent=10.0,
                       staleness=2, **k4)
        _same_bits(s_1.params, s_2.params, "(d) D=2 vs staleness 1 params")
        _same_records(h_1, h_2, "(d)")
        wire_real("(d)", h_2, [SP_TOP10_WIRE_REAL] * epochs)
        del s_1, s_2
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)

    # (e) the straggler op-point's accuracy legs (utils/straggler.py),
    # held to the JAX package's committed run of the same op-point
    ref = json.loads((HERE / "artifacts" /
                      "straggler_ablation_cpu.json").read_text())
    ref_legs = {leg["staleness"]: leg for leg in ref["legs"]}
    failures, acc = [], {}
    for bound in straggler.BOUNDS:
        ops.reset_launch_counts()
        rec = straggler.run_leg(bound, device=DEVICE)
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        want = ref_legs[bound]
        rec.update(reference_test_accuracy=want["test_accuracy"],
                   reference_msgs_saved_pct=want["msgs_saved_pct"],
                   launches={k: v for k, v in counts.items() if v})
        log(json.dumps(rec))
        acc[bound] = rec["test_accuracy"]
        leg = f"(e) D={bound}"
        if not rec["losses_finite"]:
            failures.append(f"{leg}: a loss is not finite")
        for k in ("masked_wire_int8", "fused_mix_commit_carrier"):
            if not counts[k]:
                failures.append(f"{leg}: {k} never launched")
        if bound >= 2 and (rec["edge_staleness_max"] != bound
                           or rec["late_commits"] != want["late_commits"]):
            failures.append(
                f"{leg}: gauge {rec['edge_staleness_max']}, late commits "
                f"{rec['late_commits']} != the reference's "
                f"{want['late_commits']}")
        if not abs(rec["msgs_saved_pct"]
                   - want["msgs_saved_pct"]) <= MSGS_BAND:
            failures.append(f"{leg}: msgs_saved_pct {rec['msgs_saved_pct']}"
                            f" not within {MSGS_BAND} of "
                            f"{want['msgs_saved_pct']}")
        if not rec["test_accuracy"] >= want["test_accuracy"] - ACC_BAND:
            failures.append(f"{leg}: test accuracy {rec['test_accuracy']} < "
                            f"{want['test_accuracy']} - {ACC_BAND}")
    for bound in straggler.BOUNDS:
        if bound >= 2 and not acc[bound] >= acc[1] - ACC_BAND:
            failures.append(f"(e) D={bound}: test accuracy {acc[bound]} < "
                            f"lockstep {acc[1]} - {ACC_BAND}")
    if failures:
        raise SmokeError("straggler legs: " + "; ".join(failures))
    log(json.dumps({"bucketed_async_vs_twins": {
        leg: {k: recs[leg][k] for k in ("step_ms", "peak_mem_gib",
                                        "launches_per_step")}
        for leg in recs}}))
    return totals


#: the chaos phase's flagship trigger: the JAX bench's 30 warmup passes,
#: so every edge sends on each of a leg's 6 passes and EventGraD's drop
#: count is the delivery table's
CHAOS_WARMUP = 30
#: a recovery policy whose bounds a 6-pass leg never reaches (both above
#: the trigger's max_silence of 50): its gates stay open
IDLE_POLICY = dict(sync_after=60, freeze_after=80)
#: the bucketed chaos legs' faults: iid drops, a flaky window and a death
#: (the f32 leg adds a nanstep, which a carrier refuses)
BUCKETED_FAULTS = "drop=0.2,seed=0,flaky=2-4@0.5,die=5@3"


def phase_chaos():
    """The chaos fault clauses and the integrity engine on the gossip
    path: the flagship legs under deterministic algorithms (drop 0 and an
    idle policy bitwise no chaos, through the gated kernels; exact drop
    and reject counts; the quarantined row the mixed one), then the
    chaos sweep and integrity legs held to the JAX package's artifacts.
    Returns the launches of each kernel."""
    import os

    import numpy as np
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.chaos import inject
    from eventgrad_tpu_torch.chaos.monitor import PeerHealth
    from eventgrad_tpu_torch.chaos.policy import RecoveryPolicy
    from eventgrad_tpu_torch.chaos.schedule import ChaosSchedule
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel import collectives
    from eventgrad_tpu_torch.train.steps import make_train_step
    from eventgrad_tpu_torch.utils import chaos_sweep, integrity_sweep

    log("== chaos + integrity: ResNet-18 (bf16 compute) x Ring(8), global "
        f"batch 256, warmup {CHAOS_WARMUP}")
    topo = egt.Ring(RANKS)
    per_rank, steps, epochs = 32, 3, 2
    passes = steps * epochs
    x, y = synthetic_dataset(RANKS * per_rank * steps, (32, 32, 3), seed=0)
    cfg = egt.EventConfig(adaptive=True, horizon=1.05,
                          warmup_passes=CHAOS_WARMUP, max_silence=50)
    idle = RecoveryPolicy(**IDLE_POLICY)
    totals, recs = {}, {}

    def run(leg, algo="eventgrad", must=None, **kw):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        state, hist = egt.train(
            egt.ResNet18(dtype=torch.bfloat16), topo, x, y, algo=algo,
            epochs=epochs, batch_size=per_rank, learning_rate=0.01,
            momentum=0.9, event_cfg=cfg if algo == "eventgrad" else None,
            random_sampler=True, seed=0, device=DEVICE, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for k, n in (must or {}).items():
            if counts[k] != n:
                raise SmokeError(f"{leg}: {k} launched {counts[k]} times, "
                                 f"expected {n}")
        last = hist[-1]
        rec = {"leg": leg, "step_ms": 1e3 * last["wall_s"] / last["steps"],
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
               "launches_per_step": {k: v / passes for k, v in counts.items()
                                     if v},
               **{k: last[k] for k in ("loss", "msgs_saved_pct",
                                       "chaos_drops", "wire_rejects",
                                       "quarantined_steps",
                                       "consensus_err_max") if k in last}}
        recs[leg] = rec
        log(json.dumps(rec))
        return state, hist

    def undelivered(spec):
        return int((~inject.delivery_table(ChaosSchedule.parse(spec), topo,
                                           passes)).sum())

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        raise SmokeError("CUBLAS_WORKSPACE_CONFIG unset: the bitwise legs "
                         "need deterministic cuBLAS")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        # (a) drop 0 with a policy that never trips is no chaos, bitwise:
        # the gated kernels run every pass with every gate open
        for algo, gk in (("eventgrad", "fused_mix_commit_gated"),
                         ("dpsgd", "fused_mix_sgd_gated")):
            kw = ({} if algo == "dpsgd" else {"chaos_policy": idle})
            s_n, h_n = run(f"{algo}-f32", algo)
            s_c, h_c = run(f"{algo}-f32-drop0", algo, must={gk: passes},
                           chaos=ChaosSchedule(), **kw)
            _same_bits(s_n.params, s_c.params, f"(a) {algo} params")
            _same_bits(s_n.trace, s_c.trace, f"(a) {algo} trace")
            if algo == "eventgrad":
                _same_state(s_n, s_c, f"(a) {algo}")
            _same_records(h_n, h_c, f"(a) {algo}")
            if h_c[-1]["chaos_drops"] != 0:
                raise SmokeError(f"(a) {algo}: drops at drop 0")
            del s_n, s_c
        # (b) D-PSGD under a death with the freeze: kernel 4's gated form
        # weighs the dead rank's neighbours 1/2; every undelivered edge
        # counts. EventGraD at drop 0.2: all 6 passes are warmup, so each
        # sender fired and the count is the table's
        spec = "seed=0,die=5@2"
        s_d, h_d = run("dpsgd-die5-freeze2", "dpsgd",
                       must={"fused_mix_sgd_gated": passes}, chaos=spec,
                       chaos_policy=RecoveryPolicy(freeze_after=2))
        deliver = torch.as_tensor(inject.delivery_table(
            ChaosSchedule.parse(spec), topo, passes)[-1], device=DEVICE)
        w_rows = collectives.mix_weights(deliver & (s_d.chaos.silence < 2))
        third = float(np.float32(1.0 / 3.0))
        want_w = [third] * RANKS
        want_w[4] = want_w[6] = 0.5
        want_w[5] = 1.0
        if w_rows.tolist() != want_w:
            raise SmokeError(f"(b) mix weights {w_rows.tolist()}")
        if h_d[-1]["chaos_drops"] != undelivered(spec):
            raise SmokeError(f"(b) D-PSGD drops {h_d[-1]['chaos_drops']} != "
                             f"{undelivered(spec)}")
        if not torch.isfinite(s_d.params).all():
            raise SmokeError("(b) D-PSGD parameters not finite")
        del s_d
        spec = "drop=0.2,seed=0"
        for leg, kw, gk in (
                ("eventgrad-f32-drop0.2", {}, "fused_mix_commit_gated"),
                ("eventgrad-int8-carrier-drop0.2",
                 dict(wire="int8", carrier_resident=True),
                 "fused_mix_commit_carrier_gated")):
            s_e, h_e = run(leg, must={gk: passes}, chaos=spec,
                           chaos_policy=idle, **kw)
            if h_e[-1]["chaos_drops"] != undelivered(spec):
                raise SmokeError(f"(b) {leg} drops {h_e[-1]['chaos_drops']} "
                                 f"!= the table's {undelivered(spec)}")
            del s_e
        # (c) the checksums and the quarantine under bitflips and a
        # nanstep: rejections are the corruption table, one quarantine
        spec = "seed=0,bitflip=1-7@0.3,nanstep=2@4"
        s_i, h_i = run("eventgrad-f32-integrity", chaos=spec,
                       integrity="on",
                       must={"fused_mix_commit_gated": passes})
        flips = int(inject.corruption_table(ChaosSchedule.parse(spec), topo,
                                            passes).sum())
        rejects = sum(r["wire_rejects"] for r in h_i)
        quar = sum(r["quarantined_steps"] for r in h_i)
        if rejects != flips or not flips or quar != 1:
            raise SmokeError(f"(c) rejects {rejects} (injected {flips}, "
                             f"silent {flips - rejects}), quarantined {quar}")
        if not torch.isfinite(s_i.params).all():
            raise SmokeError("(c) parameters not finite")
        log(json.dumps({"integrity_flagship": {
            "injected": flips, "rejected": rejects,
            "silent_acceptances": flips - rejects, "quarantined": quar}}))
        del s_i
        # the quarantined row is the mixed row: one step, rank 2 poisoned
        model = egt.ResNet18(dtype=torch.bfloat16, device=DEVICE)
        state = egt.init_train_state(model, (32, 32, 3), topo, "eventgrad",
                                     cfg, 0, momentum=0.9, device=DEVICE)
        state = state.replace(chaos=PeerHealth.init(topo, DEVICE))
        step = make_train_step(model, topo, "eventgrad", cfg,
                               fused_sgd=(0.01, 0.9), chaos="seed=0,"
                               "nanstep=2@1", integrity="on", n_passes=1)
        xb = torch.as_tensor(x[:RANKS * per_rank].reshape(
            RANKS, per_rank, 32, 32, 3), device=DEVICE)
        yb = torch.as_tensor(y[:RANKS * per_rank].reshape(
            RANKS, per_rank).astype(np.int64), device=DEVICE)
        new, m = step(state, (xb, yb))
        mixed = collectives.mix_weighted(
            state.params, new.event.bufs,
            torch.ones((RANKS, NB), dtype=torch.bool, device=DEVICE))
        _same_bits(new.params[2], mixed[2], "(c) quarantined row")
        _same_bits(new.trace[2], state.trace[2], "(c) quarantined trace")
        if m["integrity_quarantined"].tolist() != [0, 0, 1] + [0] * 5:
            raise SmokeError(f"(c) verdicts {m['integrity_quarantined']}")
        del state, new, mixed, model
        torch.cuda.empty_cache()
        # (f) the bucketed schedule (K = BUCKETS) under the fault clauses
        # with the freeze policy: every pass's tail is the gated pitched
        # form, BUCKETS launches a pass, bitwise the monolithic twin's
        # gated whole-arena launch (NaNs of the nanstep by their bits)
        for leg, spec, kw, k in (
                ("eventgrad-f32", BUCKETED_FAULTS + ",nanstep=2@4", {},
                 "fused_mix_commit"),
                ("eventgrad-int8-carrier", BUCKETED_FAULTS,
                 dict(wire="int8", carrier_resident=True),
                 "fused_mix_commit_carrier")):
            s_m, h_m = run(f"{leg}-faults", must={
                f"{k}_gated": passes, f"{k}_pitched_gated": 0},
                chaos=spec, chaos_policy=idle, **kw)
            s_b, h_b = run(f"{leg}-faults-bucketed{BUCKETS}", must={
                k: BUCKETS * passes, f"{k}_gated": BUCKETS * passes,
                f"{k}_pitched_gated": BUCKETS * passes},
                chaos=spec, chaos_policy=idle, bucketed=BUCKETS, **kw)
            _same_state(s_m, s_b, f"(f) {leg} bucketed vs monolithic")
            for f in ("silence", "sync_req", "drops"):
                _same_bits(getattr(s_m.chaos, f), getattr(s_b.chaos, f),
                           f"(f) {leg} health {f}")
            _same_records(h_m, h_b, f"(f) {leg}", keys=(
                "loss", "train_acc", "msgs_saved_pct", "num_events",
                "chaos_drops", "sent_bytes_per_step_per_chip"))
            nan_rows = torch.isnan(s_b.params).any(dim=1).tolist()
            if h_b[-1]["chaos_drops"] == 0 or ("nanstep" in spec) != any(
                    nan_rows):
                raise SmokeError(f"(f) {leg}: drops {h_b[-1]['chaos_drops']}"
                                 f", NaN rows {nan_rows}")
            log(json.dumps({"leg": f"(f) {leg} bucketed under faults",
                            "chaos": spec, "buckets": BUCKETS,
                            "drops": h_b[-1]["chaos_drops"],
                            "nan_rows": nan_rows,
                            "step_ms": recs[f"{leg}-faults-bucketed"
                                            f"{BUCKETS}"]["step_ms"],
                            "monolithic_step_ms": recs[f"{leg}-faults"][
                                "step_ms"]}))
            del s_m, s_b
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was)

    # (d) the chaos sweep's legs, held to the JAX package's artifact
    ref = json.loads((HERE / "artifacts" / "chaos_sweep_cpu.json")
                     .read_text())
    ops.reset_launch_counts()
    sweep = chaos_sweep.run_sweep(DEVICE)
    counts = ops.launch_counts()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    log(json.dumps({"chaos_sweep": sweep, "launches": {
        k: v for k, v in counts.items() if v}}))
    failures = []
    ref_pts = {p["drop_p"]: p for p in ref["points"]}
    # the op-point is multimodal (ReLU logits can leave a class dead):
    # one seed's fault-free accuracy is not the reference seed's, so each
    # point is held by its cost against this run's fault-free baseline,
    # at most the artifact's cost plus the band, and each accuracy by a
    # floor: the port's CPU seeds 0-9 minimum at that point less the band
    spread = json.loads((HERE / "artifacts" / "torch_chaos_seeds_cpu.json")
                        .read_text())["seeds"]
    floors = {0.0: min(r["baseline_test_acc"] for r in spread) - ACC_BAND}
    for p in chaos_sweep.DROPS[1:]:
        floors[p] = min(r[f"test_acc_drop{p}"] for r in spread) - ACC_BAND
    base, ref_base = sweep["baseline_test_acc"], ref["baseline_test_acc"]
    log(json.dumps({"chaos_baseline_test_acc": base,
                    "artifact_baseline_test_acc": ref_base,
                    "accuracy_floors": floors}))
    for pt in sweep["points"]:
        want = ref_pts[pt["drop_p"]]
        leg = f"(d) drop {pt['drop_p']}"
        if not pt["test_acc"] >= floors[pt["drop_p"]]:
            failures.append(f"{leg}: test accuracy {pt['test_acc']} under "
                            f"the CPU seeds' floor {floors[pt['drop_p']]}")
        if pt["drop_p"] == 0.0:
            if pt["chaos_drops"] != 0 or not pt[
                    "bitwise_identical_to_baseline"]:
                failures.append(f"{leg}: drops or not bitwise no chaos")
        elif not (pt["chaos_drops"] <= pt["undelivered"] and abs(
                pt["chaos_drops"] - want["chaos_drops"])
                <= 0.1 * want["chaos_drops"]):
            failures.append(f"{leg}: drops {pt['chaos_drops']} (table "
                            f"{pt['undelivered']}, artifact "
                            f"{want['chaos_drops']})")
        cost, ref_cost = base - pt["test_acc"], ref_base - want["test_acc"]
        if not cost <= ref_cost + ACC_BAND:
            failures.append(f"{leg}: accuracy cost {cost} (test accuracy "
                            f"{pt['test_acc']} against {base}) > the "
                            f"artifact's {ref_cost} + {ACC_BAND}")
        if not abs(pt["msgs_saved_pct"] - want["msgs_saved_pct"]) \
                <= MSGS_BAND:
            failures.append(f"{leg}: msgs_saved_pct {pt['msgs_saved_pct']} "
                            f"not within {MSGS_BAND} of "
                            f"{want['msgs_saved_pct']}")
    heal, want = sweep["ring_heal"], ref["ring_heal"]
    if heal["survivors"] != want["survivors"] or heal["detect_pass"] is None \
            or abs(heal["detect_pass"] - want["detect_pass"]) > 5:
        failures.append(f"(d) ring heal: survivors {heal['survivors']}, "
                        f"detected at {heal['detect_pass']} (artifact "
                        f"{want['detect_pass']})")
    if not (heal["recovered"] and sweep["flaky_recovery"]["recovered"]):
        failures.append("(d) a recovery leg did not recover")
    if not counts["fused_mix_commit_gated"]:
        failures.append("(d) the gated commit never launched")
    # (e) the integrity leg, held to the JAX package's artifact
    ref = json.loads((HERE / "artifacts" / "integrity_cpu.json").read_text())
    ops.reset_launch_counts()
    integ = integrity_sweep.run_sweep(DEVICE)
    counts = ops.launch_counts()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    log(json.dumps({"integrity_sweep": integ, "launches": {
        k: v for k, v in counts.items() if v}}))
    for k in ("injected_bitflips", "wire_rejects", "silent_acceptances",
              "rollbacks", "quarantined_steps"):
        if integ[k] != ref[k]:
            failures.append(f"(e) {k} {integ[k]} != the artifact's {ref[k]}")
    if not integ["final_acc_baseline"] >= floors[0.0]:
        failures.append(f"(e) fault-free accuracy "
                        f"{integ['final_acc_baseline']} under the CPU "
                        f"seeds' floor {floors[0.0]}")
    if not integ["acc_gap_pt"] <= ref["acc_gap_pt"] + ACC_BAND:
        failures.append(f"(e) faulted accuracy {integ['final_acc_faulted']}"
                        f" against {integ['final_acc_baseline']}: gap > the "
                        f"artifact's {ref['acc_gap_pt']} + {ACC_BAND}")
    if not (integ["replay_bitwise"] and integ["integrity_off_bitwise"]
            and integ["params_finite"]):
        failures.append("(e) replay or off leg not bitwise, or params not "
                        "finite")
    if failures:
        raise SmokeError("chaos legs: " + "; ".join(failures))
    log(json.dumps({"chaos_vs_twins": {
        leg: {k: recs[leg][k] for k in ("step_ms", "peak_mem_gib",
                                        "launches_per_step")}
        for leg in recs}}))
    return totals


#: the dispatch phase's op-point: the flagship at 8 passes an epoch
#: (2,048 synthetic CIFAR-shaped samples at global batch 256; 16 passes
#: until the mesh phase took its time), 4 epochs,
#: a test set of 512 and a snapshot every 2 epochs
DISPATCH_SAMPLES, DISPATCH_TEST, DISPATCH_EPOCHS = 2048, 512, 4
DISPATCH_K, DISPATCH_SAVE_EVERY = 2, 2
#: the profiled twins' passes an epoch: host syncs per pass are the
#: difference of two runs that differ only in their passes an epoch
DISPATCH_PROFILED_PASSES = (1, 2)


def _host_syncs(fn) -> int:
    """Host syncs of `fn()` (a whole train() run) under the profiler: the
    runtime's synchronizes and the copies that block the host, as the
    obs phase counts them (`utils/obs_overhead`). CUDA activity alone
    records the runtime calls and the copies; leaving out the CPU
    operators keeps the trace of a whole run small."""
    import torch

    from eventgrad_tpu_torch.utils.obs_overhead import (
        SYNC_CALLS, SYNC_COPIES,
    )

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    syncs = sum(e.count for e in prof.key_averages()
                if e.key in SYNC_CALLS
                or (e.key.startswith("Memcpy")
                    and any(s in e.key for s in SYNC_COPIES)))
    if syncs < 1:
        # at least the profiler's own final synchronize
        raise SmokeError("the profiler recorded no runtime synchronize")
    # the profiler's own final synchronize is not the run's
    return syncs - 1


def phase_dispatch():
    """The dispatch pipeline on the flagship (EventGraD on the masked f32
    wire, Ring(8), bf16 compute, global batch 256; deterministic
    algorithms): (a) the serial twin (one epoch a block, the pipeline
    off, the prefetcher uploading each block pinned on its side stream)
    and (b) K = 2 blocks pipelined with the dataset on the device, both
    with the deferred eval and a snapshot every 2 epochs: every state
    tensor, every record value but `wall_s` and `dispatch_*` (the eval
    and consensus error on the blocks' last epochs) and the snapshots of
    epochs 2 and 4 (as staged) bitwise; (c) K = 2 pipelined on the
    prefetcher without saves (every block's host work deferred) bitwise
    too. Kernels 1 and 2 launch once a pass in each. Logs the wall per
    epoch, the prefetcher's misses, and host syncs per pass from twins of
    (a) and (b) profiled at 1 and at 2 passes an epoch (the same epochs,
    blocks and evals: their difference over the passes is what a pass
    adds; the whole run's count over its passes beside it). Returns the
    launches."""
    import os
    import shutil
    import tempfile

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.obs import Registry
    from eventgrad_tpu_torch.utils import checkpoint, crash_matrix

    card = nvidia_smi("name,power.limit")
    per_epoch = DISPATCH_SAMPLES // (RANKS * 32)
    passes = per_epoch * DISPATCH_EPOCHS
    log(f"== dispatch: ResNet-18 (bf16 compute) x Ring(8), global batch "
        f"256, {per_epoch} passes x {DISPATCH_EPOCHS} epochs, K = "
        f"{DISPATCH_K} ({card})")
    x, y = synthetic_dataset(DISPATCH_SAMPLES, (32, 32, 3), seed=0)
    xt, yt = synthetic_dataset(DISPATCH_TEST, (32, 32, 3), seed=1)
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=30,
                          max_silence=50)
    root = tempfile.mkdtemp(prefix="eg-dispatch-")
    totals, logged = {}, {}
    # the snapshots as they are staged: the serial twin's kept on the
    # host, each of (b)'s held against it as it is staged
    staged, mismatched = {}, []
    real_stage = checkpoint._stage

    def stage(path, tensors, meta):
        leg = os.path.basename(os.path.dirname(path))
        host = {k: v.detach().cpu() for k, v in tensors.items()}
        if leg == "serial":
            staged[meta["epoch"]] = host
        else:
            ref = staged.get(meta["epoch"], {})
            bad = [k for k in host if k not in ref or not torch.equal(
                host[k].reshape(-1).view(torch.uint8),
                ref[k].reshape(-1).view(torch.uint8))]
            if bad or set(ref) != set(host):
                mismatched.append((meta["epoch"], bad[:3]))
        real_stage(path, host, meta)

    def train(leg, n=DISPATCH_SAMPLES, ck=True, registry=None, **kw):
        return egt.train(
            egt.ResNet18(dtype=torch.bfloat16), egt.Ring(RANKS), x[:n], y[:n],
            algo="eventgrad", epochs=DISPATCH_EPOCHS, batch_size=32,
            learning_rate=0.01, momentum=0.9, event_cfg=cfg,
            random_sampler=True, seed=0, x_test=xt, y_test=yt,
            checkpoint_dir=os.path.join(root, leg) if ck else None,
            save_every=DISPATCH_SAVE_EVERY if ck else 0, registry=registry,
            device=DEVICE, **kw)

    def run(leg, **kw):
        reg = Registry()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, hist = train(leg, registry=reg, **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for k in ("masked_wire", "fused_mix_commit"):
            if counts[k] != passes:
                raise SmokeError(f"({leg}) {k} launched {counts[k]} times, "
                                 f"expected {passes}")
        misses = reg._gauges.get(("prefetch_misses_total", frozenset()))
        logged[leg] = {
            "run_s": run_s,
            "wall_s_per_epoch": [r["wall_s"] for r in hist],
            "dispatch_block": [r["dispatch_block"] for r in hist],
            "dispatch_cold": [r["dispatch_cold"] for r in hist],
            "prefetch_misses": None if misses is None else misses[0],
            "test_accuracy": [r.get("test_accuracy") for r in hist]}
        log(json.dumps({"leg": leg, **logged[leg], "card": card}))
        return state, hist

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        raise SmokeError("CUBLAS_WORKSPACE_CONFIG unset: the bitwise legs "
                         "need deterministic cuBLAS")
    was = torch.are_deterministic_algorithms_enabled()
    was_bench = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    checkpoint._stage = stage
    try:
        s_a, h_a = run("serial", epochs_per_dispatch=1, pipeline=False,
                       device_data=False)
        s_b, h_b = run("pipelined", epochs_per_dispatch=DISPATCH_K,
                       pipeline=True, device_data=True)
        s_c, h_c = run("pipelined-prefetch", ck=False,
                       epochs_per_dispatch=DISPATCH_K, pipeline=True,
                       device_data=False)
        blocks = [e // DISPATCH_K for e in range(DISPATCH_EPOCHS)]
        for leg, h in (("pipelined", h_b), ("pipelined-prefetch", h_c)):
            if [r["dispatch_block"] for r in h] != blocks or [
                    r["dispatch_cold"] for r in h] != [True] * DISPATCH_K + [
                        False] * (DISPATCH_EPOCHS - DISPATCH_K):
                raise SmokeError(f"({leg}) blocks {logged[leg]}")
        for leg, s, h in (("pipelined", s_b, h_b),
                          ("pipelined-prefetch", s_c, h_c)):
            _tree_bits(s_a, s, f"({leg}) vs serial")
            _same_records(h_a, h, f"({leg}) vs serial", keys=None,
                          skip=("wall_s", "dispatch_block", "dispatch_cold"))
        if sorted(staged) != [2, 4] or mismatched:
            raise SmokeError(f"staged snapshots {sorted(staged)}, "
                             f"pipelined ones not bitwise: {mismatched}")
        if not crash_matrix.final_state_equal(os.path.join(root, "serial"),
                                              os.path.join(root,
                                                           "pipelined")):
            raise SmokeError("the final snapshots on disk differ")
        del s_a, s_b, s_c
        staged.clear()
        torch.cuda.empty_cache()
        # host syncs per pass: the serial and pipelined configurations,
        # no saves, profiled at 1 and at 2 passes an epoch
        lo, hi = DISPATCH_PROFILED_PASSES
        syncs = {}
        for leg, kw in (("serial", dict(epochs_per_dispatch=1,
                                        pipeline=False, device_data=False)),
                        ("pipelined", dict(epochs_per_dispatch=DISPATCH_K,
                                           pipeline=True,
                                           device_data=True))):
            got = {p: _host_syncs(lambda: train(
                f"p-{leg}", n=p * RANKS * 32, ck=False, **kw))
                for p in (lo, hi)}
            syncs[leg] = {
                "per_pass": (got[hi] - got[lo]) / ((hi - lo)
                                                   * DISPATCH_EPOCHS),
                "whole_run_per_pass": got[hi] / (hi * DISPATCH_EPOCHS),
                "runs": got}
        log(json.dumps({"dispatch_vs_serial": {
            leg: {"run_s": logged[leg]["run_s"],
                  "wall_s_per_epoch": logged[leg]["wall_s_per_epoch"],
                  "prefetch_misses": logged[leg]["prefetch_misses"],
                  "host_syncs": syncs.get(leg)}
            for leg in logged}, "card": card}))
    finally:
        checkpoint._stage = real_stage
        torch.use_deterministic_algorithms(was)
        torch.backends.cudnn.benchmark = was_bench
        shutil.rmtree(root, ignore_errors=True)
    return totals


def phase_leak_kernel():
    """Kernel 9, the auditor's seeded unregistered kernel
    (`eg::leak_kernel`, `csrc/audit_leak.cu`): bitwise `x * 2.0` at the
    JAX fixture's (8, 128) block and at the flagship arena, then timed
    beside `x * 2.0` and `torch.mul` over LEAK_BATCH calls in a row: the
    card's time a call (a single call's CUDA-event time also counts the
    operator's host dispatch, where the card idles), and that single-call
    time beside it."""
    import torch

    from eventgrad_tpu_torch.analysis import audit

    log("== kernel 9: eg::leak_kernel")
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(9)
    small = torch.randn((8, 128), generator=gen, device=dev)
    err = max_abs_err([audit.leak_kernel(small)],
                      [audit.leak_reference(small)])
    x = torch.randn((RANKS, FLAGSHIP_PARAMS), generator=gen, device=dev)
    err = max(err, max_abs_err([audit.leak_kernel(x)],
                               [audit.leak_reference(x)]))
    rec = dict(
        max_abs_err=err,
        ms=time_ms(lambda: audit.leak_kernel(x), LEAK_BATCH),
        plain_ms=time_ms(lambda: audit.leak_reference(x), LEAK_BATCH),
        library_ms=time_ms(lambda: torch.mul(x, 2.0), LEAK_BATCH),
        # reads x, writes o (f32); one multiply
        bound=tail_bound("leak_kernel", x.numel()),
        single_call_ms=time_ms(lambda: audit.leak_kernel(x)),
        single_call_library_ms=time_ms(lambda: torch.mul(x, 2.0)),
    )
    del x
    torch.cuda.empty_cache()
    log(json.dumps({"kernel": "leak_kernel", "elements": RANKS
                    * FLAGSHIP_PARAMS, **{k: v for k, v in rec.items()
                                          if k != "bound"},
                    "bound_ms": rec["bound"][0],
                    "bound_by": rec["bound"][1]}))
    return {"leak_kernel": rec}


#: the flagship op-point audited: (leg, algo, wire, gossip wire, compact
#: capacity, carrier, per-neighbour bytes derived from the traced lanes,
#: the step's float32 `sent_bytes_wire_real`). Derived bytes: the f32
#: value lanes (4 B x 17,444,682, or x 6,541,756 = ceil(0.375 n) on the
#: compact wire; 1 B on int8) plus 86 fire bytes on the event legs and
#: 4 x 86 int8 scale bytes; the metric is two neighbours' worth in float32
FLAGSHIP_AUDIT = (
    ("eventgrad-f32", "eventgrad", None, "dense", None, False,
     69_778_814, 139_557_632),
    ("dpsgd-f32", "dpsgd", None, "dense", None, False,
     69_778_728, 139_557_456),
    ("eventgrad-compact-f32", "eventgrad", None, "compact", 6_541_756,
     False, 26_167_110, 52_334_220),
    ("eventgrad-compact-int8-carrier", "eventgrad", "int8", "compact",
     6_541_756, True, 6_542_186, 13_084_372),
)


def _check_audit_cell(rep, what):
    """A clean report whose traced kernel ops each launched once per
    node."""
    from eventgrad_tpu_torch.analysis import audit

    if not audit.clean(rep):
        raise SmokeError(f"audit {what} not clean: "
                         f"{json.dumps({k: rep[k] for k in ('violation_details', 'wire_problems', 'undeclared_offsets', 'missing_offsets', 'metric_match', 'ravel_count', 'callbacks', 'partitions_ok')})}")
    if not rep["kernel_ops"] or rep["kernel_ops"] != rep["kernel_launches"]:
        raise SmokeError(f"audit {what}: traced kernel ops "
                         f"{rep['kernel_ops']} != launches "
                         f"{rep['kernel_launches']}")


def _audit_flagship():
    """The flagship op-point audited: Ring(8), ResNet-18 in bf16, global
    batch 256, one step of each FLAGSHIP_AUDIT leg traced, each clean
    with its exact bytes. Returns the kernel launches."""
    import numpy as np
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.analysis import audit
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.train.steps import make_train_step

    ops.reset_launch_counts()
    log("== audit: the flagship op-point, ResNet-18 (bf16 compute) x "
        "Ring(8), global batch 256")
    topo = egt.Ring(RANKS)
    per_rank = 32
    x, y = synthetic_dataset(RANKS * per_rank, (32, 32, 3), seed=0)
    batch = (torch.as_tensor(x.reshape(RANKS, per_rank, 32, 32, 3),
                             device=DEVICE),
             torch.as_tensor(y.reshape(RANKS, per_rank).astype(np.int64),
                             device=DEVICE))
    ev = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                         max_silence=50)
    t0 = time.perf_counter()
    for leg, algo, wire, gw, cap, carrier, want_b, want_m in FLAGSHIP_AUDIT:
        cfg = audit.AuditConfig(f"flagship_{leg}", algo=algo,
                                model="resnet18", wire=wire, gossip_wire=gw,
                                capacity=cap, arena=True, carrier=carrier)
        model = egt.ResNet18(dtype=torch.bfloat16, device=DEVICE)
        state = egt.init_train_state(
            model, (32, 32, 3), topo, algo, ev, 0, momentum=0.9,
            resident_wire=wire if carrier else None, device=DEVICE)
        step = make_train_step(
            model, topo, algo, ev, fused_sgd=(0.01, 0.9), wire=wire,
            gossip_wire=gw, compact_capacity=cap, carrier_resident=carrier)
        t1 = time.perf_counter()
        rep = audit.audit_step(cfg, step, state, batch, model, topo)
        trace_s = time.perf_counter() - t1
        log(json.dumps({"leg": leg, "trace_s": trace_s, **{k: rep[k] for k in (
            "n_params", "n_leaves", "capacity", "graph_nodes",
            "wire_bytes_per_neighbor_derived",
            "wire_bytes_per_neighbor_formula", "wire_metric_total",
            "kernel_ops", "kernel_launches")}}))
        _check_audit_cell(rep, leg)
        if (rep["n_params"], rep["n_leaves"]) != (FLAGSHIP_PARAMS, 86):
            raise SmokeError(f"{leg}: {rep['n_params']} parameters in "
                             f"{rep['n_leaves']} leaves")
        got = (rep["wire_bytes_per_neighbor_derived"],
               rep["wire_bytes_per_neighbor_formula"],
               rep["wire_metric_total"])
        if got != (want_b, want_b, want_m):
            raise SmokeError(f"{leg}: derived / formula / metric {got} != "
                             f"{(want_b, want_b, want_m)}")
        del state, step, model, rep
        torch.cuda.empty_cache()
    log(f"flagship legs audited in {time.perf_counter() - t0:.1f} s")
    return ops.launch_counts()


def audit_child(out, device="cuda"):
    """The audit CLI on the card (run as `python -c` by `phase_audit`):
    writes its record to `out` and prints its exit code, the kernels'
    launches of the run and kernel 9's."""
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.analysis import audit

    rc = audit.main(["--device", device, "--out", str(out)])
    print(json.dumps({"audit_child": rc, "launches": ops.launch_counts(),
                      "leak_kernel": audit.leak_kernel.launches}),
          flush=True)


def phase_audit():
    """The static-analysis path on the card: the audit CLI over the 31
    cells and the 15 oracles (`--device cuda`, a child process), and
    beside it the flagship op-point audited here. Returns the kernel
    launches of the phase."""
    from eventgrad_tpu_torch import ops

    log("== audit: 31 cells and 15 oracles on the card "
        "(python -m eventgrad_tpu_torch.analysis.audit --device cuda)")
    ops.reset_launch_counts()
    out = HERE / "build" / "audit_cuda.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    child_out = HERE / "build" / "audit_child.out"
    child = [(_mesh_child(f"import chip_smoke as c; c.audit_child("
                          f"{str(out)!r}, {DEVICE!r})", child_out),
              child_out)]
    try:
        flagship = _audit_flagship()
    finally:
        _finish_children(child, "audit CLI")
    res = _child_json(child_out, "audit_child")
    rc = res["audit_child"]
    rec = json.loads(out.read_text())
    log(f"audit CLI: exit {rc}, {rec['n_clean']}/{rec['n_configs']} clean, "
        f"{rec['n_detected']}/{rec['n_oracles']} oracles, "
        f"{rec['lint_violations']} lint violations, "
        f"{time.perf_counter() - t0:.1f} s")
    for c in rec["configs"]:
        log(json.dumps({k: c[k] for k in (
            "name", "wire_bytes_per_neighbor_derived", "wire_metric_total",
            "kernel_ops", "kernel_launches", "graph_nodes", "wall_s")}))
        _check_audit_cell(c, c["name"])
    want = {
        "event_masked_f32_tree": {"masked_wire": 1, "fused_mix_commit": 1},
        "xfmr_flash_masked_f32_tree": {"masked_wire": 1,
                                       "fused_mix_commit": 1,
                                       "flash_fwd": 1, "flash_dq": 1,
                                       "flash_dkv": 1},
    }
    for name, ops_want in want.items():
        got = next(c for c in rec["configs"] if c["name"] == name)
        if got["kernel_ops"] != ops_want:
            raise SmokeError(f"audit {name}: kernel ops {got['kernel_ops']} "
                             f"!= {ops_want}")
    for o in rec["oracles"]:
        log(json.dumps(o))
    missed = [o["name"] for o in rec["oracles"] if not o["detected"]]
    if rc != 0 or missed or rec["n_configs"] != 31 or rec["n_oracles"] != 15:
        raise SmokeError(f"audit CLI failed: exit {rc}, oracles missed "
                         f"{missed}")
    if res["leak_kernel"] < 1:
        raise SmokeError("the unregistered-kernel oracle never launched "
                         "kernel 9")

    counts = dict(flagship)
    for k, v in res["launches"].items():
        counts[k] = counts.get(k, 0) + v
    counts["leak_kernel"] = res["leak_kernel"]
    return counts


#: the resume phase's op-point: the flagship at 2 passes an epoch
#: (512 synthetic CIFAR-shaped samples at global batch 256), 3 epochs
RESUME_EPOCHS, RESUME_STEPS, RESUME_PER_RANK = 3, 2, 32

#: the crash matrix's worker threads on the card, beside the phase's own
#: legs and the kill child (the card machine has 8 host cores)
MATRIX_WORKERS = 6


def _resume_train(ck, epochs=RESUME_EPOCHS, **kw):
    """The resume legs' run: ResNet-18 (bf16 compute), Ring(8), global
    batch 256, SGD lr 0.01 momentum 0.9, the adaptive trigger; `ck` the
    checkpoint_dir (a save every epoch unless `save_every` says else).
    The kill child runs it too."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset

    x, y = synthetic_dataset(RANKS * RESUME_PER_RANK * RESUME_STEPS,
                             (32, 32, 3), seed=0)
    kw.setdefault("algo", "eventgrad")
    kw.setdefault("save_every", 1 if ck is not None else 0)
    # the serial schedule: synchronous saves, the timings (a)-(c) log
    kw.setdefault("pipeline", False)
    return egt.train(
        egt.ResNet18(dtype=torch.bfloat16), egt.Ring(RANKS), x, y,
        epochs=epochs, batch_size=RESUME_PER_RANK, learning_rate=0.01,
        momentum=0.9,
        event_cfg=egt.EventConfig(adaptive=True, horizon=1.05,
                                  warmup_passes=2, max_silence=50),
        random_sampler=True, seed=0, checkpoint_dir=ck, device=DEVICE, **kw)


def resume_child(ck: str, log_path: str) -> int:
    """Leg (a)'s run in a process of its own (forked from the crash
    matrix's forkserver), records to `log_path`, killed by the crash
    site its parent arms."""
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    with open(log_path, "a") as log:
        def on_epoch(rec):
            log.write(json.dumps(rec) + "\n")
            log.flush()

        _resume_train(ck, on_epoch=on_epoch)
    return 0


def _tree_bits(a, b, what):
    """Every tensor of two states' flat forms (`train/state.to_flat`:
    parameters, trace, statistics, event state with its buffers, scales
    and queues, peer health, the random stream's bytes) bitwise."""
    from eventgrad_tpu_torch.train import state as state_lib

    _flat_bits(state_lib.to_flat(a), state_lib.to_flat(b), what)


def _flat_bits(fa, fb, what):
    """Two flat `{path: tensor}` dicts (a state's `to_flat`, a snapshot's
    tensors) bitwise, path for path."""
    import torch

    if fa.keys() != fb.keys():
        raise SmokeError(f"{what}: fields differ "
                         f"{sorted(set(fa) ^ set(fb))}")
    for k in fa:
        x, y = fa[k], fb[k]
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.contiguous().reshape(-1).view(torch.uint8),
                y.contiguous().reshape(-1).view(torch.uint8)):
            raise SmokeError(f"{what}: {k} not bitwise equal")


def phase_resume():
    """Checkpoint/resume, graceful preemption and the crash drills on the
    flagship (deterministic algorithms): (a) a kill at `ckpt.mid_swap:2`
    and a resume bitwise the run that never stopped; (b) the int8
    carrier snapshot's round trip and two layout guards; (c) a scheduled
    preemption of D-PSGD resumed bitwise; (d) the integrity leg with its
    on-disk retention, bitwise the leg without; (e) the crash matrix on
    the card against the JAX artifact, started once the timed saves of
    (a)-(c) are done and run beside (a)'s kill child, its relaunch and
    (d). Returns the launches of each kernel."""
    import concurrent.futures
    import os
    import shutil
    import tempfile

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.chaos.crashpoint import (
        GracefulPreemption, marker_path,
    )
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.exitcodes import CRASHPOINT_EXIT
    from eventgrad_tpu_torch.train import state as state_lib
    from eventgrad_tpu_torch.utils import checkpoint, crash_matrix

    card = nvidia_smi("name,power.limit")
    log(f"== resume: ResNet-18 (bf16 compute) x Ring(8), global batch 256, "
        f"{RESUME_STEPS} passes x {RESUME_EPOCHS} epochs ({card})")
    passes = RESUME_STEPS * RESUME_EPOCHS
    totals = {}
    root = tempfile.mkdtemp(prefix="eg-resume-")

    def counted(leg, fn, must=None):
        """`fn()` with its launches counted (also when it raises, as a
        drained run does)."""
        ops.reset_launch_counts()
        try:
            out = fn()
        finally:
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            log(json.dumps({"leg": leg, "launches": {
                k: v for k, v in counts.items() if v}, "card": card}))
        for k, n in (must or {}).items():
            if counts[k] != n:
                raise SmokeError(f"{leg}: {k} launched {counts[k]} times, "
                                 f"expected {n}")
        return out

    def timed_round_trip(leg, state, template):
        """Save (fsync included) and restore seconds of `state`'s
        snapshot after the last epoch, its bytes, and the restore onto
        `template` bitwise the state."""
        path = os.path.join(root, f"{leg}-timed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, *state_lib.payload(state, RESUME_EPOCHS,
                                                 "eventgrad"))
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(os.path.join(path, checkpoint.TENSORS))
        t0 = time.perf_counter()
        raw, meta = checkpoint.peek(path, device=DEVICE)
        back = state_lib.from_flat(template, checkpoint.restore(
            raw, state_lib.to_flat(template)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        _tree_bits(state, back, f"{leg} snapshot round trip")
        shutil.rmtree(path)
        log(json.dumps({"leg": leg, "snapshot_bytes": nbytes,
                        "save_s": save_s, "restore_s": restore_s,
                        "layout": meta["layout"], "card": card}))

    def template(resident_wire=None):
        return egt.init_train_state(
            egt.ResNet18(dtype=torch.bfloat16), (32, 32, 3),
            egt.Ring(RANKS), "eventgrad",
            egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                            max_silence=50), 0, momentum=0.9,
            resident_wire=resident_wire, device=DEVICE)

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        raise SmokeError("CUBLAS_WORKSPACE_CONFIG unset: the bitwise legs "
                         "need deterministic cuBLAS")
    was = torch.are_deterministic_algorithms_enabled()
    was_bench = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    bg = concurrent.futures.ThreadPoolExecutor(1)
    try:
        # (a) the masked f32 wire: uninterrupted, then (beside the crash
        # matrix, below) a child saving every epoch killed inside its
        # epoch-3 save's swap, then the relaunch
        s_u, h_u = counted("(a) eventgrad-f32",
                           lambda: _resume_train(None),
                           must={"masked_wire": passes,
                                 "fused_mix_commit": passes})
        timed_round_trip("(a) eventgrad-f32", s_u, template())

        # (b) the int8 carrier (one save, at the end): the snapshot
        # bitwise, the guards raise
        ck_b = os.path.join(root, "b-int8")
        carrier = dict(wire="int8", carrier_resident=True)
        s_b, _ = counted("(b) eventgrad-int8-carrier",
                         lambda: _resume_train(ck_b, save_every=0,
                                               **carrier),
                         must={"masked_wire_int8": passes,
                               "fused_mix_commit_carrier": passes})
        timed_round_trip("(b) eventgrad-int8-carrier", s_b,
                         template(resident_wire="int8"))
        for what, kw, cause in (
                ("f32-resident", dict(wire="int8"),
                 "checkpoint restore failed with carrier_resident=off: "
                 "this snapshot was written by a carrier-resident "
                 "wire='int8' run"),
                ("bucketed=4", dict(carrier, bucketed=4),
                 "checkpoint restore failed with bucketed=4: this snapshot "
                 "was written by a monolithic (bucketed off) layout run")):
            try:
                _resume_train(ck_b, epochs=RESUME_EPOCHS + 1, resume=True,
                              **kw)
            except RuntimeError as e:
                if not str(e).startswith(cause):
                    raise SmokeError(f"(b) {what}: {e}") from e
            else:
                raise SmokeError(f"(b) a resume into {what} did not raise")
        log(json.dumps({"leg": "(b) guards", "raised": ["f32-resident",
                                                        "bucketed=4"]}))
        del s_b
        shutil.rmtree(ck_b)
        torch.cuda.empty_cache()

        # (c) D-PSGD preempted by schedule at epoch 2 (no save due: the
        # drain forces one), resumed bitwise the run never preempted
        spec = "drop=0,seed=1"
        s_n, h_n = counted("(c) dpsgd-chaos", lambda: _resume_train(
            None, algo="dpsgd", chaos=spec),
            must={"fused_mix_sgd_gated": passes})
        ck_c = os.path.join(root, "c-preempt")
        try:
            counted("(c) dpsgd-preempted", lambda: _resume_train(
                ck_c, algo="dpsgd", chaos=spec + ",preempt=2@1",
                save_every=0))
        except GracefulPreemption as e:
            info = e.info
        else:
            raise SmokeError("(c) no GracefulPreemption")
        if info["epoch"] != 2 or not os.path.exists(marker_path(ck_c)):
            raise SmokeError(f"(c) drain {info}")
        nbytes = os.path.getsize(os.path.join(ck_c, "ckpt",
                                              checkpoint.TENSORS))
        t0 = time.perf_counter()
        s_c, h_c = counted("(c) dpsgd-resumed", lambda: _resume_train(
            ck_c, algo="dpsgd", chaos=spec + ",preempt=2@1", save_every=0,
            resume=True), must={"fused_mix_sgd_gated": RESUME_STEPS})
        resume_s = time.perf_counter() - t0
        if os.path.exists(marker_path(ck_c)):
            raise SmokeError("(c) the marker was not consumed")
        if [r["epoch"] for r in h_c] != [3]:
            raise SmokeError(f"(c) resumed epochs {[r['epoch'] for r in h_c]}")
        _tree_bits(s_n, s_c, "(c) resumed vs never preempted")
        _same_records(h_n[2:], h_c, "(c) epoch 3")
        log(json.dumps({"leg": "(c) preempt + resume", "drain": info,
                        "snapshot_bytes": nbytes, "resumed_run_s": resume_s,
                        "card": card}))
        del s_n, s_c
        shutil.rmtree(ck_c)
        torch.cuda.empty_cache()

        # the crash matrix (e) runs from here beside the legs left, in
        # child processes on the card; the timed saves above ran alone
        matrix_fut = bg.submit(crash_matrix.run_matrix, "cuda",
                               MATRIX_WORKERS)
        t_matrix = time.perf_counter()

        # (a), continued: the kill child and its relaunch
        ck_a = os.path.join(root, "a-killed")
        log_a = os.path.join(root, "a-killed.jsonl")
        out_a = os.path.join(root, "a-killed.out")
        t0 = time.perf_counter()
        rc, out = crash_matrix.finish_child(crash_matrix.start_process(
            resume_child, (ck_a, log_a), out_a, "ckpt.mid_swap:2"), out_a)
        child_s = time.perf_counter() - t0
        if (rc != CRASHPOINT_EXIT
                or "crashpoint ckpt.mid_swap hit 2" not in out):
            raise SmokeError(f"(a) kill child: exit {rc}, output "
                             f"{out[-1500:]}")
        left = sorted(n for n in os.listdir(ck_a) if n.startswith("ckpt"))
        if "ckpt" in left or "ckpt.prev" not in left:
            raise SmokeError(f"(a) after the kill: {left}")
        with open(log_a) as f:
            killed = [json.loads(line) for line in f if line.strip()]
        if killed[0].get("crashpoint") != {"site": "ckpt.mid_swap", "hit": 2}:
            raise SmokeError(f"(a) first record's rider "
                             f"{killed[0].get('crashpoint')}")
        t0 = time.perf_counter()
        s_r, h_r = counted("(a) eventgrad-f32 resumed",
                           lambda: _resume_train(ck_a, resume=True),
                           must={"masked_wire": RESUME_STEPS,
                                 "fused_mix_commit": RESUME_STEPS})
        resume_s = time.perf_counter() - t0
        if [r["epoch"] for r in h_r] != [RESUME_EPOCHS]:
            raise SmokeError(f"(a) resumed epochs {[r['epoch'] for r in h_r]}")
        _tree_bits(s_u, s_r, "(a) resumed vs uninterrupted")
        _same_records(h_u[1:], [killed[1]] + h_r, "(a) epochs 2-3")
        log(json.dumps({"leg": "(a) kill + resume", "left_after_kill": left,
                        "child_s": child_s, "resumed_run_s": resume_s,
                        "card": card}))
        del s_u, s_r
        shutil.rmtree(ck_a)
        torch.cuda.empty_cache()

        # (d) phase_chaos's integrity leg, with and without its on-disk
        # retention (keep_good=1, so the second epoch prunes the first)
        xc, yc = synthetic_dataset(RANKS * 32 * 3, (32, 32, 3), seed=0)

        def integrity_leg(ck):
            return egt.train(
                egt.ResNet18(dtype=torch.bfloat16), egt.Ring(RANKS), xc, yc,
                algo="eventgrad", epochs=2, batch_size=32,
                learning_rate=0.01, momentum=0.9,
                event_cfg=egt.EventConfig(adaptive=True, horizon=1.05,
                                          warmup_passes=CHAOS_WARMUP,
                                          max_silence=50),
                random_sampler=True, seed=0,
                chaos="seed=0,bitflip=1-7@0.3,nanstep=2@4",
                integrity="keep_good=1", checkpoint_dir=ck,
                save_every=1 if ck else 0, device=DEVICE)

        s_0, h_0 = counted("(d) integrity", lambda: integrity_leg(None),
                           must={"fused_mix_commit_gated": 6})
        ck_d = os.path.join(root, "d-integrity")
        s_1, h_1 = counted("(d) integrity-retained",
                           lambda: integrity_leg(ck_d),
                           must={"fused_mix_commit_gated": 6})
        _tree_bits(s_0, s_1, "(d) with vs without a checkpoint_dir")
        _same_records(h_0, h_1, "(d)", keys=(
            "loss", "wire_rejects", "quarantined_steps",
            "integrity_rollbacks", "msgs_saved_pct"))
        good = checkpoint.RollingRetention(os.path.join(ck_d, "good"),
                                           keep=1).snapshots()
        if [e for e, _ in good] != [2]:
            raise SmokeError(f"(d) retained {good}")
        log(json.dumps({"leg": "(d) integrity retention",
                        "retained_epochs": [e for e, _ in good],
                        "card": card}))
        del s_0, s_1
        shutil.rmtree(ck_d)
        torch.cuda.empty_cache()
        matrix = matrix_fut.result()
    finally:
        # a failed leg still waits for the matrix's children; then the
        # forkserver they and the kill child came from stops
        bg.shutdown(wait=True)
        crash_matrix.stop_forkserver()
        torch.use_deterministic_algorithms(was)
        torch.backends.cudnn.benchmark = was_bench
        shutil.rmtree(root, ignore_errors=True)

    # (e) the crash matrix against the JAX artifact
    ref = json.loads((HERE / "artifacts" / "crash_matrix_cpu.json")
                     .read_text())
    diffs = crash_matrix.compare(ref, matrix)
    log(json.dumps({"leg": "(e) crash matrix", "n_cells": matrix["n_cells"],
                    "preemption_legs": len(matrix["preemption"]["cells"]),
                    "unresumable": matrix["unresumable"],
                    "silent_data_loss": matrix["silent_data_loss"],
                    "lost_epochs": [c["lost_epochs"]
                                    for c in matrix["cells"]],
                    "wall_s": matrix["wall_s"], "workers": matrix["workers"],
                    "joined_after_s": time.perf_counter() - t_matrix,
                    "card": card}))
    if diffs:
        raise SmokeError("(e) crash matrix vs the JAX artifact: "
                         + "; ".join(diffs))
    return totals


#: the telemetry phase's legs: 3 passes an epoch, 2 epochs
OBS_STEPS, OBS_EPOCHS = 3, 2
#: timed and profiled passes per config of the overhead leg
OBS_TIMED, OBS_WARMUP, OBS_PROFILED = 10, 3, 3


def phase_obs():
    """The on-device telemetry, the message ledger and the host registry
    on the flagship (legs (a)-(c) under deterministic algorithms, each
    with obs off and on): (a) EventGraD masked f32 with a Registry, (b)
    D-PSGD (the dense census), (c) EventGraD int8 carrier-resident; every
    state tensor bitwise the obs-off run's, the records equal but for
    `obs`, the probe and the timings, the ledger's laws per window. (d)
    the composed ledger op-point (`utils/ledger_audit.py`) on the card;
    (e) the overhead of the telemetry on the flagship pass (pass ms,
    launches and host syncs per pass, obs off then on: the syncs must be
    equal); (f) (a)'s Chrome trace reloaded, its spans nested under
    `train`, the bubble decomposition, the run report from (a)'s JSONL
    and the Prometheus ledger gauges. Returns the launches of each
    kernel."""
    import os
    import tempfile

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.obs import Registry, bubble
    from eventgrad_tpu_torch.obs import device as obs_device
    from eventgrad_tpu_torch.obs.report import (
        build_report, load_history_jsonl, render_text,
    )
    from eventgrad_tpu_torch.utils import ledger_audit, obs_overhead

    t_phase = time.perf_counter()
    card = nvidia_smi("name,power.limit")
    log(f"== obs: ResNet-18 (bf16 compute) x Ring(8), global batch 256, "
        f"{OBS_STEPS} passes x {OBS_EPOCHS} epochs ({card})")
    passes = OBS_STEPS * OBS_EPOCHS
    x, y = synthetic_dataset(RANKS * 32 * OBS_STEPS, (32, 32, 3), seed=0)
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    totals = {}
    tmp = tempfile.mkdtemp(prefix="eg-obs-")

    def run(leg, algo="eventgrad", must=None, registry=None, **kw):
        ops.reset_launch_counts()
        state, hist = egt.train(
            egt.ResNet18(dtype=torch.bfloat16), egt.Ring(RANKS), x, y,
            algo=algo, epochs=OBS_EPOCHS, batch_size=32, learning_rate=0.01,
            momentum=0.9, event_cfg=cfg, random_sampler=True, seed=0,
            registry=registry,
            on_epoch=None if registry is None else registry.record,
            device=DEVICE, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for k, n in (must or {}).items():
            if counts[k] != n:
                raise SmokeError(f"{leg}: {k} launched {counts[k]} times, "
                                 f"expected {n}")
        if not all(math.isfinite(r["loss"]) for r in hist):
            raise SmokeError(f"{leg}: a loss is not finite")
        return state, hist

    timing = ("wall_s", "obs", "consensus_err_max", "consensus_err_mean")

    def pair(leg, algo="eventgrad", must=None, registry=None, **kw):
        """The leg with obs off, then on: the whole state bitwise (the
        telemetry aside), the records equal but for `timing`, and every
        window's ledger audit clean with the sender law exact."""
        s_off, h_off = run(f"{leg} obs=off", algo, must, **kw)
        s_on, h_on = run(f"{leg} obs=epoch", algo, must, registry,
                         obs="epoch", **kw)
        if s_on.telemetry is None:
            raise SmokeError(f"{leg}: no telemetry in the obs run's state")
        _tree_bits(s_off, s_on.replace(telemetry=None),
                   f"{leg} obs on vs off")
        for a, b in zip(h_off, h_on):
            if ({k: v for k, v in a.items() if k not in timing}
                    != {k: v for k, v in b.items() if k not in timing}):
                raise SmokeError(f"{leg}: records differ with obs on")
        for h in h_on:
            o = h["obs"]
            aud, led = o["ledger_audit"], o["message_ledger"]
            tot = {k: sum(v) for k, v in led.items()}
            if not aud["ok"] or aud["violations"] or not aud["checks"]:
                raise SmokeError(f"{leg} epoch {h['epoch']}: ledger audit "
                                 f"{aud}")
            if tot["proposed"] != (tot["suppressed"] + tot["deferred"]
                                   + tot["fired"]):
                raise SmokeError(f"{leg} epoch {h['epoch']}: sender law "
                                 f"{tot}")
            if o["steps"] != OBS_STEPS:
                raise SmokeError(f"{leg}: window of {o['steps']} passes")
        log(json.dumps({"leg": leg, "ledger": [
            {k: sum(v) for k, v in h["obs"]["message_ledger"].items()}
            for h in h_on], "card": card}))
        return s_on, h_on

    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        raise SmokeError("CUBLAS_WORKSPACE_CONFIG unset: the bitwise legs "
                         "need deterministic cuBLAS")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    jsonl = os.path.join(tmp, "history.jsonl")
    reg = Registry(jsonl_path=jsonl)
    try:
        # (a) EventGraD masked f32: kernels 1 and 2, with the registry
        s_a, h_a = pair("(a) eventgrad-f32",
                        must={"masked_wire": passes,
                              "fused_mix_commit": passes}, registry=reg)
        prev = 0
        for h in h_a:
            fires = sum(h["obs"]["fire_count"])
            if fires * NB != h["num_events"] - prev:
                raise SmokeError(f"(a) epoch {h['epoch']}: {fires} fires x "
                                 f"{NB} != num_events change "
                                 f"{h['num_events'] - prev}")
            prev = h["num_events"]
        leaves = h_a[0]["obs"]["meta"]["leaves"]
        if len(leaves) != 86 or h_a[0]["obs"]["meta"]["n_ranks"] != RANKS:
            raise SmokeError(f"(a) meta {h_a[0]['obs']['meta']}")
        del s_a
        # (b) D-PSGD: kernel 4 and the dense census, 86 leaves x passes x
        # ranks on each edge, all delivered
        s_b, h_b = pair("(b) dpsgd", "dpsgd", must={"fused_mix_sgd": passes})
        for h in h_b:
            led = h["obs"]["message_ledger"]
            want = [86 * OBS_STEPS * RANKS] * NB
            if led["fired"] != want or led["delivered"] != want:
                raise SmokeError(f"(b) epoch {h['epoch']}: census {led}")
        del s_b
        # (c) EventGraD int8 carrier-resident: kernels 3 and 5
        s_c, _ = pair("(c) eventgrad-int8-carrier",
                      must={"masked_wire_int8": passes,
                            "fused_mix_commit_carrier": passes},
                      wire="int8", carrier_resident=True)
        del s_c
        torch.cuda.empty_cache()
        # (d) the composed ledger op-point on the card
        ops.reset_launch_counts()
        rec_d = ledger_audit.run(device=DEVICE)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        log(json.dumps({"leg": "(d) ledger audit", "totals": rec_d["totals"],
                        "in_flight_final": rec_d["in_flight_final"],
                        "conservation": rec_d["conservation"],
                        "dispositions_exercised":
                            rec_d["dispositions_exercised"],
                        "leak_oracles": [
                            (o["leak"], o["caught"], o["violated_laws"])
                            for o in rec_d["leak_oracles"]],
                        "obs_off_matches_obs_run":
                            rec_d["obs_off_matches_obs_run"],
                        "launches": {k: v for k, v in counts.items() if v},
                        "wall_s": rec_d["wall_s"], "card": card}))
        if not ledger_audit.ok(rec_d):
            raise SmokeError("(d) the ledger op-point's gates fail")
        if not counts["fused_mix_commit_gated"]:
            raise SmokeError("(d) the gated kernel 1 never launched")
    finally:
        torch.use_deterministic_algorithms(was)
        reg.close()
    # the bucket of every silence 0..2^20 on the card against the CPU's
    # (the JAX expression: log(s) / log(2) in float32, floored)
    s = torch.arange(0, 2 ** 20 + 1, dtype=torch.float32)
    b_card = obs_device.silence_bucket(s.to(DEVICE)).cpu()
    b_cpu = obs_device.silence_bucket(s)
    diff = torch.nonzero(b_card != b_cpu).flatten()[:8]
    at = [[int(i), int(b_card[i]), int(b_cpu[i])] for i in diff]
    log(json.dumps({"silence_bucket_card_vs_cpu_mismatches":
                    int((b_card != b_cpu).sum()), "at": at, "card": card}))
    # the H100's logf puts s = 8192 in its exact bucket, 13, where the
    # CPU's float32 quotient (and so the reference) lands one low; any
    # other difference is a drift of the card's logf
    if any(m != [8192, 13, 12] for m in at):
        raise SmokeError(f"silence buckets differ from the CPU's at {at}, "
                         "beyond the known s = 8192 (card 13, CPU 12)")

    # (e) the telemetry's overhead on the flagship pass: obs off and on
    # in one process, pass by pass on the same batches (the host's drift
    # between processes is tens of ms), then each profiled
    ops.reset_launch_counts()
    over = obs_overhead.measure_pair("resnet18", OBS_TIMED, DEVICE,
                                     warmup=OBS_WARMUP, profile=OBS_PROFILED)
    counts = ops.launch_counts()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    off, on = over["obs_off"], over["obs_on"]
    log(json.dumps({"leg": "(e) overhead, EventGraD masked f32",
                    "timed_passes": OBS_TIMED, "profiled_passes":
                    OBS_PROFILED, **over,
                    "launches_added_per_pass":
                        on["launches_per_pass"] - off["launches_per_pass"],
                    "device_busy_ms_added_per_pass":
                        on["device_busy_ms_per_pass"]
                        - off["device_busy_ms_per_pass"],
                    "off_windows_spread_ms":
                        max(off["device_busy_ms_per_pass_windows"])
                        - min(off["device_busy_ms_per_pass_windows"]),
                    "card": card}))
    if on["host_syncs_per_pass"] != off["host_syncs_per_pass"]:
        raise SmokeError(f"(e) host syncs per pass {off['host_syncs_per_pass']}"
                         f" (off) != {on['host_syncs_per_pass']} (on)")

    # (f) the registry: the trace, the bubble, the report, the gauges
    trace_path = os.path.join(tmp, "trace.json")
    reg.write_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    roots = [e for e in events if e["name"] == "train"]
    if len(roots) != 1:
        raise SmokeError(f"(f) {len(roots)} train spans, expected 1")
    root = roots[0]
    for e in events:
        if e["name"] != "train" and not (
                root["ts"] - 1 <= e["ts"]
                and e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1):
            raise SmokeError(f"(f) span {e['name']} outside the train span")
    names = {e["name"] for e in events}
    if not {"data", "dispatch_block", "block_ready", "obs_flush"} <= names:
        raise SmokeError(f"(f) spans {sorted(names)}")
    d = bubble.decompose(events)
    log(bubble.render_text(d, label="(a) eventgrad-f32, obs on"))
    if d["n_blocks"] != OBS_EPOCHS or "missing_spans" in d:
        raise SmokeError(f"(f) bubble {d}")
    hist = load_history_jsonl(jsonl)
    report = build_report(hist)
    if len(hist) != OBS_EPOCHS or not report["message_lifecycle"]["audit"][
            "ok"]:
        raise SmokeError("(f) the report from (a)'s JSONL")
    log(render_text(report))
    log("\n".join(ln for ln in reg.prometheus_text().splitlines()
                   if "ledger" in ln))
    log(json.dumps({"obs_phase_launches": {k: v for k, v in totals.items()
                                           if v},
                    "obs_phase_s": time.perf_counter() - t_phase,
                    "card": card}))
    return totals


#: the cost model's steps: (tag, model name, algo), each on the flagship
#: op-point (Ring(8), SGD lr 0.01 momentum 0.9, the adaptive trigger)
COSTMODEL_STEPS = (
    ("resnet18-eventgrad", "resnet18", "eventgrad"),
    ("resnet18-dpsgd", "resnet18", "dpsgd"),
    ("resnet50-eventgrad", "resnet50", "eventgrad"),
    ("transformer-d256-eventgrad", "transformer-d256", "eventgrad"),
)
#: passes each cost-model step is timed over (CUDA events, after the
#: traced pass and one more)
COSTMODEL_TIMED = 4


def _costmodel_step(model_name, algo, cfg):
    """(model, state, x, y, per rank, flash shape or None) of one cost-model
    step on the card: the ResNets in bf16 at 32 images a rank (global
    batch 256), the LM at Gemma-2B's attention width (dim 2048, 8 heads of
    256, 2 layers, float32, flash attention) at 4 sequences of 1024
    tokens a rank."""
    import numpy as np
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset

    topo = egt.Ring(RANKS)
    if model_name.startswith("resnet"):
        model = egt.MODEL_REGISTRY[model_name](dtype=torch.bfloat16)
        per_rank, shape = 32, (32, 32, 3)
        x, y = synthetic_dataset(RANKS * per_rank * 8, shape, seed=0)
        flash = None
    else:
        model = egt.TransformerLM(**LM_D256, attn="flash", device=DEVICE)
        per_rank, shape = 4, (LM_D256["max_len"],)
        toks = np.random.default_rng(0).integers(
            0, LM_D256["vocab"], (RANKS * per_rank * 8,) + shape)
        x, y = toks, np.roll(toks, -1, axis=-1)
        flash = FLASH_SHAPE_D256
    state = egt.init_train_state(model, shape, topo, algo, cfg, seed=0,
                                 momentum=0.9, device=DEVICE)
    return model, topo, state, x, y, per_rank, flash


def phase_costmodel():
    """The cost model on the card (`obs/costmodel.py`): one step each of
    the ResNet-18 flagship (EventGraD and D-PSGD), ResNet-50 (EventGraD)
    and the transformer at Gemma-2B's attention width (EventGraD, the
    flash kernels' wide form) traced by `analyze_step`, then timed over
    COSTMODEL_TIMED more passes (CUDA events); per step the analytic
    FLOPs and bytes, their phase split, the step time, the MFU and the
    roofline against `device_spec()`. Fails unless `device_spec()` is the
    H100 row, the phases sum to the totals, each traced kernel op's
    FLOPs and bytes are its closed form (`ops/work.py`, the kernels'
    bounds) times its calls, and every MFU and roofline share lies in
    (0, 1]. Returns the launches of each kernel."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.obs import costmodel
    from eventgrad_tpu_torch.obs.devicespec import H100, device_spec
    from eventgrad_tpu_torch.ops import work
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.train.steps import make_train_step
    from eventgrad_tpu_torch.utils import flops as flops_lib
    from eventgrad_tpu_torch.utils import profiling

    card = nvidia_smi("name,power.limit")
    log(f"== costmodel: analytic FLOPs / bytes, MFU and roofline ({card})")
    spec = device_spec()
    if spec is not H100:
        raise SmokeError(f"device_spec() is {spec.name}, not the H100 row")
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    totals = {}
    for tag, model_name, algo in COSTMODEL_STEPS:
        model, topo, state, x, y, per_rank, flash = _costmodel_step(
            model_name, algo, cfg)
        n = RANKS * arena_spec(model).n_total
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cm = costmodel.analyze_step(model, topo, algo, cfg, x, y, per_rank,
                                    state, fused_sgd=(0.01, 0.9))
        trace_s = time.perf_counter() - t0
        step = make_train_step(model, topo, algo, cfg, fused_sgd=(0.01, 0.9))
        batches = [costmodel.step_batch(x[i * RANKS * per_rank:],
                                        y[i * RANKS * per_rank:], topo,
                                        per_rank, DEVICE)
                   for i in range(COSTMODEL_TIMED + 1)]
        timed_out = profiling.timed_steps(step, state, batches, warmup=1)
        del timed_out["state"]
        torch.cuda.synchronize()
        for k, v in ops.launch_counts().items():
            # the LM's flash launches run the wide form: its records
            k += "_d256" if k.startswith("flash_") else ""
            totals[k] = totals.get(k, 0) + v
        step_s = timed_out["step_ms_p50"] / 1e3
        # the phases reproduce the totals
        for key, field in (("flops_total", "flops"),
                           ("hbm_bytes_total", "hbm_bytes")):
            got = sum(p[field] for p in cm["by_phase"].values())
            if got != cm[key]:
                raise SmokeError(f"{tag}: phases sum to {got} {field}, "
                                 f"the total is {cm[key]}")
        # each kernel op: calls x its closed form
        want_ops = (("eg::masked_wire", "eg::fused_mix_commit")
                    if algo == "eventgrad" else ("eg::fused_mix_sgd",))
        if flash is not None:
            want_ops += ("eg::flash_fwd", "eg::flash_dq", "eg::flash_dkv")
        if set(cm["kernels"]) != set(want_ops):
            raise SmokeError(f"{tag}: traced kernel ops "
                             f"{sorted(cm['kernels'])}, expected "
                             f"{sorted(want_ops)}")
        for op, k in cm["kernels"].items():
            kernel = op[len("eg::"):]
            one = (work.flash(kernel, flash, 4) if kernel.startswith("flash")
                   else work.tail(kernel, n, NB))
            if (k["flops"], k["hbm_bytes"]) != (k["calls"] * one[0],
                                                k["calls"] * one[1]):
                raise SmokeError(f"{tag}: {op} charged {k}, its closed "
                                 f"form is {one} a call")
        rl = costmodel.roofline(cm["flops_total"], cm["hbm_bytes_total"],
                                step_s, spec)
        mfu = flops_lib.mfu(cm["flops_total"], step_s)
        if mfu is None or abs(mfu - rl["mfu"]) > 1e-12 * rl["mfu"]:
            raise SmokeError(f"{tag}: utils.flops.mfu {mfu} disagrees with "
                             f"the roofline's {rl['mfu']}")
        for what in ("mfu", "roofline_frac"):
            if not 0.0 < rl[what] <= 1.0:
                raise SmokeError(f"{tag}: {what} {rl[what]} outside (0, 1]")
        log(json.dumps({"costmodel": tag, "card": card,
                        "flops_total": cm["flops_total"],
                        "hbm_bytes_total": cm["hbm_bytes_total"],
                        "by_phase": cm["by_phase"],
                        "kernels": cm["kernels"],
                        "dot_flops": cm["dot_flops"],
                        "conv_flops": cm["conv_flops"],
                        "n_eqns": cm["n_eqns"], "trace_s": trace_s,
                        "step": timed_out,
                        "block": costmodel.record_block(cm, rl)}))
        del model, state, step, batches, cm
        torch.cuda.empty_cache()
    return totals


#: the membership phase's op-point: the resume phase's (2 passes an
#: epoch at 8 ranks and at 7), 6 epochs, one rank leaving after epoch 2
#: and a newcomer joining after epoch 4
MEMB_EPOCHS, MEMB_SCHEDULE = 6, "leave=1@2,join=1@4"


def phase_membership():
    """Elastic membership on the flagship (ResNet-18 in bf16, global batch
    256 over the live ranks, under deterministic algorithms): EventGraD
    and D-PSGD under `leave=1@2,join=1@4` over 6 epochs of 2 passes, the
    joins streamed through `<checkpoint_dir>/bootstrap`; each run again
    without a checkpoint_dir (the join handed over in memory) must be
    bitwise the first (every state tensor and the records). Kernels 1 and
    2 (EventGraD) and 4 (D-PSGD) must launch once every pass of every
    epoch, at 8 rows and at 7; the transitions must be the schedule's,
    every loss finite. Then the EventGraD run cut at each transition's
    epoch (the state train() returns is the post-transition one): one
    more pass of the rebuilt step fires every leaf on every rank, the
    exact forced count. Returns the launches of each kernel."""
    import math
    import os
    import shutil
    import tempfile
    import warnings

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.chaos.membership import MembershipSchedule
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.train.steps import make_train_step

    card = nvidia_smi("name,power.limit")
    log(f"== membership: ResNet-18 (bf16 compute) x Ring(8) -> Ring(7) -> "
        f"Ring(8), {MEMB_SCHEDULE}, {RESUME_STEPS} passes x {MEMB_EPOCHS} "
        f"epochs ({card})")
    spec = arena_spec(egt.ResNet18())
    kernels = {"eventgrad": ("masked_wire", "fused_mix_commit"),
               "dpsgd": ("fused_mix_sgd",)}
    ranks_by_epoch = [8, 8, 7, 7, 8, 8]
    totals = {}
    was = torch.are_deterministic_algorithms_enabled()
    was_bench = torch.backends.cudnn.benchmark
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    root = tempfile.mkdtemp(prefix="eg-membership-")
    try:
        for algo in ("eventgrad", "dpsgd"):
            runs = []
            for ck in (os.path.join(root, algo), None):
                per_epoch = []

                def on_epoch(rec, per_epoch=per_epoch):
                    torch.cuda.synchronize()
                    per_epoch.append(dict(ops.launch_counts()))

                ops.reset_launch_counts()
                t0 = time.perf_counter()
                state, hist = _resume_train(
                    ck, epochs=MEMB_EPOCHS, algo=algo, save_every=0,
                    membership=MEMB_SCHEDULE, on_epoch=on_epoch)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                for k, v in ops.launch_counts().items():
                    totals[k] = totals.get(k, 0) + v
                runs.append((state, hist))
                what = f"{algo} ({'bootstrap dir' if ck else 'in memory'})"
                if [h["active_ranks"] for h in hist] != ranks_by_epoch:
                    raise SmokeError(f"{what}: active ranks "
                                     f"{[h['active_ranks'] for h in hist]}")
                if any(h["steps"] < 2 for h in hist):
                    raise SmokeError(f"{what}: fewer than 2 passes an epoch")
                if not all(math.isfinite(h["loss"]) for h in hist):
                    raise SmokeError(f"{what}: a loss is not finite")
                tr = [(h["epoch"], t["kind"], t["index"], t["n_ranks_after"],
                       bool(t.get("bootstrap_streamed")))
                      for h in hist for t in h.get("membership_transitions",
                                                   ())]
                want_tr = [(3, "leave", 1, 7, False),
                           (5, "join", 1, 8, ck is not None)]
                if tr != want_tr:
                    raise SmokeError(f"{what}: transitions {tr}, the "
                                     f"schedule's are {want_tr}")
                if hist[0]["membership"] != MembershipSchedule.parse(
                        MEMB_SCHEDULE).to_dict():
                    raise SmokeError(f"{what}: the schedule rider differs")
                prev = {}
                for h, counts in zip(hist, per_epoch):
                    for k in kernels[algo]:
                        got = counts.get(k, 0) - prev.get(k, 0)
                        if got != h["steps"]:
                            raise SmokeError(
                                f"{what}: {k} launched {got} times in epoch "
                                f"{h['epoch']} at {h['active_ranks']} ranks, "
                                f"{h['steps']} passes")
                    prev = counts
                log(json.dumps({"leg": f"membership {what}", "card": card,
                                "wall_s": wall,
                                "steps": [h["steps"] for h in hist],
                                "epoch_wall_s": [h["wall_s"] for h in hist],
                                "loss": [h["loss"] for h in hist],
                                "msgs_saved_pct": [h.get("msgs_saved_pct")
                                                   for h in hist],
                                "transitions": hist[2].get(
                                    "membership_transitions", [])
                                + hist[4].get("membership_transitions", []),
                                "launches": {k: per_epoch[-1].get(k, 0)
                                             for k in kernels[algo]}}))
            _tree_bits(runs[0][0], runs[1][0],
                       f"membership {algo}: the replay")
            _same_records(runs[0][1], runs[1][1],
                          f"membership {algo}: the replay")
            del runs
            torch.cuda.empty_cache()
        # the forced fire after each transition, on the run's own state
        cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                              max_silence=50)
        x, y = synthetic_dataset(RANKS * RESUME_PER_RANK * RESUME_STEPS,
                                 (32, 32, 3), seed=0)
        for cut, n_after in ((2, 7), (4, 8)):
            ops.reset_launch_counts()
            with warnings.catch_warnings():
                # the cut run leaves the later event unapplied, knowingly
                warnings.simplefilter("ignore", RuntimeWarning)
                state, _ = _resume_train(None, epochs=cut, save_every=0,
                                         membership=MEMB_SCHEDULE)
            topo = egt.Ring(n_after)
            if state.params.shape[0] != n_after:
                raise SmokeError(f"cut at {cut}: {state.params.shape[0]} "
                                 f"rows, expected {n_after}")
            step = make_train_step(egt.ResNet18(dtype=torch.bfloat16), topo,
                                   "eventgrad", cfg, fused_sgd=(0.01, 0.9))
            before = state.event.num_events.clone()
            b = n_after * RESUME_PER_RANK
            xb = torch.as_tensor(x[:b]).reshape(
                (n_after, RESUME_PER_RANK, 32, 32, 3)).to(DEVICE)
            yb = torch.as_tensor(y[:b]).long().reshape(
                (n_after, RESUME_PER_RANK)).to(DEVICE)
            state, m = step(state, (xb, yb))
            fired = (state.event.num_events - before).cpu()
            want = NB * spec.n_leaves
            torch.cuda.synchronize()
            for k, v in ops.launch_counts().items():
                totals[k] = totals.get(k, 0) + v
            if fired.tolist() != [want] * n_after:
                raise SmokeError(f"cut at {cut}: the first pass after the "
                                 f"transition fired {fired.tolist()} "
                                 f"messages a rank, the forced count is "
                                 f"{want} on each of {n_after}")
            log(json.dumps({"leg": f"membership forced fire after epoch "
                            f"{cut}", "ranks": n_after,
                            "messages_per_rank": want, "card": card}))
            del state, step, m
    finally:
        torch.use_deterministic_algorithms(was)
        torch.backends.cudnn.benchmark = was_bench
        shutil.rmtree(root, ignore_errors=True)
    return totals


#: the command-line phase: the CIFAR-10 files it writes (five training
#: batches of CLI_RECORDS records, a test batch of as many: 5 passes an
#: epoch at global batch 256 on Ring(8)), the flagship's argv through
#: `python -m eventgrad_tpu_torch.cli` and its three legs
CLI_RECORDS = 256
CLI_FLAGSHIP = ["--model", "resnet18", "--mesh", "ring:8", "--global-batch",
                "256", "--lr", "0.01", "--momentum", "0.9", "--horizon",
                "1.05", "--warmup-passes", "2", "--epochs", "2", "--dataset",
                "cifar10"]
#: (leg, its flags, the kernels it must launch once a pass); the bound on
#: silence is an event algorithm's flag (the CLI refuses it for D-PSGD)
CLI_LEGS = (
    ("cli-eventgrad", ["--algo", "eventgrad", "--max-silence", "50"],
     ("masked_wire", "fused_mix_commit")),
    ("cli-dpsgd", ["--algo", "dpsgd"], ("fused_mix_sgd",)),
    ("cli-eventgrad-int8-carrier",
     ["--algo", "eventgrad", "--max-silence", "50", "--wire", "int8",
      "--carrier-resident"],
     ("masked_wire_int8", "fused_mix_commit_carrier")),
)
#: the LM leg: the main path's first transformer width (dim 512, 8
#: heads of 64, T = 1024) at 2 layers, 16 sequences a rank (64 held ~40
#: GiB of activations, more than the card spares beside the other
#: streams), one pass
CLI_LM = ["--model", "transformer", "--attn", "flash", "--dim", "512",
          "--heads", "8", "--layers", "2", "--seq-len", "1024", "--mesh",
          "ring:8", "--n-synth", "128", "--batch-size", "16",
          "--epochs", "1"]
#: the supervised drills: the MLP on MNIST idx files the phase writes
CLI_DRILL = ["--algo", "eventgrad", "--mesh", "ring:4", "--model", "mlp",
             "--dataset", "mnist", "--epochs", "3", "--batch-size", "8",
             "--warmup-passes", "2", "--save-every", "1"]
#: seconds without a heartbeat before the supervisor kills the hang
#: drill's child (a child's first heartbeat, its log file, comes after its
#: torch import and CUDA start, which share the host with the phase and
#: the two other streams of phases: the crash drill's 60)
CLI_HANG_TIMEOUT = 60


def _write_cifar_bins(root, x_u8, y, n_files):
    """CIFAR-10 binary batches of NHWC uint8 images: a label byte and the
    CHW bytes per record; `n_files` == 1 writes test_batch.bin."""
    import numpy as np

    per = len(x_u8) // n_files
    names = (["test_batch.bin"] if n_files == 1 else
             [f"data_batch_{i}.bin" for i in range(1, n_files + 1)])
    for i, name in enumerate(names):
        xs, ys = x_u8[i * per:(i + 1) * per], y[i * per:(i + 1) * per]
        rec = np.concatenate(
            [ys.astype(np.uint8)[:, None],
             xs.transpose(0, 3, 1, 2).reshape(len(xs), -1)], axis=1)
        (root / name).write_bytes(np.ascontiguousarray(rec).tobytes())


def _write_mnist_idx(root, rng, n, prefix):
    import numpy as np

    imgs = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = rng.integers(0, 10, n).astype(np.uint8)
    for arr, kind, magic in ((imgs, "images-idx3", 2051),
                             (labs, "labels-idx1", 2049)):
        head = magic.to_bytes(4, "big") + b"".join(
            d.to_bytes(4, "big") for d in arr.shape)
        (root / f"{prefix}-{kind}-ubyte").write_bytes(head + arr.tobytes())


def _cli_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _run_cli(argv):
    """`eventgrad_tpu_torch.cli.main(argv)` in this process, its echo of
    the records kept out of this script's output (they are in the log)."""
    import contextlib
    import io

    from eventgrad_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        return cli.main(argv)


def _final_snapshot(ck):
    from eventgrad_tpu_torch.utils import checkpoint

    found = checkpoint.latest(str(ck / "ckpt"))
    if found is None:
        raise SmokeError(f"no snapshot under {ck}")
    raw, meta = checkpoint.peek(found, device="cpu")
    return raw, meta


def _same_snapshot(a, b, what):
    (ra, ma), (rb, mb) = a, b
    if ma["epoch"] != mb["epoch"]:
        raise SmokeError(f"{what}: epochs {ma['epoch']} / {mb['epoch']}")
    _flat_bits(ra, rb, what)


def phase_cli():
    """The port started the way the system starts: the command line and
    the supervisor, on files written to disk.

    (d) first: the native data library (`data/native.py`) builds from the
    checkout's source under `build/`; `available()` and
    `jpeg_supported()` are printed, and with libjpeg 64 JPEGs the phase
    writes are decoded through `load_cifar10_jpeg_dir` (without it, a line
    says this leg did not run and why). (c) starts at once beside the
    rest, as subprocesses on the card: the MLP on MNIST idx files the
    phase writes, uninterrupted through `python -m
    eventgrad_tpu_torch.cli`, with `--fault-inject crash:1` under `python
    -m eventgrad_tpu_torch.supervise --timeout 60 --max-restarts 2`, and
    with `hang:1` under a supervisor with a CLI_HANG_TIMEOUT timeout that
    must kill it; each resumed run's last snapshot must be bitwise the
    uninterrupted one's (CUBLAS_WORKSPACE_CONFIG inherited from `main`),
    its log epochs 1-3 and a final record. (a) the flagship through
    `cli.main` in this process: full-width ResNet-18, Ring(8), global
    batch 256, lr 0.01 momentum 0.9, horizon 1.05, max silence 50, warmup
    2, 2 epochs on `--dataset cifar10 --data-dir D` (D: five binary
    batches of CLI_RECORDS records and a test batch, written here; the
    loaded arrays bitwise the bytes times the reader's float32 1/255),
    legs EventGraD (kernels 1, 2), D-PSGD (kernel 4) and EventGraD on the
    int8 carrier (kernels 3, 5): each kernel launched once a pass (the
    counters zeroed just before each leg and read just after), the bytes
    exact, one record an epoch and a final one with a test accuracy.
    (b) the LM through the CLI (PR 3's width at 2 layers, 8 ranks x 64
    sequences of 1024, one EventGraD pass): the flash kernels' launches
    by form, forward once per layer per pass and per test pass (the
    epoch's and the final evaluation), dQ and dK/dV once per layer per
    pass, all on the float32 D = 64 form, and kernels 1 and 2 once a
    pass. Returns the launches of each kernel."""
    import os
    import shutil
    import tempfile
    import threading

    import numpy as np
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.data import native
    from eventgrad_tpu_torch.data.datasets import (
        CIFAR10_CLASSES, load_cifar10_jpeg_dir, load_or_synthesize,
        synthetic_dataset,
    )
    from eventgrad_tpu_torch.ops import attention as fa
    from eventgrad_tpu_torch.ops import flash_plan

    card = nvidia_smi("name,power.limit")
    root = Path(tempfile.mkdtemp(prefix="eg-cli-"))
    totals = {}
    drills = {}
    try:
        # (d) the data library, built from this checkout's source
        t0 = time.perf_counter()
        ok, jpeg = native.available(), native.jpeg_supported()
        build_s = time.perf_counter() - t0
        lib = native.library_path()
        log(json.dumps({"leg": "cli data library", "available": ok,
                        "jpeg_supported": jpeg, "library": str(lib),
                        "load_s": build_s, "card": card}))
        if not ok:
            raise SmokeError(f"the native data library did not build: "
                             f"{native.build_error()}")
        if HERE / "build" not in lib.parents and not os.environ.get(
                "EG_TORCH_BUILD_DIR"):
            raise SmokeError(f"the data library is at {lib}, not under "
                             f"{HERE / 'build'}")

        # (c) the supervised drills, started now, read at the end
        mn = root / "mnist"
        mn.mkdir()
        rng = np.random.default_rng(0)
        _write_mnist_idx(mn, rng, 512, "train")
        _write_mnist_idx(mn, rng, 128, "t10k")
        env = dict(os.environ, PYTHONPATH=str(HERE))
        drill = CLI_DRILL + ["--data-dir", str(mn), "--device", DEVICE]

        def launch(tag, pre, extra):
            d = root / tag
            d.mkdir()
            cmd = [sys.executable, "-m", *pre] + drill + [
                "--checkpoint-dir", str(d / "ck"), "--log-file",
                str(d / "log.jsonl")] + extra
            t_start = time.perf_counter()
            proc = subprocess.Popen(cmd, env=env, cwd=str(HERE),
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE, text=True)
            box = {"proc": proc, "dir": d}

            def wait():
                _, box["err"] = proc.communicate(timeout=900)
                box["wall_s"] = time.perf_counter() - t_start

            box["thread"] = threading.Thread(target=wait, daemon=True)
            box["thread"].start()
            drills[tag] = box

        launch("straight", ["eventgrad_tpu_torch.cli"], [])
        launch("crash", ["eventgrad_tpu_torch.supervise", "--timeout", "60",
                         "--max-restarts", "2", "--"],
               ["--fault-inject", "crash:1"])
        launch("hang", ["eventgrad_tpu_torch.supervise", "--timeout",
                        str(CLI_HANG_TIMEOUT), "--max-restarts", "1",
                        "--backoff-base", "0", "--"],
               ["--fault-inject", "hang:1"])

        if jpeg:
            jd = root / "jpeg"
            img_rng = np.random.default_rng(1)
            for c, cls in enumerate(CIFAR10_CLASSES[:8]):
                (jd / "train" / cls).mkdir(parents=True)
                for i in range(8):
                    native.save_jpeg(
                        str(jd / "train" / cls / f"{i:04d}.jpg"),
                        img_rng.integers(0, 256, (32, 32, 3)).astype(
                            np.uint8), 92)
            t0 = time.perf_counter()
            xj, yj = load_cifar10_jpeg_dir(str(jd), "train")
            dec_s = time.perf_counter() - t0
            if xj.shape != (64, 32, 32, 3) or yj.tolist() != [
                    c for c in range(8) for _ in range(8)]:
                raise SmokeError(f"JPEG tree: {xj.shape}, labels "
                                 f"{yj.tolist()}")
            if not (np.isfinite(xj).all() and 0.0 <= xj.min()
                    and xj.max() <= 1.0):
                raise SmokeError("JPEG tree: pixels outside [0, 1]")
            log(json.dumps({"leg": "cli jpeg tree", "images": 64,
                            "decode_s": dec_s, "card": card}))
        else:
            log("cli jpeg tree: NOT RUN — the data library was built "
                "without libjpeg (<jpeglib.h> not found by the compiler "
                "on this machine); the JPEG leg needs it")

        # (a) the flagship through the command line, on CIFAR-10 files
        cf = root / "cifar"
        cf.mkdir()
        x, y = synthetic_dataset(5 * CLI_RECORDS, (32, 32, 3), seed=0)
        xt, yt = synthetic_dataset(CLI_RECORDS, (32, 32, 3), seed=0,
                                   split="test")
        to_u8 = lambda a: np.clip(np.rint(a * 48.0 + 128.0), 0,
                                  255).astype(np.uint8)
        x_u8, xt_u8 = to_u8(x), to_u8(xt)
        _write_cifar_bins(cf, x_u8, y, 5)
        _write_cifar_bins(cf, xt_u8, yt, 1)
        inv = np.float32(1) / np.float32(255)
        for split, xs, ys in (("train", x_u8, y), ("test", xt_u8, yt)):
            got_x, got_y = load_or_synthesize("cifar10", str(cf), split)
            want_x = xs.astype(np.float32) * inv
            if (got_x.shape != want_x.shape
                    or got_x.tobytes() != want_x.tobytes()
                    or got_y.tolist() != ys.tolist()):
                raise SmokeError(f"cifar10 {split}: the loaded arrays are "
                                 "not the bytes written times float32 "
                                 "1/255")
        spec_n, leaves = FLAGSHIP_PARAMS, 86
        # 2 epochs of (5 files x CLI_RECORDS) / 8 ranks / 32 a rank
        want_passes = 2 * (5 * CLI_RECORDS // RANKS // 32)
        for leg, extra, must in CLI_LEGS:
            logf = root / f"{leg}.jsonl"
            argv = CLI_FLAGSHIP + ["--data-dir", str(cf), "--log-file",
                                   str(logf), "--device", DEVICE] + extra
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rc = _run_cli(argv)
            if DEVICE == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            recs = _cli_records(logf)
            hist = [r for r in recs if "epoch" in r]
            if rc != 0 or [r.get("epoch") for r in recs] != [1, 2, None] \
                    or not recs[-1].get("final") \
                    or not math.isfinite(recs[-1].get("accuracy", math.nan)):
                raise SmokeError(f"{leg}: rc {rc}, records "
                                 f"{[r.get('epoch') for r in recs]}, last "
                                 f"{recs[-1] if recs else None}")
            passes = sum(r["steps"] for r in hist)
            if passes != want_passes or any(counts[k] != passes
                                            for k in must):
                raise SmokeError(f"{leg}: launches {counts} over {passes} "
                                 f"passes, expected {must} once a pass")
            if not all(math.isfinite(r["loss"]) for r in hist):
                raise SmokeError(f"{leg}: a loss is not finite")
            rec = {"leg": leg, "card": card, "wall_s": wall,
                   "passes": passes,
                   "step_ms": [1e3 * r["wall_s"] / r["steps"] for r in hist],
                   "loss": [r["loss"] for r in hist],
                   "test_accuracy": [r.get("test_accuracy") for r in hist],
                   "final_accuracy": recs[-1]["accuracy"],
                   "sent_bytes_per_step_per_chip":
                       hist[-1]["sent_bytes_per_step_per_chip"],
                   "sent_bytes_wire_real_per_step_per_chip":
                       hist[-1]["sent_bytes_wire_real_per_step_per_chip"],
                   "launches": {k: counts[k] for k in must}}
            if "int8" in leg:
                if any(r["sent_bytes_wire_real_per_step_per_chip"]
                       != EVENTGRAD_INT8_WIRE_REAL for r in hist) or any(
                        r["resident_dtype"] != "int8" for r in hist):
                    raise SmokeError(f"{leg}: wire-real / resident "
                                     f"{rec}, expected "
                                     f"{EVENTGRAD_INT8_WIRE_REAL} on int8")
                rec["msgs_saved_pct"] = hist[-1]["msgs_saved_pct"]
            else:
                _check_dense_bytes(leg, extra[1], hist, spec_n, leaves, rec)
            log(json.dumps(rec))
            torch.cuda.empty_cache() if DEVICE == "cuda" else None

        # (b) the LM through the command line
        logf = root / "cli-lm.jsonl"
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rc = _run_cli(CLI_LM + ["--log-file", str(logf), "--device", DEVICE])
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, forms = ops.launch_counts(), fa.form_counts()
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        recs = _cli_records(logf)
        hist = [r for r in recs if "epoch" in r]
        from eventgrad_tpu_torch import cli

        lm = cli.build_parser().parse_args(CLI_LM)
        layers = lm.layers
        passes = sum(r["steps"] for r in hist)
        form = flash_plan.flash_form("float32", lm.dim // lm.heads, (), ())
        # the LM trains EventGraD (the CLI's default algo): kernels 1 and
        # 2 once a pass beside the flash kernels
        want = {"flash_fwd": layers * (passes + len(hist) + 1),
                "flash_dq": layers * passes, "flash_dkv": layers * passes}
        gossip = {"masked_wire": passes, "fused_mix_commit": passes}
        if rc != 0 or not recs or not recs[-1].get("final") or passes < 1:
            raise SmokeError(f"cli-lm: rc {rc}, records {recs}")
        if any(counts[k] != n or forms[k][form] != n
               for k, n in want.items()) or any(
                counts[k] != n for k, n in gossip.items()):
            raise SmokeError(f"cli-lm: launches {counts} by form {forms}, "
                             f"expected {want} on {form} and {gossip}")
        if not all(math.isfinite(r["loss"]) for r in hist):
            raise SmokeError("cli-lm: a loss is not finite")
        log(json.dumps({"leg": "cli-lm", "card": card, "wall_s": wall,
                        "passes": passes, "loss": [r["loss"] for r in hist],
                        "final_accuracy": recs[-1]["accuracy"],
                        "launches": {**want, **gossip}, "forms": {
                            k: forms[k] for k in want}}))

        # (c) read the drills
        for tag, box in drills.items():
            box["thread"].join(timeout=900)
            if box["thread"].is_alive():
                raise SmokeError(f"drill {tag}: still running")
            rc = box["proc"].returncode
            err = box.get("err") or ""
            if rc != 0:
                raise SmokeError(f"drill {tag}: exit {rc}\n{err[-3000:]}")
            epochs = [r.get("epoch") for r in _cli_records(
                box["dir"] / "log.jsonl")]
            if epochs != [1, 2, 3, None]:
                raise SmokeError(f"drill {tag}: log epochs {epochs}")
            if tag == "crash" and "attempt 1 failed (exit code 13)" \
                    not in err:
                raise SmokeError(f"drill crash: no crash seen\n{err[-2000:]}")
            if tag == "hang" and "no heartbeat on" not in err:
                raise SmokeError(f"drill hang: no kill seen\n{err[-2000:]}")
        straight = _final_snapshot(drills["straight"]["dir"] / "ck")
        for tag in ("crash", "hang"):
            _same_snapshot(_final_snapshot(drills[tag]["dir"] / "ck"),
                           straight, f"drill {tag}: the resumed snapshot")
        log(json.dumps({"leg": "cli supervised drills", "card": card,
                        "wall_s": {t: b["wall_s"] for t, b in drills.items()},
                        "hang_timeout_s": CLI_HANG_TIMEOUT,
                        "resumed_bitwise": True}))
    finally:
        for box in drills.values():
            if box["proc"].poll() is None:
                box["proc"].kill()
        shutil.rmtree(root, ignore_errors=True)
    return totals


#: the hybrid legs' model: the d128 LM legs' width (Pythia-1.4B's
#: d_model 2048, 16 heads of 128), 2 layers, T = 1024, vocab 256, float32
HYBRID_LM = dict(vocab=256, dim=2048, n_heads=16, n_layers=2, max_len=1024)
#: (leg, mesh, model, algo, sequences a data rank, entry point); the
#: mesh's dp axis gossips (two neighbours), sp is a replicated aux axis,
#: tp/pp/ep shard the model
HYBRID_LEGS = (
    ("hybrid-ring", "dp:4,sp:2", "ring", "eventgrad", 4, "train"),
    ("hybrid-ring-dpsgd", "dp:4,sp:2", "ring", "dpsgd", 4, "train"),
    ("hybrid-tp", "dp:4,tp:2", "tp", "eventgrad", 4, "cli"),
    ("hybrid-pp", "dp:4,pp:2", "pp", "eventgrad", 4, "train"),
    ("hybrid-moe", "dp:2,ep:4", "moe", "eventgrad", 2, "train"),
)
#: the passes held against the CPU, cut so the CPU's plain versions over
#: every rank's full-width arena fit the phase (the legs' own passes take
#: 19 s of it, the CPU passes at full depth took 172 s on the H100's
#: host): one sequence of this many tokens a data rank (the pipeline leg
#: one a microbatch), the model at 1 layer (the pipeline leg at 2, one a
#: stage), the width and the mesh the leg's. The ring legs' flash hops
#: are held uncut, on the card (`_hybrid_ring_check`)
HYBRID_REF_TOKENS = 32
#: the reference's passes, at warmup 1: the main ring leg takes a
#: second, whose fire bits come from the trigger (a pass costs 17-42 s
#: of the host's time at full width), the others one; each pass's
#: update is held leaf by leaf to this share of the leaf's largest
#: (`_reference_steps`)
HYBRID_REF_PASSES = {"hybrid-ring": 2}
HYBRID_UPDATE_RTOL = 1e-3
#: arena-sized copies alive at an EventGraD step's peak: the state's
#: parameters, trace and two receive buffers, the gradient, two received
#: candidates and the tail's three outputs (two new buffers, p', t'),
#: and two more transients of the hybrid gradient correction
HYBRID_COPIES = 12


def _hybrid_model(kind, topo, n_layers=None):
    from eventgrad_tpu_torch.models.moe import MoETransformerLM
    from eventgrad_tpu_torch.models.pp import PPTransformerLM
    from eventgrad_tpu_torch.models.tp import TPTransformerLM
    from eventgrad_tpu_torch.models.transformer import TransformerLM

    lm = dict(HYBRID_LM, n_layers=n_layers or HYBRID_LM["n_layers"])
    if kind in ("ring", "ulysses"):
        return TransformerLM(**lm, attn=kind, topo=topo, sp_axis="sp",
                             use_flash=True)
    if kind == "tp":
        return TPTransformerLM(**lm, tp_size=topo.axis_size("tp"))
    if kind == "pp":
        return PPTransformerLM(**lm, pp_size=topo.axis_size("pp"),
                               n_micro=4)
    return MoETransformerLM(**lm, n_experts=8, ep_size=topo.axis_size("ep"),
                            n_select=2, capacity_factor=2.0)


def _hybrid_ring_check(topo, per_rank):
    """Ring attention through the flash kernels against plain attention
    over each dp group's whole sequence, on the card at the ring legs'
    shape: `[R, per_rank, T / sp, heads, 128]` q, k and v as strided
    views of one fused projection, causal, each rank's (q_offset,
    k_offset) from its place on the `sp` axis of the 2-D grid; the
    output and the three gradients within phase_flash_kernels' float32
    tolerances. Returns the largest error."""
    import torch

    from eventgrad_tpu_torch.parallel.ring_attention import (
        full_attention, ring_attention,
    )

    n_dp, n_sp = topo.axis_size("dp"), topo.axis_size("sp")
    h = HYBRID_LM["n_heads"]
    d = HYBRID_LM["dim"] // h
    t = HYBRID_LM["max_len"] // n_sp
    r, b = topo.n_ranks, per_rank
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    qkv = torch.randn((r, b, t, 3 * h, d), generator=gen,
                      device=DEVICE).requires_grad_()
    q, k, v = qkv.split(h, dim=3)
    w = torch.randn((r, b, t, h, d), generator=gen, device=DEVICE)

    def whole(z):
        # [dp x sp, B, T/sp, H, D] -> [dp x B, T, H, D]: rank (i, j)
        # holds positions [j T/sp, (j+1) T/sp) of dp group i's sequences
        z = z.reshape((n_dp, n_sp, b, t) + tuple(z.shape[3:]))
        return z.transpose(1, 2).reshape((n_dp * b, n_sp * t)
                                         + tuple(z.shape[4:]))

    t0 = time.perf_counter()
    got = ring_attention(q, k, v, topo, axis="sp", causal=True,
                         use_flash=True)
    g_got = torch.autograd.grad(got, qkv, w)[0]
    want = full_attention(whole(q), whole(k), whole(v), causal=True)
    g_want = torch.autograd.grad(want, qkv, whole(w))[0]
    errs = [within(whole(got), want, 2e-5, 2e-5, "hybrid ring: out")]
    for i, g in enumerate(("dq", "dk", "dv")):
        sl = slice(i * h, (i + 1) * h)
        errs.append(within(g_got[:, :, :, sl], g_want[:, :, :, sl], 5e-5,
                           5e-4, f"hybrid ring: {g}"))
    torch.cuda.synchronize()
    log(f"hybrid ring attention (flash hops) vs full attention on the "
        f"card: {topo.shape} grid, [{r}, {b}, {t}, {h}, {d}] shards, "
        f"causal, max_abs_err out {errs[0]:.3e}, dq {errs[1]:.3e}, dk "
        f"{errs[2]:.3e}, dv {errs[3]:.3e} "
        f"({time.perf_counter() - t0:.2f} s)")
    del qkv, got, g_got, want, g_want
    torch.cuda.empty_cache()
    return max(errs)


def phase_hybrid_reference():
    """The hybrid legs' passes held against the CPU (module docstring,
    phase 17), in a phase of their own so that they run beside other
    phases: their time is the host's. Returns no launches (the legs
    count theirs)."""
    import os

    import numpy as np
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.cli import parse_mesh
    from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset
    from eventgrad_tpu_torch.data.sharding import expand_to_mesh

    card = nvidia_smi("name,power.limit")
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=1,
                          max_silence=50)
    tol = dict(rtol=1e-4, atol=1e-5)
    # half the host's cores: the other streams keep the rest busy
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // 2))
    log("== hybrid references: each leg's passes on the card against the "
        f"CPU, 1 layer (the pipeline leg 2), {HYBRID_REF_TOKENS} tokens a "
        "data rank")
    for leg, mesh, kind, algo, _, _ in HYBRID_LEGS:
        topo = parse_mesh(mesh)
        # passes held against the CPU from the same state, cut
        # (HYBRID_REF_TOKENS)
        n_data, n_ref = topo.n_data_ranks, HYBRID_REF_PASSES.get(leg, 1)
        ref_b = 4 if kind == "pp" else 1
        xr, yr = synthetic_lm_dataset(n_data * ref_b * n_ref,
                                      HYBRID_REF_TOKENS,
                                      HYBRID_LM["vocab"], seed=5)
        shard = lambda a: a.reshape((n_data, n_ref, ref_b, -1)).astype(
            np.int64)
        xb, yb = expand_to_mesh(shard(xr), shard(yr), topo)
        t_ref = time.perf_counter()
        ref = _reference_steps(
            leg, _hybrid_model(kind, topo, 2 if kind == "pp" else 1), algo,
            {}, cfg, [(xb[:, i], yb[:, i]) for i in range(n_ref)], tol,
            topo=topo, update_rtol=HYBRID_UPDATE_RTOL)
        log(json.dumps({"leg": f"{leg} reference", "mesh": mesh,
                        "algo": algo, "passes": n_ref,
                        "reference_s": time.perf_counter() - t_ref,
                        "max_abs_err": ref.pop("max_abs_err"),
                        "update": ref, "card": card}))
        torch.cuda.empty_cache()
    torch.set_num_threads(threads)
    return {}


def phase_hybrid():
    """EventGraD over the hybrid meshes at full width (module docstring,
    phase 17). Returns the launches of each kernel summed over the legs
    (the flash kernels under their "_d128" names)."""
    import tempfile

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.cli import parse_mesh
    from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset
    from eventgrad_tpu_torch.ops import attention as fa
    from eventgrad_tpu_torch.ops import flash_plan
    from eventgrad_tpu_torch.parallel.arena import arena_spec
    from eventgrad_tpu_torch.utils.metrics import msgs_saved_pct

    steps, epochs = 2, 2
    cfg = egt.EventConfig(adaptive=True, horizon=1.05, warmup_passes=2,
                          max_silence=50)
    seq, vocab = HYBRID_LM["max_len"], HYBRID_LM["vocab"]
    form = flash_plan.flash_form("float32", 128, (), ())
    totals = {}
    for leg, mesh, kind, algo, per_rank, entry in HYBRID_LEGS:
        topo = parse_mesh(mesh)
        model = _hybrid_model(kind, topo)
        spec = arena_spec(model)
        n, r = spec.n_total, topo.n_ranks
        n_sp = topo.axis_size("sp") if "sp" in topo.axes else 1
        copy_gib = 4 * n * r / 2**30
        log(f"== hybrid {leg}: {type(model).__name__} on {mesh} ({algo}), "
            f"{n:,} parameters in {spec.n_leaves} leaves a rank; one "
            f"arena {copy_gib:.2f} GiB, reckoned peak ~{HYBRID_COPIES} "
            f"arenas = {HYBRID_COPIES * copy_gib:.1f} GiB plus activations "
            f"({per_rank} sequences of {seq} a data rank, {seq // n_sp} "
            f"tokens a rank)")

        ring_err = (_hybrid_ring_check(topo, per_rank)
                    if kind == "ring" else None)
        n_data = topo.n_data_ranks
        x, y = synthetic_lm_dataset(n_data * per_rank * steps, seq, vocab,
                                    seed=0)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if entry == "cli":
            (HERE / "build").mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
                path = Path(tmp) / "records.jsonl"
                argv = ["--algo", algo, "--mesh", mesh, "--model",
                        "transformer_tp", "--dim", str(HYBRID_LM["dim"]),
                        "--heads", str(HYBRID_LM["n_heads"]), "--layers",
                        str(HYBRID_LM["n_layers"]), "--seq-len", str(seq),
                        "--vocab", str(vocab), "--n-synth",
                        str(n_data * per_rank * steps), "--epochs",
                        str(epochs), "--batch-size", str(per_rank), "--lr",
                        "0.01", "--momentum", "0.9", "--horizon", "1.05",
                        "--warmup-passes", "2", "--max-silence", "50",
                        "--random-sampler", "--log-file", str(path),
                        "--device", DEVICE]
                if _run_cli(argv) != 0:
                    raise SmokeError(f"{leg}: cli.main exited non-zero")
                recs = _cli_records(path)
            hist, final = recs[:-1], recs[-1]
            if not (final.get("final") and final.get("consensus_eval")
                    is False and final["loss"] == hist[-1]["loss"]):
                raise SmokeError(f"{leg}: final record {final}")
            passes = hist[-1]["epoch"] * hist[-1]["steps"]
            params_ok = True
        else:
            state, hist = egt.train(
                model, topo, x, y, algo=algo, epochs=epochs,
                batch_size=per_rank, learning_rate=0.01, momentum=0.9,
                event_cfg=cfg, random_sampler=True, seed=0, device=DEVICE)
            passes = state.pass_num
            params_ok = bool(torch.isfinite(state.params).all())
            if tuple(state.params.shape) != (r, n):
                raise SmokeError(f"{leg}: arena {tuple(state.params.shape)}")
            del state
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in hist]
        if passes != steps * epochs or len(hist) != epochs:
            raise SmokeError(f"{leg}: {passes} passes, {len(hist)} records")
        if not all(math.isfinite(v) for v in losses) or not params_ok:
            raise SmokeError(f"{leg}: loss {losses}, params finite "
                             f"{params_ok}")
        if not losses[-1] < losses[0]:
            raise SmokeError(f"{leg}: the loss did not fall: {losses}")
        must = (("masked_wire", "fused_mix_commit") if algo == "eventgrad"
                else ("fused_mix_sgd",))
        if any(counts[k] != passes for k in must):
            raise SmokeError(f"{leg}: launches {counts}, expected "
                             f"{passes} of each of {must}")
        if kind == "ring":
            # one forward, dQ and dK/dV a hop: n_sp hops a layer a pass
            want = HYBRID_LM["n_layers"] * n_sp * passes
            if any(counts[k] != want
                   for k in ("flash_fwd", "flash_dq", "flash_dkv")):
                raise SmokeError(f"{leg}: flash launches {counts}, "
                                 f"expected {want} each")
            forms = fa.form_counts()
            for k in ("flash_fwd", "flash_dq", "flash_dkv"):
                if forms[k][form] != counts[k]:
                    raise SmokeError(f"{leg}: {k} by form {forms[k]}, "
                                     f"expected all in {form}")
        rec = {"leg": leg, "mesh": mesh, "algo": algo, "passes": passes,
               "loss": losses, "train_acc": hist[-1]["train_acc"],
               "step_ms": 1e3 * hist[-1]["wall_s"] / hist[-1]["steps"],
               "first_epoch_step_ms":
                   1e3 * hist[0]["wall_s"] / hist[0]["steps"],
               "leg_wall_s": wall, "ring_flash_max_abs_err": ring_err, "peak_mem_gib": peak,
               "sent_bytes_per_step_per_chip":
                   hist[-1]["sent_bytes_per_step_per_chip"],
               "sent_bytes_wire_real_per_step_per_chip":
                   hist[-1]["sent_bytes_wire_real_per_step_per_chip"],
               "launches": {k: v for k, v in counts.items() if v}}
        # the dp gossip alone: two neighbours (`_check_dense_bytes`)
        _check_dense_bytes(leg, algo, hist, n, spec.n_leaves, rec)
        if algo == "eventgrad":
            for j, h in enumerate(hist, start=1):
                want = msgs_saved_pct(h["num_events"], j * steps,
                                      spec.n_leaves, NB, r)
                if h["msgs_saved_pct"] != want:
                    raise SmokeError(f"{leg}: msgs_saved_pct "
                                     f"{h['msgs_saved_pct']} != {want}")
        log(json.dumps(rec))
        for k, v in counts.items():
            key = k + ("_d128" if k.startswith("flash_") else "")
            totals[key] = totals.get(key, 0) + v
        del model
        torch.cuda.empty_cache()
    return totals


#: the device-mesh lift's flagship leg (phase 18 (a)): the CLI's argv
#: of the ResNet-18 op-point at 2 passes an epoch (the CLI builds the
#: model in float32: it has no compute-dtype flag, nor has the JAX one)
MESH_FLAGSHIP = ["--mesh", "ring:8", "--model", "resnet18", "--dataset",
                 "cifar10", "--n-synth", "512", "--global-batch", "256",
                 "--epochs", "2", "--lr", "0.01", "--momentum", "0.9",
                 "--horizon", "1.05", "--warmup-passes", "2",
                 "--random-sampler"]


def _mesh_flagship(algo):
    """The flagship argv of one algorithm (max silence 50 bounds the
    event trigger; the CLI refuses it for D-PSGD)."""
    return MESH_FLAGSHIP + ["--algo", algo] + (
        ["--max-silence", "50"] if algo == "eventgrad" else [])
MESH_PASSES = 4
#: leg (a), one epoch (two passes) of the mesh from the simulator's state
#: against the simulator's (`PERF.md` §6, the mesh lift; the card, at these
#: shapes): the parameters' relative norm error 9.0e-6 to 1.23e-5 and
#: largest 4.03e-5, the trace's 2.3e-3 to 3.5e-3 and 4.03e-3, the loss
#: per pass within 4e-7 of itself; an exchange with the ±2 neighbours in
#: the second epoch moves the parameters 2.9e-4 (EventGraD) to 4.0e-3
#: (D-PSGD), the trace 7.1e-2 to 0.59, the loss 1.5e-4 to 1.6e-2
MESH_PARAMS_TOL = dict(atol=2e-4, rtol=1e-4, rel_norm=5e-5)
MESH_TRACE_TOL = dict(atol=2e-2, rtol=0.0, rel_norm=1e-2)
MESH_LOSS_RTOL = 1e-5
#: the sp:2,dp:4 ring-attention leg (b), at the hybrid phase's width, its
#: depth cut to 1 of the 2 layers to keep the phase near its budget (at
#: 2 layers the leg took 56 s of children, 4.8 s a pass, most of it the
#: sp gradient mean's 1.66 GB a process through pinned host memory)
MESH_LM_MESH = "sp:2,dp:4"
MESH_LM_LAYERS = 1
MESH_LM_TOL = dict(atol=1e-5, rtol=1e-4)
#: how leg (a)'s children start the command line: what `python -m
#: eventgrad_tpu_torch.cli ARGS` runs (`runpy`, the module as __main__),
#: after the deterministic switches this process sets for the simulator
#: (a launcher's preamble; the CLI has no flag for them)
MESH_CLI = ("import runpy, sys, torch; "
            "torch.use_deterministic_algorithms(True, warn_only=True); "
            "torch.backends.cudnn.benchmark = False; "
            "sys.argv = ['eventgrad_tpu_torch.cli'] + sys.argv[1:]; "
            "runpy.run_module('eventgrad_tpu_torch.cli', run_name='__main__',"
            " alter_sys=True)")
#: seconds a child of the phase may take before the phase fails
MESH_CHILD_TIMEOUT = 420
#: the transports the legs must name: two processes sharing the card
#: stage through pinned host memory for gloo; one process takes NCCL
MESH_SHARED, MESH_NCCL = "gloo-host", "nccl"


#: leg (a)'s algorithms
MESH_ALGOS = ("eventgrad", "dpsgd")
#: leg (d), the flagship under the fault clauses: each algorithm's argv
#: beside leg (a)'s. EventGraD: drops, flips in transit and a poisoned
#: rank at pass 3 (inside the epoch held), under the in-step riders (the
#: checksums and the quarantine; a mesh refuses the sentinel and its
#: rollback, as the JAX loop does) and the edge freeze; D-PSGD (the JAX
#: step refuses it flips and poison): drops and the freeze
MESH_CHAOS = {
    "eventgrad": ["--chaos", "drop=0.1,seed=3,bitflip=0.25,nanstep=2@3",
                  "--integrity",
                  "checksum=1,quarantine=1,sentinel=0,rollback=0",
                  "--chaos-freeze-after", "60"],
    "dpsgd": ["--chaos", "drop=0.1,seed=3", "--chaos-freeze-after", "60"],
}
#: leg (d)'s record keys held equal to the simulator's, beside (a)'s
MESH_CHAOS_KEYS = {
    "eventgrad": ["chaos_drops", "edge_silence_max", "wire_rejects",
                  "quarantined_steps"],
    "dpsgd": ["chaos_drops", "edge_silence_max"],
}
#: leg (a) on the mesh's data path on both sides: the loop's bound on a
#: device-resident dataset set to 0 bytes keeps the simulator on host
#: batches, as every multi-process run is
MESH_HOST_DATA = ("EG_DEVICE_DATA_MAX_BYTES", "0")


def _mesh_flagship_stage(root, algo, stage, side, proc=0, chaos=False):
    """Leg (a)'s argv (with `chaos`, leg (d)'s: MESH_CHAOS's fault
    clauses beside it) for epoch `stage` on `side` ("mesh" or "sim"; its
    snapshots under `root / ck-{side}{stage}-{algo}`, the algorithm
    tagged "-chaos" for leg (d)): epoch 1 from the seed, epoch 2 resumed
    from the snapshot there (the simulator's epoch 1, copied in by the
    phase)."""
    tag = f"{side}{stage}-{algo}" + ("-chaos" if chaos else "")
    return (_mesh_flagship(algo) + (MESH_CHAOS[algo] if chaos else [])
            + ["--device", DEVICE, "--pipeline", "off",
               "--checkpoint-dir", str(root / f"ck-{tag}"),
               "--log-file", str(root / f"{tag}-{proc}.jsonl")]
            + (["--epochs", "1"] if stage == 1 else ["--resume"]))


def _mesh_flagship_procs(root, algo, stage, chaos=False):
    """Leg (a)'s (with `chaos`, leg (d)'s) two CLI processes for epoch
    `stage`: [(Popen, output path)]."""
    port, procs = _free_port(), []
    tag = algo + ("-chaos" if chaos else "")
    for p in (0, 1):
        argv = [sys.executable, "-c", MESH_CLI,
                *_mesh_flagship_stage(root, algo, stage, "mesh", p, chaos),
                "--backend", "mesh", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "2", "--process-id", str(p)]
        out = root / f"mesh{stage}-{tag}-{p}.out"
        with open(out, "w") as fh:
            procs.append((subprocess.Popen(
                argv, stdout=fh, stderr=subprocess.STDOUT, cwd=str(HERE),
                env=dict(_mesh_env(), **dict([MESH_HOST_DATA]))), out))
    return procs


def _mesh_flagship_epoch(root, algo, stage, spec, chaos=False):
    """Leg (a)'s (with `chaos`, leg (d)'s) epoch `stage`: the mesh's
    record and snapshot against the simulator's (module docstring, phase
    18); what was measured."""
    import torch

    tag = algo + ("-chaos" if chaos else "")
    what = f"mesh ({'d' if chaos else 'a'}) {algo} epoch {stage}"
    if (root / f"mesh{stage}-{tag}-1.jsonl").exists():
        raise SmokeError(f"{what}: process 1 wrote a log")
    mesh = _cli_records(root / f"mesh{stage}-{tag}-0.jsonl")
    sim = _cli_records(root / f"sim{stage}-{tag}-0.jsonl")
    mh, sh = mesh[:-1], sim[:-1]
    if ([h.get("epoch") for h in mh] != [stage]
            or [h.get("epoch") for h in sh] != [stage]):
        raise SmokeError(f"{what}: records {mesh} / {sim}")
    (a, b), final = (mh[0], sh[0]), mesh[-1]
    if (a.get("transport") != MESH_SHARED
            or a.get("mesh_processes") != 2):
        raise SmokeError(f"{what}: first record {a}")
    keys = ["sent_bytes_per_step_per_chip",
            "sent_bytes_wire_real_per_step_per_chip"]
    if algo == "eventgrad":
        keys += ["num_events", "msgs_saved_pct"]
    if chaos:
        keys += MESH_CHAOS_KEYS[algo]
    if any(a[k] != b[k] for k in keys):
        raise SmokeError(f"{what}: {a} vs {b}")
    loss_err = abs(a["loss"] - b["loss"])
    if not loss_err <= MESH_LOSS_RTOL * abs(b["loss"]):
        raise SmokeError(f"{what}: loss {a['loss']} vs {b['loss']}")
    launches = final.get("kernel_launches", {})
    must = (("masked_wire", "fused_mix_commit")
            if algo == "eventgrad" else ("fused_mix_sgd",))
    if chaos:
        # every pass through the gated tail: the quarantine operand rides
        # every EventGraD pass, the delivery gate every D-PSGD one
        must += (("fused_mix_commit_gated",) if algo == "eventgrad"
                 else ("fused_mix_sgd_gated",))
    passes = MESH_PASSES // 2
    if any(launches.get(k) != 2 * passes for k in must):
        raise SmokeError(f"{what}: launches {launches}, expected "
                         f"{2 * passes} of {must}")
    (got, gm), (want, wm) = (_final_snapshot(root / f"ck-{side}{stage}-"
                                             f"{tag}")
                             for side in ("mesh", "sim"))
    if gm["epoch"] != stage or wm["epoch"] != stage:
        raise SmokeError(f"{what}: snapshots at epochs {gm['epoch']} / "
                         f"{wm['epoch']}")
    if got["state/params"].shape != (RANKS, spec.n_total):
        raise SmokeError(f"{what}: snapshot "
                         f"{tuple(got['state/params'].shape)}")
    errs = {}
    try:
        for k, tol in (("state/params", MESH_PARAMS_TOL),
                       ("state/trace", MESH_TRACE_TOL)):
            g, w = got[k].to(DEVICE), want[k].to(DEVICE)
            errs[k] = [within(g, w, what=f"{what}: {k}", **tol),
                       rel_norm_err(g, w)]
            del g, w
        for k, w in want.items():
            if not w.is_floating_point() and not torch.equal(got[k], w):
                raise SmokeError(f"{what}: {k} differs")
    except SmokeError:
        log(json.dumps({"leg": f"mesh-a-{algo}", "epoch": stage,
                        "snapshot_diff": _snapshot_diffs(got, want, spec)}))
        raise
    return {"epoch": stage, "transport": a["transport"],
            "loss": a["loss"], "sim_loss": b["loss"], "loss_abs_err": loss_err,
            **({k: a[k] for k in MESH_CHAOS_KEYS[algo]} if chaos else {}),
            "params_max_abs_err": errs["state/params"][0],
            "params_rel_norm_err": errs["state/params"][1],
            "trace_max_abs_err": errs["state/trace"][0],
            "trace_rel_norm_err": errs["state/trace"][1],
            "step_ms": 1e3 * a["wall_s"] / a["steps"],
            "sim_step_ms": 1e3 * b["wall_s"] / b["steps"],
            "peak_mem_gib": final.get("peak_mem_gib"),
            "bytes_wire_real": a[keys[1]],
            "num_events": a.get("num_events"),
            "msgs_saved_pct": a.get("msgs_saved_pct"),
            "launches": launches}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_env():
    """The children's environment: this checkout on the path, no group
    variables, and TF32 off in cuBLAS and cuDNN (NVIDIA_TF32_OVERRIDE=0,
    the counterpart of the toolchain phase's switches in this process:
    float32 work stays float32 on both sides of a comparison)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(HERE), NVIDIA_TF32_OVERRIDE="0")
    for k in ("EG_COORDINATOR", "EG_NUM_PROCESSES", "EG_PROCESS_ID"):
        env.pop(k, None)
    return env


def _mesh_child(code, out):
    """A child of this phase: `python -c code` from this checkout, its
    output to the file `out`."""
    with open(out, "w") as fh:
        return subprocess.Popen([sys.executable, "-c", code], stdout=fh,
                                stderr=subprocess.STDOUT, cwd=str(HERE),
                                env=_mesh_env())


def _finish_children(procs, what):
    """Wait for every child; kill them all as soon as one fails (its
    group's peers would wait for it) or one passes the timeout, and
    raise."""
    t_end = time.perf_counter() + MESH_CHILD_TIMEOUT
    try:
        while True:
            rcs = [p.poll() for p, _ in procs]
            for rc, (_, out) in zip(rcs, procs):
                if rc not in (None, 0):
                    tail = Path(out).read_text()[-3000:]
                    raise SmokeError(f"{what}: a child exited {rc}:\n{tail}")
            if all(rc == 0 for rc in rcs):
                return
            if time.perf_counter() > t_end:
                raise SmokeError(
                    f"{what}: a child passed {MESH_CHILD_TIMEOUT} s")
            time.sleep(0.2)
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _child_json(out, key):
    for line in Path(out).read_text().splitlines():
        if line.startswith("{") and f'"{key}"' in line:
            return json.loads(line)
    raise SmokeError(f"no {key} line in {out}")


def _snapshot_diffs(got, want, spec):
    """What differs between two snapshots: each tensor's largest |got -
    want| (a count of unequal elements for integer tensors), and the five
    leaves of the parameter arena that differ most, each with its
    largest |p|."""
    out = {}
    for k, b in want.items():
        a = got[k]
        if a.shape != b.shape:
            out[k] = f"shape {tuple(a.shape)} vs {tuple(b.shape)}"
        elif a.is_floating_point():
            out[k] = float((a.double() - b.double()).abs().max()) if (
                a.numel()) else 0.0
        else:
            out[k] = int((a != b).sum())
    d, p = (got["state/params"] - want["state/params"]).abs(), \
        want["state/params"].abs()
    leaves, off = [], 0
    for name, size in zip(spec.names, spec.sizes):
        leaves.append((float(d[:, off:off + size].max()), name,
                       float(p[:, off:off + size].max())))
        off += size
    return {"tensors": {k: v for k, v in out.items() if v},
            "leaves": sorted(leaves, reverse=True)[:5]}


def _mesh_lm_data(topo):
    from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset

    return synthetic_lm_dataset(topo.n_data_ranks * 4 * 2,
                                HYBRID_LM["max_len"], HYBRID_LM["vocab"],
                                seed=0)


def _mesh_lm_train(backend, device):
    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.cli import parse_mesh

    topo = parse_mesh(MESH_LM_MESH)
    x, y = _mesh_lm_data(topo)
    return egt.train(
        _hybrid_model("ring", topo, MESH_LM_LAYERS), topo, x, y,
        algo="eventgrad", epochs=2,
        batch_size=4, learning_rate=0.01, momentum=0.9,
        event_cfg=egt.EventConfig(adaptive=True, horizon=1.05,
                                  warmup_passes=2, max_silence=50),
        random_sampler=True, seed=0, backend=backend, device=device)


def mesh_lm_child(pid, port, out, device="cuda"):
    """Leg (b)'s process `pid` of 2 (run as `python -c`): the sp:2,dp:4
    ring-attention LM on the mesh, sp outer, so every K/V hop crosses to
    the other process; prints its launches, flash forms and peak memory,
    and the primary saves the gathered parameters to `out`."""
    import torch

    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.ops import attention as fa
    from eventgrad_tpu_torch.parallel import multihost

    multihost.init(f"127.0.0.1:{port}", 2, pid, device=device)
    try:
        state, hist = _mesh_lm_train("mesh", device)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        forms = {k: dict(v) for k, v in fa.form_counts().items()}
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if device == "cuda" else 0.0)
        params = multihost.to_host(state.params)
        if multihost.is_primary():
            torch.save(params.cpu(), out)
        print(json.dumps({"mesh_lm_child": pid, "launches": counts,
                          "forms": forms, "peak_mem_gib": peak,
                          "hist": hist}), flush=True)
    finally:
        multihost.shutdown()


def mesh_nccl_child(port, device="cuda"):
    """Leg (c) (run as `python -c`): a one-process NCCL group holding all
    8 rows of the MLP on Ring(8), allreduce and EventGraD, each against
    the simulator in this process, bitwise (every state tensor and
    record but the timing and the mesh's riders)."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.data.datasets import synthetic_dataset
    from eventgrad_tpu_torch.parallel import multihost
    from eventgrad_tpu_torch.train import state as state_lib

    multihost.init(f"127.0.0.1:{port}", 1, 0, device=device)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        x, y = synthetic_dataset(8 * 32 * 2, (28, 28, 1), seed=0)
        out = {"mesh_nccl_child": 0, "legs": {}}
        for algo in ("allreduce", "eventgrad"):
            kw = dict(algo=algo, epochs=2, batch_size=32, learning_rate=0.05,
                      event_cfg=egt.EventConfig(adaptive=True, horizon=1.05,
                                                warmup_passes=2),
                      random_sampler=True, seed=0)
            ref, ref_hist = egt.train(egt.MLP(), egt.Ring(8), x, y,
                                      backend="sim", device=device, **kw)
            ops.reset_launch_counts()
            got, hist = egt.train(egt.MLP(), egt.Ring(8), x, y,
                                  backend="mesh", device=device, **kw)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            a, b = state_lib.to_flat(ref), state_lib.to_flat(got)
            differ = sorted(k for k in a if not torch.equal(a[k], b[k]))
            drop = ("wall_s", "transport", "mesh_processes")
            records_differ = sorted({
                k for a, b in zip(ref_hist, hist) for k in set(a) | set(b)
                if k not in drop and a.get(k) != b.get(k)})
            out["legs"][algo] = {
                "transport": hist[0].get("transport"), "differ": differ,
                "records_differ": records_differ, "launches": counts,
                "passes": got.pass_num,
                "num_events": hist[-1].get("num_events")}
        print(json.dumps(out), flush=True)
    finally:
        multihost.shutdown()


def _mesh_switches():
    """Put this process, the simulator's side, under the mesh children's
    switches and on the mesh's schedule (the serial one, host data):
    deterministic algorithms, no cuDNN autotuning, no device-resident
    dataset. Returns the function that restores what was."""
    import os

    import torch

    was = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    was_bench = torch.backends.cudnn.benchmark
    was_data = os.environ.get(MESH_HOST_DATA[0])
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.benchmark = False
    os.environ[MESH_HOST_DATA[0]] = MESH_HOST_DATA[1]

    def restore():
        torch.use_deterministic_algorithms(was, warn_only=was_warn)
        torch.backends.cudnn.benchmark = was_bench
        if was_data is None:
            os.environ.pop(MESH_HOST_DATA[0], None)
        else:
            os.environ[MESH_HOST_DATA[0]] = was_data
    return restore


def phase_mesh():
    """The device-mesh lift on the card (module docstring, phase 18).
    Returns the children's launches of each kernel."""
    import shutil
    import tempfile

    import torch

    from eventgrad_tpu_torch.models import ResNet18
    from eventgrad_tpu_torch.ops import flash_plan
    from eventgrad_tpu_torch.parallel.arena import arena_spec

    card = nvidia_smi("name,power.limit")
    spec = arena_spec(ResNet18())
    (HERE / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="eg-mesh-", dir=HERE / "build"))
    totals = {}

    def add(counts, suffix=""):
        for k, v in counts.items():
            key = k + (suffix if k.startswith("flash_") else "")
            totals[key] = totals.get(key, 0) + v

    torch.cuda.empty_cache()
    restore = _mesh_switches()
    # leg (d)'s processes, started before the checks of (a)-(c)
    chaos = []
    try:
        # (a) epoch 1 of the flagship, two processes on the card through
        # the CLI, and (c) the one-process NCCL group beside them (with
        # the simulator in this process: ~40 GiB on the card)
        t0 = time.perf_counter()
        stage1 = {algo: _mesh_flagship_procs(root, algo, 1)
                  for algo in MESH_ALGOS}
        nccl_out = root / "nccl.out"
        nccl = [(_mesh_child(
            f"import chip_smoke as c; c.mesh_nccl_child({_free_port()}, "
            f"{DEVICE!r})", nccl_out), nccl_out)]
        # the simulator epoch by epoch, and epoch 2 of the mesh from the
        # simulator's epoch-1 snapshot once its epoch 1 has ended
        stage2, t_sim = {}, 0.0
        torch.cuda.reset_peak_memory_stats()
        for algo in MESH_ALGOS:
            t = time.perf_counter()
            for stage in (1, 2):
                if stage == 2:
                    shutil.copytree(root / f"ck-sim1-{algo}",
                                    root / f"ck-sim2-{algo}")
                if _run_cli(_mesh_flagship_stage(root, algo, stage, "sim")
                            + ["--backend", "sim"]) != 0:
                    raise SmokeError(f"mesh (a) {algo}: the simulator's "
                                     f"epoch {stage} failed")
            t_sim += time.perf_counter() - t
            _finish_children(stage1[algo], f"mesh (a) {algo} epoch 1")
            shutil.copytree(root / f"ck-sim1-{algo}",
                            root / f"ck-mesh2-{algo}")
            stage2[algo] = _mesh_flagship_procs(root, algo, 2)
        sim_peak = torch.cuda.max_memory_allocated() / 2**30
        _finish_children([c for v in stage2.values() for c in v] + nccl,
                         "mesh children")
        t_children = time.perf_counter() - t0
        # (b) the sp:2,dp:4 ring-attention LM's two processes once (a)'s
        # have ended: beside them (2 x 14 GiB more) the card's 80 GB ran
        # out at (a)'s busiest moment
        t_lm = time.perf_counter()
        port = _free_port()
        lm = [(_mesh_child(f"import chip_smoke as c; c.mesh_lm_child("
                           f"{p}, {port}, {str(root / 'lm.pt')!r}, "
                           f"{DEVICE!r})",
                           root / f"lm-{p}.out"), root / f"lm-{p}.out")
              for p in (0, 1)]
        # (d)'s simulator here meanwhile: the flagship's two epochs under
        # the faults, each algorithm, and the mesh's copies of epoch 1
        d_sim = _mesh_chaos_sims(root)
        _finish_children(lm, "mesh (b) children")
        t_lm = time.perf_counter() - t_lm
        # (d): the mesh's epoch 2 under the faults, both algorithms'
        # processes at once, beside (b)'s simulator here below
        t_d = time.perf_counter()
        chaos.extend(c for algo in MESH_ALGOS
                     for c in _mesh_flagship_procs(root, algo, 2, chaos=True))

        # (c): bitwise the simulator in the child, through NCCL
        nccl = _child_json(nccl_out, "mesh_nccl_child")
        for algo, leg in nccl["legs"].items():
            if (leg["transport"] != MESH_NCCL or leg["differ"]
                    or leg["records_differ"]
                    or leg["passes"] != MESH_PASSES):
                raise SmokeError(f"mesh (c) {algo}: {leg}")
            kernel = "fused_mix_sgd" if algo == "allreduce" else "masked_wire"
            if leg["launches"].get(kernel) != leg["passes"]:
                raise SmokeError(f"mesh (c) {algo}: launches "
                                 f"{leg['launches']}")
            add(leg["launches"])
        log(json.dumps({"leg": "mesh-c-nccl", "legs": nccl["legs"],
                        "card": card}))

        # (a): each epoch against the simulator's from the same state
        for algo in MESH_ALGOS:
            rec = {"leg": f"mesh-a-{algo}", "processes": 2, "epochs": [],
                   "tol": {"params": MESH_PARAMS_TOL,
                           "trace": MESH_TRACE_TOL,
                           "loss_rtol": MESH_LOSS_RTOL},
                   "sim_peak_mem_gib": sim_peak, "children_s": t_children,
                   "sim_s": t_sim, "concurrent": "every child of (a) "
                   "and (c), and the simulator", "card": card}
            for stage in (1, 2):
                rec["epochs"].append(_mesh_flagship_epoch(root, algo, stage,
                                                          spec))
                add(rec["epochs"][-1].pop("launches"))
            log(json.dumps(rec))
        torch.cuda.empty_cache()

        # (b): its simulator in this process
        kids = [_child_json(out, "mesh_lm_child") for _, out in lm]
        torch.cuda.reset_peak_memory_stats()
        t_sim = time.perf_counter()
        state, sim_hist = _mesh_lm_train(None, DEVICE)
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t_sim
        sim_peak = torch.cuda.max_memory_allocated() / 2**30
        got = torch.load(root / "lm.pt").to(state.params.device)
        err = within(got, state.params, what="mesh (b): parameters",
                     **MESH_LM_TOL)
        hist = kids[0]["hist"]
        if hist[0].get("transport") != MESH_SHARED:
            raise SmokeError(f"mesh (b): first record {hist[0]}")
        for a, b in zip(hist, sim_hist):
            for k in ("num_events", "msgs_saved_pct",
                      "sent_bytes_per_step_per_chip",
                      "sent_bytes_wire_real_per_step_per_chip"):
                if a[k] != b[k]:
                    raise SmokeError(f"mesh (b): {k} {a[k]} != {b[k]}")
        form = flash_plan.flash_form("float32", 128, (), ())
        for kid in kids:
            # each process: one forward, dQ and dK/dV a hop, two hops a
            # layer, on its four rows
            want = MESH_LM_LAYERS * 2 * MESH_PASSES
            for k in ("flash_fwd", "flash_dq", "flash_dkv"):
                if (kid["launches"].get(k) != want
                        or kid["forms"][k].get(form) != want):
                    raise SmokeError(f"mesh (b): {k} launches "
                                     f"{kid['launches']} forms "
                                     f"{kid['forms'][k]}, expected {want}")
            for k in ("masked_wire", "fused_mix_commit"):
                if kid["launches"].get(k) != MESH_PASSES:
                    raise SmokeError(f"mesh (b): {k} {kid['launches']}")
            add(kid["launches"], "_d128")
        log(json.dumps({
            "leg": "mesh-b-ring-lm", "mesh": MESH_LM_MESH,
            "transport": hist[0]["transport"], "processes": 2,
            "params_max_abs_err": err, "tol": MESH_LM_TOL,
            "step_ms": 1e3 * hist[-1]["wall_s"] / hist[-1]["steps"],
            "sim_step_ms": 1e3 * sim_hist[-1]["wall_s"]
            / sim_hist[-1]["steps"],
            "peak_mem_gib": [k["peak_mem_gib"] for k in kids],
            "sim_peak_mem_gib": sim_peak,
            "num_events": hist[-1]["num_events"],
            "msgs_saved_pct": hist[-1]["msgs_saved_pct"],
            "launches": [k["launches"] for k in kids],
            "children_s": t_lm, "sim_s": t_sim,
            "concurrent": "its two processes, with (d)'s simulator in "
            "this process; its simulator beside (d)'s processes",
            "card": card}))
        del state, got
        torch.cuda.empty_cache()

        # (d): epoch 2 under the faults against the simulator's
        _finish_children(chaos, "mesh (d) children")
        t_d = time.perf_counter() - t_d
        for algo in MESH_ALGOS:
            rec = _mesh_flagship_epoch(root, algo, 2, spec, chaos=True)
            # the record keeps the launches, summed over the processes
            add(rec["launches"])
            log(json.dumps({
                "leg": f"mesh-d-{algo}-chaos", "processes": 2,
                "chaos": MESH_CHAOS[algo], "epoch": rec,
                "tol": {"params": MESH_PARAMS_TOL, "trace": MESH_TRACE_TOL,
                        "loss_rtol": MESH_LOSS_RTOL},
                "sim_peak_mem_gib": d_sim[1], "children_s": t_d,
                "sim_s": d_sim[0], "concurrent": "both algorithms' "
                "processes, (b)'s simulator in this process; the "
                "simulator beside (b)'s processes", "card": card}))
    finally:
        for p, _ in chaos:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
        restore()
    return totals


def _mesh_chaos_sims(root):
    """Leg (d)'s simulator: each algorithm's two epochs under MESH_CHAOS's
    faults through the command line in this process, epoch 2 resumed from
    epoch 1's snapshot, which is copied for the mesh's epoch 2 as well.
    Returns (seconds, peak GiB)."""
    import shutil

    import torch

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for algo in MESH_ALGOS:
        for stage in (1, 2):
            if stage == 2:
                shutil.copytree(root / f"ck-sim1-{algo}-chaos",
                                root / f"ck-sim2-{algo}-chaos")
            if _run_cli(_mesh_flagship_stage(root, algo, stage, "sim",
                                             chaos=True)
                        + ["--backend", "sim"]) != 0:
                raise SmokeError(f"mesh (d) {algo}: the simulator's epoch "
                                 f"{stage} failed")
        shutil.copytree(root / f"ck-sim1-{algo}-chaos",
                        root / f"ck-mesh2-{algo}-chaos")
    torch.cuda.synchronize()
    return time.perf_counter() - t, torch.cuda.max_memory_allocated() / 2**30


#: legs (e)-(h) of the mesh (phase 18): the sharded transformers and
#: Ulysses attention at the hybrid phase's width (HYBRID_LM) as two
#: processes of four rows, the sharded (or sequence) axis outer so that
#: process p holds index p of it and each of its collectives crosses the
#: process boundary: (leg, mesh, model kind, sequences a data rank,
#: entry point). Depth MESH_LM_LAYERS (the pipeline 2, one a stage: the
#: least two stages hold); the MoE leg 2 sequences a data rank as in the
#: hybrid phase
MESH_HYBRID_LEGS = (
    ("e-tp", "tp:2,dp:4", "tp", 4, "cli"),
    ("f-pp", "pp:2,dp:4", "pp", 4, "train"),
    ("g-moe", "ep:4,dp:2", "moe", 2, "train"),
    ("h-ulysses", "sp:2,dp:4", "ulysses", 4, "train"),
)
#: legs (e)-(h): 2 epochs of one pass, warmup 1, so the second pass's
#: fire bits are the trigger's
MESH_HYBRID_EPOCHS = 2
#: the collectives each of legs (e)-(h) must send across the processes
#: (`spmd.Mesh.crossed`, "collective:axis"); the dp gossip stays inside
#: a process (each holds whole dp rings)
MESH_HYBRID_CROSSED = {
    "tp": {"fold:tp"}, "pp": {"hop:pp", "fold:pp"},
    "moe": {"swap:ep", "fold:ep"}, "ulysses": {"swap:sp", "fold:sp"},
}


def _mesh_hybrid_layers(kind):
    return 2 if kind == "pp" else MESH_LM_LAYERS


def _mesh_hybrid_args(kind, per_rank):
    """Legs (e)-(h)'s training options beside the model and data."""
    import eventgrad_tpu_torch as egt

    return dict(algo="eventgrad", epochs=MESH_HYBRID_EPOCHS,
                batch_size=per_rank, learning_rate=0.01, momentum=0.9,
                event_cfg=egt.EventConfig(adaptive=True, horizon=1.05,
                                          warmup_passes=1, max_silence=50),
                random_sampler=True, seed=0)


def _mesh_hybrid_data(topo, per_rank):
    from eventgrad_tpu_torch.data.datasets import synthetic_lm_dataset

    return synthetic_lm_dataset(topo.n_data_ranks * per_rank,
                                HYBRID_LM["max_len"], HYBRID_LM["vocab"],
                                seed=0)


def _mesh_hybrid_cli_argv(mesh, per_rank, root, side, proc=0):
    """Leg (e)'s argv on `side` ("mesh" or "sim"): the TP transformer
    through the command line, its snapshot under `root / ck-e-{side}`."""
    from eventgrad_tpu_torch.cli import parse_mesh

    n = parse_mesh(mesh).n_data_ranks * per_rank
    return ["--algo", "eventgrad", "--mesh", mesh, "--model",
            "transformer_tp", "--dim", str(HYBRID_LM["dim"]), "--heads",
            str(HYBRID_LM["n_heads"]), "--layers", str(MESH_LM_LAYERS),
            "--seq-len", str(HYBRID_LM["max_len"]), "--vocab",
            str(HYBRID_LM["vocab"]), "--n-synth", str(n), "--epochs",
            str(MESH_HYBRID_EPOCHS), "--batch-size", str(per_rank), "--lr",
            "0.01", "--momentum", "0.9", "--horizon", "1.05",
            "--warmup-passes", "1", "--max-silence", "50",
            "--random-sampler", "--pipeline", "off", "--device", DEVICE,
            "--checkpoint-dir", str(root / f"ck-e-{side}"),
            "--log-file", str(root / f"e-{side}-{proc}.jsonl")]


def mesh_hybrid_child(legs, pid, port, root, device="cuda"):
    """Legs (f)-(h)'s process `pid` of 2 (run as `python -c`): each leg
    of `legs` in turn through `train` on the mesh of one two-process
    group, under the simulator's switches, its parameter rows held
    against the simulator's (`root / "<leg>-sim.pt"`, written by the
    phase before this process started) within MESH_LM_TOL; prints one
    line a leg: its launches, flash forms, peak memory, the bytes its
    collectives sent across processes, the errors and the records."""
    import gc

    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch import ops
    from eventgrad_tpu_torch.cli import parse_mesh
    from eventgrad_tpu_torch.ops import attention as fa
    from eventgrad_tpu_torch.parallel import multihost, spmd

    root = Path(root)
    multihost.init(f"127.0.0.1:{port}", 2, pid, device=device)
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
        for leg in legs:
            _, mesh_spec, kind, per_rank, _ = next(
                g for g in MESH_HYBRID_LEGS if g[0] == leg)
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            topo = parse_mesh(mesh_spec)
            mesh = spmd.build_mesh(topo, device)
            x, y = _mesh_hybrid_data(topo, per_rank)
            state, hist = egt.train(
                _hybrid_model(kind, topo, _mesh_hybrid_layers(kind)), topo,
                x, y, mesh=mesh, device=device,
                **_mesh_hybrid_args(kind, per_rank))
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            forms = {k: dict(v) for k, v in fa.form_counts().items()}
            peak = torch.cuda.max_memory_allocated() / 2**30
            want = torch.load(root / f"{leg}-sim.pt", mmap=True)[
                mesh.lo:mesh.hi].to(device)
            got = state.params
            err = within(got, want, what=f"mesh ({leg}) process {pid}: "
                         "parameters", **MESH_LM_TOL)
            diff2 = float(((got.double() - want.double()) ** 2).sum())
            want2 = float((want.double() ** 2).sum())
            print(json.dumps({
                "mesh_hybrid_child": pid, "leg": leg, "launches": counts,
                "forms": forms, "peak_mem_gib": peak,
                "crossed_bytes": {f"{k}:{a}": v
                                  for (k, a), v in mesh.crossed.items()},
                "params_max_abs_err": err, "diff2": diff2, "want2": want2,
                "hist": hist}), flush=True)
            del state, got, want
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        multihost.shutdown()


def _mesh_hybrid_sim(root, leg, mesh_spec, kind, per_rank, entry):
    """A leg of (e)-(h) on the simulator in this process (the command
    line's for (e), its snapshot kept for the check; `train` for the
    others, the parameters saved to `root / "<leg>-sim.pt"` for the
    leg's processes to read their rows): (records, seconds, peak GiB,
    the model's arena spec)."""
    import torch

    import eventgrad_tpu_torch as egt
    from eventgrad_tpu_torch.cli import parse_mesh
    from eventgrad_tpu_torch.parallel.arena import arena_spec

    topo = parse_mesh(mesh_spec)
    layers = _mesh_hybrid_layers(kind)
    model = _hybrid_model(kind, topo, layers)
    spec = arena_spec(model)
    copy_gib = 4 * spec.n_total * (topo.n_ranks // 2) / 2**30
    log(f"== mesh ({leg[0]}) {leg}: {type(model).__name__} at {layers} "
        f"layer(s) on {mesh_spec}, two processes of {topo.n_ranks // 2} "
        f"rows; {spec.n_total:,} parameters a rank; reckoned peak a "
        f"process ~{HYBRID_COPIES} arenas = {HYBRID_COPIES * copy_gib:.1f} "
        f"GiB plus activations ({per_rank} sequences of "
        f"{HYBRID_LM['max_len']} a data rank)")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    if entry == "cli":
        if _run_cli(_mesh_hybrid_cli_argv(mesh_spec, per_rank, root, "sim")
                    + ["--backend", "sim"]) != 0:
            raise SmokeError(f"mesh ({leg}): the simulator's run failed")
        hist = _cli_records(root / "e-sim-0.jsonl")[:-1]
    else:
        x, y = _mesh_hybrid_data(topo, per_rank)
        state, hist = egt.train(model, topo, x, y, device=DEVICE,
                                **_mesh_hybrid_args(kind, per_rank))
        torch.save(state.params.cpu(), root / f"{leg}-sim.pt")
        del state
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    torch.cuda.empty_cache()
    return hist, t, peak, spec, HYBRID_COPIES * copy_gib


def _mesh_hybrid_check(leg, mesh_spec, kind, per_rank, sim, got, card):
    """Hold one leg of (e)-(h) against its simulator and log it; `got`
    is (records, each process's launches, peaks, the bytes that crossed
    the processes (both processes' sends), the parameters' largest
    error, their relative norm
    error, the flash forms of each process or None, the children's
    seconds). Returns the launches."""
    from eventgrad_tpu_torch.cli import parse_mesh
    from eventgrad_tpu_torch.ops import flash_plan
    from eventgrad_tpu_torch.utils.metrics import msgs_saved_pct

    sim_hist, t_sim, sim_peak, spec, reckoned = sim
    hist, launches, peaks, crossed, err, rel, forms, t_kids = got
    # t_kids: the children's seconds, None where a pair ran several legs
    what = f"mesh ({leg})"
    r = parse_mesh(mesh_spec).n_ranks
    layers = _mesh_hybrid_layers(kind)
    if (hist[0].get("transport") != MESH_SHARED
            or hist[0].get("mesh_processes") != 2):
        raise SmokeError(f"{what}: first record {hist[0]}")
    if not len(hist) == len(sim_hist) == MESH_HYBRID_EPOCHS:
        raise SmokeError(f"{what}: records {hist} / {sim_hist}")
    for j, (a, b) in enumerate(zip(hist, sim_hist), start=1):
        for k in ("num_events", "msgs_saved_pct",
                  "sent_bytes_per_step_per_chip",
                  "sent_bytes_wire_real_per_step_per_chip"):
            if a[k] != b[k]:
                raise SmokeError(f"{what}: epoch {j} {k} {a[k]} != {b[k]}")
        if a["msgs_saved_pct"] != msgs_saved_pct(a["num_events"], j,
                                                 spec.n_leaves, NB, r):
            raise SmokeError(f"{what}: msgs_saved_pct {a}")
    # each process: kernels 1 and 2 once a pass; Ulysses' flash forward,
    # dQ and dK/dV once a layer a pass, on the float32 D = 128 form (the
    # command line's launches come summed over its two processes)
    passes = MESH_HYBRID_EPOCHS
    per = passes * (2 if len(launches) == 1 else 1)
    form = flash_plan.flash_form("float32", 128, (), ())
    for i, counts in enumerate(launches):
        for k in ("masked_wire", "fused_mix_commit"):
            if counts.get(k) != per:
                raise SmokeError(f"{what}: {k} launches {counts}, "
                                 f"expected {per}")
        if kind == "ulysses":
            for k in ("flash_fwd", "flash_dq", "flash_dkv"):
                if (counts.get(k) != layers * passes
                        or forms[i][k].get(form) != layers * passes):
                    raise SmokeError(f"{what}: {k} launches {counts}, "
                                     f"forms {forms[i][k]}, expected "
                                     f"{layers * passes}")
    if set(crossed) != MESH_HYBRID_CROSSED[kind] or not all(
            v > 0 for v in crossed.values()):
        raise SmokeError(f"{what}: crossed {crossed}, expected "
                         f"{sorted(MESH_HYBRID_CROSSED[kind])}")
    log(json.dumps({
        "leg": f"mesh-{leg}", "mesh": mesh_spec, "layers": layers,
        "sequences_a_data_rank": per_rank, "processes": 2,
        "transport": hist[0]["transport"], "params_max_abs_err": err,
        "params_rel_norm_err": rel, "tol": MESH_LM_TOL,
        "step_ms": 1e3 * hist[-1]["wall_s"] / hist[-1]["steps"],
        "sim_step_ms": 1e3 * sim_hist[-1]["wall_s"] / sim_hist[-1]["steps"],
        "peak_mem_gib": peaks, "sim_peak_mem_gib": sim_peak,
        "reckoned_arenas_gib": reckoned, "crossed_bytes": crossed,
        "num_events": hist[-1]["num_events"],
        "msgs_saved_pct": hist[-1]["msgs_saved_pct"],
        "launches": launches, "children_s": t_kids, "sim_s": t_sim,
        "concurrent": "its processes alone", "card": card}))
    totals = {}
    for counts in launches:
        for k, v in counts.items():
            key = k + ("_d128" if k.startswith("flash_") else "")
            totals[key] = totals.get(key, 0) + v
    return totals


def phase_mesh_hybrid():
    """The sharded transformers and Ulysses attention on the device-mesh
    lift (module docstring, phase 18, legs (e)-(h)): every leg's
    simulator first, then (e)'s two command-line processes, then one
    pair of processes running (f)-(h) in turn, each alone on the card.
    Returns the children's launches of each kernel."""
    import math
    import shutil
    import tempfile

    import torch

    card = nvidia_smi("name,power.limit")
    (HERE / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="eg-mesh-hybrid-",
                                 dir=HERE / "build"))
    totals = {}

    def add(counts):
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v

    legs = {g[0]: g for g in MESH_HYBRID_LEGS}
    torch.cuda.empty_cache()
    restore = _mesh_switches()
    try:
        sims = {leg: _mesh_hybrid_sim(root, *g) for leg, g in legs.items()}
        want = _final_snapshot(root / "ck-e-sim")[0]["state/params"]
        shutil.rmtree(root / "ck-e-sim", ignore_errors=True)

        # (e): the tensor-parallel transformer's two command-line
        # processes
        t = time.perf_counter()
        port, procs = _free_port(), []
        _, mesh_spec, _, per_rank, _ = legs["e-tp"]
        for p in (0, 1):
            out = root / f"e-mesh-{p}.out"
            argv = [sys.executable, "-c", MESH_CLI,
                    *_mesh_hybrid_cli_argv(mesh_spec, per_rank, root, "mesh",
                                           p),
                    "--backend", "mesh", "--coordinator", f"127.0.0.1:{port}",
                    "--num-processes", "2", "--process-id", str(p)]
            with open(out, "w") as fh:
                procs.append((subprocess.Popen(
                    argv, stdout=fh, stderr=subprocess.STDOUT, cwd=str(HERE),
                    env=dict(_mesh_env(), **dict([MESH_HOST_DATA]))), out))
        _finish_children(procs, "mesh (e-tp) children")
        t = time.perf_counter() - t
        if (root / "e-mesh-1.jsonl").exists():
            raise SmokeError("mesh (e-tp): process 1 wrote a log")
        recs = _cli_records(root / "e-mesh-0.jsonl")
        final = recs[-1]
        got = _final_snapshot(root / "ck-e-mesh")[0]["state/params"]
        shutil.rmtree(root / "ck-e-mesh", ignore_errors=True)
        err = within(got.to(DEVICE), want.to(DEVICE),
                     what="mesh (e-tp): parameters", **MESH_LM_TOL)
        add(_mesh_hybrid_check(
            "e-tp", *legs["e-tp"][1:4], sims["e-tp"],
            (recs[:-1], [final.get("kernel_launches", {})],
             final.get("peak_mem_gib"), final.get("mesh_crossed_bytes", {}),
             err, rel_norm_err(got, want), None, t), card))
        del got, want

        # (f)-(h): one pair of processes, the legs in turn
        rest = [leg for leg in legs if leg != "e-tp"]
        t = time.perf_counter()
        port = _free_port()
        procs = [(_mesh_child(
            f"import chip_smoke as c; c.mesh_hybrid_child({rest!r}, {p}, "
            f"{port}, {str(root)!r}, {DEVICE!r})", root / f"fgh-{p}.out"),
            root / f"fgh-{p}.out") for p in (0, 1)]
        _finish_children(procs, "mesh (f)-(h) children")
        t = time.perf_counter() - t
        lines = [[json.loads(line) for line in Path(out).read_text()
                  .splitlines() if line.startswith('{"mesh_hybrid_child"')]
                 for _, out in procs]
        for leg in rest:
            kids = [next(d for d in ls if d["leg"] == leg) for ls in lines]
            rel = math.sqrt(sum(k["diff2"] for k in kids)
                            / sum(k["want2"] for k in kids))
            add(_mesh_hybrid_check(
                leg, *legs[leg][1:4], sims[leg],
                (kids[0]["hist"], [k["launches"] for k in kids],
                 [k["peak_mem_gib"] for k in kids],
                 {c: sum(k["crossed_bytes"].get(c, 0) for k in kids)
                  for c in {c for k in kids for c in k["crossed_bytes"]}},
                 max(k["params_max_abs_err"] for k in kids), rel,
                 [k["forms"] for k in kids], None), card))
        log(f"mesh (f)-(h): their pair of processes {t:.1f} s for the "
            "three legs")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        restore()
    return totals

KERNELS = (
    ("masked_wire", "eventgrad_tpu_torch/csrc/masked_wire.cu",
     "eventgrad_tpu/ops/event_engine.py:118"),
    ("fused_mix_commit", "eventgrad_tpu_torch/csrc/mix_commit.cu",
     "eventgrad_tpu/ops/arena_update.py:58"),
    ("fused_mix_sgd", "eventgrad_tpu_torch/csrc/mix_sgd.cu",
     "eventgrad_tpu/ops/fused_update.py:50"),
    ("masked_wire_int8", "eventgrad_tpu_torch/csrc/mask_quant.cu",
     "eventgrad_tpu/ops/event_engine.py:124"),
    ("fused_mix_commit_carrier",
     "eventgrad_tpu_torch/csrc/mix_commit_carrier.cu",
     "eventgrad_tpu/ops/arena_update.py:205"),
    # the gated forms (chaos and integrity on the fused tail), timed on
    # the mixed pattern and counted on the chaos phase's legs
    ("fused_mix_commit_gated", "eventgrad_tpu_torch/csrc/mix_commit.cu",
     "eventgrad_tpu/ops/arena_update.py:58"),
    ("fused_mix_sgd_gated", "eventgrad_tpu_torch/csrc/mix_sgd.cu",
     "eventgrad_tpu/ops/fused_update.py:50"),
    ("fused_mix_commit_carrier_gated",
     "eventgrad_tpu_torch/csrc/mix_commit_carrier.cu",
     "eventgrad_tpu/ops/arena_update.py:205"),
    # the gated pitched forms (the bucketed schedule under the fault
    # clauses), timed over four buckets and counted on the chaos phase's
    # bucketed legs
    ("fused_mix_commit_pitched_gated",
     "eventgrad_tpu_torch/csrc/mix_commit.cu",
     "eventgrad_tpu/ops/arena_update.py:58"),
    ("fused_mix_commit_carrier_pitched_gated",
     "eventgrad_tpu_torch/csrc/mix_commit_carrier.cu",
     "eventgrad_tpu/ops/arena_update.py:205"),
    ("flash_fwd","eventgrad_tpu_torch/csrc/flash_fwd.cu",
     "eventgrad_tpu/ops/attention.py:128"),
    ("flash_dq", "eventgrad_tpu_torch/csrc/flash_dq.cu",
     "eventgrad_tpu/ops/attention.py:169"),
    ("flash_dkv", "eventgrad_tpu_torch/csrc/flash_dkv.cu",
     "eventgrad_tpu/ops/attention.py:205"),
    # the DMAX = 128 instantiations (float32, the legs' dtype), timed at
    # FLASH_SHAPE_D128 and counted on the transformer-d128 legs
    ("flash_fwd_d128", "eventgrad_tpu_torch/csrc/flash_fwd.cu",
     "eventgrad_tpu/ops/attention.py:128"),
    ("flash_dq_d128", "eventgrad_tpu_torch/csrc/flash_dq.cu",
     "eventgrad_tpu/ops/attention.py:169"),
    ("flash_dkv_d128", "eventgrad_tpu_torch/csrc/flash_dkv.cu",
     "eventgrad_tpu/ops/attention.py:205"),
    # head dimension 256 (float32, the legs' dtype: all three on the
    # whole form), timed at FLASH_SHAPE_D256 and counted on the
    # transformer-d256 legs
    ("flash_fwd_d256", "eventgrad_tpu_torch/csrc/flash_fwd_whole.cu",
     "eventgrad_tpu/ops/attention.py:128"),
    ("flash_dq_d256", "eventgrad_tpu_torch/csrc/flash_dq_whole.cu",
     "eventgrad_tpu/ops/attention.py:169"),
    ("flash_dkv_d256", "eventgrad_tpu_torch/csrc/flash_dkv_whole.cu",
     "eventgrad_tpu/ops/attention.py:205"),
    # kernel 9, the auditor's seeded unregistered kernel: launched by the
    # audit phase's unregistered_kernel oracle only
    ("leak_kernel", "eventgrad_tpu_torch/csrc/audit_leak.cu",
     "eventgrad_tpu/analysis/audit.py:1208"),
)


def timed(phase):
    """Run one phase and log its seconds; then hand the card back what
    this process's allocator keeps cached, for the other streams."""
    import torch

    t0 = time.perf_counter()
    out = phase()
    log(f"-- {phase.__name__}: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return out


#: the phases run alone first, after the kernels' timings: each holds
#: 25-42 GiB of the card, or times the steps its figures divide
HEAVY = ("phase_main_path_resnet50", "phase_main_path_lm_d128",
         "phase_main_path_lm_d256", "phase_costmodel")
#: then three streams of phases at once on the one card, this process
#: running the first and a child process (`stream_child`) each other
#: one. Their time is mostly the host's (Python dispatch, the CPU's plain
#: versions, child processes that wait): a ResNet-18 pass keeps the card
#: busy 49 of its 149 ms. The first stream holds at most ~15 GiB of the
#: card, the second ~20 (the resume legs beside their kill child), the
#: third ~35 (the hybrid references' 8-rank states at full width, 1
#: layer), so that the three fit the card's 80 GB together. Their step
#: times are taken beside one another
STREAMS = (
    ("phase_reference", "phase_main_path", "phase_main_path_lm",
     "phase_realdata", "phase_frontier", "phase_bucketed_async",
     "phase_chaos", "phase_dispatch"),
    ("phase_sass", "phase_obs", "phase_audit", "phase_resume"),
    ("phase_cli", "phase_hybrid_reference", "phase_membership"),
)
#: last, alone again: the hybrid legs (72 GiB at the MoE leg), the mesh
#: (its children and the simulator at once, ~65 GiB) and the mesh's
#: faults and sharded models (each leg's simulator, then its processes)
TAIL = ("phase_hybrid", "phase_mesh", "phase_mesh_hybrid")
#: the streams must have ended this many seconds after the start, so
#: that the tail fits the run's 1,200 s
STREAM_DEADLINE_S = 1000


def stream_child(names):
    """A stream of phases in a process of its own, started by `main` as
    `python -c`: TF32 off as phase_toolchain sets it, then each phase in
    turn; prints the launches they return, summed, as its last line."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launches = {}
    for name in names:
        # the reference phase counts nothing (None)
        for k, v in (timed(globals()[name]) or {}).items():
            launches[k] = launches.get(k, 0) + v
    print(json.dumps({"stream_child": launches}), flush=True)


def _stream_start(i, names):
    """Stream `i` as a child in a session of its own (so that it can be
    stopped with every process it starts), its output to a file."""
    import os

    (HERE / "build").mkdir(exist_ok=True)
    out = HERE / "build" / f"stream-{i}.out"
    env = dict(os.environ, PYTHONPATH=str(HERE))
    for k in ("EG_COORDINATOR", "EG_NUM_PROCESSES", "EG_PROCESS_ID"):
        env.pop(k, None)
    with open(out, "w") as fh:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as c; c.stream_child({list(names)!r})"],
            stdout=fh, stderr=subprocess.STDOUT, cwd=str(HERE), env=env,
            start_new_session=True)
    return proc, out, names


def _stream_failed(stream, rc):
    proc, out, names = stream
    return SmokeError(f"the stream of {', '.join(names)} exited {rc}:\n"
                      f"{Path(out).read_text()[-6000:]}")


def _stream_check(streams):
    """Fail as soon as a stream has failed."""
    for stream in streams:
        rc = stream[0].poll()
        if rc not in (None, 0):
            raise _stream_failed(stream, rc)


def _stream_join(streams, deadline):
    """Wait for each stream until `deadline` (perf_counter seconds), log
    its output, and return the launches it counted."""
    out = []
    for stream in streams:
        proc, path, names = stream
        try:
            rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            raise SmokeError(f"the stream of {', '.join(names)} had not "
                             f"ended {STREAM_DEADLINE_S} s into the run")
        if rc != 0:
            raise _stream_failed(stream, rc)
        log(f"== stream: {', '.join(names)} (a child process)")
        text = Path(path).read_text()
        log(text.rstrip("\n"))
        out.append(_child_json(path, "stream_child")["stream_child"])
    return out


def _stream_stop(streams):
    """Stop each stream's session: the child and what it started."""
    import os
    import signal

    for proc, _, _ in streams:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        proc.wait()


def main() -> int:
    t_start = time.perf_counter()
    import os

    # deterministic cuBLAS for the bucketed phase's bitwise legs: read
    # when the first cuBLAS handle is made, so set before any CUDA work
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    launches, streams = {}, []

    def add(counts):
        # the reference phase counts nothing (None)
        for k, v in (counts or {}).items():
            launches[k] = launches.get(k, 0) + v

    try:
        card = timed(phase_toolchain)
        timed(phase_build)
        recs = timed(phase_kernels)
        recs.update(timed(phase_flash_kernels))
        recs.update(timed(phase_leak_kernel))
        for name in HEAVY:
            add(timed(globals()[name]))
        streams = [_stream_start(i, names)
                   for i, names in enumerate(STREAMS[1:], start=1)]
        for name in STREAMS[0]:
            add(timed(globals()[name]))
            _stream_check(streams)
        for counts in _stream_join(streams, t_start + STREAM_DEADLINE_S):
            add(counts)
        for name in TAIL:
            add(timed(globals()[name]))
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        _stream_stop(streams)
    kernels = []
    for name, source, replaces in KERNELS:
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches.get(name, 0),
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
