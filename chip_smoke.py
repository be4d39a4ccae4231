#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Run from the root of a checkout with one CUDA card:

    python3 chip_smoke.py

It imports only ``torch``, numpy and the port (``src/repro_torch``), and
runs, in order (any failure exits non-zero and prints no result):

Kernel times come two ways: single calls between CUDA events (``ms``, the
median of 30; the wrapper's host work counts), and device time
(``device_ms``): 100 calls back to back under ``torch.profiler``, the
device time of the kernel's own launches per call (the median recorded
launch; ``device_mean_ms`` the mean), with the host's microseconds per
call over the same window beside it.  Each window opens with 2,048 tiny
filler kernels and closes with 256, which take the records the profiler
loses at the head or the tail of some windows; a window whose first or last
record is not a filler, or that kept fewer timed launches than calls,
is taken again (the counts are printed at the end).

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, started
   together), and ptxas's register, shared-memory and spill report of the
   flash_attention, paged_attention and select_topk kernels;
2. ``select_topk`` against its plain PyTorch version on the card: the
   conformance corpus (heavy ties, k in {0, 1, n}, ulp-apart non-ties,
   empty rows), the tuning shape (8, 32783) with heats from a HeMem epoch
   and the KV replay's (1, 2048) from a kv-hemem epoch; each case through
   the rule's kernel (the cluster kernel on both main paths) and both
   kernels forced, masks bitwise equal and bitwise on a rerun.
   Then at (8, 32783) device times of the cluster and the block kernel in
   turns (new, old, old, new), both at (1, 2048), both with k = 0 (no
   radix pass) and k = n (one), both on cuts of the tuning epoch from
   1,024 to 32,783 pages at B in {1, 8} (where the cluster kernel starts
   to win), single-call times, the plain version and a ``torch.topk``
   yardstick;
3. the port against its own CPU path on a small input (gups at scale
   0.02): deterministic engines bitwise on migrations, sampled ones within
   the cross-device float tolerance; every select_topk launch (656-page
   rows) on the block kernel;
4. ``Study.run`` for each engine on the paper's GUPS deployment (gups
   8GiB-hot at scale 1.0: 32,783 pages, 60 epochs) on ``pmem-large``,
   B = 8, ``crn=True``: bitwise equal to the same run with the plain
   selection, bitwise equal on a rerun, identical rows for identical
   configs, and 60 kernel launches per planning engine, all on the
   cluster kernel;
5. the main path of the tuning loop: ``Study.tune`` (hemem, budget 16,
   batch 8, crn) with the launch counters set to 0 just before and read
   just after (180 launches, all on the cluster kernel);
6. the paper's Bayesian-optimisation surface on the card: (a)
   ``ops.topk_mask`` (the acquisition's top-q, the promote side of
   ``select_topk`` on one row) against its plain version, bitwise and on a
   rerun, at n in {40, 96, 512, 1,024, 1,536} with heavy ties, valid masks
   and k in {0, 1, 5, 40, n}, both kernels forced at 1,536; the block
   kernel's device time at (1, 512) beside the single call, the plain
   version and ``torch.topk``; (b) ``Study.tune(budget=100, batch_size=4,
   seed=0)`` of hemem on the GUPS deployment above with the launch
   counters set to 0 just before and read just after (one block launch
   per model round, 60 cluster launches per ``Study.run`` pass), every
   model round's card selection against ``suggest_topq`` pinned to numpy
   on the same forest, pool and valid mask as the card reads them
   (thresholds and pool rounded to float32: ``as_read_in_float32``), equal
   but for swaps of EIs within 1e-5 relative, counted; the rounds where
   plain float64 numpy selects otherwise, through candidates on a split
   point, counted too; acquisition ms per round card against numpy, the
   ask and the tuning wall without the numpy shadow's time; (c) Fig. 2:
   each of the paper's eight workloads tuned (hemem,
   ``sampler="sparse"``, budget 40, q 4, seed 3), then
   ``sweep(configs=[default, best])`` bitwise equal to ``Study.run`` of
   the same configs, the improvement beside the paper's band and
   ``knob_importance``'s top three knobs; (d) a sweep of hemem, memtis and
   hmsdk over gups and gapbs-pr, the reference's cell keys, each cell
   bitwise equal to its own ``Study.run``; then asynchronous and online
   tuning on the same deployment (``phase_tune_service``), each part's
   seconds on a line of its own: (a) ``run_simulation_segment`` over
   [0, 15), [15, 30) and [30, 60) carried, B = 4, bitwise equal to
   ``Study.run``'s rows and to a rerun, 60 cluster launches; (b)
   ``Study.tune(executor="async", slots=1)`` against ``Study.tune``,
   budget 26, seed 0, histories bitwise equal, one block launch per
   model-phase ask (the 26th); (c) ``Study.tune(budget=40, executor="async",
   slots=4, scheduler="asha")`` (100 until it was cut for the clock) on
   thread slots with a journal: cluster
   launches equal to the epochs evaluated, no failed trial; makespan,
   slot utilization, ASHA's saved share and the incumbent beside the sync
   budget-100 wall of (b) above, its journal valid under
   ``tools/journal_schema.py`` (run as a subprocess);
   (e) 2 process slots (spawned, each starting CUDA and loading the
   kernels) against 2 thread slots, budget 8 (12 until it was cut for
   the clock): journals byte-identical;
   (d), after (e), (e)'s study in a child process, SIGKILLed once its
   journal holds three quarters of (e)'s lines (deadline 300 s), resumed
   here: journal byte-identical to (e)'s thread slots', trials equal,
   valid;
   (f) ``Study.tune(online=True, window_epochs=10, batch_size=4)`` on
   drift-hotspot at scale 1.0 (switches at 20 and 40): zero thrash, each
   switch detected in the first window past it, 10 cluster launches a
   window, a journaled rerun byte-identical, the windows to re-adapt and
   the deployed wall beside the default config's; then the fleet
   (``phase_fleet``): (g1) (c)'s study with ``executor="fleet",
   workers=4, pool="process"`` (spawned workers, each starting CUDA and
   loading ``select_topk`` before it greets), journaled: trials, history,
   incumbent and default bitwise (c)'s, no expired lease, death,
   duplicate or degradation, the workers' ``cluster`` launches (the
   receipt's ``kernel_launches``) equal to the epochs evaluated and the
   coordinator's own launches the model-phase asks' ``block`` only;
   makespan, utilization and epochs evaluated beside (c)'s; (g2) at (e)'s
   budget on 2 workers, ``FaultPlan(kill=[(2, 0)])``: one ``worker-dead``
   expiry, one respawn, the study bitwise (e)'s on thread slots (which the
   fleet equals, as (g1) shows at (c)'s budget); (g3) a spec minted by
   ``python -m repro_torch.launch.fleet --init`` and 2 workers its local
   mode starts: the study bitwise (e)'s, the key not in the journal; then
   ``FaultPlan(truncate=[(2, 0)])`` on a socket fleet: one ``truncated``
   reject, the study (e)'s; every journal valid under
   ``tools/journal_schema.py`` (the byte-identical twins of (g2) and (g3)
   were cut for the clock: the CPU tests hold them);
7. ``page_migrate`` against its plain version, bitwise: bf16 and f32, -1
   lanes (the row-0 case included), duplicate destinations, no lanes, rows
   that are not a multiple of 16 bytes, and the serving shape (256 lanes of
   917,504-byte rows); single-call and device times of the kernel, the
   plain version and ``index_select`` + ``index_copy_`` at the serving
   shape;
8. ``paged_attention`` against its plain version (f32 within 1e-5, bf16
   and f16 within 1e-2) and bitwise on a rerun: G in {1, 2, 4, 16, 32},
   lengths 0, partial and full, -1 table entries, the strided layer-0
   view; each case through the rule's kernel and, where the rule picks the
   split kernel, the walk kernel and the split kernel at several split
   counts; then at the serving shape device times of the split and the
   walk kernel in turns, the split kernel by split count, both with L2
   evicted between calls, single-call times, the plain version and
   ``scaled_dot_product_attention`` on the resident K/V gathered into a
   dense tensor (the gather not timed); and a long-context shape where
   the plan splits;
9. the main path of serving: ``replay`` at chatglm3-6b's KV width (28
   layers, 2 KV heads of 128, 32 query heads, bf16, 64-token pages), 64
   sequence slots of 32 pages, 256 HBM pages, 1,024 steps of
   bursty-diurnal traffic, an engine epoch every 8 steps, with the launch
   counters set to 0 just before and read just after (paged_attention once
   per decoded step, all on the split kernel; page_migrate 4 and
   select_topk 1 per epoch, the latter on the cluster kernel); a rerun
   bitwise equal in residency, migrations and outputs; ``FORCE="plain"``
   bitwise equal in residency and migrations, outputs within 1e-2; decode
   ms per step timed in turns (kernels, plain, plain, kernels); then a
   profiled 256-step replay for each kernel's share of device time;
10. a small spec on the card and on the port's CPU path: residency and
   migrations bitwise;
11. ``Study.run`` of kv-hemem on kv-poisson on the card, within the
    cross-device tolerance of the CPU path;
12. the serving tuning loop: ``Study.tune(budget=8, objective=serving
    objective)`` over 256-step replays at the same width;
13. after freeing the serving pools, ``flash_attention`` against its
    plain version (f32 within 2e-5, bf16 within 2e-2) on the CPU test
    file's cases, gemma2-9b's head shape (D 256, softcap 50, window
    4,096 at S = 4,608), h2o-danube-3-4b's (D 120), chatglm3-6b's
    prefill (q (4, 2048, 32, 128), k/v (4, 2048, 2, 128)), the wgmma
    kernel's edges at D = 64, 128, 256 and 120 (ragged S and T, S != T
    with a softcap, a window without causality, rows that see no key, 10
    query heads on one KV head, group size 4 at D = 120) and
    recurrentgemma-2b's prefill (q (2, 4096, 10, 256), k/v (2, 4096, 1,
    256), window 2,048); every bf16 case the rule sends to the wgmma
    kernel (D 64, 120, 128 and 256) also runs the old mma kernel; every
    run bitwise on a rerun.  Times at
    chatglm3-6b's prefill: the wgmma and the mma kernel in turns (new,
    old, old, new), with achieved TFLOP/s and the share of the bound,
    beside ``scaled_dot_product_attention`` (causal, GQA), and the device
    times of both kernels and SDPA;
14. the LM main path: ``build_prefill_step`` at chatglm3-6b's full width
    on 4 x 2,048 tokens with the launch counters set to 0 just before and
    read just after (flash_attention exactly once per layer, 28, every
    one on the wgmma kernel), prefill ms and tokens/s, last logits
    against ``FORCE="plain"``, and a profiled prefill for the kernel's
    share of device time;
15. the port's launcher (``--arch chatglm3-6b --full --batch 4
    --prompt-len 512 --new-tokens 32``): ms per generated token, no
    kernel launched by decode, and its logits after teacher-forcing the
    prompt against prefill's last-position logits on the same prompt
    (within ``LM_LOGIT_TOL``, relative to the largest logit);
16. the chatglm3-6b, gemma2-9b, h2o-danube-3-4b, granite-moe-1b-a400m,
    kimi-k2-1t-a32b, recurrentgemma-2b, xlstm-1.3b, whisper-base and
    llama-3.2-vision-11b smoke configs at S = 512 on the card against the port's CPU path (the
    cross gates at 0.5, a stub input at scale 1); the
    MoE configs' card runs routed as the CPU routed (``Routing``), each
    router's own choice equal to the CPU's but at near ties;
17. ``select_topk`` past the old 65,535-page ceiling: both kernels
    bitwise against the plain version and on a rerun at n in {65,536,
    100,003, ``MAX_N``}, B in {1, 8}, with ties and k in {0, 1, n}; then
    ``Study.run`` of hemem on gapbs-bc kron at scale 1.7 (68,004 pages,
    120 epochs), B = 8, ``crn=True``: bitwise equal to ``FORCE="plain"``,
    the cluster kernel once per epoch;
18. LM training, card against CPU: 2 AdamW steps (``n_micro`` 1 and 2) of
    the chatglm3-6b, gemma2-9b, h2o-danube-3-4b, granite-moe-1b-a400m,
    recurrentgemma-2b, xlstm-1.3b, whisper-base and llama-3.2-vision-11b
    smoke configs (the MoE layers' index ops, the RG-LRU scan, the mLSTM
    chunks, the sLSTM loop, the encoder and the cross layers under
    autograd; the cross gates at 0.5 on both sides) from the same weights
    and ``SyntheticLM`` batches, losses and grad norms within
    ``TRAIN_TOL``, no kernel launched; ``flash_attention`` under autograd
    on the card raises;
19. checkpoint restarts on the card at the chatglm3-6b, granite-moe-1b-a400m,
    recurrentgemma-2b, xlstm-1.3b, whisper-base and gemma2-9b smoke configs:
    20 steps straight against 10, a restart and 10, the losses after the
    restart bitwise equal;
20. LM training at full width and depth through the launcher's trainer
    (``--full --batch 4``, no checkpoint written) of chatglm3-6b,
    granite-moe-1b-a400m, recurrentgemma-2b, whisper-base and
    h2o-danube-3-4b (AdamW by the launcher's rule; 4 steps of 4 x 512
    tokens), xlstm-1.3b (AdamW; 3 steps of 4 x 256, cut for the clock:
    its sLSTM loop takes 8.3 s a step at 512) and gemma2-9b and
    llama-3.2-vision-11b (``--optimizer adafactor``: AdamW's 12 B a
    parameter would not fit the card; 4 steps of 4 x 512); the cross gates
    set to 0.5 right after ``make_trainer``; the launch counters set to 0
    just before and read just after (no kernel: flash has no gradient);
    finite losses and grad norms, the first loss against ``loss_fn`` under
    ``no_grad`` within 1e-3, and each family's own leaves
    (``train_leaves``) given a nonzero gradient by the first step and
    moved (but RG-LRU's decay path, whose gradient at the reference's init
    is far below AdamW's eps: ``STILL_LEAVES``, reported); per step loss,
    grad norm, ms, tokens/s and peak memory beside the card's name and
    power limit; init seconds, ``n_micro``, granite's aux loss and
    dropped-slot share, and a step in its parts (``train_breakdown``:
    forward and backward, clipping and the update between CUDA events,
    then a profiled step for device busy and the matrix products' share;
    each arch profiled at the shape it trained, its kernels summed from
    the profiler's raw records, ``kernel_rows``);
21. ``flash_attention`` at granite-moe-1b-a400m's prefill shape (q (4,
    2048, 16, 64), k/v (4, 2048, 8, 64), causal; the wgmma kernel at D = 64
    with group size 2): against the plain version (bf16 2e-2) and bitwise
    on a rerun, device times of the kernel and SDPA in turns (kernel,
    SDPA, SDPA, kernel), single-call times, the bound and its share;
22. the MoE serving path: ``build_prefill_step`` at granite-moe-1b-a400m's
    full width and depth (24 layers, 32 experts, top-8; random weights from
    a seed) on 4 x 2,048 tokens, as phase 14: the launch counters set to 0
    just before and read just after (flash_attention exactly 24 times, all
    on the wgmma kernel), prefill ms and tokens/s, last logits against
    ``FORCE="plain"`` within ``LM_LOGIT_TOL``, and a profiled prefill with
    device busy against the prefill's CUDA-event time, the matrix
    products' share, the share of the MoE dispatch and combine (sorts,
    index scatters and gathers) and the share of slots the capacity rule
    drops;
23. the launcher at granite's full width (``--arch granite-moe-1b-a400m
    --full --batch 4 --prompt-len 512 --new-tokens 32``), as phase 15: ms
    per token, no kernel launched by decode, logits after the prompt
    against the last-position logits of each sequence prefilled alone
    (512 x 8 slots: dropless, as decode is) within ``LM_LOGIT_TOL``; the
    batch prefill's dropped-slot share and distance reported beside;
24. ``TieredParamStore`` over one granite layer's 32 experts at full width
    (6.29 MB a host expert in float32, 8 experts in a bf16 pool on the
    card), the reference test's engine config: 30 steps of ``route`` (the
    65,536 slots of a 4 x 2,048 prefill at top-8, 8 hot experts among
    12-31 carrying 90%, from a numpy seed) and ``step_engine(100.0)``;
    residency, migrations and hits bitwise equal to the same store on the
    CPU after every step, the hot set resident at the end, ``gather``
    bitwise equal to the host rows in bf16; ms per step, gather ms for 8
    ids (half resident) and the promotions' host-to-device GB/s;
25. ``flash_attention`` at recurrentgemma-2b's prefill shape (q (2, 4096,
    10, 256), k/v (2, 4096, 1, 256), causal, window 2,048; the wgmma kernel
    at D = 256 with group size 10), as phase 21: against the plain version
    (bf16 2e-2) and bitwise on a rerun, the old mma kernel against the
    plain version too, device times of the wgmma kernel, the mma kernel
    and SDPA in turns (wgmma, mma, SDPA, SDPA, mma, wgmma; SDPA with the
    window's boolean mask and K/V repeated to the query heads, the kernels
    it ran recorded), single-call times, the bound and its share;
26. the recurrentgemma-2b serving path at full width and depth (26 layers:
    18 RG-LRU, 8 local attention; random weights from a seed): the
    launch counters set to 0 just before and read just after a prefill of
    2 x 4,096 tokens (flash_attention exactly 8 times, all on the wgmma
    kernel), prefill ms and tokens/s, last logits against ``FORCE="plain"``
    within ``LM_LOGIT_TOL``, a profiled prefill with device busy against
    the CUDA-event time, the matrix products', flash's and the RG-LRU
    scan's shares; then its launcher (``--full --batch 4 --prompt-len 512
    --new-tokens 32``): ms per token, no kernel launched by decode, prompt
    logits against prefill's last-position logits within
    ``LM_LOGIT_TOL``;
27. the xlstm-1.3b serving path at full width and depth (48 layers: 42
    mLSTM, 6 sLSTM): a prefill of 4 x 2,048 tokens launching no kernel,
    finite logits bitwise equal on a rerun, prefill ms and tokens/s, a
    profiled prefill of its first 128 tokens (the sLSTM loop's ~140
    kernels a token make the profiler's post-processing the phase's
    longest step at 2,048; 512 until it was cut for the clock) with the sLSTM loop's and the mLSTM chunks'
    device and host ms; then its launcher (a prompt of 128 tokens), as
    above, its prompt logits against a prefill whose mLSTM layers run at
    chunk 1 (what decode computes; the reference's mLSTM clamps within a
    chunk only) within
    ``LM_LOGIT_TOL``, the distance to the ordinary prefill reported
    beside;
28. one layer of each recurrent kind at full width (RG-LRU at d_model
    2,560, mLSTM and sLSTM at 2,048; B = 1, S = 512) on the card against
    the port's CPU path: output and state within 1e-4 (float32) and 3e-2
    (bf16) of the largest CPU value, card ms per call;
29. cross-attention serving: ``flash_attention`` at llama-3.2-vision-11b's
    decoder prefill (q (4, 2048, 32, 128), k/v (4, 2048, 8, 128), causal;
    ``wgmma`` at D = 128, group size 4) and whisper-base's (q (4, 512, 8,
    64), k/v (4, 512, 8, 64); D = 64, group size 1), each as phase 21;
    then llama-3.2-vision-11b at full width and depth (40 layers, 8 cross
    layers over 1,601 patches; random weights from a seed, every cross
    gate set to 0.5 after ``init``, whose 0 would make the cross path add
    nothing): the launch counters set to 0 just before and read just
    after a prefill of 4 x 2,048 tokens with a stub patch input (flash
    exactly 40 times, all ``wgmma``), logits against ``FORCE="plain"``
    within ``LM_LOGIT_TOL`` and bitwise on a rerun, the logits moved by
    another draw of the stub input, a profiled prefill with the cross
    path's shares (K/V projections, the cross sub-layer, the inline
    ``_sdpa``); its launcher (``--batch 4 --prompt-len 128 --new-tokens
    32``, the cross K/V primed from the launcher's stub input) on the same
    weights, prompt logits against prefill's; then whisper-base at full
    width and depth (6 encoder and 6 decoder layers, 1,500 frames) the
    same way, a prefill of 4 x 512 decoder tokens (flash exactly 6 times,
    all ``wgmma``; the encoder's share reported), its launcher 4 x 128 +
    32;
30. the sliding-window dense families past their window: ``flash_attention``
    at gemma2-9b's prefill (q (2, 8192, 16, 256), k/v (2, 8192, 8, 256),
    causal, window 4,096, softcap 50) and h2o-danube-3-4b's (q (2, 8192,
    32, 120), k/v (2, 8192, 8, 120), causal, window 4,096; ``wgmma`` at
    D = 120 on D = 128's plan), each as phase 25 (the old ``mma`` kernel
    beside; SDPA at gemma2's shape without the softcap, recorded as not
    the same function); then gemma2-9b at full width and depth (42
    layers, 9.24 B parameters, every layer windowed as the reference
    does) and h2o-danube-3-4b (24 layers, 3.84 B): the launch counters set
    to 0 just before and read just after a prefill of 2 x 8,192 tokens
    (flash exactly 42 and 24 times, all ``wgmma``), logits against
    ``FORCE="plain"`` within ``LM_LOGIT_TOL`` and bitwise on a rerun, a
    profiled prefill with flash's and the matrix products' shares and the
    idle share; their launchers (``--full --batch 4 --new-tokens 32``,
    prompts of 128 for gemma2-9b, 256 before the clock cut it, and 256
    for h2o-danube-3-4b) on the same weights, no kernel in decode, prompt
    logits against prefill's; then both smoke configs (window 32) through
    64 teacher-forced decode steps, twice around their rings, card against
    the CPU path within ``LM_LOGIT_TOL`` at every step;
31. multi-card on one card (``phase_mesh``): the dry-run of
    command-r-plus-104b's and kimi-k2-1t-a32b's ``train_4k`` cells at full
    width on the (16, 16) production mesh (256 fake ranks, fake tensors:
    ``python -m repro_torch.launch.dryrun``, one subprocess each, started
    before phase 20 and run on the host while the card trains, each
    bounded by ``DRYRUN_BOUND_S`` from its start), their per-rank bytes
    and peak against the card's memory; the sharded ``Trainer`` on a (1, 1) ("data",
    "model") mesh over NCCL at granite-moe-1b-a400m's full width and depth
    (4 x 512, AdamW, 4 steps, ``set_moe_buffer_sharding`` on) against the
    unsharded trainer from the same seed: losses bitwise, ms per step and
    peak GiB side by side, no kernel launched (the counters set to 0
    before and read after the mesh run); then an elastic round trip at
    granite's full width cut to 2 layers (the checkpoint's full arrays
    then take seconds): 4 steps on the mesh, a checkpoint,
    ``restore_elastic`` onto the plain device for a step, a checkpoint,
    back onto the mesh for a step, every loss bitwise the unsharded run's;
32. one JSON line per the kernel table, the card line again, and as the
    last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM device-memory rate (bytes/s), NVIDIA's data sheet
HBM_BYTES_PER_S = 3.35e12
SCALE, EPOCHS, BATCH = 1.0, 60, 8
PLANNING = ("hemem", "memtis", "hmsdk", "oracle")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_launch_us(prof, names=None):
    """Device microseconds of each recorded launch of a profile's CUDA
    kernels whose names contain one of ``names`` (every kernel when None),
    by kernel name."""
    import torch
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if names is None or any(n in e.name for n in names):
            out.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return out


#: tiny kernels (``torch.cuda._sleep(1)``, ATen's ``spin_kernel``)
#: launched at the head (:data:`FILLER`) and at the tail
#: (:data:`TAIL_FILLER`, as many as the timed launches of most windows)
#: of every ``device_ms`` window.
#: The profiler loses the first records of some windows, more late in a
#: long process (idle time before the first launch does not help, nor
#: does a warmup cycle), and once lost every timed launch of a window
#: while keeping its head; the fillers take such losses instead of the
#: timed launches, and a window whose loss reached them is taken again
FILLER, TAIL_FILLER, FILLER_NAME = 2048, 256, "spin"
#: filler records lost per ``device_ms`` window, in order, windows taken
#: again included (printed at the end)
FILLER_LOSS = []
#: ``device_ms`` windows taken again, with the reason (printed at the end)
RETAKEN = []
#: seconds spent in ``device_ms`` calls, warmup included (printed at the
#: end)
PROFILED_S = [0.0]


def _window_loss(prof, names, n):
    """Why a ``device_ms`` window cannot be used, or None: its first or
    last CUDA record is not a filler (the profiler's loss may have reached
    the timed launches), or it kept fewer launches of ``names`` than the
    ``n`` calls it timed."""
    import torch
    recs = sorted((e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not recs or FILLER_NAME not in recs[0].name:
        return "lost its head filler"
    if FILLER_NAME not in recs[-1].name:
        return "lost its tail filler"
    kept = sum(1 for e in recs if FILLER_NAME not in e.name and (
        names is None or any(m in e.name for m in names)))
    if kept < n:
        return f"kept {kept} timed launches of {n} calls"
    return None


def device_ms(fn, names, n: int = 100, warmup: int = 5, between=None):
    """Device time per call of ``fn()``: ``n`` calls back to back under
    ``torch.profiler`` (CUDA activity); for each kernel whose name
    contains one of ``names`` (every kernel when None), the median of its
    recorded launches times the launches a call makes, summed
    (``device_ms``), and the same with the mean of its recorded launches
    (``device_mean_ms``), so a slow tail shows as the gap between the two.
    The window opens with :data:`FILLER` filler kernels and closes with
    :data:`TAIL_FILLER` (not counted); one that :func:`_window_loss` refuses is taken again, up to
    four times.  ``between()``, if given, runs before each call and is not
    counted unless its kernels match ``names``.  Also
    the host's microseconds per call over the same window (the loop's
    clock, so the wrapper's checks, allocations and launch, and
    ``between``), and the matched launches recorded per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start = time.perf_counter()
    for _ in range(warmup):
        if between is not None:
            between()
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(FILLER):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()      # the timed loop waits on no filler
            t0 = time.perf_counter()
            for _ in range(n):
                if between is not None:
                    between()
                fn()
            host_s = time.perf_counter() - t0
            for _ in range(TAIL_FILLER):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        filler = kernel_launch_us(prof, (FILLER_NAME,))
        FILLER_LOSS.append(FILLER + TAIL_FILLER
                           - sum(len(t) for t in filler.values()))
        why = _window_loss(prof, names, n)
        if why is None:
            break
        RETAKEN.append(why)
        print(f"device_ms: a window timing {names} {why}; taking it again",
              flush=True)
    else:
        fail(f"the profiler lost records of five windows timing {names} "
             f"(the last {why})")
    launches = {k: t for k, t in kernel_launch_us(prof, names).items()
                if k not in filler}
    per_call = [max(1, round(len(t) / n)) for t in launches.values()]
    us = sum(statistics.median(t) * c
             for t, c in zip(launches.values(), per_call))
    mean_us = sum(statistics.mean(t) * c
                  for t, c in zip(launches.values(), per_call))
    PROFILED_S[0] += time.perf_counter() - start
    return {"device_ms": us / 1e3, "device_mean_ms": mean_us / 1e3,
            "host_us": host_s * 1e6 / n,
            "kernels_per_call": sum(len(t) for t in launches.values()) / n,
            "kernels": sorted(name[:100] for name in launches)}


def gups_study(engine, device="cuda", scale=SCALE, **opts):
    from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
    return Study(ExperimentSpec(
        engine=engine, workload=WorkloadSpec("gups", "8GiB-hot", scale=scale),
        machine="pmem-large",
        options=SimOptions(seed=0, crn=True, device=device, **opts)))


def batch_configs(engine):
    """Default config plus 7 seeded random ones (empty for knob-less)."""
    import numpy as np
    from repro_torch.core.knobs import SPACES
    space = SPACES.get(engine)
    if space is None:
        return [{} for _ in range(BATCH)]
    rng = np.random.default_rng(1234)
    return [space.default_config()] + [space.sample(rng)
                                       for _ in range(BATCH - 1)]


def corpus(device):
    """(name, args) cases of the conformance corpus plus the edges."""
    import numpy as np
    import torch
    rng = np.random.default_rng(7)
    B, n = 3, 256
    cases = []
    for levels in (0, 2, 3, 17, 255):
        for density in (0.05, 0.5, 0.95):
            if levels:
                ph = rng.integers(0, levels, (B, n)).astype(np.float32)
                dh = rng.integers(0, levels, (B, n)).astype(np.float32)
            else:
                ph = rng.uniform(0, 1e6, (B, n)).astype(np.float32)
                dh = rng.uniform(0, 1e6, (B, n)).astype(np.float32)
            pm = rng.uniform(size=(B, n)) < density
            dm = rng.uniform(size=(B, n)) < density
            edges = [0, 1, n, int(rng.integers(0, n + 1))]
            kp = np.array([edges[b % 4] for b in range(B)], np.float32)
            kd = np.array([edges[(b + 1) % 4] for b in range(B)], np.float32)
            cases.append((f"levels={levels},density={density}",
                          (pm, ph, dm, dh, kp, kd)))
    ones = np.ones((B, n), bool)
    tied = np.full((B, n), 7.0, np.float32)
    k3 = np.array([0, 1, 13], np.float32)
    cases.append(("all tied", (ones, tied, ones, tied, k3, k3)))
    base = np.float32(1000.0)
    up = np.nextafter(base, np.float32(np.inf), dtype=np.float32)
    ulp = np.tile(np.array([base, up] * (n // 2), np.float32), (B, 1))
    half = np.full(B, n // 2, np.float32)
    cases.append(("ulp-apart", (ones, ulp, ones, ulp, half, half)))
    zero = np.zeros((B, n), bool)
    cases.append(("empty rows", (zero, tied, zero, tied, half, half)))
    big = (rng.uniform(size=(2, 65535)) < 0.3,
           rng.integers(0, 9, (2, 65535)).astype(np.float32),
           rng.uniform(size=(2, 65535)) < 0.6,
           rng.uniform(-5, 5, (2, 65535)).astype(np.float32),
           np.array([65535, 1234], np.float32),
           np.array([30000, 0], np.float32))
    cases.append(("n=65535", big))
    return [(name, [torch.from_numpy(np.asarray(a)).to(device) for a in args])
            for name, args in cases]


def capture_select_inputs(run):
    """The select_topk inputs of the call with the most pages to select
    while ``run()`` goes through the plain versions."""
    from repro_torch.core import engine_torch
    from repro_torch.kernels import ops
    best = []
    orig = ops.select_topk

    def record(*args):
        k = float(args[4].sum() + args[5].sum())
        if not best or k > best[0]:
            best[:] = [k, [a.clone() for a in args]]
        return orig(*args)

    ops.FORCE = "plain"
    engine_torch.kernel_ops.select_topk = record
    try:
        run()
    finally:
        engine_torch.kernel_ops.select_topk = orig
        ops.FORCE = None
    args = [a.contiguous() for a in best[1]]
    return [args[0].bool(), args[1].float(), args[2].bool(), args[3].float(),
            args[4].float(), args[5].float()]


def capture_hemem_epoch():
    """The select_topk inputs of one HeMem epoch at the main path's shape
    (the epoch with the most pages to select), taken from a plain run."""
    return capture_select_inputs(
        lambda: gups_study("hemem").run(configs=batch_configs("hemem")))


def capture_replay_epoch():
    """The select_topk inputs of one kv-hemem epoch of the KV replay
    (1 x 2,048 pages; the epoch with the most pages to select of a
    256-step plain replay)."""
    return capture_select_inputs(lambda: serving_replay(None, 256))


#: the kernels each select_topk variant launches (profiler names)
TOPK_NAMES = {"cluster": ("select_topk_cluster_kernel",),
              "block": ("select_topk_kernel<",)}


def phase_select_topk(device):
    import torch
    from repro_torch.kernels import ops, ref, select_topk as sk
    cases = corpus(device)
    cases.append(("main path (8, 32783), hemem epoch", capture_hemem_epoch()))
    replay_args = capture_replay_epoch()
    cases.append(("KV replay (1, 2048), kv-hemem epoch", replay_args))
    # the rule's kernel (through ops) and both kernels forced
    runs = [("rule", {}), ("block", dict(variant="block")),
            ("cluster", dict(variant="cluster"))]
    for name, args in cases:  # each in the kernel's dtypes, contiguous
        rpm, rdm = ref.select_topk_ref(*args)
        for run, kw in runs:
            pm, dm = ops.select_topk(*args) if not kw else \
                sk.select_topk(*args, **kw)
            again = ops.select_topk(*args) if not kw else \
                sk.select_topk(*args, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(pm, rpm) and torch.equal(dm, rdm)):
                fail(f"select_topk ({run}) differs from its plain version "
                     f"on {name}")
            if not (torch.equal(pm, again[0]) and torch.equal(dm, again[1])):
                fail(f"select_topk ({run}) is not bitwise equal on a rerun "
                     f"on {name}")
    print(f"select_topk: {len(cases)} cases x {len(runs)} runs (the rule's "
          f"kernel, block, cluster) bitwise equal to the plain version and "
          f"on reruns", flush=True)
    args = cases[-2][1]
    B, n = args[0].shape
    if sk.pick_variant(B, n) != "cluster" \
            or sk.pick_variant(*replay_args[0].shape) != "cluster":
        fail("the rule does not pick the cluster kernel on the main paths")
    # device time, the new and the old kernel in turns (new, old, old, new)
    turns = {"cluster": [], "block": []}
    for name in ("cluster", "block", "block", "cluster"):
        turns[name].append(device_ms(
            lambda: sk.select_topk(*args, variant=name), TOPK_NAMES[name]))
    dev = statistics.mean(t["device_ms"] for t in turns["cluster"])
    dev_mean = statistics.mean(t["device_mean_ms"] for t in turns["cluster"])
    block_dev = statistics.mean(t["device_ms"] for t in turns["block"])
    replay = {name: device_ms(lambda: sk.select_topk(*replay_args,
                                                     variant=name),
                              TOPK_NAMES[name])
              for name in ("cluster", "block")}
    # what a radix pass costs: k = 0 runs no pass, k = n one where fewer
    # than n pages are candidates (all are taken after it), the real k four
    passes = {}
    for shape, a in (("tune", args), ("replay", replay_args)):
        for label, k in (("k=0", 0.0), ("k=n", float(a[0].shape[1]))):
            ka = a[:4] + [torch.full_like(a[4], k), torch.full_like(a[5], k)]
            for name in ("cluster", "block"):
                passes[f"{shape} {label} {name}"] = device_ms(
                    lambda: sk.select_topk(*ka, variant=name),
                    TOPK_NAMES[name])["device_ms"]
    crossover = topk_crossover(sk, args)
    kernel_ms = cuda_ms(lambda: sk.select_topk(*args, variant="cluster"))
    block_ms = cuda_ms(lambda: sk.select_topk(*args, variant="block"))
    plain_ms = cuda_ms(lambda: ref.select_topk_ref(*args))
    # yardstick: one torch.topk over unique packed (key, -index) words
    vp, vd = ref.pack_keys(*args[:4])
    idx = torch.arange(n, device=device, dtype=torch.int64)
    packed = torch.cat([vp, vd]) << 17 | (n - idx)[None, :]
    kmax = max(1, int(torch.cat([args[4], args[5]]).max()))
    library_ms = cuda_ms(lambda: torch.topk(packed, kmax, dim=-1))
    library_dev = device_ms(lambda: torch.topk(packed, kmax, dim=-1), None)
    moved = B * n * (1 + 4 + 1 + 4) + 2 * B * 4 + 2 * B * n
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    out = {"max_abs_err": 0, "kernel_ms": kernel_ms, "device_ms": dev,
           "device_mean_ms": dev_mean,
           "host_us": statistics.mean(t["host_us"]
                                      for t in turns["cluster"]),
           "variant": "cluster", "old_variant": "block", "old_ms": block_ms,
           "old_device_ms": block_dev, "turns": turns,
           "replay_shape_device_ms": {k: v["device_ms"]
                                      for k, v in replay.items()},
           "crossover_device_ms": crossover,
           "pass_ablation_device_ms": passes,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_dev["device_ms"],
           "bound_ms": bound_ms}
    print(f"select_topk at (B={B}, n={n}): cluster kernel (C="
          f"{sk.CLUSTER_SIZE}) device {dev:.5f} ms ({bound_ms / dev:.1%} of "
          f"the bound; mean of launches {dev_mean:.5f} ms), single call "
          f"{kernel_ms:.4f} ms; block kernel device {block_dev:.5f} ms, "
          f"single call {block_ms:.4f} ms; at the KV replay's (1, 2048): "
          f"{json.dumps({k: v['device_ms'] for k, v in replay.items()})}; "
          f"plain {plain_ms:.4f} ms, "
          f"torch.topk {library_ms:.4f} ms (device "
          f"{library_dev['device_ms']:.5f}), bound {bound_ms:.5f} ms "
          f"({moved} bytes); turns {json.dumps(turns)}; device ms by "
          f"passes {json.dumps(passes)}; block vs cluster device ms by "
          f"(B, n) {json.dumps(crossover)}", flush=True)
    return out


def topk_crossover(sk, args):
    """Device ms of the block and the cluster kernel on the first B rows
    and n pages of a tuning epoch (k scaled to n), for B in {1, 8} and n
    from one block tile (1,024) to the whole row: where the cluster kernel
    starts to win, the measurement behind ``BLOCK_MAX_N``."""
    import torch
    full = args[0].shape[1]
    out = {}
    for B in (1, 8):
        for n in (1024, 2048, 4096, 8192, 16384, full):
            a = [t[:B, :n].contiguous() for t in args[:4]] + [
                torch.floor(t[:B] * n / full).contiguous() for t in args[4:]]
            out[f"({B}, {n})"] = {name: device_ms(
                lambda: sk.select_topk(*a, variant=name),
                TOPK_NAMES[name])["device_ms"]
                for name in ("block", "cluster")}
    return out


def phase_small_reference():
    """The card against the port's CPU path on a small input (656 pages:
    the planning engines' select_topk takes the block kernel)."""
    import numpy as np
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    for engine in ("static", "oracle", "hemem", "hmsdk"):
        cfgs = batch_configs(engine)[:4]
        on_card = gups_study(engine, scale=0.02).run(configs=cfgs)
        on_cpu = gups_study(engine, "cpu", scale=0.02).run(configs=cfgs)
        for a, b in zip(on_card, on_cpu):
            if not (np.isfinite(a.epoch_wall_ms).all()
                    and a.epoch_wall_ms.shape == (EPOCHS,)):
                fail(f"{engine}: non-finite or misshapen walls")
            if engine in ("static", "oracle"):
                if not np.array_equal(a.cum_migrations, b.cum_migrations):
                    fail(f"{engine}: migrations differ from the CPU path")
                if not np.allclose(a.epoch_wall_ms, b.epoch_wall_ms,
                                   rtol=1e-5, atol=0):
                    fail(f"{engine}: walls differ from the CPU path")
            else:
                mig = abs(a.cum_migrations[-1] - b.cum_migrations[-1]) \
                    / max(b.cum_migrations[-1], 1.0)
                if mig > 0.01 or abs(a.total_s - b.total_s) > 1e-3 * b.total_s:
                    fail(f"{engine}: card and CPU path disagree")
    by_variant = ops.launch_counts_by_variant()["select_topk"]
    if by_variant["block"] == 0 or by_variant["cluster"] != 0:
        fail(f"small input: select_topk launches by variant {by_variant}, "
             f"expected all on block")
    print(f"small input (gups, scale 0.02): card agrees with the CPU path; "
          f"select_topk launches by variant {json.dumps(by_variant)}",
          flush=True)


def phase_study_run():
    import numpy as np
    from repro_torch.kernels import ops
    for engine in PLANNING + ("static",):
        study = gups_study(engine)
        cfgs = batch_configs(engine)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = study.run(configs=cfgs)
        wall_s = time.perf_counter() - t0
        launches = ops.launch_counts()["select_topk"]
        by_variant = ops.launch_counts_by_variant()["select_topk"]
        want = EPOCHS if engine in PLANNING else 0
        if launches != want or by_variant != {"block": 0, "cluster": want}:
            fail(f"{engine}: {launches} select_topk launches ({by_variant}), "
                 f"expected {want}, all on the cluster kernel")
        n_pages = study.workload().n_pages
        for r in res:
            if not (r.epoch_wall_ms.shape == (EPOCHS,)
                    and np.isfinite(r.epoch_wall_ms).all() and r.total_s > 0):
                fail(f"{engine}: non-finite or misshapen result")
        again = study.run(configs=cfgs)
        ops.FORCE = "plain"
        try:
            plain = study.run(configs=cfgs)
        finally:
            ops.FORCE = None
        for name, other in (("rerun", again), ("plain selection", plain)):
            for a, b in zip(res, other):
                if not (np.array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
                        and np.array_equal(a.cum_migrations,
                                           b.cum_migrations)):
                    fail(f"{engine}: {name} is not bitwise equal")
        dup = study.run(configs=cfgs[:4] * 2)
        for i in range(4):
            if not (np.array_equal(dup[i].epoch_wall_ms,
                                   dup[i + 4].epoch_wall_ms)
                    and np.array_equal(dup[i].cum_migrations,
                                       dup[i + 4].cum_migrations)):
                fail(f"{engine}: identical configs differ under CRN")
        print(f"Study.run {engine}: n_pages={n_pages}, B={BATCH}, "
              f"{launches} launches, wall {wall_s:.3f} s, default total_s "
              f"{res[0].total_s:.4f}, migrations "
              f"{int(res[0].cum_migrations[-1])}", flush=True)


def phase_tune():
    import numpy as np
    from repro_torch.kernels import ops
    study = gups_study("hemem")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result = study.tune(budget=16, batch_size=BATCH, seed=0)
    wall_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    by_variant = ops.launch_counts_by_variant()["select_topk"]
    # one default evaluation plus two rounds of 8, each a 60-epoch run
    if launches["select_topk"] != 3 * EPOCHS \
            or by_variant != {"block": 0, "cluster": 3 * EPOCHS}:
        fail(f"Study.tune: {launches} launches ({by_variant}), expected "
             f"{3 * EPOCHS}, all on the cluster kernel")
    if len(result.history) != 16 or not np.isfinite(result.best_value):
        fail("Study.tune: incomplete or non-finite history")
    print(f"Study.tune hemem: incumbent total_s {result.best_value:.4f}, "
          f"default total_s {result.default_value:.4f}, tuning wall "
          f"{wall_s:.3f} s, select_topk launches {json.dumps(by_variant)}",
          flush=True)
    return launches, by_variant


# ---------------------------------------------------------------------------
# the paper's Bayesian-optimisation surface: the acquisition on the card
# ---------------------------------------------------------------------------

#: the acquisition's pool: SMAC's 512 candidates a model round (one row)
ACQ_N = 512
#: the paper's benchmark suite with default inputs (Table 4), as
#: ``benchmarks/common.py`` lists it
SUITE = [
    ("gapbs-bc", "kron"), ("gapbs-pr", "kron"), ("gapbs-cc", "kron"),
    ("silo", "ycsb-c"), ("btree", ""), ("xsbench", ""),
    ("gups", "8GiB-hot"), ("graph500", "kron"),
]
#: how far two float32 EIs may lie apart, relative, for the card's and the
#: numpy path's selections to swap them (the card computes in float32 with
#: the exact erf, numpy in float64 with the Abramowitz-Stegun erf)
EI_SWAP_RTOL = 1e-5


def as_read_in_float32(forest, X):
    """The forest's thresholds and the pool rounded to float32 and back:
    what the card's (and the reference's jitted) descent compares.  A
    threshold halfway between two observed grid values of an integer knob
    is itself a grid value in exact arithmetic (the split between 6 and 8
    is 7), but float64 may round it one ulp below the candidate's 7, which
    then goes right where float32, seeing them equal, sends it left."""
    import dataclasses
    import numpy as np

    def f32(a):
        return a.astype(np.float32).astype(np.float64)

    return dataclasses.replace(forest, threshold=f32(forest.threshold)), \
        f32(X)


def topk_mask_args(scores, k, valid):
    """The ``select_topk`` kernel inputs ``ops.topk_mask`` builds: the
    promote side over one row of scores, no demote side."""
    import torch
    return [valid.reshape(1, -1), scores.reshape(1, -1), None, None,
            torch.full((1,), float(k), device=scores.device), None]


def phase_topk_mask():
    """``ops.topk_mask`` (the acquisition's top-q) on the card against its
    plain version, then its times at the acquisition's (1, 512)."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops, ref, select_topk as sk
    rng = np.random.default_rng(20)
    n_cases = 0
    for n in (40, 96, ACQ_N, 1024, 1536):
        ei = rng.uniform(0, 1, n).astype(np.float32)
        ei[::4] = ei[1]                            # heavy ties
        scores = torch.from_numpy(ei).cuda()
        valid = torch.from_numpy(rng.uniform(size=n) < 0.8).cuda()
        for k in sorted({0, 1, 5, 40, n}):
            for v in (valid, None):
                ops.FORCE = "plain"
                try:
                    want = ops.topk_mask(scores, k, v)
                finally:
                    ops.FORCE = None
                got = ops.topk_mask(scores, k, v)
                again = ops.topk_mask(scores, k, v)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"topk_mask differs from its plain version at "
                         f"n={n}, k={k}")
                if not torch.equal(got, again):
                    fail(f"topk_mask is not bitwise equal on a rerun at "
                         f"n={n}, k={k}")
                if n > sk.BLOCK_MAX_N:   # both kernels at a cluster shape
                    mask = torch.ones_like(valid) if v is None else v
                    args = topk_mask_args(scores, k, mask)
                    for variant in sk.VARIANTS:
                        pm, _ = sk.select_topk(*args, variant=variant)
                        if not torch.equal(pm[0], want):
                            fail(f"topk_mask's {variant} kernel differs at "
                                 f"n={n}, k={k}")
                n_cases += 1
    print(f"topk_mask: {n_cases} cases (n in 40..1,536, heavy ties, valid "
          f"masks, k in {{0, 1, 5, 40, n}}) bitwise equal to the plain "
          f"version and on reruns; block and cluster forced equal at "
          f"n = 1,536", flush=True)

    # times at the acquisition's shape: one 512-candidate row, q = 4
    ei = rng.uniform(0, 1, ACQ_N).astype(np.float32)
    scores = torch.from_numpy(ei).cuda()
    valid = torch.from_numpy(rng.uniform(size=ACQ_N) < 0.95).cuda()
    k = 4
    args = topk_mask_args(scores, k, valid)
    if sk.pick_variant(1, ACQ_N) != "block":
        fail("the rule does not pick the block kernel at the acquisition's "
             "shape")
    dev = device_ms(lambda: sk.select_topk(*args, variant="block"),
                    TOPK_NAMES["block"])
    kernel_ms = cuda_ms(lambda: ops.topk_mask(scores, k, valid))

    def plain():
        ops.FORCE = "plain"
        try:
            return ops.topk_mask(scores, k, valid)
        finally:
            ops.FORCE = None

    plain_ms = cuda_ms(plain)
    vp, _ = ref.pack_keys(args[0], args[1], torch.zeros_like(args[0]),
                          torch.zeros_like(args[1]))
    idx = torch.arange(ACQ_N, device="cuda", dtype=torch.int64)
    packed = vp[0] << 17 | (ACQ_N - idx)
    library_ms = cuda_ms(lambda: torch.topk(packed, k))
    library_dev = device_ms(lambda: torch.topk(packed, k), None)
    # what topk_mask needs: the scores, the valid mask, the count and the
    # output mask (the kernel reads and writes no demote side)
    moved = ACQ_N * (4 + 1 + 1) + 4
    out = {"shape": [1, ACQ_N], "k": k, "variant": "block",
           "device_ms": dev["device_ms"],
           "device_mean_ms": dev["device_mean_ms"],
           "host_us": dev["host_us"], "kernel_ms": kernel_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_dev["device_ms"],
           "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "bound_bytes": moved}
    print(f"topk_mask at (1, {ACQ_N}), k = {k}: block kernel device "
          f"{out['device_ms']:.6f} ms (mean of launches "
          f"{out['device_mean_ms']:.6f}; host {out['host_us']:.1f} us a "
          f"call), single call {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.topk {library_ms:.4f} ms (device "
          f"{out['library_device_ms']:.6f}), bound {out['bound_ms']:.7f} ms "
          f"({moved} bytes)", flush=True)
    return out


def same_but_near_swaps(sel, sel_np, ei_np):
    """True if the card's selection equals numpy's but for positions whose
    two candidates' float32 EIs (numpy's) lie within ``EI_SWAP_RTOL``."""
    if len(sel) != len(sel_np):
        return False
    for a, b in zip(sel, sel_np):
        if a != b:
            x, y = float(ei_np[a]), float(ei_np[b])
            if abs(x - y) > EI_SWAP_RTOL * max(abs(x), abs(y)):
                return False
    return True


def phase_bo_tune(device="cuda", scale=SCALE):
    """The paper's tuning loop past ``n_init`` with the model on the card:
    every model round's card selection against numpy's on the same
    forest, pool and valid mask.  The two numpy selections of each round
    (the shadow) are timed and taken out of that round's ask time and of
    the tuning wall, which are the main path's."""
    import numpy as np
    from repro_torch.core.bo import forest_fast, smac
    from repro_torch.kernels import ops
    if forest_fast.acquisition_backend(device) != "torch":
        fail(f"the acquisition does not resolve to the card on {device}")
    rounds = []
    shadow_s = []        # the shadow's seconds inside each ask_batch call
    orig = forest_fast.suggest_topq
    orig_ask = smac.SMACOptimizer.ask_batch

    def shadowed(forest, X, best, y_mean, y_std, valid=None, q=1,
                 backend=None, device="cuda"):
        t0 = time.perf_counter()
        ei, sel = orig(forest, X, best, y_mean, y_std, valid=valid, q=q,
                       backend=backend, device=device)
        t1 = time.perf_counter()
        _, sel_f64 = orig(forest, X, best, y_mean, y_std, valid=valid, q=q,
                          backend="numpy")
        t2 = time.perf_counter()
        ei_np, sel_np = orig(*as_read_in_float32(forest, X), best, y_mean,
                             y_std, valid=valid, q=q, backend="numpy")
        if not same_but_near_swaps(sel, sel_np, ei_np):
            fail(f"model round {len(rounds)}: the card selected "
                 f"{sel.tolist()}, numpy on the float32-read inputs "
                 f"{sel_np.tolist()}")
        rounds.append({"pool": int(X.shape[0]), "q": q,
                       "card_ms": (t1 - t0) * 1e3, "numpy_ms": (t2 - t1) * 1e3,
                       "swapped": not np.array_equal(sel, sel_np),
                       "split_ties": not np.array_equal(sel_np, sel_f64)})
        shadow_s[-1] += time.perf_counter() - t1
        return ei, sel

    def ask_batch(self, q):
        shadow_s.append(0.0)
        return orig_ask(self, q)

    study = gups_study("hemem", device, scale)
    forest_fast.suggest_topq = shadowed
    smac.SMACOptimizer.ask_batch = ask_batch
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = study.tune(budget=100, batch_size=4, seed=0)
    finally:
        forest_fast.suggest_topq = orig
        smac.SMACOptimizer.ask_batch = orig_ask
    wall_s = time.perf_counter() - t0 - sum(shadow_s)
    if len(shadow_s) != len(result.round_times):
        fail(f"BO tune: {len(shadow_s)} ask_batch calls for "
             f"{len(result.round_times)} rounds")
    by_variant = ops.launch_counts_by_variant()["select_topk"]
    passes = 1 + len(result.round_times)     # the default, then each round
    if len(result.history) != 100 or not np.isfinite(result.best_value):
        fail("BO tune: incomplete or non-finite history")
    if not rounds or any(r["pool"] != ACQ_N for r in rounds):
        fail(f"BO tune: model rounds {len(rounds)}, pools "
             f"{sorted({r['pool'] for r in rounds})}, expected {ACQ_N}")
    if by_variant != {"block": len(rounds), "cluster": EPOCHS * passes}:
        fail(f"BO tune: select_topk launches {by_variant}, expected "
             f"{len(rounds)} block (one per model round) and "
             f"{EPOCHS * passes} cluster ({passes} Study.run passes)")
    swaps = sum(r["swapped"] for r in rounds)
    split_ties = sum(r["split_ties"] for r in rounds)
    card = [r["card_ms"] for r in rounds]
    host = [r["numpy_ms"] for r in rounds]
    # rounds past the initial design (20 configs, 5 rounds of 4), without
    # the shadow
    ask_ms = [1e3 * (r["ask_s"] - sh) for r, sh
              in zip(result.round_times[5:], shadow_s[5:])]
    fit_ms = [1e3 * r["fit_s"] for r in result.round_times[5:]]
    out = {"model_rounds": len(rounds), "swap_rounds": swaps,
           "split_tie_rounds": split_ties,
           "passes": passes, "launches": dict(by_variant),
           "acquire_card_ms_median": statistics.median(card),
           "acquire_numpy_ms_median": statistics.median(host),
           "acquire_card_ms": card, "acquire_numpy_ms": host,
           "ask_ms_median": statistics.median(ask_ms),
           "fit_ms_median": statistics.median(fit_ms), "wall_s": wall_s,
           "shadow_s": sum(shadow_s),
           "best_s": result.best_value, "default_s": result.default_value}
    print(f"BO tune (hemem, gups, budget 100, q 4, crn): {len(rounds)} model "
          f"rounds, each selection equal to numpy's on the float32-read "
          f"inputs ({swaps} with near-tie swaps; plain float64 numpy "
          f"selected otherwise in {split_ties}, candidates on a split "
          f"point); select_topk {json.dumps(by_variant)} over {passes} "
          f"Study.run passes; acquisition ms per round, median: card "
          f"{out['acquire_card_ms_median']:.3f}, numpy on the same inputs "
          f"{out['acquire_numpy_ms_median']:.3f} (all rounds: card "
          f"{json.dumps([round(x, 3) for x in card])}, numpy "
          f"{json.dumps([round(x, 3) for x in host])}); ask ms per round "
          f"past the initial design median {out['ask_ms_median']:.3f}, of "
          f"it the forest fit {out['fit_ms_median']:.3f}; tuning "
          f"wall {wall_s:.3f} s (both without the numpy shadow's "
          f"{out['shadow_s']:.3f} s); default {result.default_value:.4f} s, "
          f"best {result.best_value:.4f} s", flush=True)
    return out


def same_results(a, b) -> bool:
    """Two lists of SimResults bitwise equal in walls and migrations."""
    import numpy as np
    return all(np.array_equal(x.epoch_wall_ms, y.epoch_wall_ms)
               and np.array_equal(x.cum_migrations, y.cum_migrations)
               for x, y in zip(a, b)) and len(a) == len(b)


def phase_fig2(device="cuda", suite=SUITE, scale=SCALE):
    """Fig. 2 on the card: each suite workload tuned (hemem, the quick
    budget), then default against best through ``Study.sweep``."""
    from repro_torch.core import (ExperimentSpec, SimOptions, Study,
                                  WorkloadSpec)
    from repro_torch.core.bo import knob_importance
    from repro_torch.core.knobs import HEMEM_SPACE
    from repro_torch.kernels import ops
    import numpy as np
    default = HEMEM_SPACE.default_config()
    rows = {}
    ops.reset_launch_counts()
    t_all = time.perf_counter()
    for name, inp in suite:
        study = Study(ExperimentSpec(
            engine="hemem", workload=WorkloadSpec(name, inp, scale=scale),
            options=SimOptions(sampler="sparse", device=device)))
        t0 = time.perf_counter()
        res = study.tune(budget=40, batch_size=4, seed=3)
        tune_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sweep = study.sweep(configs=[default, res.best.config])
        sweep_s = time.perf_counter() - t0
        key = ("hemem", study.spec.workload.key)
        if list(sweep.cells) != [key]:
            fail(f"fig2 {name}: sweep cells {list(sweep.cells)}")
        run = study.run(configs=[default, res.best.config])
        if not same_results(sweep[key], run):
            fail(f"fig2 {name}: the sweep is not bitwise equal to Study.run")
        default_s, best_s = sweep.total_s()[key]
        if not (np.isfinite(default_s) and np.isfinite(best_s)
                and best_s > 0):
            fail(f"fig2 {name}: non-finite times")
        imp = knob_importance(HEMEM_SPACE, res.history)
        rows[study.key] = {
            "default_s": default_s, "best_s": best_s,
            "improvement": default_s / best_s, "tune_s": tune_s,
            "sweep_s": sweep_s, "n_pages": study.workload().n_pages,
            "epochs": study.workload().n_epochs,
            "top_knobs": [[k, v] for k, v in list(imp.items())[:3]]}
        print(f"fig2 {study.key}: default {default_s:.4f} s, best "
              f"{best_s:.4f} s, {default_s / best_s:.3f}x; tune "
              f"{tune_s:.2f} s, sweep {sweep_s:.3f} s; top knobs "
              f"{json.dumps(rows[study.key]['top_knobs'])}", flush=True)
    by_variant = ops.launch_counts_by_variant()["select_topk"]
    imps = {k: v["improvement"] for k, v in rows.items()}
    print(f"fig2 on the card in {time.perf_counter() - t_all:.1f} s, "
          f"select_topk {json.dumps(by_variant)}; the paper's band (a "
          f"finding, not a gate): 1.07-2.09x but graph500 ~1.0x; here "
          f"{json.dumps({k: round(v, 3) for k, v in imps.items()})}",
          flush=True)
    return rows


def phase_engine_sweep(device="cuda", scale=SCALE):
    """hemem, memtis and hmsdk over gups and gapbs-pr at their default
    configs: the reference's cell keys, each cell its own Study.run."""
    from repro_torch.core import (EngineSpec, ExperimentSpec, Study,
                                  WorkloadSpec)
    engines = ["hemem", "memtis", "hmsdk"]
    workloads = ["gups", "gapbs-pr"]
    base = gups_study("hemem", device, scale)
    t0 = time.perf_counter()
    sweep = base.sweep(engines=engines, workloads=workloads)
    wall_s = time.perf_counter() - t0
    wspecs = [WorkloadSpec(w, threads=base.spec.workload.threads,
                           scale=base.spec.workload.scale) for w in workloads]
    keys = [(e, ws.key) for ws in wspecs for e in engines]
    if list(sweep.cells) != keys:
        fail(f"engine sweep: cells {list(sweep.cells)}, expected {keys}")
    for ws in wspecs:
        for e in engines:
            own = Study(ExperimentSpec(
                engine=e, workload=ws, machine=base.spec.machine,
                options=base.spec.options)).run(
                configs=[EngineSpec(e).config])
            if not same_results(sweep[(e, ws.key)], own):
                fail(f"engine sweep: cell ({e}, {ws.key}) is not bitwise "
                     f"equal to its Study.run")
    totals = {f"{e}/{w}": v[0] for (e, w), v in sweep.total_s().items()}
    print(f"engine sweep ({len(sweep)} cells, each bitwise its Study.run) "
          f"in {wall_s:.3f} s: total_s {json.dumps(totals)}", flush=True)


# ---------------------------------------------------------------------------
# asynchronous and online tuning: segments, the tune service, the online
# re-tuner on the GUPS deployment
# ---------------------------------------------------------------------------
#: the async study: 4 thread slots, ASHA rungs at 15, 30 and 60 epochs;
#: budget 40 (the paper's 100 until it was cut for the clock)
TS_KW = dict(budget=40, seed=0, executor="async", slots=4,
             scheduler="asha")
#: the twin study of thread against process slots (its budget and (b)'s
#: are the ones lowered when the phase runs long)
TS_PROC_KW = dict(budget=8, seed=0, executor="async", slots=2,
                  scheduler="asha")
#: async at one slot against sync: with optimizer seed 0 the asks past
#: n_init = 20 are random interleaves (probability 0.2 each) up to the
#: 26th, the first model-phase ask
TS_SYNC_BUDGET = 26
#: journals and the killed child's study go here (build/ is gitignored)
TS_DIR = ROOT / "build" / "tune_service"
#: the killed child's study: (c)'s, on the card, in a fresh interpreter
TS_CHILD = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
Study(ExperimentSpec(
    engine="hemem", workload=WorkloadSpec("gups", "8GiB-hot", scale={scale!r}),
    machine="pmem-large",
    options=SimOptions(seed=0, crn=True, device={device!r}))).tune(
    journal={journal!r}, **{kw!r})
"""
#: online re-tuning: drift-hotspot (gups's hot set rotated every 20
#: epochs) in windows of 10 epochs, 4 candidates a window
ONLINE_W, ONLINE_Q = 10, 4


def topk_counts():
    from repro_torch.kernels import ops
    return dict(ops.launch_counts_by_variant()["select_topk"])


def journal_schema_ok(*paths):
    out = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "journal_schema.py"),
         *map(str, paths)], capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"journal_schema.py: {out.stdout}{out.stderr}")


def phase_tune_service(bo_wall_s, device="cuda", scale=SCALE):
    """(a) segments against Study.run; (b) async at one slot against sync;
    (c) ASHA on 4 thread slots; (e) process slots
    against thread slots; (d) (e)'s study in a SIGKILLed child, resumed;
    (f) online re-tuning on drift-hotspot."""
    import os
    import shutil
    import signal
    import numpy as np
    from repro_torch.core import (ExperimentSpec, SimOptions, Study,
                                  WorkloadSpec)
    from repro_torch.core.bo import forest_fast
    from repro_torch.core.simulator import run_simulation_segment
    from repro_torch.core.tune_service import read_events
    from repro_torch.kernels import ops
    shutil.rmtree(TS_DIR, ignore_errors=True)
    TS_DIR.mkdir(parents=True)
    out = {}

    # (a) segments, carried, against the whole run
    t0 = time.perf_counter()
    study = gups_study("hemem", device, scale)
    cfgs = batch_configs("hemem")[:4]
    whole = study.run(configs=cfgs)
    opts = study.spec.options

    def segments():
        parts, carry = [], None
        for lo, hi in ((0, 15), (15, 30), (30, 60)):
            seg = run_simulation_segment(
                study.workload(), "hemem", cfgs, study.machine,
                seeds=opts.seed, sampler=opts.sampler, crn=True,
                epoch_start=lo, epoch_stop=hi, carry=carry,
                return_carry=True, device=device)
            for b, r in enumerate(whole):
                if not (np.array_equal(seg["wall_ms"][:, b],
                                       r.epoch_wall_ms[lo:hi])
                        and np.float32(r.cum_migrations[hi - 1])
                        == seg["carry"][4][b]):
                    fail(f"segment [{lo}, {hi}) row {b} is not bitwise "
                         f"Study.run's")
            parts.append(seg["wall_ms"])
            carry = seg["carry"]
        return np.concatenate(parts)

    ops.reset_launch_counts()
    first = segments()
    seg_counts = topk_counts()
    if seg_counts != {"block": 0, "cluster": EPOCHS}:
        fail(f"segments: select_topk {seg_counts}, expected {EPOCHS} cluster")
    if not np.array_equal(segments(), first):
        fail("segments: a rerun is not bitwise equal")
    out["a_s"] = time.perf_counter() - t0
    print(f"tune service (a) segments [0,15)+[15,30)+[30,60) at B=4: "
          f"bitwise Study.run's rows and a rerun, select_topk "
          f"{json.dumps(seg_counts)}", flush=True)
    print(f"tune service (a) seconds {out['a_s']:.3f}", flush=True)

    # (b) async at one slot against sync, past n_init: one block launch
    # per model-phase ask
    t0 = time.perf_counter()
    asks = []
    orig = forest_fast.suggest_topq

    def counted(*args, **kw):
        asks.append(1)
        return orig(*args, **kw)

    forest_fast.suggest_topq = counted
    runs = {}
    try:
        for name, kw in (("sync", dict(batch_size=1)),
                         ("async", dict(executor="async", slots=1))):
            del asks[:]
            ops.reset_launch_counts()
            t1 = time.perf_counter()
            res = gups_study("hemem", device, scale).tune(
                budget=TS_SYNC_BUDGET, seed=0, **kw)
            runs[name] = (res, topk_counts(), len(asks),
                          time.perf_counter() - t1)
    finally:
        forest_fast.suggest_topq = orig
    (r_sync, c_sync, a_sync, w_sync), (r_async, c_async, a_async, w_async) \
        = runs["sync"], runs["async"]
    if [(o.config, o.value) for o in r_sync.history] != \
            [(o.config, o.value) for o in r_async.history] \
            or r_sync.default_value != r_async.default_value:
        fail("async at slots=1: history differs from sync")
    passes = EPOCHS * (TS_SYNC_BUDGET + 1)
    for name, c, a in (("sync", c_sync, a_sync), ("async", c_async,
                                                  a_async)):
        if not a or c != {"block": a, "cluster": passes}:
            fail(f"{name} tune: select_topk {c}, expected {a} block (one "
                 f"per model-phase ask, at least one) and {passes} cluster")
    out["b_s"] = time.perf_counter() - t0
    out["b"] = {"sync_wall_s": w_sync, "async_wall_s": w_async,
                "model_asks": a_async, "launches": c_async}
    print(f"tune service (b) async slots=1 == sync bitwise (budget "
          f"{TS_SYNC_BUDGET}, {a_async} model-phase asks), select_topk "
          f"{json.dumps(c_async)}; wall sync {w_sync:.3f} s, async "
          f"{w_async:.3f} s", flush=True)
    print(f"tune service (b) seconds {out['b_s']:.3f}", flush=True)

    # (c) ASHA on 4 thread slots ((g1) reruns it
    # on the fleet)
    t0 = time.perf_counter()
    first = TS_DIR / "asha0.jsonl"
    ops.reset_launch_counts()
    res = gups_study("hemem", device, scale).tune(journal=str(first),
                                                  **TS_KW)
    c_counts = topk_counts()
    if c_counts["cluster"] != res.epochs_evaluated:
        fail(f"ASHA study: {c_counts['cluster']} cluster launches, "
             f"{res.epochs_evaluated} epochs evaluated")
    rungs = sorted({t["epochs_run"] for t in res.trials})
    if not set(rungs) <= {15, 30, 60} or res.n_stopped_early == 0:
        fail(f"ASHA study: rungs {rungs}, {res.n_stopped_early} stopped")
    if any(e["event"] == "fail" for e in read_events(str(first))):
        fail("ASHA study: a trial failed")
    journal_schema_ok(first)
    out["c_s"] = time.perf_counter() - t0
    out["c"] = {
        "makespan_s": res.makespan_s, "utilization": res.utilization,
        "asha_epochs_saved_frac": res.asha_epochs_saved_frac,
        "epochs_evaluated": res.epochs_evaluated,
        "epochs_committed": res.epochs_committed,
        "stopped_early": res.n_stopped_early, "launches": c_counts,
        "best_s": res.best_value, "default_s": res.default_value,
        "sync_q4_wall_s": bo_wall_s}
    print(f"tune service (c) ASHA budget {TS_KW['budget']}, 4 thread "
          f"slots: makespan "
          f"{res.makespan_s:.3f} s, slot utilization "
          f"{res.utilization:.4f}, asha_epochs_saved_frac "
          f"{res.asha_epochs_saved_frac:.4f} ({res.n_stopped_early} "
          f"stopped early), epochs evaluated {res.epochs_evaluated} = "
          f"cluster launches, block {c_counts['block']}; incumbent "
          f"{res.best_value:.4f} s against default "
          f"{res.default_value:.4f} s "
          f"({res.default_value / res.best_value:.4f}x); the sync "
          f"Study.tune(budget=100, batch_size=4) of phase 6 (b) took "
          f"{bo_wall_s:.3f} s; no failed trial, journal valid", flush=True)
    print(f"tune service (c) seconds {out['c_s']:.3f}", flush=True)

    # (e) process slots against thread slots
    t0 = time.perf_counter()
    twins, small = {}, {}
    for pool in ("thread", "process"):
        path = TS_DIR / f"{pool}.jsonl"
        t1 = time.perf_counter()
        small[pool] = gups_study("hemem", device, scale).tune(
            journal=str(path), pool=pool, **TS_PROC_KW)
        twins[pool] = (path, time.perf_counter() - t1)
    if twins["thread"][0].read_bytes() != twins["process"][0].read_bytes():
        fail("process slots: the journal differs from thread slots'")
    journal_schema_ok(twins["thread"][0], twins["process"][0])
    out["e_s"] = time.perf_counter() - t0
    out["e"] = {pool: wall for pool, (_, wall) in twins.items()}
    print(f"tune service (e) 2 process slots (spawned, CUDA in each) == 2 "
          f"thread slots, journals byte-identical (budget "
          f"{TS_PROC_KW['budget']}): wall thread {twins['thread'][1]:.3f} "
          f"s, process {twins['process'][1]:.3f} s", flush=True)
    print(f"tune service (e) seconds {out['e_s']:.3f}", flush=True)

    # (d) (e)'s thread-slot study in a child process, SIGKILLed, resumed
    # here
    t0 = time.perf_counter()
    small_journal = twins["thread"][0]
    killed = TS_DIR / "killed.jsonl"
    # killed three quarters in, so the resume here re-evaluates a quarter
    kill_at = max(4, 3 * len(small_journal.read_bytes().splitlines()) // 4)
    proc = subprocess.Popen(
        [sys.executable, "-c", TS_CHILD.format(
            src=str(ROOT / "src"), scale=scale, device=device,
            journal=str(killed), kw=TS_PROC_KW)],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline and proc.poll() is None:
            if killed.exists() and \
                    len(killed.read_bytes().splitlines()) >= kill_at:
                break
            time.sleep(0.01)
        else:
            fail(f"the child study never reached {kill_at} journal "
                 f"lines: " + proc.stderr.read().decode()[-2000:])
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=60)
        proc.stderr.close()
    n_killed = len(read_events(str(killed)))
    if not 0 < n_killed < len(read_events(str(small_journal))):
        fail(f"the killed journal holds {n_killed} events")
    resumed = gups_study("hemem", device, scale).tune(
        journal=str(killed), resume=True, **TS_PROC_KW)
    if killed.read_bytes() != small_journal.read_bytes():
        fail("killed.jsonl: the resumed journal differs from (e)'s thread "
             "slots'")
    if resumed.trials != small["thread"].trials:
        fail("the resumed study's trials differ from (e)'s thread slots'")
    journal_schema_ok(killed)
    out["d_s"] = time.perf_counter() - t0
    out["d"] = {"resume_makespan_s": resumed.makespan_s,
                "killed_after_events": n_killed}
    print(f"tune service (d) (e)'s thread-slot study (budget "
          f"{TS_PROC_KW['budget']}) in a child process SIGKILLed after "
          f"{n_killed} events, resumed here (makespan "
          f"{resumed.makespan_s:.3f} s): journal byte-identical to (e)'s, "
          f"trials equal, journal valid", flush=True)
    print(f"tune service (d) seconds {out['d_s']:.3f}", flush=True)

    # (f) online re-tuning on drift-hotspot
    t0 = time.perf_counter()
    online = Study(ExperimentSpec(
        engine="hemem",
        workload=WorkloadSpec("drift-hotspot", scale=scale),
        machine="pmem-large",
        options=SimOptions(seed=0, crn=True, device=device)))
    wl = online.workload()
    runs = []
    for i in range(2):
        path = TS_DIR / f"online{i}.jsonl"
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        r = online.tune(online=True, window_epochs=ONLINE_W,
                        batch_size=ONLINE_Q, seed=0, journal=str(path))
        runs.append((r, topk_counts(), path, time.perf_counter() - t1))
    r, counts, path, wall_s = runs[0]
    if path.read_bytes() != runs[1][2].read_bytes():
        fail("online: the rerun's journal differs")
    if r.thrash_events != 0:
        fail(f"online: {r.thrash_events} thrash events")
    if counts["cluster"] != len(r.windows) * ONLINE_W:
        fail(f"online: {counts['cluster']} cluster launches for "
             f"{len(r.windows)} windows of {ONLINE_W}")
    from repro_torch.core.drift import BUILTIN_DRIFTS
    switch_epochs = BUILTIN_DRIFTS["drift-hotspot"].switch_epochs
    readapt = []
    for s in switch_epochs:
        k0 = -(-s // ONLINE_W)
        if not r.windows[k0].detect:
            fail(f"online: the switch at epoch {s} was not detected in "
                 f"window {k0}")
        after = [w.index for w in r.windows[k0:] if w.switched]
        readapt.append(after[0] - k0 if after else None)
    default_ms = 1e3 * online.run().total_s
    out["f_s"] = time.perf_counter() - t0
    out["f"] = {
        "n_pages": wl.n_pages, "windows": len(r.windows),
        "detections": r.detections, "switches": r.switches,
        "switch_windows": r.switch_windows, "guard_blocks": r.guard_blocks,
        "thrash_events": r.thrash_events, "readapt_windows": readapt,
        "deployed_wall_ms": r.total_wall_ms, "default_wall_ms": default_ms,
        "launches": counts, "wall_s": wall_s}
    print(f"tune service (f) online on drift-hotspot ({wl.n_pages} pages, "
          f"switches at {list(switch_epochs)}), windows of {ONLINE_W}, q "
          f"{ONLINE_Q}: {len(r.windows)} windows, detections "
          f"{[w.index for w in r.windows if w.detect]}, config switches "
          f"{r.switch_windows}, guard blocks {r.guard_blocks}, thrash 0; "
          f"windows from a phase switch to the config switch {readapt}; "
          f"deployed wall {r.total_wall_ms:.3f} ms against the default "
          f"config's {default_ms:.3f} ms "
          f"({default_ms / r.total_wall_ms:.4f}x); select_topk "
          f"{json.dumps(counts)}; tuning wall {wall_s:.3f} s; journal "
          f"rerun byte-identical", flush=True)
    print(f"tune service (f) seconds {out['f_s']:.3f}", flush=True)
    return out, res, small["thread"]


# ---------------------------------------------------------------------------
# the fault-tolerant fleet: spawned workers on the card, its launcher
# ---------------------------------------------------------------------------
#: (g1): (c)'s study on 4 spawned process workers
FLEET_KW = dict(TS_KW, executor="fleet", workers=4, pool="process")
#: (g2) and (g3): TS_PROC_KW's study on 2 workers
FLEET_SMALL_KW = dict(TS_PROC_KW, executor="fleet", workers=2)


def fleet_receipt(res):
    fs = res.fleet
    return {k: fs[k] for k in (
        "n_reissues", "n_expired_leases", "n_worker_deaths", "n_respawns",
        "n_spare_promotions", "n_duplicate_results", "n_reconnects",
        "n_rejected_frames", "degraded")}


def same_study(res, base):
    """``res`` made every decision ``base`` made, bitwise."""
    return res.trials == base.trials and \
        [(o.config, o.value) for o in res.history] == \
        [(o.config, o.value) for o in base.history] and \
        res.best_value == base.best_value and \
        res.default_value == base.default_value


def clean_fleet(res, what):
    r = fleet_receipt(res)
    if r["n_expired_leases"] or r["n_worker_deaths"] or \
            r["n_duplicate_results"] or r["degraded"]:
        fail(f"{what}: the clean fleet's receipt {r}")


def fleet_faulted(what, kw, plan, scale, device, **more):
    """A journaled fleet study under a fault plan: the result, its
    seconds and its journal's events (the journal valid)."""
    from repro_torch.core.tune_service import read_events
    path = TS_DIR / f"{what}.jsonl"
    t1 = time.perf_counter()
    res = gups_study("hemem", device, scale).tune(
        journal=str(path), faults=plan, **kw, **more)
    wall = time.perf_counter() - t1
    journal_schema_ok(path)
    return res, wall, read_events(str(path))


def phase_fleet(asha, small, device="cuda", scale=SCALE):
    """(g1) (c)'s study ``asha`` on a clean 4-worker process fleet; (g2)
    a killed worker; (g3) a socket fleet from the launcher, and a truncated
    result on a socket fleet.
    (g2) and (g3) are held to (e)'s thread-slot study ``small`` at their
    budget, which the fleet equals bitwise as (g1) shows at (c)'s."""
    import os
    import signal
    from repro_torch.core.tune_service import FaultPlan, FleetSpec
    from repro_torch.kernels import ops
    out = {}

    # (g1) (c)'s study on 4 spawned workers
    t0 = time.perf_counter()
    path = TS_DIR / "fleet.jsonl"
    ops.reset_launch_counts()
    res = gups_study("hemem", device, scale).tune(journal=str(path),
                                                  **FLEET_KW)
    own = topk_counts()
    workers = dict(res.fleet["kernel_launches"]["select_topk"])
    if not same_study(res, asha):
        fail("(g1) the fleet's study differs from (c)'s async study")
    clean_fleet(res, "(g1)")
    if workers != {"block": 0, "cluster": res.epochs_evaluated}:
        fail(f"(g1) the workers launched select_topk {workers}, expected "
             f"{res.epochs_evaluated} cluster (one per epoch evaluated)")
    if own["cluster"] != 0 or own["block"] == 0:
        fail(f"(g1) the coordinator launched select_topk {own}: expected "
             f"the model-phase asks' block launches only")
    journal_schema_ok(path)
    out["g1_s"] = time.perf_counter() - t0
    out["g1"] = {
        "makespan_s": res.makespan_s, "utilization": res.utilization,
        "epochs_evaluated": res.epochs_evaluated,
        "epochs_committed": res.epochs_committed,
        "async_makespan_s": asha.makespan_s,
        "async_epochs_evaluated": asha.epochs_evaluated,
        "worker_launches": workers, "coordinator_launches": own,
        "launches": {v: workers[v] + own[v] for v in workers},
        "receipt": fleet_receipt(res), "best_s": res.best_value}
    print(f"fleet (g1) ASHA budget {FLEET_KW['budget']} on "
          f"{FLEET_KW['workers']} spawned process workers: "
          f"trials, history, incumbent and default bitwise (c)'s; makespan "
          f"{res.makespan_s:.3f} s against (c)'s {asha.makespan_s:.3f} s on "
          f"4 thread slots ({asha.makespan_s / res.makespan_s:.3f}x), "
          f"utilization {res.utilization:.4f}, epochs evaluated "
          f"{res.epochs_evaluated} (async {asha.epochs_evaluated}: the "
          f"promotions re-derive their prefixes) = the workers' cluster "
          f"launches, the coordinator's block launches {own['block']}; "
          f"receipt {json.dumps(fleet_receipt(res))}", flush=True)
    print(f"fleet (g1) seconds {out['g1_s']:.3f}", flush=True)

    # (g2) a killed worker at TS_PROC_KW's budget
    t0 = time.perf_counter()
    killed, kill_s, events = fleet_faulted(
        "fleet_kill", FLEET_SMALL_KW, FaultPlan(kill=[(2, 0)]), scale, device)
    if not same_study(killed, small):
        fail("(g2) the killed fleet's study differs from (e)'s")
    rc = fleet_receipt(killed)
    if rc["n_worker_deaths"] != 1 or rc["n_respawns"] != 1:
        fail(f"(g2) receipt {rc}")
    expires = [(e["unit"], e["attempt"], e["reason"]) for e in events
               if e["event"] == "expire"]
    if expires != [(2, 0, "worker-dead")]:
        fail(f"(g2) expiries {expires}, receipt {rc}, seconds to recover "
             f"{killed.fleet['time_to_recover_s']}")
    out["g2_s"] = time.perf_counter() - t0
    out["g2"] = {"kill_wall_s": kill_s, "receipt": rc,
                 "recover_s": killed.fleet["time_to_recover_s"]}
    print(f"fleet (g2) budget {TS_PROC_KW['budget']} on 2 workers: kill "
          f"(2, 0) ({kill_s:.3f} s), one worker-dead expiry, one respawn, "
          f"study bitwise (e)'s thread slots'; receipt "
          f"{json.dumps(out['g2']['receipt'])}", flush=True)
    print(f"fleet (g2) seconds {out['g2_s']:.3f}", flush=True)

    # (g3) a socket fleet from the launcher, then a truncated result
    t0 = time.perf_counter()
    spec_path = TS_DIR / "fleet_spec.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    init = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fleet", str(spec_path),
         "--init", "--workers", "2"], env=env, capture_output=True,
        text=True, timeout=120)
    if init.returncode != 0:
        fail(f"launcher --init: {init.stdout}{init.stderr}")
    spec = FleetSpec.load(str(spec_path))
    launched = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fleet", str(spec_path),
         "--device", device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        path = TS_DIR / "fleet_socket.jsonl"
        t1 = time.perf_counter()
        sock = gups_study("hemem", device, scale).tune(
            journal=str(path), fleet_spec=spec,
            **{k: v for k, v in FLEET_SMALL_KW.items() if k != "workers"})
        sock_s = time.perf_counter() - t1
        log, _ = launched.communicate(timeout=120)
    finally:
        if launched.poll() is None:  # SIGTERM: the launcher stops its
            launched.send_signal(signal.SIGTERM)  # workers
            try:
                launched.communicate(timeout=30)
            except subprocess.TimeoutExpired:
                launched.kill()
                launched.communicate(timeout=30)
    if launched.returncode != 0 or "all 2 workers greeted" not in log:
        fail(f"launcher: exit {launched.returncode}\n{log[-2000:]}")
    if not same_study(sock, small):
        fail("(g3) the socket fleet's study differs from (e)'s")
    clean_fleet(sock, "(g3)")
    if spec.auth_key.encode() in path.read_bytes():
        fail("(g3) the fleet's key is in the journal")
    journal_schema_ok(path)
    cut, cut_s, events = fleet_faulted(
        "fleet_truncate", FLEET_SMALL_KW, FaultPlan(truncate=[(2, 0)]),
        scale, device, pool="socket")
    rejects = [(e["unit"], e["attempt"], e["reason"]) for e in events
               if e["event"] == "reject"]
    if rejects != [(2, 0, "truncated")]:
        fail(f"(g3) rejects {rejects}")
    if not same_study(cut, small):
        fail("(g3) the truncated fleet's study differs from (e)'s")
    out["g3_s"] = time.perf_counter() - t0
    out["g3"] = {"launcher_wall_s": sock_s, "truncate_wall_s": cut_s,
                 "receipt": fleet_receipt(cut)}
    print(f"fleet (g3) socket fleet of 2 launcher workers (spec from "
          f"--init) {sock_s:.3f} s, study bitwise (e)'s; truncate (2, 0) "
          f"({cut_s:.3f} s), one reject (truncated), study bitwise (e)'s; "
          f"journals valid", flush=True)
    print(f"fleet (g3) seconds {out['g3_s']:.3f}", flush=True)
    return out


# ---------------------------------------------------------------------------
# tiered-KV serving
# ---------------------------------------------------------------------------
#: the serving main path: chatglm3-6b's KV width, 64 slots x 32 pages of
#: 64 tokens (2,048 logical pages), 256 HBM pages (1/8), 1,024 steps
SERVING = dict(model="chatglm3-6b", batch=64, max_pages=32, hbm_frac=1 / 8,
               steps=1024, tune_steps=256, profile_steps=256, decode_lo=256,
               decode_hi=1024, engine_every=8, dt_ms=50.0, tune_budget=8)


def serving_traffic(steps):
    from repro_torch.core.traffic import TrafficSpec
    b = SERVING["batch"]
    # the repo's arrival rule: batch / 24 requests per step
    return TrafficSpec(pattern="bursty-diurnal", arrival_rate=b / 24,
                       steps=steps, decode_lo=SERVING["decode_lo"],
                       decode_hi=SERVING["decode_hi"])


def serving_replay(config, steps, device="cuda", **kw):
    from repro_torch.core.tiered_kv import KV_MODELS
    from repro_torch.serving_replay import replay
    model = KV_MODELS[SERVING["model"]]
    return replay(config, serving_traffic(steps), batch=SERVING["batch"],
                  max_pages=SERVING["max_pages"],
                  hbm_frac=SERVING["hbm_frac"],
                  engine_every=SERVING["engine_every"],
                  dt_ms=SERVING["dt_ms"], spec=model.spec,
                  q_heads=model.q_heads, device=device, **kw)


def expected_serving_launches(steps):
    """Launches the replay must make: paged_attention once per step with an
    active sequence; per engine epoch page_migrate 4 and select_topk 1;
    no flash_attention."""
    from repro_torch.core.traffic import replay_schedule
    b, mp = SERVING["batch"], SERVING["max_pages"]
    from repro_torch.core.tiered_kv import KV_MODELS
    pt = KV_MODELS[SERVING["model"]].spec.page_tokens
    sched = replay_schedule(serving_traffic(steps), b, mp * pt, 0)
    decoded = sched["active"].any(axis=1)
    every = SERVING["engine_every"]
    epochs = int(sum(decoded[t] for t in range(steps)
                     if t % every == every - 1))
    return {"paged_attention": int(decoded.sum()),
            "page_migrate": 4 * epochs, "select_topk": epochs,
            "flash_attention": 0}


def migrate_cases(device):
    """(name, dst, src, dst_ids, src_ids) cases of the conformance set."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    cases = []

    def pools(P, Q, elems, dtype):
        return (torch.from_numpy(rng.normal(size=(P, elems))).to(device, dtype),
                torch.from_numpy(rng.normal(size=(Q, elems))).to(device, dtype))

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        ids = [("row-0 no-op", 6, 6, 64, [0, -1], [2, 1]),
               ("duplicates", 6, 8, 64, [2, 3, 2, 5, -1, 2], [1, 0, 4, 4, 3, 7]),
               ("no lanes", 4, 4, 64, [], []),
               ("rows of 7 elements", 5, 5, 7, [1, 4, 0, -1], [3, 3, 2, 0]),
               ("misaligned rows", 9, 9, 4099, [8, 0, 3, 3], [0, 8, -1, 5])]
        for name, P, Q, elems, d, s_ in ids:
            dst, src = pools(P, Q, elems, dtype)
            cases.append((f"{name} ({tag})", dst, src,
                          torch.tensor(d, dtype=torch.int32, device=device),
                          torch.tensor(s_, dtype=torch.int32, device=device)))
        P, Q, elems = 300, 400, 4096
        dst, src = pools(P, Q, elems, dtype)
        d = torch.from_numpy(rng.integers(-1, P, 512).astype(np.int32))
        s_ = torch.from_numpy(rng.integers(-1, Q, 512).astype(np.int32))
        cases.append((f"random 512 lanes ({tag})", dst, src, d.to(device),
                      s_.to(device)))
    return cases


def serving_migrate_args(device):
    """The serving shape: promote 256 pages of chatglm3-6b's KV width from
    the host pool (2,049 rows) into the HBM pool (257 rows), every lane
    valid."""
    import torch
    from repro_torch.core.tiered_kv import KV_MODELS
    spec = KV_MODELS[SERVING["model"]].spec
    elems = spec.n_layers * spec.page_tokens * spec.kv_heads * spec.head_dim
    n = SERVING["batch"] * SERVING["max_pages"]
    H = int(n * SERVING["hbm_frac"])
    g = torch.Generator(device=device).manual_seed(3)
    dst = torch.randn((H + 1, elems), generator=g, device=device
                      ).to(spec.dtype)
    src = torch.randn((n + 1, elems), generator=g, device=device
                      ).to(spec.dtype)
    d = torch.randperm(H, generator=g, device=device).int()
    s = torch.randperm(n, generator=g, device=device)[:H].int()
    return dst, src, d, s


def phase_page_migrate():
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import page_migrate as pmk
    cases = migrate_cases("cuda")
    cases.append(("serving shape", *serving_migrate_args("cuda")))
    for name, dst, src, d, s in cases:
        want = ref.page_migrate_plain(dst.clone(), src, d, s)
        got = ops.page_migrate(dst, src, d, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"page_migrate differs from its plain version on {name}")
    print(f"page_migrate: {len(cases)} cases bitwise equal to the plain "
          f"version", flush=True)
    dst, src, d, s = cases[-1][1:]
    dl, sl = d.long(), s.long()
    kernel_ms = cuda_ms(lambda: pmk.page_migrate(dst, src, d, s))
    dev = device_ms(lambda: pmk.page_migrate(dst, src, d, s),
                    ("page_migrate_copy", "page_migrate_winner"))
    plain_ms = cuda_ms(lambda: ref.page_migrate_plain(dst, src, d, s))
    library_ms = cuda_ms(lambda: dst.index_copy_(0, dl, src.index_select(0, sl)))
    library_dev = device_ms(
        lambda: dst.index_copy_(0, dl, src.index_select(0, sl)), None)
    moved = 2 * d.numel() * dst[0].numel() * dst.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    print(f"page_migrate at the serving shape ({d.numel()} lanes of "
          f"{dst[0].numel() * dst.element_size()} B): kernel device "
          f"{dev['device_ms']:.5f} ms ({bound_ms / dev['device_ms']:.1%} of "
          f"the bound), single call {kernel_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_select+index_copy_ {library_ms:.4f} ms "
          f"(device {library_dev['device_ms']:.5f}), bound {bound_ms:.5f} ms "
          f"({moved} bytes)", flush=True)
    return {"max_abs_err": 0.0, "kernel_ms": kernel_ms,
            "device_ms": dev["device_ms"],
            "device_mean_ms": dev["device_mean_ms"],
            "host_us": dev["host_us"], "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_dev["device_ms"],
            "bound_ms": bound_ms}


def attention_case(device, dtype, B, H, KV, D, page, ppseq, P, layers, seed):
    """q, layer-0 views of (P, layers, page, KV, D) pools, a block table
    with -1 entries, and lengths 0 (row 0), full (last row), partial (row
    1) and random."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(B, H, D))).to(device, dtype)
    k = torch.from_numpy(rng.normal(size=(P, layers, page, KV, D))).to(device, dtype)
    v = torch.from_numpy(rng.normal(size=(P, layers, page, KV, D))).to(device, dtype)
    table = np.stack([rng.choice(P, ppseq, replace=False) for _ in range(B)])
    table = np.where(rng.uniform(size=table.shape) < 0.25, -1, table)
    lengths = rng.integers(0, page * ppseq + 1, B)
    lengths[0] = 0
    lengths[-1] = page * ppseq
    if B > 2:
        lengths[1] = page // 2 + 1
    return (q, k[:, 0], v[:, 0],
            torch.from_numpy(table.astype(np.int32)).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


def serving_attention_args(device):
    """The serving shape: q (64, 32, 128) bf16 over the layer-0 view of a
    (257, 28, 64, 2, 128) HBM pool; the 256 slots spread 4 per sequence
    over pages below its length, the rest of the table -1."""
    import numpy as np
    import torch
    from repro_torch.core.tiered_kv import KV_MODELS
    model = KV_MODELS[SERVING["model"]]
    spec = model.spec
    B, mp = SERVING["batch"], SERVING["max_pages"]
    H = int(B * mp * SERVING["hbm_frac"])
    rng = np.random.default_rng(5)
    g = torch.Generator(device=device).manual_seed(5)
    shape = (H + 1, spec.n_layers, spec.page_tokens, spec.kv_heads,
             spec.head_dim)
    pool_k = torch.randn(shape, generator=g, device=device).to(spec.dtype)
    pool_v = torch.randn(shape, generator=g, device=device).to(spec.dtype)
    q = torch.randn((B, model.q_heads, spec.head_dim), generator=g,
                    device=device).to(spec.dtype)
    lengths = rng.integers(4 * spec.page_tokens, mp * spec.page_tokens + 1, B)
    table = np.full((B, mp), -1, np.int32)
    slots = rng.permutation(H)
    per = H // B
    for b in range(B):
        n_p = (lengths[b] - 1) // spec.page_tokens + 1
        pages = rng.choice(n_p, per, replace=False)
        table[b, pages] = slots[b * per:(b + 1) * per]
    return (q, pool_k[:, 0], pool_v[:, 0], torch.from_numpy(table).to(device),
            torch.from_numpy(lengths.astype(np.int32)).to(device))


def attended_positions(table, lengths, page):
    """Resident positions each sequence attends: (B,) int64 on the host."""
    import torch
    t = table.cpu().long()
    ln = lengths.cpu().long()
    pos = torch.arange(t.shape[1] * page)
    ok = (pos[None, :] < ln[:, None]) & (t[:, pos // page] >= 0)
    return ok, ok.sum(1)


#: the kernels each paged_attention variant launches (profiler names)
PAGED_NAMES = {"split": ("paged_attention_split_kernel",
                         "paged_attention_combine_kernel"),
               "walk": ("paged_attention_kernel<",)}


def paged_runs(pak, args, dtype, G, D, page):
    """(name, kwargs) runs of one case: the rule's kernel, the walk kernel
    where it takes the case, and the split kernel at the fewest splits,
    one more, and 8 where the rule picks it."""
    runs = [("rule", None)]
    variant = pak.pick_variant(dtype, G, D, page)
    if variant == "split":
        if G * D <= pak.MAX_GROUP_ELEMS:
            runs.append(("walk", dict(variant="walk")))
        least = max(1, -(-args[3].shape[1] // pak.MAX_SHARE))
        runs += [(f"split x{n}", dict(variant="split", splits=n))
                 for n in sorted({least, least + 1, max(least, 8)})]
    return runs


def phase_paged_attention():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as pak
    max_err = 0.0
    n = 0
    shapes = [  # B, H, KV, D, page, ppseq, P, layers
        (2, 8, 4, 64, 16, 4, 16, 1), (3, 4, 1, 128, 8, 8, 64, 1),
        (4, 2, 2, 128, 64, 4, 24, 3), (8, 32, 2, 128, 64, 8, 40, 3),
        (3, 64, 2, 128, 32, 40, 90, 2), (5, 4, 4, 64, 32, 6, 30, 1)]
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2),
                       (torch.float16, 1e-2)):
        for shape in shapes:
            _, H, KV, D, page = shape[:5]
            for cap in (0.0, 30.0):
                args = attention_case("cuda", dtype, *shape, seed=n)
                want = ref.paged_attention_plain(*args, logit_softcap=cap)
                for run, kw in paged_runs(pak, args, dtype, H // KV, D, page):
                    def call():
                        if kw is None:
                            return ops.paged_attention(*args,
                                                       logit_softcap=cap)
                        return pak.paged_attention(*args, logit_softcap=cap,
                                                   **kw)
                    got = call()
                    again = call()
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    if dtype != torch.float32:
                        max_err = max(max_err, err)
                    if not torch.allclose(got.float(), want.float(),
                                          atol=tol, rtol=tol):
                        fail(f"paged_attention ({run}) differs from its "
                             f"plain version ({dtype}, shape {shape}, cap "
                             f"{cap}): {err}")
                    if not torch.equal(got, again):
                        fail(f"paged_attention ({run}) is not bitwise equal "
                             f"on a rerun ({dtype}, shape {shape})")
                    n += 1
    args = serving_attention_args("cuda")
    q, k, v, table, lengths = args
    B, Hq, D = q.shape
    P, page, KV = k.shape[:3]
    if pak.pick_variant(q.dtype, Hq // KV, D, page) != "split":
        fail("the rule does not pick the split kernel at the serving shape")
    want = ref.paged_attention_plain(*args)
    for run, kw in [("rule", None), ("walk", dict(variant="walk"))] + [
            (f"split x{m}", dict(variant="split", splits=m))
            for m in (2, 8)]:
        got = ops.paged_attention(*args) if kw is None else \
            pak.paged_attention(*args, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        max_err = max(max_err, err)
        if not torch.allclose(got.float(), want.float(), atol=1e-2,
                              rtol=1e-2):
            fail(f"paged_attention ({run}) differs from its plain version "
                 f"at the serving shape: {err}")
        n += 1
    print(f"paged_attention: {n} runs within tolerance of the plain version "
          f"(f32 1e-5, bf16 and f16 1e-2; max bf16/f16 abs err "
          f"{max_err:.3g}) and bitwise equal on reruns", flush=True)
    splits = pak.split_plan(B, KV, table.shape[1], page,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count, pool_pages=P)
    # device time, the new and the old kernel in turns (new, old, old, new)
    turns = {"split": [], "walk": []}
    for name in ("split", "walk", "walk", "split"):
        turns[name].append(device_ms(
            lambda: pak.paged_attention(q, k, v, table, lengths,
                                        variant=name), PAGED_NAMES[name]))
    dev = statistics.mean(t["device_ms"] for t in turns["split"])
    dev_mean = statistics.mean(t["device_mean_ms"] for t in turns["split"])
    walk_dev = statistics.mean(t["device_ms"] for t in turns["walk"])
    by_splits = {m: device_ms(
        lambda: pak.paged_attention(q, k, v, table, lengths, variant="split",
                                    splits=m),
        PAGED_NAMES["split"])["device_ms"] for m in (1, 2, 4, 8)}
    # as the replay finds them: a 64 MB write between calls evicts the
    # 17 MB of inputs from the 50 MB L2 (the write's own kernel is not
    # counted)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cold = {name: device_ms(
        lambda: pak.paged_attention(q, k, v, table, lengths, variant=name),
        PAGED_NAMES[name], between=scratch.zero_)["device_ms"]
        for name in ("split", "walk")}
    del scratch
    kernel_ms = cuda_ms(lambda: pak.paged_attention(q, k, v, table, lengths,
                                                    variant="split"))
    walk_ms = cuda_ms(lambda: pak.paged_attention(q, k, v, table, lengths,
                                                  variant="walk"))
    plain_ms = cuda_ms(lambda: ref.paged_attention_plain(q, k, v, table,
                                                         lengths))
    # yardstick: SDPA over the resident K/V, gathered (not timed) into a
    # dense (B, H, T, D) tensor padded to the longest row, with a mask
    ok, per_seq = attended_positions(table, lengths, page)
    T = int(per_seq.max())
    idx = torch.zeros((B, T), dtype=torch.long)
    mask = torch.zeros((B, T), dtype=torch.bool)
    for b in range(B):
        pos = torch.nonzero(ok[b]).flatten()
        idx[b, :pos.numel()] = pos
        mask[b, :pos.numel()] = True
    tbl = table.cpu().long()
    slot = tbl.gather(1, idx // page).clamp(min=0)
    kd = k[slot.to(q.device), (idx % page).to(q.device)]   # (B, T, KV, D)
    vd = v[slot.to(q.device), (idx % page).to(q.device)]
    G = Hq // KV
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
    qd = q[:, :, None, :]
    am = mask.to(q.device)[:, None, None, :]
    lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=am)[:, :, 0]
    if not torch.allclose(lib.float(), want.float(), atol=2e-2, rtol=2e-2):
        fail("the SDPA yardstick does not compute the kernel's function")
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=am))
    library_dev = device_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=am), None)
    elt = q.element_size()
    moved = 2 * int(per_seq.sum()) * KV * D * elt + 2 * q.numel() * elt
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    long = long_context_attention(pak)
    out = {"max_abs_err": max_err, "kernel_ms": kernel_ms, "device_ms": dev,
           "device_mean_ms": dev_mean,
           "host_us": statistics.mean(t["host_us"] for t in turns["split"]),
           "variant": "split", "splits": splits, "old_variant": "walk",
           "old_ms": walk_ms, "old_device_ms": walk_dev, "turns": turns,
           "device_ms_by_splits": by_splits, "cold_l2_device_ms": cold,
           "long_context": long, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_device_ms": library_dev["device_ms"],
           "bound_ms": bound_ms}
    print(f"paged_attention at the serving shape (B={B}, H={Hq}, KV={KV}, "
          f"D={D}, {int(per_seq.sum())} resident positions, {splits} "
          f"split(s)): split kernel device {dev:.5f} ms "
          f"({bound_ms / dev:.1%} of the bound), single call "
          f"{kernel_ms:.4f} ms; walk kernel device {walk_dev:.5f} ms, single "
          f"call {walk_ms:.4f} ms; split device by splits "
          f"{json.dumps(by_splits)}; with L2 evicted between calls split "
          f"{cold['split']:.5f} ms, walk {cold['walk']:.5f} ms; plain "
          f"{plain_ms:.4f} ms, SDPA on gathered K/V {library_ms:.4f} ms "
          f"(device {library_dev['device_ms']:.5f}), bound {bound_ms:.5f} ms "
          f"({moved} bytes); turns {json.dumps(turns)}; long context "
          f"{json.dumps(long)}", flush=True)
    return out


def long_context_attention(pak):
    """Few long sequences, where the plan splits: 4 sequences x 64 resident
    pages of 64 tokens at chatglm3-6b's KV width (q (4, 32, 128) bf16),
    the plan's split count against 4 and against the walk kernel, device
    ms, each held to the plain version."""
    import torch
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(9)
    P = 300
    k = torch.randn((P, 64, 2, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    v = torch.randn((P, 64, 2, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    q = torch.randn((4, 32, 128), generator=g, device="cuda").to(
        torch.bfloat16)
    table = torch.randperm(P, generator=g, device="cuda")[:256].to(
        torch.int32).reshape(4, 64)
    lengths = torch.full((4,), 64 * 64 - 5, dtype=torch.int32, device="cuda")
    plan = pak.split_plan(4, 2, 64, 64, torch.cuda.get_device_properties(0)
                          .multi_processor_count, pool_pages=P)
    want = ref.paged_attention_plain(q, k, v, table, lengths)
    out = {"splits": plan}
    for name, kw in ((f"split x{plan}", dict(variant="split")),
                     ("split x4", dict(variant="split", splits=4)),
                     ("walk", dict(variant="walk"))):
        got = pak.paged_attention(q, k, v, table, lengths, **kw)
        torch.cuda.synchronize()
        if not torch.allclose(got.float(), want.float(), atol=1e-2,
                              rtol=1e-2):
            fail(f"paged_attention ({name}) differs from its plain version "
                 f"on long contexts")
        out[name] = device_ms(
            lambda: pak.paged_attention(q, k, v, table, lengths, **kw),
            PAGED_NAMES[kw["variant"]])["device_ms"]
    return out


def profile_serving(steps):
    """Device time by kernel over a profiled replay: the share of each of
    the port's kernels and the device's busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        serving_replay(None, steps)
        wall_ms = (time.perf_counter() - t0) * 1e3
    names = {"paged_attention": PAGED_NAMES["split"] + PAGED_NAMES["walk"],
             "page_migrate": ("page_migrate_copy", "page_migrate_winner"),
             "select_topk": TOPK_NAMES["cluster"] + TOPK_NAMES["block"]}
    per = {k: 0.0 for k in names}
    busy_us = 0.0
    launches = 0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us or e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        busy_us += us
        launches += e.count
        rows.append((us, e.key[:80], e.count))
        for k, pats in names.items():
            if any(pat in e.key for pat in pats):
                per[k] += us
    rows.sort(reverse=True)
    out = {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / 1e3 / wall_ms,
           "device_launches": launches,
           "kernel_ms": {k: v / 1e3 for k, v in per.items()},
           "kernel_share": {k: v / busy_us if busy_us else 0.0
                            for k, v in per.items()},
           "top": [{"name": n, "ms": us / 1e3, "count": c}
                   for us, n, c in rows[:6]]}
    print("serving device time (profiled replay): " + json.dumps(out),
          flush=True)
    return out


def phase_serving():
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    steps = SERVING["steps"]
    want = expected_serving_launches(steps)
    # warm-up (first-use allocation of the pools and op dispatch), so the
    # timed turns below start alike; its launches are reset away
    serving_replay(None, 64)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serving_replay(None, steps, record=True)
    launches = ops.launch_counts()
    by_variant = ops.launch_counts_by_variant()
    if launches != want:
        fail(f"serving replay launches {launches}, expected {want}")
    want_variant = {"paged_attention": {"walk": 0, "split":
                                        want["paged_attention"]},
                    "select_topk": {"block": 0, "cluster":
                                    want["select_topk"]}}
    for name, counts in want_variant.items():
        if by_variant[name] != counts:
            fail(f"serving replay's {name} launches by variant "
                 f"{by_variant[name]}, expected {counts}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if res["migrations"] <= 0:
        fail("serving replay made no migrations")
    out = res["outputs"]
    if not (torch.isfinite(out.float()).all() and out.shape[1:] == (
            SERVING["batch"], 32, 128)):
        fail("serving outputs non-finite or misshapen")
    again = serving_replay(None, steps, record=True)
    if not (np.array_equal(res["epoch_slots"], again["epoch_slots"])
            and res["migrations"] == again["migrations"]
            and torch.equal(res["outputs"], again["outputs"])):
        fail("serving rerun is not bitwise equal")
    ops.FORCE = "plain"
    try:
        plain = serving_replay(None, steps, record=True)
        plain2 = serving_replay(None, steps)
    finally:
        ops.FORCE = None
    again2 = serving_replay(None, steps)
    # decode ms per step in turns: kernels, plain, plain, kernels (the
    # first and second replays are also the rerun check)
    turns = [r["decode_ms_per_step"] for r in (res, plain, plain2, again2)]
    del again, plain2, again2
    if not (np.array_equal(res["epoch_slots"], plain["epoch_slots"])
            and res["migrations"] == plain["migrations"]):
        fail("serving with the plain versions differs in residency or "
             "migrations")
    err = float((res["outputs"].float() - plain["outputs"].float()).abs().max())
    if not torch.allclose(res["outputs"].float(), plain["outputs"].float(),
                          atol=1e-2, rtol=1e-2):
        fail(f"serving outputs differ from the plain versions by {err}")
    stats = {k: res[k] for k in ("steps", "tokens", "decode_ms_per_step",
                                 "tokens_per_s", "p50_ms", "p99_ms", "recall",
                                 "migrations", "completed", "wall_s")}
    stats.update(decode_ms_per_step_turns=dict(zip(
                     ("kernels", "plain", "plain_again", "kernels_again"),
                     turns)),
                 plain_wall_s=plain["wall_s"], peak_gb=peak_gb,
                 outputs_max_abs_err_vs_plain=err,
                 launches_by_variant={k: by_variant[k] for k in want_variant},
                 # every page_migrate launch passes one lane per HBM page;
                 # each migrated page moves its K and V rows (2 lanes)
                 page_migrate_lanes_per_launch=int(
                     SERVING["batch"] * SERVING["max_pages"]
                     * SERVING["hbm_frac"]),
                 page_migrate_valid_lanes_per_launch=2 * res["migrations"]
                 / max(1, launches["page_migrate"]))
    print("serving replay (chatglm3-6b KV width, 64 x 32 pages, 256 in "
          "HBM): " + json.dumps(stats), flush=True)
    del res, plain
    torch.cuda.empty_cache()
    profile = profile_serving(SERVING["profile_steps"])
    return launches, by_variant, stats, profile


def phase_serving_small():
    """The port's fused serving on the card against its CPU path."""
    import numpy as np
    import torch
    from repro_torch.core.tiered_kv import KVSpec
    from repro_torch.core.traffic import TrafficSpec
    from repro_torch.serving_replay import replay
    spec = KVSpec(n_layers=2, kv_heads=2, head_dim=8, page_tokens=8,
                  dtype=torch.bfloat16)
    traffic = TrafficSpec(pattern="bursty-diurnal", arrival_rate=8 / 24,
                          steps=160, decode_lo=16, decode_hi=60)
    corners = [None,
               dict(read_hot_threshold=1, sampling_period=100,
                    migration_period=10),
               dict(read_hot_threshold=2, write_hot_threshold=1,
                    cooling_threshold=4, cooling_pages=1024,
                    migration_period=10)]
    for cfg in corners:
        runs = [replay(cfg, traffic, batch=8, max_pages=8, spec=spec,
                       q_heads=8, device=dev, record=True)
                for dev in ("cuda", "cpu")]
        a, b = runs
        if not (np.array_equal(a["epoch_slots"], b["epoch_slots"])
                and a["migrations"] == b["migrations"]):
            fail(f"small spec {cfg}: card and CPU differ in residency or "
                 f"migrations")
        if not torch.allclose(a["outputs"].cpu().float(),
                              b["outputs"].float(), atol=1e-2, rtol=1e-2):
            fail(f"small spec {cfg}: card and CPU outputs differ")
    print(f"small spec: {len(corners)} configs, residency and migrations "
          f"bitwise equal on the card and the CPU", flush=True)


def phase_kv_study():
    import numpy as np
    from repro_torch.core import ExperimentSpec, SimOptions, Study

    def run(device):
        return Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson",
                                    options=SimOptions(device=device))).run()
    card, cpu = run("cuda"), run("cpu")
    if not (np.isfinite(card.epoch_wall_ms).all() and card.total_s > 0):
        fail("Study.run kv-hemem: non-finite result")
    mig = abs(card.cum_migrations[-1] - cpu.cum_migrations[-1]) \
        / max(cpu.cum_migrations[-1], 1.0)
    if mig > 0.01 or abs(card.total_s - cpu.total_s) > 1e-3 * cpu.total_s:
        fail("Study.run kv-hemem: card and CPU path disagree")
    print(f"Study.run kv-hemem/kv-poisson: total_s {card.total_s:.4f} "
          f"(CPU path {cpu.total_s:.4f}), migrations "
          f"{int(card.cum_migrations[-1])}", flush=True)


def phase_serving_tune():
    import numpy as np
    from repro_torch.core import ExperimentSpec, Study
    from repro_torch.serving_replay import serving_objective
    steps = SERVING["tune_steps"]

    def objective(config):
        return serving_objective(serving_replay(config, steps))

    study = Study(ExperimentSpec(engine="kv-hemem", workload="kv-poisson"))
    t0 = time.perf_counter()
    result = study.tune(budget=SERVING["tune_budget"], batch_size=1, seed=0,
                        n_init=4, objective=objective)
    wall_s = time.perf_counter() - t0
    if len(result.history) != SERVING["tune_budget"] \
            or not np.isfinite(result.best_value):
        fail("serving Study.tune: incomplete or non-finite history")
    print(f"serving Study.tune (budget {SERVING['tune_budget']}, {steps}-step "
          f"replays): default objective {result.default_value:.4f}, tuned "
          f"{result.best_value:.4f}, wall {wall_s:.3f} s", flush=True)
    return {"default": result.default_value, "tuned": result.best_value,
            "wall_s": wall_s}


# ---------------------------------------------------------------------------
# LM serving: flash attention, prefill and decode at chatglm3-6b's width
# ---------------------------------------------------------------------------
#: H100 SXM dense bf16 tensor-core rate (FLOP/s), NVIDIA's data sheet
BF16_FLOPS_PER_S = 989e12
#: the LM main path: chatglm3-6b at full width, prefill of 4 x 2,048 tokens;
#: the launcher teacher-forces 4 x 128 tokens (512 until it was cut for the
#: clock), then decodes 32
LM = dict(arch="chatglm3-6b", batch=4, seq=2048, prompt_len=128,
          new_tokens=32)
#: bf16 logits: largest |difference| over the largest |reference logit|
LM_LOGIT_TOL = 3e-2

#: the CPU test file's cases, then gemma2-9b's head shape (window 4,096
#: bites at 4,608; the wgmma kernel at D = 256), h2o-danube-3-4b's (the
#: wgmma kernel at D = 120), chatglm3-6b's prefill, the edges of the wgmma
#: kernel at D = 64, 128, 256 and 120, the cross-attention models' decoder
#: prefills and recurrentgemma-2b's
FLASH_CASES = [  # B, S, T, H, KV, D, causal, window, cap
    (1, 128, 128, 4, 4, 64, True, 0, 0.0),
    (2, 256, 256, 8, 2, 64, True, 0, 0.0),
    (1, 256, 256, 4, 1, 128, True, 128, 0.0),
    (2, 128, 128, 4, 4, 64, False, 0, 0.0),
    (1, 256, 256, 2, 2, 256, True, 0, 50.0),
    (1, 96, 96, 4, 2, 120, True, 0, 0.0),
    (1, 200, 256, 4, 2, 32, True, 0, 0.0),
    (1, 200, 200, 4, 2, 32, True, 0, 0.0),
    (2, 200, 77, 4, 2, 32, True, 0, 30.0),
    (1, 160, 160, 2, 1, 16, False, 48, 0.0),
    (1, 64, 16, 4, 2, 32, False, 8, 0.0),
    (1, 4608, 4608, 16, 8, 256, True, 4096, 50.0),
    (1, 4608, 4608, 32, 8, 120, True, 4096, 0.0),
    (4, 2048, 2048, 32, 2, 128, True, 0, 0.0),
    # the wgmma kernel's edges (D 64 and 128): S and T not multiples of its
    # 128-row tiles, S != T with a softcap, a window without causality,
    # rows that see no key
    (1, 1000, 1000, 8, 2, 128, True, 0, 0.0),
    (2, 300, 517, 4, 1, 64, True, 0, 30.0),
    (1, 640, 640, 8, 8, 128, False, 256, 0.0),
    (1, 192, 64, 4, 2, 128, False, 8, 0.0),
    # the same edges at D = 256 (64-key tiles, the output staged through
    # the single Q buffer), and G = 10 on one KV head without causality
    (1, 1000, 1000, 8, 1, 256, True, 0, 0.0),
    (2, 300, 517, 4, 2, 256, True, 0, 50.0),
    (1, 640, 640, 10, 1, 256, False, 256, 0.0),
    (1, 192, 64, 4, 2, 256, False, 8, 0.0),
    # the same edges at D = 120 (D = 128's plan, the maps' last 8 columns
    # zero-filled), and group size 4 with a window
    (1, 1000, 1000, 8, 2, 120, True, 0, 0.0),
    (2, 300, 517, 4, 1, 120, True, 0, 30.0),
    (1, 640, 640, 8, 8, 120, False, 256, 0.0),
    (1, 192, 64, 4, 2, 120, False, 8, 0.0),
    (2, 700, 700, 32, 8, 120, True, 256, 0.0),
    # llama-3.2-vision-11b's decoder prefill (D = 128, group size 4) and
    # whisper-base's (D = 64, group size 1)
    (4, 2048, 2048, 32, 8, 128, True, 0, 0.0),
    (4, 512, 512, 8, 8, 64, True, 0, 0.0),
    # recurrentgemma-2b's local attention (the wgmma kernel at D = 256,
    # group size 10, the 2,048-token window biting at S = 4,096)
    (2, 4096, 4096, 10, 1, 256, True, 2048, 0.0),
]
#: the main path's shape (chatglm3-6b's prefill), the one timed
FLASH_MAIN = FLASH_CASES[13]


def flash_inputs(case, dtype, seed):
    import torch
    B, S, T, H, KV, D = case[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D))]


def attended_pairs(S, T, causal, window):
    """(query, key) pairs the mask keeps, counted from the positions."""
    import numpy as np
    q = np.arange(S)[:, None]
    k = np.arange(T)[None, :]
    keep = np.ones((S, T), bool)
    if causal:
        keep &= k <= q
    if window > 0:
        keep &= k > q - window
    return int(keep.sum())


def flash_bound(case, q, k, v):
    """(bound ms, what bounds it, flops, bytes) of one flash call: 4 D
    flops per attended (query, key) pair and head, at the bf16 tensor-core
    rate; q, k and v read once and the output (q's shape) written once."""
    B, S, T, H, _, D, causal, window, _ = case
    flops = 4 * D * attended_pairs(S, T, causal, window) * B * H
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    by_ops = flops / BF16_FLOPS_PER_S >= moved / HBM_BYTES_PER_S
    bound_ms = max(flops / BF16_FLOPS_PER_S, moved / HBM_BYTES_PER_S) * 1e3
    return bound_ms, "operations" if by_ops else "bytes", flops, moved


def phase_flash_attention():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops, ref
    max_err = 0.0
    n = 0
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        for case in FLASH_CASES:
            q, k, v = flash_inputs(case, dtype, seed=n)
            kw = dict(causal=case[6], window=case[7], logit_softcap=case[8])
            want = ref.flash_attention_plain(q, k, v, **kw)
            # the variant the rule picks (through ops), and the mma kernel
            # too where the rule picks wgmma, so both stay held to the plain
            # version at these shapes; each bitwise on a rerun
            runs = [("rule", lambda: ops.flash_attention(q, k, v, **kw))]
            if fak.pick_variant(dtype, case[5]) == "wgmma":
                runs.append(("mma", lambda: fak.flash_attention(
                    q, k, v, variant="mma", **kw)))
            for name, run in runs:
                got = run()
                again = run()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"flash_attention ({name}) is not bitwise on a "
                         f"rerun ({dtype}, case {case})")
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.bfloat16:
                    max_err = max(max_err, err)
                if not torch.allclose(got.float(), want.float(), atol=tol,
                                      rtol=tol):
                    fail(f"flash_attention ({name}) differs from its plain "
                         f"version ({dtype}, case {case}): {err}")
                n += 1
            del q, k, v, want, got, again
    print(f"flash_attention: {n} runs within tolerance of the plain "
          f"version (f32 2e-5, bf16 2e-2; max bf16 abs err {max_err:.3g}), "
          f"each bitwise on a rerun", flush=True)
    D = FLASH_MAIN[5]
    q, k, v = flash_inputs(FLASH_MAIN, torch.bfloat16, seed=99)
    variant = fak.pick_variant(q.dtype, D)
    if variant != "wgmma":
        fail(f"the rule picks {variant} at the main shape, not wgmma")
    # the new and the old bf16 kernel in turns (new, old, old, new)
    turns = {"wgmma": [], "mma": []}
    for name in ("wgmma", "mma", "mma", "wgmma"):
        turns[name].append(cuda_ms(
            lambda: fak.flash_attention(q, k, v, variant=name)))
    kernel_ms = statistics.mean(turns["wgmma"])
    mma_ms = statistics.mean(turns["mma"])
    plain_ms = cuda_ms(lambda: ref.flash_attention_plain(q, k, v))
    # yardstick: SDPA in its (B, H, S, D) layout (the transposes not timed)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True).transpose(1, 2)
    if not torch.allclose(lib.float(), fak.flash_attention(q, k, v).float(),
                          atol=2e-2, rtol=2e-2):
        fail("the SDPA yardstick does not compute the kernel's function")
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    dev = {name: device_ms(lambda: fak.flash_attention(q, k, v, variant=name),
                           (f"flash_{name}_kernel",), n=20)
           for name in ("wgmma", "mma")}
    library_dev = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), None, n=20)
    bound_ms, bound_by, flops, moved = flash_bound(FLASH_MAIN, q, k, v)
    tflops = flops / kernel_ms / 1e9
    print(f"flash_attention at chatglm3-6b's prefill (q {tuple(q.shape)}, "
          f"k/v {tuple(k.shape)} bf16, causal): wgmma kernel "
          f"{kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s, "
          f"{bound_ms / kernel_ms:.1%} of the bound), mma kernel "
          f"{mma_ms:.4f} ms ({flops / mma_ms / 1e9:.1f} TFLOP/s), turns "
          f"{json.dumps(turns)}, plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({flops} flops, {moved} bytes); device ms: wgmma "
          f"{dev['wgmma']['device_ms']:.5f}, mma {dev['mma']['device_ms']:.5f}"
          f", SDPA {library_dev['device_ms']:.5f}", flush=True)
    return {"max_abs_err": max_err, "kernel_ms": kernel_ms,
            "device_ms": dev["wgmma"]["device_ms"],
            "device_mean_ms": dev["wgmma"]["device_mean_ms"],
            "host_us": dev["wgmma"]["host_us"],
            "old_variant": "mma", "old_ms": mma_ms,
            "old_device_ms": dev["mma"]["device_ms"],
            "library_device_ms": library_dev["device_ms"],
            "variant": variant, "mma_ms": mma_ms, "turns_ms": turns,
            "achieved_tflops": tflops, "bound_share": bound_ms / kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def lm_cfg(spec=None):
    from repro_torch.configs import get_config
    return get_config((spec or LM)["arch"])


def device_rows(prof, skip=()):
    """(device us, kernel name, launches) of a profile's CUDA kernels,
    longest first; rows named in ``skip`` (the device side of profiler
    ranges) left out."""
    import torch
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us and e.device_type == torch.autograd.DeviceType.CUDA \
                and e.key not in skip:
            rows.append((us, e.key[:80], e.count))
    return sorted(rows, reverse=True)


class Ranges:
    """Within ``with``: every call of the module functions ``targets``
    names (``{label: (module name, attribute)}``) runs in a profiler range
    of its label; a recursive function's outermost call only."""

    def __init__(self, targets):
        self.targets = targets
        self.saved = {}

    def __enter__(self):
        import importlib
        import torch
        for label, (modname, name) in self.targets.items():
            mod = importlib.import_module(modname)
            orig = getattr(mod, name)
            depth = [0]

            def wrapped(*args, _orig=orig, _label=label, _depth=depth,
                        **kw):
                if _depth[0]:
                    return _orig(*args, **kw)
                _depth[0] += 1
                try:
                    with torch.profiler.record_function(_label):
                        return _orig(*args, **kw)
                finally:
                    _depth[0] -= 1
            self.saved[label] = (mod, name, orig)
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self.saved.values():
            setattr(mod, name, orig)


def range_times(prof, labels):
    """Per label: the device ms of the kernels its ranges launched, the
    host ms spent in them, and their count."""
    import torch
    out = {}
    for e in prof.key_averages():
        if e.key in labels and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.key] = {"device_ms": e.device_time_total / 1e3,
                          "host_ms": e.cpu_time_total / 1e3,
                          "calls": e.count}
    missing = set(labels) - set(out)
    if missing:
        fail(f"the profile has no range {sorted(missing)}")
    return out


def profile_prefill(prefill, model, batch, ranges=None):
    """Device time of one profiled prefill, and the shares of the flash
    kernel, the matrix products and the MoE dispatch
    and combine's kernels (sorts, index scatters and gathers, scans); with
    ``ranges`` (``Ranges``' targets), the device and host ms of each and
    its share of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ranges = ranges or {}
    with Ranges(ranges), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(model, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = device_rows(prof, skip=set(ranges))
    busy_us = sum(us for us, _, _ in rows)

    def share(names):
        us = sum(t for t, n, _ in rows if any(m in n.lower() for m in names))
        return us / 1e3, us / busy_us if busy_us else 0.0
    flash_ms, flash_share = share([f"flash_{v}_kernel"
                                   for v in ("wgmma", "mma", "fma")])
    gemm_ms, gemm_share = share(GEMM_NAMES)
    moe_ms, moe_share = share(MOE_DISPATCH_NAMES)
    out = {"device_busy_ms": busy_us / 1e3, "flash_ms": flash_ms,
           "flash_share": flash_share, "gemm_ms": gemm_ms,
           "gemm_share": gemm_share,
           "moe_dispatch_ms": moe_ms, "moe_dispatch_share": moe_share,
           "kernels": sum(c for _, _, c in rows),
           "top": [{"name": n, "ms": us / 1e3, "count": c}
                   for us, n, c in rows[:8]]}
    if ranges:
        out["profiled_wall_ms"] = wall_ms
        out["ranges"] = range_times(prof, set(ranges))
        for r in out["ranges"].values():
            r["device_share"] = r["device_ms"] * 1e3 / busy_us
    return out


def attn_layers(cfg) -> int:
    """The config's attention layers: one flash launch each per prefill."""
    return sum(kind.startswith("attn") for kind in cfg.pattern)


def set_gates(model, value: float) -> None:
    """Every cross layer's ``gate_x`` to ``value``.  ``init`` leaves them
    at 0, as the reference does, and a zero gate makes the cross path and
    the encoder add exactly nothing to the logits (and gives them no
    gradient)."""
    import torch
    with torch.no_grad():
        for blk in model.blocks:
            if blk.gate_x is not None:
                blk.gate_x.fill_(value)


def phase_lm_prefill(spec=None):
    """chatglm3-6b (or ``spec``'s arch) at full width: build_prefill_step
    on ``spec``'s (batch, seq), flash_attention once per attention layer
    on ``spec``'s variant (``wgmma`` unless it names one).  Logits against
    ``FORCE="plain"``; where no layer attends (no kernel on the path),
    bitwise against a rerun instead (with ``spec["rerun"]``, as well).
    ``spec["ranges"]`` names functions whose share of the profiled
    prefill is reported.  A cross-attention
    family's cross gates are set to ``CROSS_GATE`` after ``init`` and its
    batch carries the launcher's stub input (``make_extra``, seed 1); its
    logits are also held bitwise to a rerun and must move when the
    stub input is another draw (seed 2)."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_extra
    from repro_torch.models import transformer as T
    from repro_torch.serve.step import build_prefill_step
    spec = spec or LM
    cfg = lm_cfg(spec)
    t0 = time.perf_counter()
    model = T.init(0, cfg, device="cuda")
    if cfg.family != "lm":
        set_gates(model, CROSS_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    B, S = spec["batch"], spec["seq"]
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, S))).cuda()}
    extra = make_extra(cfg, B, seed=1)
    if extra is not None:
        batch["extra"] = extra
    prefill = build_prefill_step(cfg)
    prefill(model, batch)                      # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    n_flash = attn_layers(cfg)
    variant = spec.get("flash_variant", "wgmma")
    ops.reset_launch_counts()
    logits = prefill(model, batch)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    by_variant = dict(fak.launches_by_variant)
    if launches["flash_attention"] != n_flash or \
            sum(launches.values()) != n_flash:
        fail(f"prefill launches {launches}, expected flash_attention "
             f"{n_flash} and nothing else")
    if by_variant != {**dict.fromkeys(by_variant, 0), variant: n_flash}:
        fail(f"prefill's flash launches by variant {by_variant}, expected "
             f"all {n_flash} on the {variant} kernel")
    if not (logits.shape == (B, 1, cfg.padded_vocab)
            and bool(torch.isfinite(logits.float()).all())):
        fail("prefill logits non-finite or misshapen")
    reps = spec.get("reps", 5)
    prefill_ms = cuda_ms(lambda: prefill(model, batch), reps=reps, warmup=1)
    if n_flash:
        # one plain prefill, timed between CUDA events: the comparison
        # needs no more (gemma2-9b's takes 5.4 s)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ops.FORCE = "plain"
        try:
            ev[0].record()
            plain_logits = prefill(model, batch)
            ev[1].record()
            torch.cuda.synchronize()
        finally:
            ops.FORCE = None
        plain_prefill_ms = ev[0].elapsed_time(ev[1])
        err = float((logits.float() - plain_logits.float()).abs().max()
                    / plain_logits.float().abs().max())
        if err > LM_LOGIT_TOL:
            fail(f"prefill logits with the kernel and the plain version "
                 f"differ by {err} (relative to the largest logit)")
        check = {"plain_prefill_ms": plain_prefill_ms,
                 "last_logits_rel_err_vs_plain": err}
    else:
        check = {}
    if not n_flash or extra is not None or spec.get("rerun"):
        if not torch.equal(prefill(model, batch), logits):
            fail(f"{cfg.arch} prefill logits are not bitwise on a rerun")
        check["last_logits_bitwise_on_rerun"] = True
    if extra is not None:
        other = dict(batch, extra=make_extra(cfg, B, seed=2))
        moved = rel_err(prefill(model, other), logits)
        if not moved > 0:
            fail(f"{cfg.arch} prefill logits do not move when the stub input "
                 f"is another draw: the cross path adds nothing")
        check["last_logits_rel_change_other_stub_input"] = moved
        del other
    # ``profile_seq`` profiles a prefill of the first tokens only, against
    # its own unprofiled time: xlstm's per-position sLSTM loop launches
    # ~140 kernels a token, which the profiler post-processes slowly
    prof_batch, prof_ms = batch, prefill_ms
    if spec.get("profile_seq"):
        prof_batch = {"tokens": batch["tokens"][:, :spec["profile_seq"]]
                      .contiguous()}
        prof_ms = cuda_ms(lambda: prefill(model, prof_batch), reps=reps,
                          warmup=1)
    prof = profile_prefill(prefill, model, prof_batch, spec.get("ranges"))
    prof["seq"] = prof_batch["tokens"].shape[1]
    prof["unprofiled_ms"] = prof_ms
    if cfg.moe_experts:
        with Routing() as routes:
            prefill(model, batch)
        prof["moe_dropped_slot_share"] = dropped_share(routes.seen, cfg)
    stats = {"params": n_params, "weights_gb": weight_gb, "init_s": init_s,
             "batch": B, "seq": S, "prefill_ms": prefill_ms,
             "tokens_per_s": B * S / prefill_ms * 1e3, **check,
             "flash_launches": launches["flash_attention"],
             "flash_launches_by_variant": by_variant,
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
             "profile": prof,
             # the unprofiled prefill's CUDA-event time is the wall
             "device_idle_share": 1 - prof["device_busy_ms"] / prof_ms}
    print(f"LM prefill ({cfg.arch} full width, {cfg.n_layers} layers, "
          f"B={B}, S={S}): " + json.dumps(stats), flush=True)
    return model, launches, stats


def phase_lm_decode(model, spec=None):
    """The port's launcher at full width, then prefill's last logits on
    the launcher's prompt (and stub input, where the family has one)
    against the logits after teacher-forcing it.  The launcher serves
    ``model`` (the prefill phase's weights, a cross family's gates set):
    ``T.init`` hands it over while ``main`` runs, so no second copy of the
    weights is made."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as T
    from repro_torch.serve.step import build_prefill_step
    spec = spec or LM
    cfg = lm_cfg(spec)
    B = spec.get("launch_batch", spec["batch"])
    argv = ["--arch", cfg.arch, "--full", "--batch", str(B),
            "--prompt-len", str(spec["prompt_len"]), "--new-tokens",
            str(spec["new_tokens"])]
    init = T.init

    def same_model(key, c, device="cuda"):
        if key != 0 or c != cfg:
            fail(f"the launcher built another model: {key}, {c.arch}")
        return model
    ops.reset_launch_counts()
    T.init = same_model
    try:
        res = launcher.main(argv)
    finally:
        T.init = init
    decode_launches = ops.launch_counts()
    if any(decode_launches.values()):
        fail(f"the launcher's decode loop launched kernels: {decode_launches}")
    tokens = res["tokens"]
    if tokens.shape != (B, spec["new_tokens"]) or \
            int(tokens.min()) < 0 or int(tokens.max()) >= cfg.padded_vocab:
        fail(f"launcher tokens misshapen or out of range: {tokens.shape}")
    ops.reset_launch_counts()
    if cfg.moe_experts:
        want, moe = moe_prompt_check(model, cfg, res)
    elif "mlstm" in cfg.pattern:
        want, moe = mlstm_prompt_check(model, cfg, res)
    else:
        batch = {"tokens": res["prompt"]}
        if res["extra"] is not None:
            batch["extra"] = res["extra"]
        want = build_prefill_step(cfg)(model, batch)[:, -1]
        moe = {}
    prefill_launches = ops.launch_counts()["flash_attention"]
    got = res["prompt_logits"]
    err = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if not (bool(torch.isfinite(got.float()).all()) and err <= LM_LOGIT_TOL):
        fail(f"decode after teacher forcing and prefill disagree by {err} "
             f"(relative to the largest logit; tolerance {LM_LOGIT_TOL})")
    stats = {"decode_ms_per_token": res["decode_ms_per_token"],
             "prompt_s": res["prompt_s"],
             "prompt_ms_per_token": res["prompt_s"] / spec["prompt_len"]
             * 1e3,
             "decode_launches": decode_launches,
             "prefill_flash_launches": prefill_launches,
             "prompt_logits_rel_err_vs_prefill": err,
             "prompt_argmax_agreement": agree, **moe}
    print(f"LM launcher ({' '.join(argv)}): " + json.dumps(stats), flush=True)
    return stats


def rel_err(got, want) -> float:
    """Largest |difference| over the largest |reference value|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def moe_prompt_check(model, cfg, res):
    """(prefill's last logits on the launcher's prompt, stats) for a MoE
    model.  A prefill of the whole batch is not dropless (T * k above
    4,096 gives each expert C = 1.25 T k / E slots and drops the rest),
    while decode is, so the two compute different functions: each
    sequence is prefilled alone (512 x 8 = 4,096 slots: dropless).  The
    batch prefill's share of dropped slots and its distance from decode
    are reported beside."""
    import torch
    from repro_torch.serve.step import build_prefill_step
    prompt = res["prompt"]
    B, P = prompt.shape
    if P * cfg.moe_top_k > 4096:
        fail(f"a {P}-token prompt is not dropless at top-{cfg.moe_top_k}")
    prefill = build_prefill_step(cfg)
    with Routing() as routes:
        batch = prefill(model, {"tokens": prompt})[:, -1]
    want = torch.cat([prefill(model, {"tokens": prompt[b:b + 1]})[:, -1]
                      for b in range(B)])
    return want, {
        "prefill": "each sequence alone (dropless)",
        "batch_prefill_dropped_slot_share": dropped_share(routes.seen, cfg),
        "decode_vs_batch_prefill_rel_err": rel_err(res["prompt_logits"],
                                                   batch)}


def mlstm_prompt_check(model, cfg, res):
    """(prefill's last logits on the launcher's prompt with the mLSTM
    layers at chunk 1, stats).  The reference's mLSTM clamps its
    within-chunk decay weights but not the state carried between chunks,
    so decode (chunks of one token) computes what a chunk-1 prefill
    computes, not what a prefill in chunks of 256 does (ROADMAP queue 3 b);
    the ordinary prefill's distance from decode is reported beside."""
    import functools
    import torch
    from repro_torch.models import layers as L
    from repro_torch.serve.step import build_prefill_step
    prefill = build_prefill_step(cfg)
    batch = {"tokens": res["prompt"]}
    ordinary = prefill(model, batch)[:, -1]
    apply = L.mlstm_apply
    L.mlstm_apply = functools.partial(apply, chunk=1)
    try:
        t0 = time.perf_counter()
        want = prefill(model, batch)[:, -1]
        torch.cuda.synchronize()
        chunk_1_s = time.perf_counter() - t0
    finally:
        L.mlstm_apply = apply
    return want, {
        "prefill": "mLSTM layers at chunk 1 (what decode computes)",
        "chunk_1_prefill_s": chunk_1_s,
        "decode_vs_chunk_256_prefill_rel_err": rel_err(res["prompt_logits"],
                                                       ordinary),
        "chunk_1_vs_chunk_256_prefill_rel_err": rel_err(want, ordinary)}


#: two router probabilities closer than this (relative) are a near tie,
#: which a bf16 ulp of a layer's input may reorder: 2**-7, two bf16 ulps
#: (``tests/test_torch_moe.py``)
NEAR_TIE = 2.0 ** -7


class Routing:
    """Within ``with``: each ``layers.moe_route`` call's (probs, indices),
    on the host, in ``seen``.  With ``pinned`` (another run's ``seen``, in
    call order) the calls route to those experts, with their own gate
    values, while ``seen`` keeps the experts they would have chosen."""

    def __init__(self, pinned=None):
        self.seen = []
        self.pinned = None if pinned is None else iter(pinned)

    def __enter__(self):
        import torch
        from repro_torch.models import layers as L
        self.route = L.moe_route

        def route(router, xf, top_k):
            probs, vals, idx = self.route(router, xf, top_k)
            self.seen.append((probs.float().cpu(), idx.cpu()))
            if self.pinned is not None:
                idx = next(self.pinned)[1].to(idx.device)
                vals = torch.gather(probs, -1, idx)
                vals = vals / torch.clamp(vals.sum(-1, keepdim=True),
                                          min=1e-9)
            return probs, vals, idx
        L.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.moe_route = self.route


def routing_flips(ref, got, what):
    """Tokens routed to other experts in ``got`` than in ``ref``; fails
    unless each differs only among experts whose probabilities in ``ref``
    nearly tie.  ``got`` comes from a run pinned to ``ref``'s routing, so
    each layer's input differs from ``ref``'s by rounding only."""
    import torch
    if len(ref) != len(got):
        fail(f"{what}: {len(got)} routing calls against {len(ref)}")
    flips = 0
    for (rp, ri), (_, gi) in zip(ref, got):
        differ = (ri != gi).any(-1)
        for t in differ.nonzero().flatten().tolist():
            moved = ri[t] != gi[t]
            p = rp[t][torch.cat([ri[t][moved], gi[t][moved]])]
            if (p.max() - p.min()) / p.max() >= NEAR_TIE:
                fail(f"{what}: token {t} routed to {gi[t].tolist()} "
                     f"against {ri[t].tolist()}, probabilities {p.tolist()}")
        flips += int(differ.sum())
    return flips


def dropped_share(routes, cfg) -> float:
    """Share of a run's routed slots that the capacity rule drops (each
    expert keeps ``layers.moe_capacity`` slots a call), from its routing."""
    import torch
    from repro_torch.models.layers import moe_capacity
    dropped = slots = 0
    for _, idx in routes:
        cap = moe_capacity(idx.shape[0], cfg.moe_top_k, cfg.moe_experts)
        counts = torch.bincount(idx.flatten(), minlength=cfg.moe_experts)
        dropped += int((counts - cap).clamp(min=0).sum())
        slots += idx.numel()
    return dropped / slots


def phase_lm_card_vs_cpu():
    """chatglm3-6b, gemma2-9b, h2o-danube-3-4b, granite-moe-1b-a400m,
    kimi-k2-1t-a32b, recurrentgemma-2b, xlstm-1.3b, whisper-base and
    llama-3.2-vision-11b smoke configs at S = 512: the card's forward and
    prefill against the port's CPU path on the same weights (the cross
    gates at ``CROSS_GATE``, a stub input at scale 1).  The MoE configs' card runs
    are routed as the CPU routed; each router's own choice must equal the
    CPU's but at near ties (bf16 activations differ by ulps between the
    two)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_extra
    from repro_torch.models import transformer as T
    from repro_torch.serve.step import build_prefill_step
    flips = {}
    for arch in ("chatglm3-6b",) + WINDOW_ARCHS + MOE_SMOKE_ARCHS \
            + RNN_ARCHS + CROSS_ARCHS:
        cfg = get_config(arch, smoke=True)
        cpu_model = T.init(0, cfg, device="cpu")
        set_gates(cpu_model, CROSS_GATE)
        card_model = T.init(0, cfg, device="cpu")
        set_gates(card_model, CROSS_GATE)
        card_model = card_model.to("cuda")
        tokens = torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab, (2, 512)))
        extra = make_extra(cfg, 2, seed=1, scale=1.0)

        def run(model, device):
            batch = {"tokens": tokens.to(device)}
            if extra is not None:
                batch["extra"] = extra.to(device)
            return (T.forward(model, cfg, batch["tokens"],
                              batch.get("extra"))[0],
                    build_prefill_step(cfg)(model, batch))
        with Routing() as cpu_routes:
            cpu, cpu_last = run(cpu_model, "cpu")
        ops.reset_launch_counts()
        with Routing(pinned=cpu_routes.seen) as card_routes:
            card, card_last = run(card_model, "cuda")
        if ops.launch_counts()["flash_attention"] != 2 * attn_layers(cfg):
            fail(f"{arch} smoke: flash_attention not launched per "
                 f"attention layer")
        if cfg.moe_experts:
            flips[arch] = routing_flips(cpu_routes.seen, card_routes.seen,
                                        f"{arch} smoke")
        for name, a, b in (("forward", card, cpu),
                           ("prefill", card_last, cpu_last)):
            err = float((a.cpu().float() - b.float()).abs().max()
                        / b.float().abs().max())
            if err > LM_LOGIT_TOL:
                fail(f"{arch} smoke {name}: card and CPU differ by {err}")
    print(f"LM smoke configs (chatglm3-6b, gemma2-9b, h2o-danube-3-4b, "
          f"granite-moe-1b-a400m, kimi-k2-1t-a32b, recurrentgemma-2b, "
          f"xlstm-1.3b, whisper-base, llama-3.2-vision-11b) at S = 512: "
          f"card agrees with the CPU path; MoE tokens routed apart at near "
          f"ties (of 4,096 routings each): {json.dumps(flips)}", flush=True)


# ---------------------------------------------------------------------------
# select_topk past the old 65,535-page ceiling
# ---------------------------------------------------------------------------
#: gapbs-bc on kron (78.13 GiB) at scale 1.7: 68,004 pages, 120 epochs
BIG = dict(workload="gapbs-bc", input="kron", scale=1.7, epochs=120)


def long_rows(n, B, seed):
    """(B, n) select_topk inputs with heavy ties (3 heat levels) and k in
    {0, 1, n} on the first rows, random below n on the rest."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ph = rng.integers(0, 3, (B, n)).astype(np.float32)
    dh = rng.integers(0, 3, (B, n)).astype(np.float32)
    pm = rng.uniform(size=(B, n)) < 0.6
    dm = rng.uniform(size=(B, n)) < 0.3
    edges = [0, 1, n]
    kp = np.array([edges[b] if b < 3 else rng.integers(2, n)
                   for b in range(B)], np.float32)
    kd = np.array([edges[(b + 1) % 3] if b < 3 else rng.integers(2, n)
                   for b in range(B)], np.float32)
    if B == 1:
        kp[0], kd[0] = 1, n
    return pm, ph, dm, dh, kp, kd


def phase_select_topk_long():
    """Both select_topk kernels past 65,535 pages, then Study.run of hemem
    on gapbs-bc kron at scale 1.7 (the repair of the page ceiling)."""
    import numpy as np
    import torch
    from repro_torch.core import ExperimentSpec, SimOptions, Study, WorkloadSpec
    from repro_torch.kernels import ops, ref, select_topk as sk
    times = {}
    for n in (65_536, 100_003, sk.MAX_N):
        for B in (1, 8):
            args = [torch.from_numpy(a).cuda()
                    for a in long_rows(n, B, n + B)]
            want = ref.select_topk_ref(*args)
            for variant in sk.VARIANTS:
                got = sk.select_topk(*args, variant=variant)
                again = sk.select_topk(*args, variant=variant)
                torch.cuda.synchronize()
                for name, other in (("plain", want), ("rerun", again)):
                    if not (torch.equal(got[0], other[0])
                            and torch.equal(got[1], other[1])):
                        fail(f"select_topk {variant} at ({B}, {n}) is not "
                             f"bitwise equal to its {name}")
                if B == 8:
                    times[f"{variant}@{n}"] = cuda_ms(
                        lambda: sk.select_topk(*args, variant=variant),
                        reps=10, warmup=2)
    study = Study(ExperimentSpec(
        engine="hemem",
        workload=WorkloadSpec(BIG["workload"], BIG["input"],
                              scale=BIG["scale"]),
        machine="pmem-large",
        options=SimOptions(seed=0, crn=True, device="cuda")))
    n_pages = study.workload().n_pages
    if n_pages <= 65_535:
        fail(f"{BIG} has {n_pages} pages, not past the old ceiling")
    cfgs = batch_configs("hemem")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = study.run(configs=cfgs)
    wall_s = time.perf_counter() - t0
    by_variant = ops.launch_counts_by_variant()["select_topk"]
    if by_variant != {"block": 0, "cluster": BIG["epochs"]}:
        fail(f"Study.run past the old ceiling: select_topk launches "
             f"{by_variant}, expected {BIG['epochs']}, all on the cluster "
             f"kernel")
    ops.FORCE = "plain"
    try:
        plain = study.run(configs=cfgs)
    finally:
        ops.FORCE = None
    for a, b in zip(res, plain):
        if not (a.epoch_wall_ms.shape == (BIG["epochs"],)
                and np.isfinite(a.epoch_wall_ms).all()
                and np.array_equal(a.epoch_wall_ms, b.epoch_wall_ms)
                and np.array_equal(a.cum_migrations, b.cum_migrations)):
            fail("Study.run past the old ceiling: not bitwise equal to the "
                 "plain selection")
    stats = {"max_n": sk.MAX_N, "single_call_ms_B8": times,
             "study": {**BIG, "n_pages": n_pages, "B": BATCH,
                       "wall_s": wall_s, "launches": by_variant,
                       "default_total_s": res[0].total_s,
                       "migrations": int(res[0].cum_migrations[-1])},
             "card": card_line()}
    print("select_topk past 65,535 pages (both kernels bitwise at n = "
          "65,536, 100,003 and MAX_N; Study.run hemem gapbs-bc kron 1.7 "
          "bitwise vs plain): " + json.dumps(stats), flush=True)
    return by_variant["cluster"]


# ---------------------------------------------------------------------------
# LM training: the smoke configs card against CPU, restarts, and every arch
# that one card holds at full width and depth
# ---------------------------------------------------------------------------
#: the training path at full width through the launcher's trainer, 4
#: sequences a step
TRAIN_BATCH = 4
#: (arch, ``--optimizer`` (None: the launcher's rule, AdamW below 3e11
#: parameters), steps, tokens a sequence).  gemma2-9b and
#: llama-3.2-vision-11b take Adafactor: AdamW's bf16 weights and gradients
#: and float32 moments, 12 B a parameter, come to 110.9 and 115.1 GB.
#: xlstm-1.3b's sLSTM loop makes a step of 4 x 512 take 8.3 s on the host,
#: so it trains 3 steps of 4 x 256 (cut for the clock)
TRAIN_ARCHS = (("chatglm3-6b", None, 4, 512),
               ("granite-moe-1b-a400m", None, 4, 512),
               ("recurrentgemma-2b", None, 4, 512),
               ("xlstm-1.3b", None, 3, 256), ("whisper-base", None, 4, 512),
               ("h2o-danube-3-4b", None, 4, 512),
               ("gemma2-9b", "adafactor", 4, 512),
               ("llama-3.2-vision-11b", "adafactor", 4, 512))
#: the smoke configs trained on the card against the CPU path
TRAIN_SMOKE_ARCHS = ("chatglm3-6b", "gemma2-9b", "h2o-danube-3-4b",
                     "granite-moe-1b-a400m", "recurrentgemma-2b",
                     "xlstm-1.3b", "whisper-base", "llama-3.2-vision-11b")
#: the smoke configs whose restart on the card must be bitwise
RESTART_ARCHS = ("chatglm3-6b", "granite-moe-1b-a400m", "recurrentgemma-2b",
                 "xlstm-1.3b", "whisper-base", "gemma2-9b")
#: losses and grad norms of the card against the CPU path, bf16 smoke
#: configs (``LM_LOGIT_TOL``'s bar)
TRAIN_TOL = 3e-2


def phase_train_card_vs_cpu():
    """2 train steps (AdamW, n_micro 1 and 2) of each ``TRAIN_SMOKE_ARCHS``
    smoke config on the card and on the CPU from the same weights (the
    cross gates at ``CROSS_GATE``) and batches; then flash_attention under
    autograd must raise."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import extra_shape
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train.step import TrainState, build_train_step, to_device
    worst = 0.0
    ops.reset_launch_counts()
    for arch in TRAIN_SMOKE_ARCHS:
        cfg = get_config(arch, smoke=True)
        data = SyntheticLM(cfg.vocab, 128, 4, seed=0,
                           extra_shape=extra_shape(cfg, 4))
        for n_micro in (1, 2):
            seen = {}
            for device in ("cpu", "cuda"):
                model = T.init(0, cfg, device="cpu")
                set_gates(model, CROSS_GATE)
                model = model.to(device).requires_grad_(True)
                opt = AdamW(lr=cosine_schedule(1e-3, 2, 10))
                state = TrainState(
                    model, opt.init(dict(model.named_parameters())), 0)
                step = build_train_step(cfg, opt, n_micro=n_micro,
                                        use_flash=False)
                out = []
                for s in range(2):
                    state, m = step(state, to_device(data.batch_at(s),
                                                     device))
                    out.append((float(m["loss"]), float(m["grad_norm"])))
                seen[device] = out
            for (lc, gc), (lg, gg) in zip(seen["cpu"], seen["cuda"]):
                for a, b in ((lg, lc), (gg, gc)):
                    if not (abs(a) < float("inf")
                            and abs(a - b) <= TRAIN_TOL * abs(b)):
                        fail(f"{arch} smoke train (n_micro {n_micro}): card "
                             f"{seen['cuda']} vs CPU {seen['cpu']}")
                    worst = max(worst, abs(a - b) / abs(b))
    if any(ops.launch_counts().values()):
        fail(f"training launched kernels: {ops.launch_counts()}")
    q = torch.randn((1, 512, 4, 64), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.randn((1, 512, 2, 64), device="cuda", dtype=torch.bfloat16)
    try:
        ops.flash_attention(q, kv, kv)
    except NotImplementedError:
        pass
    else:
        fail("flash_attention under autograd on the card did not raise")
    if ops.launch_counts()["flash_attention"]:
        fail("flash_attention launched under autograd")
    print(f"LM training smoke configs ({', '.join(TRAIN_SMOKE_ARCHS)}; "
          f"n_micro 1, 2): card agrees with the CPU path, worst relative "
          f"difference {worst:.3g}; flash_attention under autograd raises",
          flush=True)


#: each block kind's own leaves, as ``named_parameters`` names them
KIND_LEAVES = {"attn": ("attn.wq",), "attn_local": ("attn.wq",),
               "rglru": ("rnn.w_gate_a", "rnn.w_gate_x", "rnn.lambda_p"),
               "mlstm": ("rnn.w_up", "rnn.w_if"), "slstm": ("rnn.r_in",)}
#: leaves held to a nonzero gradient but not to a move: RG-LRU's decay
#: path, ``a = exp(-8 r softplus(lambda_p))`` with ``r`` from ``w_gate_a``.
#: At the reference's init (``lambda_p`` from 4 to 9) ``a`` lies near e^-16
#: to e^-36, so both get gradients far below AdamW's eps (1e-8), which
#: scales their update under half an ulp (bf16 ``w_gate_a``, float32
#: ``lambda_p`` near 4 to 9) in a few steps
STILL_LEAVES = ("rnn.w_gate_a", "rnn.lambda_p")


def train_leaves(model):
    """The leaves a train step must reach in ``model``'s family: the
    embedding, the first block of each kind's own weights (attention's
    ``wq``, RG-LRU's gates and ``lambda_p``, mLSTM's ``w_up`` and ``w_if``,
    sLSTM's ``r_in``), the first cross layer's ``cross`` weights, the
    encoder's first block, the vision projection, the last MLP's
    ``w_down`` or the last experts' router and ``w_up``, and the final
    norm."""
    names = ["embed"]
    first = {}
    for i, blk in enumerate(model.blocks):
        first.setdefault(blk.kind, i)
    for kind, i in first.items():
        names += [f"blocks.{i}.{leaf}" for leaf in KIND_LEAVES[kind]]
    cross = [i for i, blk in enumerate(model.blocks) if blk.cross is not None]
    if cross:
        names += [f"blocks.{cross[0]}.cross.{w}" for w in ("wq", "wk", "wv")]
    if model.encoder is not None:
        names += ["encoder.0.attn.wq", "encoder.0.mlp.w_up"]
    if model.vision_proj is not None:
        names.append("vision_proj")
    ffn = [i for i, blk in enumerate(model.blocks) if blk.norm2 is not None]
    if ffn:
        i = ffn[-1]
        names += ([f"blocks.{i}.moe.router", f"blocks.{i}.moe.w_up"]
                  if model.blocks[i].moe is not None
                  else [f"blocks.{i}.mlp.w_down"])
    names += [n for n, _ in model.named_parameters()
              if n == "norm_f" or n.startswith("norm_f.")]
    return names


class FirstGrads:
    """Within ``with``: the largest absolute value of the first gradient
    autograd accumulates into each of ``params`` (name to leaf), kept on
    the card (``post_accumulate_grad`` hooks)."""

    def __init__(self, params):
        self.params = params
        self.seen = {}
        self.handles = []

    def __enter__(self):
        import torch
        for name, p in self.params.items():
            def hook(p, name=name):
                if name not in self.seen:   # no temporary of the grad's size
                    self.seen[name] = torch.linalg.vector_norm(
                        p.grad.detach(), float("inf"))
            self.handles.append(p.register_post_accumulate_grad_hook(hook))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def values(self):
        return {n: float(v) for n, v in self.seen.items()}


#: substrings of cuBLAS's matrix-product kernel names (nvjet: CUDA 12.8's)
GEMM_NAMES = ("gemm", "cutlass", "nvjet", "xmma")


def kernel_rows(prof):
    """(device us, kernel name, launches) of a profile's CUDA activity,
    longest first, summed from the profiler's raw records: ``device_rows``'
    ``key_averages`` builds a Python event for each record first, which
    the ~300,000 launches of xlstm-1.3b's train step would keep busy for
    about a minute."""
    import torch
    acc = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and \
                not e.is_user_annotation():
            us, n = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((us, name[:80], n) for name, (us, n) in acc.items()),
                  reverse=True)


def train_breakdown(tr):
    """Two more steps of ``tr`` in their parts: forward and backward,
    clipping and the optimizer update between CUDA events, then the same
    under the profiler for device busy time, the matrix products' share
    and the longest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.train.step import to_device
    model = tr.state.params
    params = dict(model.named_parameters())
    batch = to_device(tr.data.batch_at(tr.data_state.step), "cuda")

    def step(ev, batch):
        ev[0].record()
        T.loss_fn(model, tr.cfg, batch, use_flash=False).backward()
        ev[1].record()
        grads, _ = clip_by_global_norm(
            {k: p.grad for k, p in params.items()}, 1.0)
        ev[2].record()
        tr.optimizer.update(grads, tr.state.opt_state, params)
        ev[3].record()
        del grads
        for p in params.values():
            p.grad = None
        torch.cuda.synchronize()

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    step(ev, batch)
    out = {"forward_backward_ms": ev[0].elapsed_time(ev[1]),
           "clip_ms": ev[1].elapsed_time(ev[2]),
           "update_ms": ev[2].elapsed_time(ev[3])}
    t0 = time.perf_counter()
    # the card's activity only: host-side operator events cost the
    # profiler's post-processing about 1 ms a kernel
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step([torch.cuda.Event(enable_timing=True) for _ in range(4)], batch)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = kernel_rows(prof)
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    gemm_ms = sum(us for us, n, _ in rows
                  if any(g in n.lower() for g in GEMM_NAMES)) / 1e3
    out.update({"profiled_tokens": list(batch["tokens"].shape),
                "profiler_s": time.perf_counter() - t0,
                "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "profiled_idle_share": 1 - busy_ms / wall_ms,
                "gemm_ms": gemm_ms, "gemm_share": gemm_ms / busy_ms,
                "kernels": sum(c for _, _, c in rows),
                "top": [{"name": n, "ms": us / 1e3, "count": c}
                        for us, n, c in rows[:8]]})
    return out


def train_full(arch, optimizer, steps, seq, workdir):
    """The launcher's trainer for ``arch`` at full width on the card,
    ``TRAIN_BATCH`` x ``seq`` tokens a step (``optimizer`` None: the
    launcher's rule): the cross gates at ``CROSS_GATE``, ``steps`` steps,
    no kernel launch, finite losses and grad norms, the first loss against
    ``loss_fn`` under ``no_grad``, each of ``train_leaves`` given a nonzero
    gradient by the first step and moved (but ``STILL_LEAVES``); per-step
    ms, tokens/s and the peak memory, granite's aux loss and dropped-slot
    share, and a step in its parts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.models import transformer as T
    from repro_torch.train.step import auto_microbatches, to_device
    argv = ["--arch", arch, "--full", "--steps", str(steps),
            "--batch", str(TRAIN_BATCH), "--seq", str(seq),
            "--device", "cuda", "--workdir", workdir]
    if optimizer:
        argv += ["--optimizer", optimizer]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = launcher.make_trainer(argv)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    try:
        if tr.ckpt_every <= steps:
            fail(f"the launcher would checkpoint every {tr.ckpt_every} steps")
        cfg, model = tr.cfg, tr.state.params
        set_gates(model, CROSS_GATE)
        n_params = sum(p.numel() for p in model.parameters())
        batch = to_device(tr.data.batch_at(0), "cuda")
        moe = {}
        with torch.no_grad():
            want = float(T.loss_fn(model, cfg, batch, use_flash=False))
            if cfg.moe_experts:  # batch 0's routing at the first step
                with Routing() as routes:
                    _, aux = T.hidden_forward(model, cfg, batch["tokens"],
                                              use_flash=False)
                moe = {"aux_loss": float(aux),
                       "dropped_slot_share": dropped_share(routes.seen, cfg)}
        params = dict(model.named_parameters())
        leaves = {n: params[n] for n in train_leaves(model)}
        before = {n: p.detach().to("cpu", copy=True)
                  for n, p in leaves.items()}
        ops.reset_launch_counts()
        with FirstGrads(leaves) as first:
            out = tr.run(log_every=1)
        launches = ops.launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        if any(launches.values()):
            fail(f"{arch} training at full width launched kernels: "
                 f"{launches}")
        ms = [m["dt"] * 1e3 for m in out["metrics"]]
        losses = [m["loss"] for m in out["metrics"]]
        norms = [m["grad_norm"] for m in out["metrics"]]
        if out["final_step"] != steps or len(ms) != steps:
            fail(f"{arch} full-width training ran {out['final_step']} steps")
        if not all(abs(v) < float("inf") for v in losses + norms):
            fail(f"{arch}: non-finite loss or grad norm: {losses} {norms}")
        if abs(losses[0] - want) > 1e-3 * abs(want):
            fail(f"{arch}: first step's loss {losses[0]} vs loss_fn {want}")
        grads = first.values()
        if sorted(grads) != sorted(leaves) or \
                not all(0 < g < float("inf") for g in grads.values()):
            fail(f"{arch}: the first step's largest gradients {grads}")
        moved = {n: int((p != before[n].to(p.device)).sum()) / p.numel()
                 for n, p in leaves.items()}
        del before
        if not all(v for n, v in moved.items()
                   if not n.endswith(STILL_LEAVES)):
            fail(f"{arch}: the steps left a leaf unchanged: {moved}; "
                 f"first-step gradients {grads}")
        tokens = TRAIN_BATCH * seq
        steady = statistics.median(ms[1:])
        stats = {"arch": arch, "optimizer": type(tr.optimizer).__name__,
                 "params": n_params,
                 "adamw_reckoned_gb": 12 * n_params / 1e9,
                 "batch": TRAIN_BATCH, "seq": seq,
                 "layers": cfg.n_layers, "remat": cfg.remat,
                 "n_micro": auto_microbatches(cfg, TRAIN_BATCH, seq),
                 "init_s": init_s, "loss": losses, "grad_norm": norms,
                 "ms": ms, "first_step_ms": ms[0], "ms_per_step": steady,
                 "tokens_per_s": tokens / steady * 1e3,
                 "loss_fn_no_grad": want,
                 "first_loss_rel_err": abs(losses[0] - want) / abs(want),
                 "first_step_max_abs_grad": grads, "moved_share": moved,
                 "peak_gib": peak_gib, "launches": launches,
                 "card": card_line()}
        stats.update(moe)
        # after the checks
        stats["breakdown"] = train_breakdown(tr)
        stats["seconds"] = time.perf_counter() - t0
        for m in out["metrics"]:
            print(f"  {arch} step {m['step']}: loss {m['loss']:.6f}  grad "
                  f"norm {m['grad_norm']:.6f}  {m['dt'] * 1e3:.2f} ms  "
                  f"{tokens / m['dt']:.1f} tokens/s  peak "
                  f"{stats['peak_gib']:.2f} GiB  ({stats['card']})",
                  flush=True)
        return stats
    finally:
        tr.close()
        del tr
        gc.collect()
        torch.cuda.empty_cache()


def phase_train_full():
    """Each of ``TRAIN_ARCHS`` at full width and depth through the
    launcher's trainer."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for arch, optimizer, steps, seq in TRAIN_ARCHS:
            st = train_full(arch, optimizer, steps, seq, f"{d}/{arch}")
            print(f"LM training ({arch} full width, {st['optimizer']}): "
                  + json.dumps(st), flush=True)
            out[arch] = st
    return out


def phase_train_restart():
    """At each ``RESTART_ARCHS`` smoke config on the card (the cross gates
    at ``CROSS_GATE``): 20 steps straight against 10 steps, a restart from
    the checkpoint, and 10 more; the losses after the restart must be
    bitwise equal."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.train.trainer import Trainer
    kw = dict(device="cuda", global_batch=4, seq_len=64, total_steps=20,
              ckpt_every=10, lr=1e-3)

    def trainer(cfg, workdir):
        tr = Trainer(cfg, workdir, **kw)
        if tr.data_state.step == 0:
            set_gates(tr.state.params, CROSS_GATE)
        return tr

    last = {}
    for arch in RESTART_ARCHS:
        cfg = get_config(arch, smoke=True)
        with tempfile.TemporaryDirectory() as d:
            straight = trainer(cfg, d + "/a")
            ref = {m["step"]: m["loss"]
                   for m in straight.run(log_every=1)["metrics"]}
            straight.close()
            first = trainer(cfg, d + "/b")
            first.run(n_steps=10, log_every=1)
            first.close()
            second = trainer(cfg, d + "/b")
            if second.data_state.step != 10:
                fail(f"{arch}: restart resumed at step "
                     f"{second.data_state.step}")
            got = {m["step"]: m["loss"]
                   for m in second.run(log_every=1)["metrics"]}
            second.close()
        if sorted(got) != list(range(10, 20)) or \
                any(got[s] != ref[s] for s in got):
            fail(f"{arch} smoke: losses after the restart differ: {got} vs "
                 f"{ref}")
        last[arch] = got[19]
    print(f"checkpoint restarts on the card (smoke configs, 10 + 10 steps "
          f"against 20): losses after the restart bitwise equal; last "
          f"losses {json.dumps(last)}", flush=True)


# ---------------------------------------------------------------------------
# MoE serving: granite-moe-1b-a400m at full width, and TieredParamStore
# ---------------------------------------------------------------------------
#: the MoE serving path: granite-moe-1b-a400m at full width and depth (24
#: layers, 32 experts, top-8), prefill of 4 x 2,048 tokens; the launcher
#: teacher-forces 4 x 128 tokens (512 until it was cut for the clock), then
#: decodes 32
MOE = dict(arch="granite-moe-1b-a400m", batch=4, seq=2048, prompt_len=128,
           new_tokens=32)
#: the MoE smoke configs the card is held to the CPU path on
MOE_SMOKE_ARCHS = ("granite-moe-1b-a400m", "kimi-k2-1t-a32b")
#: the recurrent archs, whose smoke configs phases 16 and 18 take
RNN_ARCHS = ("recurrentgemma-2b", "xlstm-1.3b")
#: recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU, 8 local
#: attention at D = 256 with 10 query heads on one KV head, window 2,048):
#: prefill of 2 x 4,096 tokens, so the window bites, flash on the wgmma
#: kernel; the launcher teacher-forces 4 x 128 tokens (512 until it was cut
#: for the clock), then decodes 32.
#: The profile reports the RG-LRU scan's share.
RG = dict(arch="recurrentgemma-2b", batch=2, seq=4096, launch_batch=4,
          prompt_len=128, new_tokens=32, flash_variant="wgmma",
          ranges={"rglru_scan": ("repro_torch.models.layers",
                                 "associative_scan")})
#: flash_attention at recurrentgemma's prefill: q (2, 4096, 10, 256), k/v
#: (2, 4096, 1, 256), causal, window 2,048: 6,292,480 attended pairs per
#: (batch, head)
FLASH_RG = FLASH_CASES[-1]
#: xlstm-1.3b at full width and depth (48 layers: 42 mLSTM, 6 sLSTM; no
#: attention, so no kernel): prefill of 4 x 2,048 tokens, the launcher
#: teacher-forcing 4 x 128 tokens (a decode step costs the same at any
#: position: the state is fixed-size; 512 took 29-48 s a call, and 256 was
#: cut to 128 for the clock), then 32;
#: the profile reports the sLSTM loop's and the mLSTM chunks' shares.
#: Its prefill is host-bound (2,048 sLSTM steps a layer), so it is timed
#: over 2 calls
XL = dict(arch="xlstm-1.3b", batch=4, seq=2048, prompt_len=128,
          new_tokens=32, reps=2, profile_seq=128,
          ranges={"slstm": ("repro_torch.models.layers", "slstm_apply"),
                  "mlstm": ("repro_torch.models.layers", "mlstm_apply")})
#: the cross-attention archs, whose smoke configs phase 16 takes
CROSS_ARCHS = ("whisper-base", "llama-3.2-vision-11b")
#: every cross layer's gate after ``init`` (which leaves it at 0, as the
#: reference does: the cross path would add nothing)
CROSS_GATE = 0.5
#: llama-3.2-vision-11b at full width and depth (40 layers, 8 of them cross
#: layers over 1,601 patches of 1,280; 32 query heads on 8 KV heads of
#: 128): prefill of 4 x 2,048 tokens, flash on the wgmma kernel at group
#: size 4; the launcher teacher-forces 4 x 128 tokens (256 until it was cut
#: for the clock),
#: then decodes 32.  The profile reports the cross path's
#: shares
VLM = dict(arch="llama-3.2-vision-11b", batch=4, seq=2048, prompt_len=128,
           new_tokens=32,
           ranges={"cross_layer": ("repro_torch.models.transformer",
                                   "_cross"),
                   "cross_kv": ("repro_torch.models.transformer",
                                "_make_cross_kv"),
                   "sdpa": ("repro_torch.models.layers", "_sdpa")})
#: whisper-base at full width and depth (6 encoder and 6 decoder layers,
#: d_model 512, 8/8 heads of 64, 1,500 frames): prefill of 4 x 512 decoder
#: tokens (512 is the flash threshold; whisper's own text context is 448,
#: which takes the inline _sdpa), flash on the wgmma kernel at D = 64, group
#: size 1; the launcher teacher-forces 4 x 128 tokens (512 until it was cut
#: for the clock), then decodes 32.
#: The profile reports the encoder's and the cross path's shares
WHISPER = dict(arch="whisper-base", batch=4, seq=512, prompt_len=128,
               new_tokens=32,
               ranges={"encoder": ("repro_torch.models.transformer",
                                   "_encode"),
                       **VLM["ranges"]})
#: flash_attention at the two cross models' decoder prefills: llama's q (4,
#: 2048, 32, 128), k/v (4, 2048, 8, 128) and whisper's q (4, 512, 8, 64),
#: k/v (4, 512, 8, 64), causal
FLASH_VLM = FLASH_CASES[-3]
FLASH_WHISPER = FLASH_CASES[-2]
#: the sliding-window dense families at full width and depth, random
#: weights from a seed, every layer windowed at 4,096 (the reference windows
#: gemma2's "attn" layers too): prefills of 2 x 8,192 tokens, so the window
#: bites, flash on the wgmma kernel (D = 256 with softcap 50; D = 120 on
#: D = 128's plan), logits bitwise on a rerun; the launchers teacher-force 4
#: x 128 tokens (256 until the clock cut them), then decode 32.  gemma2-9b: 42 layers, d_model 3,584, 16 /
#: 8 heads of 256, 9.24 B parameters; h2o-danube-3-4b: 24 layers, d_model
#: 3,840, 32 / 8 heads of 120, 3.84 B
GEMMA = dict(arch="gemma2-9b", batch=2, seq=8192, launch_batch=4,
             prompt_len=128, new_tokens=32, flash_variant="wgmma",
             rerun=True)
DANUBE = dict(GEMMA, arch="h2o-danube-3-4b")
#: flash_attention at their prefills: 25,167,872 attended (query, key)
#: pairs per (batch, head), 8.25e11 and 7.73e11 flops
FLASH_GEMMA = (2, 8192, 8192, 16, 8, 256, True, 4096, 50.0)
FLASH_DANUBE = (2, 8192, 8192, 32, 8, 120, True, 4096, 0.0)
#: their smoke configs (window 32): teacher-forced decode steps past the
#: 32-slot rings, card against the CPU path
WINDOW_ARCHS = ("gemma2-9b", "h2o-danube-3-4b")
WINDOW_DECODE_STEPS = 64
#: one layer of each recurrent kind at full width (RG-LRU at
#: recurrentgemma's d_model, mLSTM and sLSTM at xlstm's), B = 1, S = 512
#: (two mLSTM chunks): the card against the port's CPU path, relative to
#: the largest CPU value
RNN_LAYERS = (("rglru", 2560, 10), ("mlstm", 2048, 4), ("slstm", 2048, 4))
RNN_LAYER_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
#: flash_attention at granite's prefill: q (4, 2048, 16, 64), k/v (4, 2048,
#: 8, 64), causal; the wgmma kernel at D = 64 with group size 2
FLASH_MOE = (4, 2048, 2048, 16, 8, 64, True, 0, 0.0)
#: substrings (lower case) of the MoE dispatch and combine's kernels: the
#: sorts, the index copies, scatters and gathers, the counts' scans
MOE_DISPATCH_NAMES = ("sort", "radix", "index", "scatter", "gather", "scan")
#: the store's cell: one granite layer's experts at full width, 8 of 32 in
#: the pool, the reference test's engine config; each step routes the
#: slots of one 4 x 2,048 prefill at top-8, 8 hot experts among 12-31
#: carrying 90% of them
STORE = dict(hbm_experts=8, steps=30, slots=4 * 2048 * 8, n_hot=8,
             hot_mass=0.9, seed=0,
             config=dict(read_hot_threshold=1, sampling_period=100))


def phase_flash_shape(arch, case, variant, old=None):
    """flash_attention at ``arch``'s prefill shape ``case``: the rule's
    kernel (``variant``) against the plain version and bitwise on a rerun,
    then device times of the kernel and SDPA in turns (kernel, SDPA, SDPA,
    kernel; with ``old``, the kernel it replaced, forced, is held to the
    plain version too and timed beside them: kernel, old, SDPA, SDPA, old,
    kernel), single-call times and the bound.  With a window, SDPA takes
    the window's boolean mask and K/V repeated to the query heads (not
    timed), and the kernels it ran (the backend PyTorch picked) are
    recorded.  No PyTorch call takes a softcap: with one, SDPA is timed
    without it and recorded as not the same function."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import ref
    B, S, T, H, KV, D, causal, window, cap = case
    q, k, v = flash_inputs(case, torch.bfloat16, seed=D)
    if fak.pick_variant(q.dtype, D) != variant:
        fail(f"the rule does not pick {variant} at D = {D}")
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    want = ref.flash_attention_plain(q, k, v, **kw)
    got = fak.flash_attention(q, k, v, **kw)
    again = fak.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), atol=2e-2, rtol=2e-2):
        fail(f"flash_attention ({variant}, D = {D}) differs from its plain "
             f"version by {err}")
    if not torch.equal(got, again):
        fail(f"flash_attention ({variant}, D = {D}) is not bitwise on a "
             f"rerun")
    if old is not None:
        old_out = fak.flash_attention(q, k, v, variant=old, **kw)
        torch.cuda.synchronize()
        old_err = float((old_out.float() - want.float()).abs().max())
        if not torch.allclose(old_out.float(), want.float(), atol=2e-2,
                              rtol=2e-2):
            fail(f"flash_attention ({old}, D = {D}) differs from its plain "
                 f"version by {old_err}")
        del old_out
    qt = q.transpose(1, 2).contiguous()
    if window:
        kt, vt = (x.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
                  for x in (k, v))
        qp = torch.arange(S, device="cuda")[:, None]
        kp = torch.arange(T, device="cuda")[None, :]
        mask = (kp > qp - window) & ((kp <= qp) if causal else True)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask)
    else:
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal,
                                                  enable_gqa=True)
    same_function = not cap
    if same_function and not torch.allclose(
            sdpa().transpose(1, 2).float(), got.float(), atol=2e-2,
            rtol=2e-2):
        fail("the SDPA yardstick does not compute the kernel's function")
    del want, again
    # device times in turns (kernel, [old,] SDPA, SDPA, [old,] kernel)
    order = (variant, old, "sdpa") if old else (variant, "sdpa")
    turns = {name: [] for name in order}
    sdpa_kernels = set()
    for name in order + order[::-1]:
        if name != "sdpa":
            dev = device_ms(lambda: fak.flash_attention(q, k, v, variant=name,
                                                        **kw),
                            (f"flash_{name}_kernel",), n=20)
        else:
            dev = device_ms(sdpa, None, n=20)
            sdpa_kernels.update(dev["kernels"])
        turns[name].append(dev["device_ms"])
    kernel_ms = cuda_ms(lambda: fak.flash_attention(q, k, v, **kw))
    library_ms = cuda_ms(sdpa)
    plain_ms = cuda_ms(lambda: ref.flash_attention_plain(q, k, v, **kw),
                       reps=5, warmup=1)
    bound_ms, bound_by, flops, moved = flash_bound(case, q, k, v)
    device = statistics.mean(turns[variant])
    library_device = statistics.mean(turns["sdpa"])
    stats = {"shape": {"q": list(q.shape), "kv": list(k.shape),
                       "causal": causal, "window": window},
             "variant": variant, "max_abs_err": err, "device_ms": device,
             "library_device_ms": library_device,
             "library_same_function": same_function,
             "device_turns_ms": turns, "sdpa_kernels": sorted(sdpa_kernels),
             "kernel_ms": kernel_ms, "library_ms": library_ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "flops": flops, "bytes": moved,
             "device_bound_share": bound_ms / device,
             "achieved_tflops": flops / device / 1e9}
    if old:
        old_device = statistics.mean(turns[old])
        stats.update(old_variant=old, old_device_ms=old_device,
                     old_max_abs_err=old_err,
                     old_device_bound_share=bound_ms / old_device,
                     device_vs_old=device / old_device,
                     device_vs_library=device / library_device)
    print(f"flash_attention at {arch}'s prefill (D = {D}, H = {H}, "
          f"KV = {KV}): " + json.dumps(stats), flush=True)
    return stats


def route_stream(steps, slots, E, n_hot, hot_mass, seed):
    """Expert ids of ``steps`` batches of ``slots`` routed slots, from a
    numpy seed: ``n_hot`` hot experts among 12..E-1 carry ``hot_mass``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hot = np.sort(rng.choice(np.arange(12, E), n_hot, replace=False))
    p = np.full(E, (1 - hot_mass) / (E - n_hot))
    p[hot] = hot_mass / n_hot
    return hot, [rng.choice(E, size=slots, p=p) for _ in range(steps)]


def phase_tiered_params():
    """TieredParamStore over one granite layer's 32 experts at full width,
    8 in the card's pool: 30 steps of route + step_engine, residency,
    migrations and hits bitwise equal to the same store on the CPU, the
    hot set resident at the end, gather bitwise equal to the host rows in
    bf16; ms per step, gather ms and the promotions' host-to-device GB/s."""
    import numpy as np
    import torch
    from repro_torch.core.tiered_params import TieredParamStore
    cfg = lm_cfg(MOE)
    E, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(STORE["seed"])
    weights = {"w_gate": rng.standard_normal((E, d, f), np.float32),
               "w_up": rng.standard_normal((E, d, f), np.float32),
               "w_down": rng.standard_normal((E, f, d), np.float32)}
    hot, stream = route_stream(STORE["steps"], STORE["slots"], E,
                               STORE["n_hot"], STORE["hot_mass"],
                               STORE["seed"])
    kw = dict(config=STORE["config"], seed=STORE["seed"])
    card = TieredParamStore(weights, STORE["hbm_experts"], device="cuda",
                            **kw)
    cpu = TieredParamStore(weights, STORE["hbm_experts"], device="cpu", **kw)
    if not card.host["w_gate"].is_pinned():
        fail("the store's host experts are not pinned")
    ids_card = [torch.from_numpy(ids).cuda() for ids in stream]
    torch.cuda.synchronize()
    step_ms = []
    for ids, ids_dev in zip(stream, ids_card):
        t0 = time.perf_counter()
        card.route(ids_dev)
        card.step_engine(100.0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        cpu.route(ids)
        cpu.step_engine(100.0)
        same = (np.array_equal(card.slot_of, cpu.slot_of)
                and np.array_equal(card.expert_of_slot, cpu.expert_of_slot)
                and (card.migrations, card.fast_hits, card.slow_hits)
                == (cpu.migrations, cpu.fast_hits, cpu.slow_hits))
        if not same:
            fail(f"the store on the card and on the CPU diverge: "
                 f"{card.slot_of} vs {cpu.slot_of}")
    resident = set(np.flatnonzero(card.slot_of >= 0).tolist())
    if not set(hot.tolist()) <= resident:
        fail(f"hot experts {hot.tolist()} not all resident: {resident}")
    ids = np.concatenate([hot[:4], np.flatnonzero(card.slot_of < 0)[:4]])
    for name, w in weights.items():
        want = torch.from_numpy(w[ids]).to(torch.bfloat16)
        got = card.gather(name, ids)
        if not (torch.equal(got.cpu(), want) and torch.equal(
                card.hbm[name].cpu(), cpu.hbm[name])):
            fail(f"gather({name!r}) is not the host rows in bf16")
    gather_ms = cuda_ms(lambda: [card.gather(n, ids) for n in weights])
    # promotions: an evicted expert comes back, host to device, in turns
    out = [int(e) for e in ids[4:]]
    n_moves = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        for e_in in out:
            e_out = int(card.expert_of_slot[0])
            card._demote(e_out)
            card._promote(e_in)
            out[out.index(e_in)] = e_out
            n_moves += 1
    torch.cuda.synchronize()
    promote_s = time.perf_counter() - t0
    stats = {"experts": E, "hbm_experts": STORE["hbm_experts"],
             "expert_mb_host_f32": card.bytes_per_expert / 1e6,
             "expert_mb_pool_bf16": card.bytes_per_expert / 2e6,
             "steps": STORE["steps"], "slots_per_step": STORE["slots"],
             "hot": hot.tolist(), "resident": sorted(resident),
             "migrations": card.migrations, "fast_hits": card.fast_hits,
             "slow_hits": card.slow_hits, "hit_rate": card.hit_rate(),
             "step_ms": step_ms, "step_ms_median": statistics.median(step_ms),
             "gather_ms_8_ids_3_leaves": gather_ms,
             "promotions_timed": n_moves,
             "promote_ms": promote_s * 1e3 / n_moves,
             "promote_gb_per_s": n_moves * card.bytes_per_expert / promote_s
             / 1e9}
    print("TieredParamStore (granite-moe-1b-a400m layer, full expert width, "
          "card = CPU bitwise): " + json.dumps(stats), flush=True)
    return stats


def phase_recurrent_layers():
    """One layer of each recurrent kind at full width on the card against
    the port's CPU path, same weights and input (from a seed), float32 and
    bf16: the output and each leaf of the new state within
    ``RNN_LAYER_TOL`` of the largest CPU value; card ms per call beside.
    The recurrences have no hand-written kernel, so this holds them at
    full width."""
    import torch
    from repro_torch.models import layers as L
    init = {"rglru": lambda g, D, H, dt: L.rglru_init(
                g, D, int(1.5 * D), H, dtype=dt, device="cpu"),
            "mlstm": lambda g, D, H, dt: L.mlstm_init(g, D, H, dt, "cpu"),
            "slstm": lambda g, D, H, dt: L.slstm_init(g, D, H, dt, "cpu")}
    apply = {"rglru": lambda p, x, H: L.rglru_apply(p, x),
             "mlstm": lambda p, x, H: L.mlstm_apply(p, x, H),
             "slstm": lambda p, x, H: L.slstm_apply(p, x)}
    stats = {}
    for kind, D, H in RNN_LAYERS:
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            gen = torch.Generator().manual_seed(0)
            params = init[kind](gen, D, H, dt)
            x = torch.randn((1, 512, D), generator=gen).to(dt)
            t0 = time.perf_counter()
            cpu_out, cpu_state = apply[kind](params, x, H)
            cpu_s = time.perf_counter() - t0
            card_params = {k: v.cuda() for k, v in params.items()}
            xc = x.cuda()
            out, state = apply[kind](card_params, xc, H)
            errs = [rel_err(a.cpu(), b)
                    for a, b in zip((out,) + tuple(state),
                                    (cpu_out,) + tuple(cpu_state))]
            if not all(e <= RNN_LAYER_TOL[dname] for e in errs):
                fail(f"{kind} at d_model {D} ({dname}): card and CPU differ "
                     f"by {errs} (output, state leaves)")
            card_ms = cuda_ms(lambda: apply[kind](card_params, xc, H),
                              reps=5, warmup=1)
            stats[f"{kind}-{dname}"] = {"d_model": D, "rel_err": errs,
                                        "card_ms": card_ms, "cpu_s": cpu_s}
            del params, card_params, out, state, cpu_out, cpu_state
    print("recurrent layers at full width (B = 1, S = 512), card against the "
          "CPU path: " + json.dumps(stats), flush=True)
    return stats


def phase_window_decode():
    """gemma2-9b's and h2o-danube-3-4b's smoke configs (window 32) through
    ``WINDOW_DECODE_STEPS`` teacher-forced ``build_serve_step`` steps, twice
    around their 32-slot rings, on the card against the port's CPU path
    from the same weights: every step's logits within ``LM_LOGIT_TOL`` of
    the largest CPU logit, no kernel launched (decode attends inline)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve.step import build_serve_step
    stats = {}
    for arch in WINDOW_ARCHS:
        cfg = get_config(arch, smoke=True)
        n = WINDOW_DECODE_STEPS
        tokens = torch.from_numpy(
            np.random.default_rng(3).integers(0, cfg.vocab, (2, n)))
        step = build_serve_step(cfg)
        logits = {}
        ops.reset_launch_counts()
        for device in ("cpu", "cuda"):
            model = T.init(0, cfg, device="cpu").to(device)
            cache = T.decode_init(cfg, 2, n, device=device)
            rings = {e["kv"][0].shape[1] for e in cache}
            if rings != {cfg.window}:
                fail(f"{arch} smoke: rings of {rings} slots, expected "
                     f"{cfg.window}")
            out = []
            for t in range(n):
                _, lg, cache = step(model, tokens[:, t:t + 1].to(device), t,
                                    cache)
                out.append(lg[:, -1].float().cpu())
            logits[device] = torch.stack(out, 1)
        if any(ops.launch_counts().values()):
            fail(f"{arch} smoke decode launched kernels: "
                 f"{ops.launch_counts()}")
        errs = [rel_err(logits["cuda"][:, t], logits["cpu"][:, t])
                for t in range(n)]
        if not (bool(torch.isfinite(logits["cuda"]).all())
                and max(errs) <= LM_LOGIT_TOL):
            fail(f"{arch} smoke decode past its ring: card and CPU differ by "
                 f"{max(errs)} (tolerance {LM_LOGIT_TOL})")
        stats[arch] = {"steps": n, "ring": cfg.window,
                       "max_rel_err": max(errs),
                       "max_rel_err_past_ring": max(errs[cfg.window:])}
    print("window decode (smoke configs, window 32, teacher-forced), card "
          "against the CPU path: " + json.dumps(stats), flush=True)
    return stats


MESH = dict(arch="granite-moe-1b-a400m", batch=4, seq=512, steps=4,
            elastic_layers=2)
#: the full-width dry-run cells (the (16, 16) mesh, train_4k)
DRYRUN_ARCHS = ("command-r-plus-104b", "kimi-k2-1t-a32b")
#: each dry-run subprocess's bound (they took 34 and 48 s on an 8-core
#: CPU host, the two together)
DRYRUN_BOUND_S = 300
DRYRUN_DIR = ROOT / "build" / "dryrun_chip"


def stop_procs(procs):
    for _, p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def start_dryruns():
    """The dry-run cells, one subprocess each, on the host (no card),
    stopped at exit if they still run."""
    import atexit
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch in DRYRUN_ARCHS:
        procs.append((arch, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "train_4k", "--mesh", "single", "--out",
             str(DRYRUN_DIR)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    atexit.register(stop_procs, procs)
    return procs, time.perf_counter()


def finish_dryruns(procs, t0):
    """Each cell done within ``DRYRUN_BOUND_S`` of its start (one still
    running past it fails); its JSON and its per-rank bytes against the
    card's memory."""
    import torch
    hbm = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for arch, p in procs:
        left = DRYRUN_BOUND_S - (time.perf_counter() - t0)
        try:
            text, _ = p.communicate(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            fail(f"the {arch} dry-run ran past its {DRYRUN_BOUND_S} s bound")
        if p.returncode != 0:
            fail(f"the {arch} dry-run exited {p.returncode}: {text[-3000:]}")
        res = json.loads((DRYRUN_DIR / f"{arch}__train_4k__single.json"
                          ).read_text())
        mem = res["memory"]
        held = mem["param_bytes"] + mem["optimizer_bytes"] + \
            mem["batch_bytes"]
        res.update(card_bytes=hbm,
                   held_share_of_card=held / hbm,
                   peak_share_of_card=mem["peak_bytes"] / hbm,
                   fits=mem["peak_bytes"] < hbm, card=card_line())
        print(f"dry-run {arch} train_4k on (16, 16), per rank: params "
              f"{mem['param_bytes']} B, optimizer {mem['optimizer_bytes']} "
              f"B, batch {mem['batch_bytes']} B, peak {mem['peak_bytes']} B "
              f"= {res['peak_share_of_card']:.4f} of the card's {hbm} B; "
              f"{res['cost_analysis']['flops']:.6g} flops, "
              f"{res['collective_bytes_total']} collective bytes; traced "
              f"in {res['trace_s']:.1f} s ({res['card']})", flush=True)
        out[arch] = res
    return out


def mesh_run(tr, steps):
    """Losses and ms of ``steps`` more steps (``run`` returns its whole
    log)."""
    out = tr.run(n_steps=steps, log_every=1)["metrics"][-steps:]
    return [m["loss"] for m in out], [m["dt"] * 1e3 for m in out]


def same_losses(got, want, what):
    """Bitwise, or else within 1e-6 relative (reported)."""
    if got == want:
        return True
    worst = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    if len(got) != len(want) or worst > 1e-6:
        fail(f"{what}: losses {got} against the unsharded {want}")
    print(f"{what}: losses within {worst:.3g} relative, not bitwise",
          flush=True)
    return False


def phase_mesh(procs, t_dry):
    """Phase 31: the (1, 1) mesh trainer against the unsharded one, the
    elastic round trip, and the dry-run subprocesses (started before
    phase 20, so that they trace on the host while the card trains)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    from repro_torch.train.trainer import Trainer
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        L.set_moe_buffer_sharding(("model", "data", None))
        cfg = get_config(MESH["arch"])
        kw = dict(global_batch=MESH["batch"], seq_len=MESH["seq"],
                  total_steps=100, ckpt_every=1000, optimizer="adamw",
                  seed=0)
        res = {}
        with tempfile.TemporaryDirectory() as d:
            for name in ("plain", "mesh"):
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                tr = Trainer(cfg, f"{d}/{name}", device="cuda", **kw) \
                    if name == "plain" else Trainer(cfg, mesh, f"{d}/{name}",
                                                    **kw)
                try:
                    ops.reset_launch_counts()
                    losses, ms = mesh_run(tr, MESH["steps"])
                    launches = ops.launch_counts()
                finally:
                    tr.close()
                    del tr
                res[name] = {"loss": losses, "ms": ms,
                             "ms_per_step": statistics.median(ms[1:]),
                             "peak_gib": torch.cuda.max_memory_allocated()
                             / 2 ** 30, "launches": launches}
                if any(launches.values()):
                    fail(f"the {name} granite run launched kernels: "
                         f"{launches}")
            res["bitwise"] = same_losses(res["mesh"]["loss"],
                                         res["plain"]["loss"],
                                         "granite on the (1, 1) mesh")
            small = dataclasses.replace(cfg, n_layers=MESH["elastic_layers"])
            ref = Trainer(small, f"{d}/ref", device="cuda", **kw)
            try:
                want, _ = mesh_run(ref, MESH["steps"] + 2)
            finally:
                ref.close()
                del ref
            tr = Trainer(small, mesh, f"{d}/el", **kw)
            try:
                got, _ = mesh_run(tr, MESH["steps"])
                save_checkpoint(f"{d}/el", tr.data_state.step, tr.state,
                                aux={"data": tr.data_state.to_dict()})
                tr.restore_elastic(torch.device("cuda"))
                plain_dev = tr.mesh is None
                got += mesh_run(tr, 1)[0]
                save_checkpoint(f"{d}/el", tr.data_state.step, tr.state,
                                aux={"data": tr.data_state.to_dict()})
                tr.restore_elastic(mesh)
                got += mesh_run(tr, 1)[0]
            finally:
                tr.close()
                del tr
            if not plain_dev:
                fail("restore_elastic onto the device kept the mesh")
            res["elastic"] = {"loss": got, "unsharded": want,
                              "layers": MESH["elastic_layers"],
                              "bitwise": same_losses(
                                  got, want, "elastic mesh -> device -> "
                                  "mesh")}
        for name in ("plain", "mesh"):
            r = res[name]
            print(f"  granite {name}: losses {r['loss']}, "
                  f"{r['ms_per_step']:.2f} ms/step ({r['ms']}), peak "
                  f"{r['peak_gib']:.2f} GiB ({card_line()})", flush=True)
        res["dryrun"] = finish_dryruns(procs, t_dry)
        res["card"] = card_line()
        print("mesh: " + json.dumps(res), flush=True)
        return res
    finally:
        L.set_moe_buffer_sharding(None)
        stop_procs(procs)


#: the elapsed seconds at the last ``stamp``
STAMPED = [0.0]


def stamp(label: str, t0: float) -> None:
    """The script's elapsed seconds at the end of a group of phases, and
    the group's own."""
    now = time.perf_counter() - t0
    print(f"chip_smoke: {label} done at {now:.1f} s ({now - STAMPED[0]:.1f} "
          f"s)", flush=True)
    STAMPED[0] = now


def main() -> int:
    import torch
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fak
    from repro_torch.kernels import page_migrate as pmk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import select_topk as sk

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    seconds = build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(seconds)}", flush=True)
    # ptxas's registers, shared memory and spills of the kernels built
    # with its report
    for name in build.KERNEL_FLAGS:
        print("\n".join(line for line in build.build_log(name).splitlines()
                        if line.startswith("ptxas info    : Used")
                        or line.startswith("ptxas info    : Compiling")
                        or "spill" in line or "arning" in line), flush=True)

    stamp("build", start)
    topk_timing = phase_select_topk("cuda")
    stamp("select_topk", start)
    phase_small_reference()
    phase_study_run()
    tune_launches, tune_by_variant = phase_tune()
    stamp("Study.run and Study.tune", start)
    acq_timing = phase_topk_mask()
    bo = phase_bo_tune()
    stamp("topk_mask and the budget-100 tune", start)
    phase_fig2()
    phase_engine_sweep()
    stamp("Fig. 2 and the engine sweep", start)
    tune_service, asha, small = phase_tune_service(bo["wall_s"])
    stamp("the tune service and the online tuner", start)
    fleet = phase_fleet(asha, small)
    del asha, small
    stamp("the fleet", start)
    migrate_timing = phase_page_migrate()
    attention_timing = phase_paged_attention()
    stamp("page_migrate and paged_attention", start)
    serving_launches, serving_by_variant, _, _ = phase_serving()
    phase_serving_small()
    phase_kv_study()
    phase_serving_tune()
    stamp("serving", start)
    gc.collect()                      # the serving pools (~4.2 GB) go first
    torch.cuda.empty_cache()
    flash_timing = phase_flash_attention()
    model, prefill_launches, lm_stats = phase_lm_prefill()
    phase_lm_decode(model)
    stamp("flash and chatglm3-6b serving", start)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    long_study_launches = phase_select_topk_long()
    stamp("smoke configs card vs CPU and select_topk past 65,535", start)
    phase_train_card_vs_cpu()
    phase_train_restart()
    stamp("training: smoke configs card vs CPU and restarts", start)
    gc.collect()
    torch.cuda.empty_cache()
    dryruns = start_dryruns()
    train = phase_train_full()
    stamp("training at full width: " + ", ".join(train), start)
    gc.collect()
    torch.cuda.empty_cache()
    flash_moe = phase_flash_shape(MOE["arch"], FLASH_MOE, "wgmma")
    moe_model, moe_launches, moe_stats = phase_lm_prefill(MOE)
    phase_lm_decode(moe_model, MOE)
    del moe_model
    gc.collect()
    torch.cuda.empty_cache()
    phase_tiered_params()
    stamp("granite and the store", start)
    gc.collect()
    torch.cuda.empty_cache()
    flash_rg = phase_flash_shape(RG["arch"], FLASH_RG, "wgmma", old="mma")
    rg_model, rg_launches, rg_stats = phase_lm_prefill(RG)
    phase_lm_decode(rg_model, RG)
    stamp("recurrentgemma-2b", start)
    del rg_model
    gc.collect()
    torch.cuda.empty_cache()
    xl_model, xl_launches, _ = phase_lm_prefill(XL)
    if any(xl_launches.values()):
        fail(f"xlstm's prefill launched kernels: {xl_launches}")
    phase_lm_decode(xl_model, XL)
    stamp("xlstm-1.3b", start)
    del xl_model
    gc.collect()
    torch.cuda.empty_cache()
    phase_recurrent_layers()
    stamp("recurrent layers", start)
    gc.collect()
    torch.cuda.empty_cache()
    flash_vlm = phase_flash_shape(VLM["arch"], FLASH_VLM, "wgmma")
    flash_whisper = phase_flash_shape(WHISPER["arch"], FLASH_WHISPER, "wgmma")
    vlm_model, vlm_launches, vlm_stats = phase_lm_prefill(VLM)
    phase_lm_decode(vlm_model, VLM)
    del vlm_model
    gc.collect()
    torch.cuda.empty_cache()
    wh_model, wh_launches, wh_stats = phase_lm_prefill(WHISPER)
    phase_lm_decode(wh_model, WHISPER)
    del wh_model
    gc.collect()
    torch.cuda.empty_cache()
    stamp("cross-attention: llama-3.2-vision-11b and whisper-base", start)
    flash_gemma = phase_flash_shape(GEMMA["arch"], FLASH_GEMMA, "wgmma",
                                    old="mma")
    flash_danube = phase_flash_shape(DANUBE["arch"], FLASH_DANUBE, "wgmma",
                                     old="mma")
    gm_model, gm_launches, gm_stats = phase_lm_prefill(GEMMA)
    phase_lm_decode(gm_model, GEMMA)
    del gm_model
    gc.collect()
    torch.cuda.empty_cache()
    dn_model, dn_launches, dn_stats = phase_lm_prefill(DANUBE)
    phase_lm_decode(dn_model, DANUBE)
    del dn_model
    gc.collect()
    torch.cuda.empty_cache()
    window_decode = phase_window_decode()
    stamp("sliding window: gemma2-9b and h2o-danube-3-4b", start)
    gc.collect()
    torch.cuda.empty_cache()
    mesh = phase_mesh(*dryruns)
    mesh_launches = mesh["mesh"]["launches"]
    stamp("multi-card on one card: the (1, 1) mesh and the dry-run", start)

    def row(name, mod, timing, by_path):
        out = {
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": timing["max_abs_err"], "matches_plain": True,
            "ms": timing["kernel_ms"], "kernel_ms": timing["kernel_ms"],
            "device_ms": timing["device_ms"],
            "device_mean_ms": timing["device_mean_ms"],
            "device_bound_share": timing["bound_ms"] / timing["device_ms"],
            "host_us_per_call": timing["host_us"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing.get("bound_by", "bytes"),
            "library_ms": timing["library_ms"],
            "library_device_ms": timing["library_device_ms"]}
        for key in ("variant", "old_variant", "old_ms", "old_device_ms"):
            if key in timing:
                out[key] = timing[key]
        # the mesh path (phase 31) launches no kernel
        out["launches_by_path"]["mesh_train"] = mesh_launches.get(name, 0)
        return out

    flash_by_variant = {
        v: sum(st["flash_launches_by_variant"][v]
               for st in (lm_stats, moe_stats, rg_stats, vlm_stats, wh_stats,
                          gm_stats, dn_stats))
        for v in fak.VARIANTS}
    topk_by_variant = {v: tune_by_variant[v]
                       + serving_by_variant["select_topk"][v]
                       for v in tune_by_variant}
    topk_by_variant["cluster"] += long_study_launches
    topk_by_variant["block"] += bo["launches"]["block"]
    for part in ("c", "f"):
        for v, n in tune_service[part]["launches"].items():
            topk_by_variant[v] += n
    for v, n in fleet["g1"]["launches"].items():
        topk_by_variant[v] += n
    kernels = [
        dict(row("select_topk", sk, topk_timing,
                 {"tune": tune_launches["select_topk"],
                  "serving": serving_launches["select_topk"],
                  "study_past_old_ceiling": long_study_launches,
                  "acquisition": bo["launches"]["block"],
                  "async_tune": sum(tune_service["c"]["launches"].values()),
                  "online_tune":
                      sum(tune_service["f"]["launches"].values()),
                  "fleet_tune": sum(fleet["g1"]["launches"].values())}),
             launches_by_variant=topk_by_variant,
             cluster_size=sk.CLUSTER_SIZE,
             replay_shape_device_ms=topk_timing["replay_shape_device_ms"],
             acquisition_shape=acq_timing,
             acquisition_tune={k: bo[k] for k in (
                 "model_rounds", "swap_rounds", "split_tie_rounds",
                 "passes", "launches",
                 "acquire_card_ms_median", "acquire_numpy_ms_median")},
             tune_service=tune_service, fleet=fleet),
        row("page_migrate", pmk, migrate_timing,
            {"serving": serving_launches["page_migrate"]}),
        dict(row("paged_attention", pak, attention_timing,
                 {"serving": serving_launches["paged_attention"]}),
             launches_by_variant=serving_by_variant["paged_attention"],
             splits=attention_timing["splits"],
             cold_l2_device_ms=attention_timing["cold_l2_device_ms"]),
        dict(row("flash_attention", fak, flash_timing,
                 {"lm_prefill": prefill_launches["flash_attention"],
                  "lm_prefill_moe": moe_launches["flash_attention"],
                  "lm_prefill_recurrentgemma":
                      rg_launches["flash_attention"],
                  "lm_prefill_vlm": vlm_launches["flash_attention"],
                  "lm_prefill_whisper": wh_launches["flash_attention"],
                  "lm_prefill_gemma2": gm_launches["flash_attention"],
                  "lm_prefill_danube": dn_launches["flash_attention"]}),
             launches_by_variant=flash_by_variant,
             mma_ms=flash_timing["mma_ms"],
             achieved_tflops=flash_timing["achieved_tflops"],
             moe_shape=flash_moe, recurrentgemma_shape=flash_rg,
             recurrentgemma_device_ms=flash_rg["device_ms"],
             recurrentgemma_old_variant=flash_rg["old_variant"],
             recurrentgemma_old_device_ms=flash_rg["old_device_ms"],
             vlm_shape=flash_vlm, whisper_shape=flash_whisper,
             gemma2_shape=flash_gemma, danube_shape=flash_danube,
             gemma2_device_ms=flash_gemma["device_ms"],
             danube_device_ms=flash_danube["device_ms"],
             window_decode=window_decode, mesh=mesh,
             train_full_launches={a: st["launches"]["flash_attention"]
                                  for a, st in train.items()}),
    ]
    lossy = [x for x in FILLER_LOSS if x]
    print(f"profiler windows: {len(FILLER_LOSS)} in {PROFILED_S[0]:.1f} s, "
          f"{len(lossy)} lost filler records, {len(RETAKEN)} taken again "
          f"({json.dumps(RETAKEN)}); "
          f"filler losses in order {json.dumps(lossy)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
