#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) on error:

1. device  — needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build   — compiles every hand-written kernel from ``src/repro_torch/csrc``
   (matmul, matvec, conv2d, maxpool, blur, flash_attention) with ``nvcc``,
   one process per source, all at once, and prints the time, the
   compiler's register and spill report, per library its kernels, the
   most registers a thread and the spill bytes in all, and by name the
   registers and spills of conv2d's vector-path kernels and the
   flash-attention forward kernels.
3. kernels — each kernel at each schedule, fp32 and bf16, against its plain
   PyTorch version on the card, over the ragged shape grid of the JAX
   package's kernel tests and the workloads' shapes: matmul and matvec at
   1e-4 (fp32) and 2e-2 (bf16), relative to the output's largest magnitude
   above 1 for ``mixed_dag``'s chained products; the matmul also at shapes
   that take every cluster size along k (1, 2, 4, 8, checked per tile),
   with k not a multiple of s·bk and below it, and on the narrow copy path
   (k or n off 16 bytes, a base pointer off 16 bytes), with the cluster
   size ``split_k`` gives each main-path product printed; each matvec
   launched twice and held equal bit for bit; conv2d and maxpool
   exactly (a maxpool NaN case included), conv2d on both of its paths
   (the vector path at r = 3, 5, 7 on the workload plane and on a
   [1024,1024] one, the staged path on copies 4 bytes off alignment); the
   blur kernels (fused and
   separable, both tiles) at the workloads' planes and the JAX tests'
   ragged shapes, against their plain version exactly and the plain blur
   within 1e-5 (fp32) and 2e-2 (bf16), and the five blur host schedules
   against the plain blur at 1e-5; each blur entry and maxpool on the
   workloads' planes 4 bytes off alignment (their staged path, maxpool
   with a NaN), exactly; the four flash-attention kernels over
   the JAX tests' grid (Sq 100 padded to 128, bq = bk = 32, GQA, causal,
   window), at full width (``attention_block``'s q/k/v, one attention
   layer of yi-9b and gemma3-1b's local and global layers at 4096 tokens,
   B = 1 of the train_4k shape's global batch of 256) and at two shapes
   whose backward tiles are wholly visible (D = 128) or end in a sk_orig
   tail (D = 256), at 1e-4
   (fp32) and 3e-2 (bf16), gradients relative to their largest magnitude
   above 1, each kernel launched twice and held equal bit for bit.
4. main path — four paths, each over fresh tuning caches (the card's
   fingerprint, and the host's for slice 4) and its own dispatchers over
   the port's registry, the launch counters zeroed just before each and
   read just after.  Slice 1: eager
   ``ops.matmul``/``ops.matvec`` on cold shapes (every variant measured,
   each model fitted), then the ``large`` ``mlp_block`` and
   ``decode_microbatch`` workloads traced, compiled (sequential) and run.
   Slice 2: eager ``ops.matmul`` (``mixed_dag``'s shape among them),
   ``ops.conv2d``, ``ops.maxpool`` and ``ops.blur`` on cold shapes, then
   ``large`` ``image_pipeline`` and ``mixed_dag``.  Slice 3: eager
   ``ops.matmul`` and ``ops.attention`` on cold shapes, then ``large``
   ``attention_block``, then the differentiable flash-attention op on the
   workload's q/k/v: its forward held to the compiled run's attention
   output, the gradients of sum(sin(o)) to autograd through the plain
   oracle at 1e-4.  Each one-device workload's second run prints its
   dispatcher's ``stats()`` (decision counts, the steady overhead share).  Slice 4: a second dispatcher over the host
   (``device="cpu"``) beside the card's, both warmed at the slice-2 cold
   shapes; copies ``cpu->cuda:0`` and ``cuda:0->cpu`` measured into a
   ``CommModel``; ``large`` ``image_pipeline`` and ``mixed_dag``, bound on
   the host, compiled over ``{"cuda:0", "cpu"}`` with that model and the
   real-copy hook, and run under the sequential, async and adaptive
   executors (steals and online feedback on): placements, transfers,
   steals, predicted and measured wall time, where the last run's time
   went (decisions, calls to synchronise, the gaps between nodes) and the
   card's busy share are printed, async must equal sequential bit for bit;
   one call timed on the calling thread, on a fresh thread and on a lane
   worker of the programs' kind (``exec.LanePool``); the lane contention
   probe (``contention_probe``: a card lane's chain of dispatched 384^3
   matmuls beside a cpu lane's 384^3 matmuls, each side alone and
   together, under a spinning and a yielding wait and three cpu-lane
   thread counts), the same probe with the cpu lane's work in turns the
   matmuls, a pure-Python loop, a 256 MB copy and a cache-resident sin,
   on every core and on one (which of them slows the card op names fault
   1's cause), and what
   ``torch.set_num_threads`` on a lane worker changes; then the blur
   kernels
   (both tiles, fused and separable) on the plane each workload's blur
   node took, against that node's output, with the counters zeroed just
   before; the contention probe again in child processes (today's
   spinning wait and thread count), in turns under the OpenMP runtime's
   default wait policy and under ``OMP_WAIT_POLICY=PASSIVE``.  Then the
   obs path: ``large`` ``image_pipeline`` and ``mixed_dag`` on the warm
   slice-2 dispatcher, compiled with a fresh ``obs.Telemetry``, five
   sequential calls each, printing the dispatch and gate counters, the
   decision and per-kernel time percentiles, the drift status, the
   ``makespan:`` instants, explain's buckets and critical path, and the
   memory ledger's peak beside the predicted peak and the allocator's
   growth over the call; it fails unless the ledger peak equals the
   predicted one, the buckets sum to the makespan within 1%, the trace
   saved with the telemetry merged and read back (``from_chrome``,
   ``analyze_chrome``) gives the live critical path and buckets, the
   outputs equal those of the program compiled without telemetry bit for
   bit, and the matmul, conv2d and maxpool launches equal the dispatches
   that picked their hand variants (one at least above zero);
   ``steady_overhead_pct`` with and without telemetry in turns, for
   information.  And ``mixed_dag`` over ``{"cuda:0", "cpu"}`` under the
   async executor with a telemetry: lane utilisation, queue depths and
   waits, explain's buckets, the ledger peaks within 1.25x of predicted
   both ways, the card's hand launches equal to its hand picks, then one
   sequential call (ledger peak equal to predicted) for comparison.
   Every output is held against its workload's reference
   within 1e-5 (relative to the output's largest magnitude where that
   exceeds 1), and every hand kernel a path runs must have launched in it.
   cuDNN's TF32 default is left as PyTorch sets it: the port pins fp32
   itself.
5. bench   — the bench layer (``repro_torch.bench``) on the card, with the
   launch counters zeroed just before and read just after: ``run_bench``
   at ``large`` over the five workloads on the ``cuda`` config (every
   variant of every distinct node measured on the card, the NN+C models
   fitted, then each workload compiled and run under the best, default
   and worst variant rules), printing the summary, per workload the three
   walls, both speedups, the dispatch and executor shares, each kernel's
   MAPE, the attribution buckets and the hand-kernel launches, and the
   seconds the grid measurement and the fits took; it fails unless the
   document validates, every wall is above 0, every kernel of a workload
   has its MAPE and the matmul, matvec, conv2d and maxpool kernels
   launched.  The speedups are printed, not gated.  Then ``simdev2``
   quick with the adaptive section (best must beat worst in every
   workload, adaptive must stay bit-exact), and the CLIs in process over
   the two documents: ``bench compare`` (0 on itself, 1 against a
   simulated copy with its best walls 2x slower, 0 for such a copy of the
   real config, whose speedups are never thresholded), ``bench history``,
   ``obs report`` over the adaptive telemetry and trace, ``obs cards``
   (one card per measured kernel) and ``obs dashboard``; every file under
   a temporary directory.
6. paper   — the paper's experiments (``repro_torch.paper``) on the card,
   with the launch counters zeroed just before the card combos are
   measured and read just after: the 9 card combos (the registry's
   matmul, matvec, conv2d and maxpool variants, library and hand kernels)
   generated at 500 instances each from Table 2's samplers into a
   temporary cache, then NN+C and the four baselines fitted on 250 and
   scored on the 250 held out (4000 epochs); per combo the five MAEs and
   MAPEs, NN+C's weights, the targets' range and the seconds measured
   and fitted, Table 8's ``CARD`` row and NN+C's wins over NN; it fails
   unless every NN+C has at most 75 weights, every MAPE is finite, the
   four hand kernels launched, and every card variant agrees with the
   host numpy variant in fp32 on the first 5 instances of each kernel
   within 1e-4 relative to the output's largest magnitude above 1.  Then
   Fig. 4 (the five blur schedules on cuda:0, the predictor's pick
   against the best and the default schedule; every time above 0) and
   the runtime overhead on the blur axis (``quick``).  The MAPEs and
   speedups are printed, not gated.
7. models  — the model stack (``repro_torch.models``) on the card, the
   launch counters zeroed just before and read just after: gemma3-1b
   uncut (26 layers, full width) and yi-9b at full width cut to 2 of its
   48 layers, fp32 parameters from a seeded ``torch.Generator``.  Each
   model's ``forward`` at B = 1, S = 4096 (train_4k, the batch cut to 1)
   through the hand flash-attention kernel and through the plain
   ``attend_chunked`` (``use_kernel=False``), in fp32 compute and in the
   config's bf16: the kernel's launches rise by one a layer
   (``flash_attention``; the lse forward by none) and the logits agree
   within MODEL_TOL relative to their largest magnitude, top-1 agreement
   printed.  Then serving: ``prefill`` of two 2048-token prompts into a
   cache of 2048 + 32 (one launch a layer), its logits and every cache
   leaf held against the plain prefill's, and 32 greedy ``decode_step``s
   (no launch), in fp32 — the decode logits held against ``forward``'s
   at the same positions, that forward (2080 tokens, a ragged length the
   kernel pads) against its plain twin — and in bf16 with a bf16 cache.
   Each model's weights are freed before the next one's are made.  Last
   (outside the counted window, the weights made anew from the same
   seed) each forward timed by CUDA events, with an event pair around
   every kernel launch: the kernel's share of the forward's wall; the
   serving run twice, the second timed (prefill wall, decode tokens/s,
   peak device memory over it); and a planted fault (gemma3-1b's window
   dropped, yi-9b's causal mask) that must land above MODEL_TOL.
8. serve   — the serving slice (``repro_torch.serve``, ``bench serve``,
   ``launch.serve``, ``checkpoint``) at gemma3-1b uncut, the launch
   counters zeroed just before and read just after.  ``generate`` at the
   models phase's serving shape (2 x 2048 + 32 new) in fp32 and bf16: one
   flash launch a layer in the prefill and none in decode, counted per
   call; in fp32 its tokens held to the same loop over the plain prefill
   (``use_kernel=False``), token for token or, at the first token that
   differs, the plain run's top-2 logit margin there within
   MODEL_TOL["float32"]; a second run timed (prefill, decode tokens/s,
   peak memory).  ``ServeEngine`` (bf16, 4 slots of 256) over ``bench
   serve``'s protocol at the full vocabulary: a FIFO warm-up over
   ``poisson_trace(8, rate=0.5)`` recording rows, ``LinearModel`` fits,
   then a fresh engine per trace (``bursty_trace(2, burst_gap=16)``,
   ``poisson_trace(8, rate=0.4)``) and policy (FIFO, SJF): every request
   completes, no flash launch, the telemetry contract holds (histograms,
   counters, instants and spans per request and step); TTFT and token
   latency p50/p99, goodput, steps, occupancy, the ``serve_step`` mean
   against its seeded prior, and one more step timed and profiled (the
   card's busy share, its launches).  In fp32 the engine's tokens over
   the bursty trace held to each request alone through
   ``ContinuousBatcher(max_slots=1)`` under the same margin rule.
   ``launch.serve.main`` in process at the serving shape, then through a
   checkpoint of the same weights saved and restored by the port's
   ``CheckpointManager``: the same tokens.  ``run_serve(quick=False)``
   (reduced yi-9b) on the card merged into a copy of the committed bench
   document and validated, and ``bench serve --quick`` in process.  Last,
   outside the counted window, TTFT by prefill design: a prompt of the
   traces' lengths times one engine step (piggyback) beside its batched
   prefill at B = 1, by events.
9. train   — the training slice (``repro_torch.{data,optim,train}``,
   ``launch.train``) at gemma3-1b uncut, B = 2, S = 2048 (past the 512
   window: the local layers banded, the 4 global ones full causal),
   seed-0 fp32 weights, batches from ``data.pipeline.batch_at``.  (a)
   ``make_loss_fn``'s value and gradients through the kernels against its
   ``use_kernel=False`` twin, fp32 and bf16 compute: the loss and every
   gradient leaf (relative to that leaf's largest magnitude) within
   MODEL_TOL; (b) the same with the dq and dk/dv kernels launched with
   ``window=0`` (the forward right) must land above the bound; (c) the
   counters zeroed just before, one ``make_train_step`` step (remat, bf16)
   launches the lse forward 50 times (26, and 24 again in the recompute of
   the 4 checkpointed periods of 6 layers; the 2 tail layers are not
   checkpointed), dq and dk/dv 26 times each, the forward without lse
   never; (d) ``launch.train.main`` in process, 8 steps (``--warmup 2``):
   every loss and grad norm finite, the last loss below the first, the
   same launches a step; the warm steps' time and tokens/s, the peak
   device memory; the counters read just after.  Then, outside the
   counted window, one step by the host's clock and under the profiler
   (the card's busy share, its kernels, the flash kernels' device time by
   name) and one by CUDA events with an event pair around every flash
   launch, beside the resident bytes of params, grads and both moments;
   (e) ``launch.train`` in child processes (``--train-child``: the
   launcher with the arch cut to 2 of 26 layers at full width, so a
   checkpoint of params and two fp32 moments is 3.6 GB, not 12): an
   uninterrupted run, one that crashes at step 5 (exit 42, after the
   step-4 checkpoint) and one that resumes from it; the resumed steps'
   losses equal the uninterrupted run's bit for bit, or within 1e-6
   relative (which held is printed).
10. dist   — the dist slice (``repro_torch.dist``, the shard_map MoE,
   ``launch.train --data-parallel``) on ``torch.distributed``.  (1)-(3)
   run in DIST_RANKS child processes (``--dist-child``) that share
   ``cuda:0`` over gloo, their CUDA tensors staged through host memory
   (NCCL refuses two ranks on one card; ``tools/dist_probe.py``): (1)
   gemma3-1b uncut, seed-0 fp32 weights (their checksum equal on every
   rank), the forward at B = 1, S = 4096 with ``ring=True`` under a
   4-rank ``("model",)`` mesh and ``train_rules(seq_parallel=True)``:
   the logits within MODEL_TOL["float32"] of the one-process forward
   through the flash kernel (rank 0), bit-equal on every rank, no flash
   launch in a ring layer; a planted fault (every rotation the wrong way
   round) must land above the bound; per rank the wall, the bytes staged
   through the host and their seconds, the peak device memory; (2)
   prefill 2048 tokens and 32 decode steps with ``stream_kv`` under
   ``serve_rules(long_context=True)`` (the cache's sequence over the 4
   ranks): the fp32 tokens equal the one-process run's (or a top-2
   margin within 1e-3); (3) the shard_map MoE (qwen3-moe reduced, fp32,
   capacity factor 8) on a (2, 2) ``("data", "model")`` mesh: the output
   within 1e-5 of ``moe_reference``, the expert gradients within 1e-5 of
   the global dispatch's.  (4) ``launch.train --data-parallel``: in
   process on a world of one over NCCL with phase 9's launcher argv, the
   losses within 1e-6 of that run's, the warm step and tokens/s beside
   its, the gradient all-reduce by events; then two ranks over gloo on
   ``cuda:0`` (``--dp-child``, torchrun's environment) and one process,
   2 of 26 layers at fp32 compute, the losses within 1e-5.  The counters
   are zeroed just before; every rank and child reports its launches,
   and their sum is the ``dist`` path's.
11. times  — each kernel at the workloads' shapes, timed with CUDA events
   over operand sets that together exceed the 50 MB L2 cache (the workloads
   read each operand once), beside its plain version, the one PyTorch call
   that computes the same function (``library_ms``) and its bound from the
   card's data sheet; the matmul at all five main-path products, one record
   each for its faster schedule with both schedules' times; the blur
   kernels (the fused one and each separable pass, both tiles) beside
   ``F.avg_pool2d``, with the host schedules'
   times for information, and beside each blur, maxpool and conv2d time
   the device-memory rate it reached as a share of the card's peak; the
   flash-attention kernels at the four
   attention shapes, forward and backward, beside
   ``scaled_dot_product_attention`` forward, backward (its forward+backward
   less its forward) and forward+backward, their bounds on the tensor
   cores (3xTF32) with the fp32 FMA bound beside them.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

FP32_TOL = 1e-4       # the JAX package's kernel-test tolerance for fp32
BF16_TOL = 2e-2       # and for bf16 (rounding of the bf16 result)
PARITY_TOL = 1e-5     # the workload suite's end-to-end budget

# (m, n, k) of C[m,n] = A[m,k] @ B[k,n]; (m, k) of y = A[m,k] @ x[k]
RAGGED_MM = [(64, 64, 64), (100, 70, 130), (33, 257, 65), (1, 1, 1),
             (128, 1, 128)]
RAGGED_MV = [(64, 64), (100, 70), (257, 513), (1, 5)]
WORK_MM = [(256, 2048, 1024), (256, 1024, 2048)]     # mlp_block large
WORK_MV = [(1024, 1024)]                               # decode_microbatch large
DAG_N, DAG_WIDTH = 384, 6                              # mixed_dag large
WORK_MM_DAG = [(DAG_N, DAG_N, DAG_N)]
# eager warm-up shapes in the paper's Table 2 range, the workloads' included
WARM_MM = WORK_MM + [(128, 512, 512), (512, 1024, 256), (64, 256, 1024),
                     (1024, 1024, 1024), (384, 640, 768), (32, 64, 128)]
WARM_MV = WORK_MV + [(512, 1024), (1024, 512), (256, 256), (768, 384),
                     (128, 1024), (2048, 1024)]
# (m, n, r) of a [m,n] (x) w [r,r]; (m, n, r, s) of an r x r pool at stride s
RAGGED_MC = [(64, 64, 3), (100, 90, 5), (41, 77, 7)]
RAGGED_MP = [(64, 64, 2, 2), (100, 90, 3, 2), (65, 43, 5, 1), (32, 32, 4, 2)]
WORK_MC = [(1022, 1022, 3)]                            # image_pipeline large
WORK_MP = [(1020, 1020, 2, 2), (384, 384, 2, 2)]       # image, mixed_dag
WORK_BLUR = [(1024, 1024), (384, 384)]                 # image, mixed_dag
RAGGED_BLUR = [(66, 66), (128, 100), (51, 200)]        # the JAX blur tests
# eager warm-up shapes in the paper's ranges (core/features.py mc_sample,
# mp_sample, blur_sample), the workloads' included; 2 variants x 7 shapes
# exceed min_rows_to_fit = 12, as do 5 blur variants x 4 shapes
WARM_MC = WORK_MC + [(512, 512, 3), (256, 768, 5), (1000, 300, 7),
                     (128, 128, 3), (700, 900, 5), (64, 1024, 3)]
WARM_MP = WORK_MP + [(512, 512, 3, 2), (1000, 700, 2, 1), (256, 256, 4, 2),
                     (800, 600, 5, 1), (100, 900, 3, 2)]
WARM_BLUR = WORK_BLUR + [(512, 1536), (2048, 256)]
# the slice-2 path's own matmul cold shapes: 3 variants x 5 shapes exceed
# min_rows_to_fit
WARM_MM_DAG = WORK_MM_DAG + [(128, 512, 512), (384, 640, 768), (32, 64, 128),
                             (512, 1024, 256)]
# attention_block large: its MLP branch x [512,512] @ w1 [512,1024] @ w2,
# and its causal attention over q/k/v [b=4, s=512, h=8, dh=32]
WORK_MM_ATT = [(512, 1024, 512), (512, 512, 1024)]
# the slice-3 path's cold shapes: 3 matmul variants x 4 shapes and 4
# attention variants x 4 shapes exceed min_rows_to_fit; (b, s, h, d) past
# s = 512 make the chunked schedules differ from the full one
WARM_MM_ATT = WORK_MM_ATT + [(128, 512, 512), (32, 64, 128)]
# the matmul's cluster split along k (kernels/matmul/matmul.py: split_k): on
# an H100 the 128 tile takes s = 8, 4, 2, 1 at the first four shapes (k =
# 1000 does not divide by 8 * 32), and s = 8 at (64, 96, 120), where k is
# below s * bk; the 32 tile takes s = 8 at the first, and 2 and 4 at the
# ragged (33, 257, 65) and (100, 70, 130).  (96, 36, 264) takes the narrow
# copy path in bf16 only (n a multiple of 4 but not of 8), the ragged shapes
# in both types; MM_MISALIGNED's a starts 4 or 2 bytes off 16.
CLUSTER_MM = [(128, 256, 1000), (384, 1280, 520), (512, 1536, 200),
              (1024, 1280, 64), (64, 96, 120), (96, 36, 264)]
MM_MISALIGNED = (256, 512, 300)
WARM_ATT = [(4, 512, 8, 32), (2, 1024, 8, 32), (1, 2048, 4, 64),
            (2, 768, 8, 32)]
FA_BF16_TOL = 3e-2    # the JAX flash-attention tests' bf16 tolerance
# the JAX flash-attention tests' grid: b=2, Sq=Sk=100, d=32, bq=bk=32
FA_GRID = [(h, kv, causal, window) for h, kv in ((8, 2), (4, 4), (6, 1))
           for causal, window in ((True, 0), (False, 0), (True, 16))]
# (label, B, H, KV, S, D, causal, window) at full width: attention_block
# large, and one attention layer of yi-9b (src/repro/configs/yi_9b.py) and
# both kinds of gemma3-1b's (src/repro/configs/gemma3_1b.py: 22 local
# layers, window 512, and 4 global ones) at the train_4k sequence of 4096
# (src/repro/configs/base.py), B = 1 of its global batch of 256
FA_SHAPES = (("attention_block", 4, 8, 8, 512, 32, True, 0),
             ("yi-9b", 1, 32, 4, 4096, 128, True, 0),
             ("gemma3-1b", 1, 4, 1, 4096, 256, True, 512),
             ("gemma3-1b-global", 1, 4, 1, 4096, 256, True, 0))
# (label, B, H, KV, S, D, causal, window, sk_orig) the backward tiles meet
# otherwise: every tile visible (no mask evaluated) at D = 128, and a key
# tail past sk_orig that ends inside a 16-row tile at D = 256
FA_EDGES = (("whole-tiles", 1, 8, 2, 512, 128, False, 0, 0),
            ("sk_orig-tail", 1, 4, 2, 512, 256, True, 0, 437))

# fp32 FLOP/s outside the tensor cores, dense TF32 tensor-core FLOP/s (half
# the data sheets' rate with sparsity) and device-memory bytes/s, from
# NVIDIA's data sheets, by a fragment of the name nvidia-smi reports (first
# match wins: the plain "H100" is the SXM part)
CARD_PEAKS = (("H100 PCIe", 51e12, 378e12, 2.0e12),
              ("H100 NVL", 60e12, 417.5e12, 3.9e12),
              ("H100", 67e12, 495e12, 3.35e12),
              ("H200", 67e12, 495e12, 4.8e12))
L2_BYTES = 50 * 2 ** 20

# the TPU kernel each record's kernel replaces, and its source in the port
REPLACES = {
    "matmul": "src/repro/kernels/matmul/matmul.py:17",
    "matvec": "src/repro/kernels/matvec/matvec.py:16",
    "conv2d": "src/repro/kernels/conv2d/conv2d.py:19",
    "maxpool": "src/repro/kernels/maxpool/maxpool.py:15",
    "blur_direct": "src/repro/kernels/blur/blur.py:21",
    "blur_h": "src/repro/kernels/blur/blur.py:33",
    "blur_v": "src/repro/kernels/blur/blur.py:42",
    "flash_attention": "src/repro/kernels/flash_attention/flash_attention.py:24",
    "flash_attention_fwd":
        "src/repro/kernels/flash_attention/flash_attention.py:63",
    "flash_attention_bwd_dq":
        "src/repro/kernels/flash_attention/flash_attention.py:114",
    "flash_attention_bwd_dkv":
        "src/repro/kernels/flash_attention/flash_attention.py:143",
}


def source_of(kernel: str) -> str:
    base = next((b for b in ("flash_attention", "blur")
                 if kernel.startswith(b)), kernel)
    return f"src/repro_torch/csrc/{base}.cu"


def launch_counts(K) -> dict:
    """Kernel -> launches so far: each wrapper's plain-int counter under its
    kernel's name, or its per-entry-point counters."""
    counts = {}
    for name, mod in K.items():
        if isinstance(mod.LAUNCHES, dict):
            counts.update(mod.LAUNCHES)
        else:
            counts[name] = mod.LAUNCHES
    return counts


def zero_counts(K) -> None:
    for mod in K.values():
        if isinstance(mod.LAUNCHES, dict):
            mod.LAUNCHES.update(dict.fromkeys(mod.LAUNCHES, 0))
        else:
            mod.LAUNCHES = 0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_peaks(name: str) -> tuple:
    """(fp32 FLOP/s, dense TF32 FLOP/s, bytes/s) of the card."""
    for fragment, fp32, tf32, bandwidth in CARD_PEAKS:
        if fragment in name:
            return fp32, tf32, bandwidth
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


# kernels whose registers and spills the build lines give by name
NAMED_KERNELS = ("conv_vec_kernel", "fa_fwd_kernel")


def _demangle(names: list) -> list:
    """The names as ``c++filt`` gives them, or as they are without it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return out.stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names


def phase_build(build) -> None:
    t0 = time.perf_counter()
    built = build.build()
    wall = time.perf_counter() - t0
    for name, (seconds, report) in built.items():
        print(f"build: {name}.cu {seconds:.2f} s")
        regs, spills, named = [], [], {}
        kernel = None
        for line in report.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = entry.group(1)
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
                if kernel and any(k in kernel for k in NAMED_KERNELS):
                    named.setdefault(kernel, []).append(line.strip())
            regs += [int(r) for r in re.findall(r"Used (\d+) registers",
                                                line)]
            spills += [int(b) for b in re.findall(
                r"(\d+) bytes spill stores", line)]
        for readable, lines in zip(_demangle(list(named)), named.values()):
            print(f"build: {name}.cu {readable}: " + "; ".join(lines))
        print(f"build: {name}.cu: {len(regs)} kernels, at most "
              f"{max(regs, default=0)} "
              f"registers a thread, {sum(spills)} bytes of spill stores in "
              f"all, {sum(b > 0 for b in spills)} kernels spilling")
    print(f"build: {len(built)} libraries in {wall:.2f} s wall "
          f"({'all cached' if not built else 'parallel nvcc'})")


def _operands(shapes, workload: bool, device, gen) -> tuple:
    """Standard-normal operands for the ragged grid (as the JAX package's
    kernel tests draw them); for the workloads' shapes, the values the main
    path feeds the kernel: uniform in [-0.5, 0.5), the contraction operand
    scaled by 1/sqrt(k) (``workloads.library._weight``).  At k=2048 two fp32
    summation orders of standard-normal products already differ by more
    than 1e-4 in absolute terms, while the workloads keep every value O(1)
    precisely so that fp32 parity holds."""
    if not workload:
        return tuple(torch.randn(*s, generator=gen, device=device)
                     for s in shapes)
    lhs, rhs = (torch.rand(*s, generator=gen, device=device) - 0.5
                for s in shapes)
    return lhs, rhs / rhs.shape[0] ** 0.5


def _dag_products(plain, device, gen) -> list:
    """The (lhs, rhs) of each of ``mixed_dag``'s matmuls at ``large``,
    drawn as the workload draws them (a, b uniform in [-0.5, 0.5), the
    weights scaled by 1/sqrt(n)) and chained through the plain version in
    fp32: the root a @ b, the branches root @ w, then the join chain."""
    a, b, *ws = (torch.rand(DAG_N, DAG_N, generator=gen, device=device)
                 - 0.5 for _ in range(2 + DAG_WIDTH))
    ws = [w / DAG_N ** 0.5 for w in ws]
    root = plain(a, b)
    pairs = [(a, b)] + [(root, w) for w in ws]
    join, *branches = (plain(root, w) for w in ws)
    for br in branches:
        pairs.append((join, br))
        join = plain(join, br)
    return pairs


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose storage starts one element past a
    16-byte boundary."""
    return t.new_empty(t.numel() + 1)[1:].view(t.shape).copy_(t)


def _print_splits(mm) -> None:
    """The cluster size split_k gives each main-path product on this card,
    fp32, per tile, beside the blocks the card runs at once per size."""
    for bm, _, _ in mm.SCHEDULES:
        print(f"kernels: matmul tile {bm} fp32 blocks at once by cluster "
              f"size: {mm.cluster_slots(0, torch.float32, bm)}")
    print("kernels: matmul split_k at the main path's shapes (tile -> s): "
          + json.dumps({str(shape): {
              bm: mm._split(0, torch.float32, *shape, bm, bn, bk)
              for bm, bn, bk in mm.SCHEDULES}
              for shape in WORK_MM + WORK_MM_DAG + WORK_MM_ATT}))


def _check_mm_mv(mm, mv, device, gen, report, worst) -> None:
    _print_splits(mm)
    work = WORK_MM + WORK_MM_ATT
    for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).removeprefix("torch.")
        splits = {bm: set() for bm, _, _ in mm.SCHEDULES}
        for m, n, k in RAGGED_MM + CLUSTER_MM + work + [MM_MISALIGNED]:
            # the cluster shapes reach k = 1000: drawn as the workloads
            # draw, like the workloads' own shapes (see _operands)
            a, b = (t.to(dtype) for t in _operands(
                [(m, k), (k, n)], (m, n, k) not in RAGGED_MM, device, gen))
            if (m, n, k) == MM_MISALIGNED:
                a = _misaligned(a)
            want = mm.plain(a, b).float()
            for bm, bn, bk in mm.SCHEDULES:
                got = mm.matmul(a, b, bm=bm, bn=bn, bk=bk)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                torch.testing.assert_close(
                    got.float(), want, rtol=tol, atol=tol,
                    msg=lambda s: f"matmul tile {bm} {dtype} {(m, n, k)}: {s}")
                key = (f"matmul_t{bm}", dname)
                report[key] = max(report.get(key, 0.0), err)
                splits[bm].add(mm._split(0, dtype, m, n, k, bm, bn, bk))
                if dtype == torch.float32 and (m, n, k) in work:
                    worst["matmul"] = max(worst["matmul"], err)
        print(f"kernels: matmul {dname} cluster sizes exercised (tile -> "
              f"s): " + json.dumps({bm: sorted(v) for bm, v in
                                    splits.items()}))
        if dtype == torch.float32:
            for bm, got in splits.items():
                if set(mm.SPLITS) - got:
                    raise RuntimeError(
                        f"matmul tile {bm}: the checked shapes exercise "
                        f"cluster sizes {sorted(got)}, not all of "
                        f"{mm.SPLITS}")
        for m, k in RAGGED_MV + WORK_MV:
            # y = A x with A the contraction operand: x first, A scaled
            x, a_t = _operands([(k,), (k, m)], (m, k) in WORK_MV, device,
                               gen)
            a = a_t.t().contiguous().to(dtype)
            x = x.to(dtype)
            want = mv.plain(a, x).float()
            got, again = mv.matvec(a, x), mv.matvec(a, x)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"matvec {dtype} {(m, k)}: two launches "
                                   "on the same operands differ")
            err = (got.float() - want).abs().max().item()
            torch.testing.assert_close(
                got.float(), want, rtol=tol, atol=tol,
                msg=lambda s: f"matvec {dtype} {(m, k)}: {s}")
            key = ("matvec", dname)
            report[key] = max(report.get(key, 0.0), err)
            if dtype == torch.float32 and (m, k) in WORK_MV:
                worst["matvec"] = max(worst["matvec"], err)
        # mixed_dag's products: absolute error over the output's largest
        # magnitude above 1 (the join's operands reach about 1e5)
        for lhs, rhs in _dag_products(mm.plain, device, gen):
            a, b = lhs.to(dtype), rhs.to(dtype)
            want = mm.plain(a, b).float()
            scale = max(1.0, want.abs().max().item())
            for bm, bn, bk in mm.SCHEDULES:
                got = mm.matmul(a, b, bm=bm, bn=bn, bk=bk)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got.float(), want, rtol=tol, atol=tol * scale,
                    msg=lambda s: f"matmul tile {bm} {dtype} mixed_dag "
                                  f"product, scale {scale:.3g}: {s}")
                err = (got.float() - want).abs().max().item() / scale
                key = (f"matmul_t{bm} mixed_dag relative", dname)
                report[key] = max(report.get(key, 0.0), err)


def _plane(shape, workload: bool, device, gen) -> torch.Tensor:
    """Standard-normal for the ragged grid; for the workloads' shapes,
    uniform in [-0.5, 0.5) as the workloads draw their planes and taps."""
    if workload:
        return torch.rand(*shape, generator=gen, device=device) - 0.5
    return torch.randn(*shape, generator=gen, device=device)


def _check_conv_pool(mc, mp, device, gen, report, worst) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        # the kernel rounds each product before the add, in the plain
        # version's tap order, and rounds the sum to bf16 as it does
        for m, n, r in RAGGED_MC + WORK_MC:
            work = (m, n, r) in WORK_MC
            a = _plane((m, n), work, device, gen).to(dtype)
            w = _plane((r, r), work, device, gen).to(dtype)
            want = mc.plain(a, w).float()
            for bm, bn in mc.SCHEDULES:
                got = mc.conv2d(a, w, bm=bm, bn=bn)
                torch.cuda.synchronize()
                err = (got.float() - want).abs().max().item()
                torch.testing.assert_close(
                    got.float(), want, rtol=0, atol=0,
                    msg=lambda s: f"conv2d tile {bm} {dtype} {(m, n, r)}: {s}")
                key = (f"conv2d_t{bm}", dname)
                report[key] = max(report.get(key, 0.0), err)
                if dtype == torch.float32 and work:
                    worst["conv2d"] = max(worst["conv2d"], err)
        # the last case plants a NaN, which must win its windows as in
        # jnp.maximum and F.max_pool2d
        cases = [(shape, False) for shape in RAGGED_MP + WORK_MP] \
            + [((100, 90, 3, 2), True)]
        for (m, n, r, s), nan in cases:
            a = _plane((m, n), (m, n, r, s) in WORK_MP, device, gen).to(dtype)
            if nan:
                a[37, 41] = float("nan")
            want = mp.plain(a, r=r, s=s)
            for bm, bn in mp.SCHEDULES:
                got = mp.maxpool(a, r=r, s=s, bm=bm, bn=bn)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, rtol=0, atol=0, equal_nan=True,
                    msg=lambda x: f"maxpool tile {bm} {dtype} "
                                  f"{(m, n, r, s)}: {x}")
                err = (got.float() - want.float()).nan_to_num().abs().max()
                key = (f"maxpool_t{bm}", dname)
                report[key] = max(report.get(key, 0.0), err.item())
                if dtype == torch.float32 and (m, n, r, s) in WORK_MP:
                    worst["maxpool"] = max(worst["maxpool"], err.item())
            if nan and not torch.isnan(want).any():
                raise RuntimeError("maxpool NaN case: the plain version "
                                   "dropped the NaN")


def _check_blur(bk, device, gen, report, worst) -> None:
    """The hand blur kernels, both tiles, fused and separable, fp32 and
    bf16, at the workloads' planes (uniform, as they feed it) and the JAX
    blur tests' ragged shapes (standard normal): against their plain
    version exactly (the bf16 rounding of h between the passes included)
    and against the plain blur within 1e-5 (fp32) or 2e-2 (bf16).  Then the
    five host schedules against the plain blur, as the workloads feed them,
    at the suite's 1e-5."""
    from repro_torch.kernels.blur import ops, ref
    for dtype, tol in ((torch.float32, PARITY_TOL), (torch.bfloat16,
                                                      BF16_TOL)):
        dname = str(dtype).removeprefix("torch.")
        for m, n in WORK_BLUR + RAGGED_BLUR:
            work = (m, n) in WORK_BLUR
            a = _plane((m, n), work, device, gen).to(dtype)
            oracle = ref.blur(a).float()
            for separable in (False, True):
                want = bk.plain(a, separable=separable)
                for bm, bn in bk.SCHEDULES:
                    got = bk.blur(a, bm=bm, bn=bn, separable=separable)
                    torch.cuda.synchronize()
                    label = (f"blur tile {bm} separable={separable} {dtype} "
                             f"{(m, n)}")
                    torch.testing.assert_close(
                        got, want, rtol=0, atol=0,
                        msg=lambda x: f"{label} vs plain: {x}")
                    torch.testing.assert_close(
                        got.float(), oracle, rtol=tol, atol=tol,
                        msg=lambda x: f"{label} vs ref.blur: {x}")
                    err = (got.float() - want.float()).abs().max().item()
                    names = ("blur_h", "blur_v") if separable \
                        else ("blur_direct",)
                    for name in names:
                        key = (f"{name}_t{bm}", dname)
                        report[key] = max(report.get(key, 0.0), err)
                        if dtype == torch.float32 and work:
                            worst[name] = max(worst[name], err)
                    key = (f"blur_t{bm} separable={separable} vs ref.blur",
                           dname)
                    report[key] = max(report.get(key, 0.0), (
                        got.float() - oracle).abs().max().item())
    for m, n in WORK_BLUR:
        a = _plane((m, n), True, device, gen)
        want = ref.blur(a)
        errs = {}
        for name, fn in ops.HOST_SCHEDULES.items():
            got = fn(a)
            torch.testing.assert_close(
                got, want, rtol=PARITY_TOL, atol=PARITY_TOL,
                msg=lambda x: f"blur {name} {(m, n)}: {x}")
            errs[name] = (got - want).abs().max().item()
        print(f"kernels: blur schedules at [{m},{n}] vs plain, max abs err: "
              + json.dumps(errs))


def _off4(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose base lies 4 bytes past an aligned
    buffer."""
    per = 4 // t.element_size()
    return t.new_empty(t.numel() + per)[per:].view(t.shape).copy_(t)


def _check_windows_staged(bk, mp, device, gen, report) -> None:
    """The window kernels' staged path: each blur entry and maxpool on a
    workload plane whose base lies 4 bytes past an aligned buffer (the
    v pass on such a copy of h, the maxpool plane with a NaN), both tiles,
    fp32 and bf16, held to the plain version exactly; the wrappers'
    geometry must have chosen the staged path, and the aligned planes the
    vector path."""
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for m, n in WORK_BLUR:
            a = _plane((m, n), True, device, gen).to(dtype)
            for name, fn, plain, src in (
                    ("blur_direct", bk.blur_direct, bk.plain, a),
                    ("blur_h", bk.blur_h, bk.plain_h, a),
                    ("blur_v", bk.blur_v, bk.plain_v, bk.plain_h(a))):
                taps, (mi, ni) = bk._TAPS[name], src.shape
                plane, es = _off4(src), src.element_size()
                if bk.geometry(taps, mi, ni, es, 128,
                               plane.data_ptr() & 15).load_bytes:
                    raise RuntimeError(f"{name} {dtype} {(mi, ni)} off 4 "
                                       "bytes: not the staged path")
                if ni * es % 8 == 0 and not bk.geometry(
                        taps, mi, ni, es, 128, src.data_ptr() & 15).load_bytes:
                    raise RuntimeError(f"{name} {dtype} {(mi, ni)}: not the "
                                       "vector path")
                want = plain(plane)
                for bm, bn in bk.SCHEDULES:
                    got = fn(plane, bm=bm, bn=bn)
                    torch.cuda.synchronize()
                    torch.testing.assert_close(
                        got, want, rtol=0, atol=0,
                        msg=lambda x: f"{name} tile {bm} {dtype} "
                                      f"{(mi, ni)} off 4 bytes: {x}")
                    key = (f"{name}_t{bm} staged", dname)
                    report[key] = max(report.get(key, 0.0), (
                        got.float() - want.float()).abs().max().item())
        for m, n, r, s in WORK_MP:
            a = _plane((m, n), True, device, gen).to(dtype)
            a[m // 3, n // 5] = float("nan")
            plane = _off4(a)
            if mp.geometry(m, n, r, s, plane.element_size(), 32,
                           plane.data_ptr() & 15).load_bytes:
                raise RuntimeError(f"maxpool {(m, n)} off 4 bytes: not the "
                                   "staged path")
            want = mp.plain(plane, r=r, s=s)
            for bm, bn in mp.SCHEDULES:
                got = mp.maxpool(plane, r=r, s=s, bm=bm, bn=bn)
                torch.cuda.synchronize()
                torch.testing.assert_close(
                    got, want, rtol=0, atol=0, equal_nan=True,
                    msg=lambda x: f"maxpool tile {bm} {dtype} {(m, n)} off "
                                  f"4 bytes: {x}")
                key = (f"maxpool_t{bm} staged", dname)
                report[key] = max(report.get(key, 0.0), (
                    got.float() - want.float()).nan_to_num().abs().max()
                    .item())


def _check_conv_paths(mc, device, gen, report) -> None:
    """conv2d on both of its paths: the workload plane and a [1024,1024]
    one (whose bf16 rows take the vector path, where the workload's
    2,044-byte bf16 rows do not), each aligned and 4 bytes past an aligned
    buffer (``_off4``, the staged path), at every compiled tap count r = 3,
    5, 7, both tiles, fp32 and bf16, held to the plain version bit for bit;
    the wrapper's geometry must have chosen the path the alignment
    allows, and both paths must have run."""
    paths = set()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for m, n, _ in WORK_MC + [(1024, 1024, 3)]:
            a = _plane((m, n), True, device, gen).to(dtype)
            for r in mc.VECTOR_TAPS:
                w = _plane((r, r), True, device, gen).to(dtype)
                for plane, off in ((a, False), (_off4(a), True)):
                    es = plane.element_size()
                    vector = not off and n * es % 8 == 0
                    want = mc.plain(plane, w)
                    for bm, bn in mc.SCHEDULES:
                        geo = mc.geometry(m, n, r, es, bm,
                                          plane.data_ptr() & 15)
                        if (geo.load_bytes > 0) != vector:
                            raise RuntimeError(
                                f"conv2d {dtype} {(m, n, r)} off 4 bytes="
                                f"{off}: geometry {geo} is not the "
                                f"{'vector' if vector else 'staged'} path")
                        got = mc.conv2d(plane, w, bm=bm, bn=bn)
                        torch.cuda.synchronize()
                        torch.testing.assert_close(
                            got, want, rtol=0, atol=0,
                            msg=lambda x: f"conv2d tile {bm} {dtype} "
                                          f"{(m, n, r)} off 4 bytes={off}: "
                                          f"{x}")
                        path = "vector" if vector else "staged"
                        paths.add(path)
                        key = (f"conv2d_t{bm} {path}", dname)
                        report[key] = max(report.get(key, 0.0), (
                            got.float() - want.float()).abs().max().item())
    if paths != {"vector", "staged"}:
        raise RuntimeError(f"conv2d ran only its {paths} path")


def _fa_inputs(b, h, kv, s, d, dtype, device, gen) -> tuple:
    """q, k scaled by 0.5 and v, do standard normal, as the JAX
    flash-attention tests draw them."""
    q, k = (torch.randn(b, n, s, d, generator=gen, device=device) * 0.5
            for n in (h, kv))
    v, do = (torch.randn(b, n, s, d, generator=gen, device=device)
             for n in (kv, h))
    return tuple(t.to(dtype) for t in (q, k, v, do))


def _fa_case(fa, q, k, v, do, kw, tol) -> dict:
    """The four kernels against their plain versions on one input set;
    returns kernel -> error (outputs absolute, lse absolute, gradients
    relative to their largest magnitude above 1)."""
    pkw = {key: val for key, val in kw.items() if key not in ("bq", "bk")}
    want_o, want_lse = fa.plain_fwd(q, k, v, **pkw)
    out = fa.flash_attention(q, k, v, **kw)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, **kw)
    if not (torch.equal(fa.flash_attention(q, k, v, **kw), out)
            and torch.equal(o2, o) and torch.equal(lse2, lse)):
        raise RuntimeError("flash attention forward: two launches on the "
                           "same operands differ")
    torch.cuda.synchronize()
    for got in (out, o):
        torch.testing.assert_close(got.float(), want_o.float(), rtol=tol,
                                   atol=tol)
    torch.testing.assert_close(lse, want_lse, rtol=FP32_TOL, atol=FP32_TOL)
    if not (torch.isfinite(out).all() and torch.isfinite(o).all()):
        raise RuntimeError("flash attention: non-finite output")
    errs = {"flash_attention": (out.float() - want_o.float()).abs().max(),
            "flash_attention_fwd": max((o.float() - want_o.float()).abs()
                                       .max(), (lse - want_lse).abs().max())}
    delta = (do.float() * want_o.float()).sum(dim=-1)
    bwd = {"flash_attention_bwd_dq": (fa.flash_attention_bwd_dq,
                                      fa.plain_bwd_dq),
           "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv,
                                       fa.plain_bwd_dkv)}
    for name, (kernel, plain) in bwd.items():
        gots = kernel(q, k, v, do, want_lse, delta, **kw)
        again = kernel(q, k, v, do, want_lse, delta, **kw)
        wants = plain(q, k, v, do, want_lse, delta, **pkw)
        torch.cuda.synchronize()
        gots = gots if isinstance(gots, tuple) else (gots,)
        again = again if isinstance(again, tuple) else (again,)
        wants = wants if isinstance(wants, tuple) else (wants,)
        if not all(torch.equal(a, b) for a, b in zip(gots, again)):
            raise RuntimeError(f"{name}: two launches on the same operands "
                               "differ")
        err = 0.0
        for got, want in zip(gots, wants):
            scale = max(1.0, want.float().abs().max().item())
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol * scale)
            err = max(err, (got.float() - want.float()).abs().max().item()
                      / scale)
        errs[name] = err
        del gots, wants
    return {name: float(e) for name, e in errs.items()}


def _check_flash_attention(fa, device, gen, report, worst) -> None:
    """Each kernel against its plain version over the JAX tests' grid
    (Sq = Sk = 100 padded to 128 as ops.attention pads at bq = bk = 32,
    sk_orig masking the padded keys), at FA_SHAPES' full widths and at
    FA_EDGES; each kernel launched twice and held equal bit for bit; the
    forwards at attention_block in fp32 within PARITY_TOL."""
    for dtype, tol in ((torch.float32, FP32_TOL),
                       (torch.bfloat16, FA_BF16_TOL)):
        dname = str(dtype).removeprefix("torch.")
        cases = [(f"grid h={h} kv={kv} causal={c} window={w}",
                  (2, h, kv, 128, 32),
                  {"causal": c, "window": w, "bq": 32, "bk": 32,
                   "sk_orig": 100}) for h, kv, c, w in FA_GRID]
        cases += [(label, (b, h, kv, s, d),
                   {"causal": c, "window": w, "bq": 256, "bk": 256})
                  for label, b, h, kv, s, d, c, w in FA_SHAPES]
        cases += [(label, (b, h, kv, s, d),
                   {"causal": c, "window": w, "bq": 256, "bk": 256,
                    "sk_orig": sk_orig})
                  for label, b, h, kv, s, d, c, w, sk_orig in FA_EDGES]
        for label, dims, kw in cases:
            q, k, v, do = _fa_inputs(*dims, dtype, device, gen)
            if kw.get("sk_orig"):         # zero padding, as ops.attention
                for t in (q, k, v, do):
                    t[:, :, kw["sk_orig"]:] = 0
            errs = _fa_case(fa, q, k, v, do, kw, tol)
            # attention_block's forward also within the workloads' budget
            if dtype == torch.float32 and label == FA_SHAPES[0][0]:
                for name in ("flash_attention", "flash_attention_fwd"):
                    if errs[name] > PARITY_TOL:
                        raise RuntimeError(
                            f"{name} at {label}: {errs[name]:.3g} from its "
                            f"plain version, above {PARITY_TOL}")
            for name, err in errs.items():
                key = (f"{name} {label.split()[0]}", dname)
                report[key] = max(report.get(key, 0.0), err)
                if dtype == torch.float32 and label == FA_SHAPES[0][0]:
                    worst[name] = max(worst[name], err)
            del q, k, v, do
            torch.cuda.empty_cache()


def phase_kernels(K, device) -> dict:
    """Every kernel at every schedule against its plain version; returns
    kernel -> worst abs error at the main path's shapes in fp32."""
    gen = torch.Generator(device=device).manual_seed(0)
    worst = dict.fromkeys(launch_counts(K), 0.0)
    report = {}
    _check_mm_mv(K["matmul"], K["matvec"], device, gen, report, worst)
    _check_conv_pool(K["conv2d"], K["maxpool"], device, gen, report, worst)
    _check_blur(K["blur"], device, gen, report, worst)
    _check_windows_staged(K["blur"], K["maxpool"], device, gen, report)
    _check_conv_paths(K["conv2d"], device, gen, report)
    _check_flash_attention(K["flash_attention"], device, gen, report, worst)
    print("kernels: " + json.dumps(
        {f"{k}/{d}": e for (k, d), e in sorted(report.items())}))
    print(f"kernels: all within tolerance of their plain versions (conv2d, "
          f"maxpool and blur exact, a NaN case included); launches while "
          f"checking: " + json.dumps(launch_counts(K)))
    return worst


def _warm_slice1(ops, device, gen) -> None:
    for m, n, k in WARM_MM:
        ops.matmul(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, n, generator=gen, device=device))
    for m, k in WARM_MV:
        ops.matvec(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, generator=gen, device=device))


def _warm_slice2(ops, device, gen) -> None:
    for m, n, k in WARM_MM_DAG:
        ops.matmul(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, n, generator=gen, device=device))
    for m, n, r in WARM_MC:
        ops.conv2d(torch.randn(m, n, generator=gen, device=device),
                   torch.randn(r, r, generator=gen, device=device))
    for m, n, r, s in WARM_MP:
        ops.maxpool(torch.randn(m, n, generator=gen, device=device), r=r, s=s)
    for m, n in WARM_BLUR:
        ops.blur(torch.randn(m, n, generator=gen, device=device))


def _warm_slice3(ops, device, gen) -> None:
    for m, n, k in WARM_MM_ATT:
        ops.matmul(torch.randn(m, k, generator=gen, device=device),
                   torch.randn(k, n, generator=gen, device=device))
    for b, s, h, d in WARM_ATT:
        ops.attention(*(torch.randn(b, s, h, d, generator=gen, device=device)
                        for _ in range(3)))


def _attention_op(runs) -> None:
    """The differentiable flash-attention op on attention_block's q/k/v,
    transposed to [B,H,S,D]: without gradients (the no-lse forward kernel)
    and with them (the lse forward, then the dq and dk/dv kernels through
    autograd).  Both forwards are held to the compiled run's attention
    output as the workloads' outputs are; the gradients of sum(sin(o)) to
    autograd through the plain oracle at 1e-4 of their largest magnitude
    above 1."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    built, outs = runs["attention_block"]
    q, k, v = (built.bindings[f"in{i}"].transpose(1, 2).contiguous()
               for i in range(3))
    with torch.no_grad():
        out = fa_ops.attention(q, k, v, causal=True)
    err = _check_outputs("attention op forward",
                         (out.transpose(1, 2),), (outs[0],))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa_ops.attention(*leaves, causal=True)
    err = max(err, _check_outputs("attention op forward with lse",
                                  (out.detach().transpose(1, 2),),
                                  (outs[0],)))
    torch.sin(out).sum().backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sin(fa_ops.attention(*plain, causal=True,
                               use_kernel=False)).sum().backward()
    torch.cuda.synchronize()
    gerr = 0.0
    for name, got, want in zip(("dq", "dk", "dv"), leaves, plain):
        scale = max(1.0, want.grad.abs().max().item())
        torch.testing.assert_close(
            got.grad, want.grad, rtol=FP32_TOL, atol=FP32_TOL * scale,
            msg=lambda x: f"attention op {name}: {x}")
        gerr = max(gerr, (got.grad - want.grad).abs().max().item() / scale)
    print(f"main: attention op on attention_block's q/k/v [B,H,S,D] = "
          f"{list(q.shape)}: forward vs the compiled run {err:.3g} (budget "
          f"{PARITY_TOL}), gradients of sum(sin(o)) vs autograd through the "
          f"plain oracle {gerr:.3g} of max(1, |grad|) (budget {FP32_TOL})")


# (label, hand kernels that must launch, models that must be fitted, eager
# warm-up, workloads driven at ``large``, a check run after them or None)
PATHS = (
    ("slice 1", ("matmul", "matvec"), ("matmul", "matvec"), _warm_slice1,
     ("mlp_block", "decode_microbatch"), None),
    ("slice 2", ("matmul", "conv2d", "maxpool"),
     ("matmul", "conv2d", "maxpool", "blur"), _warm_slice2,
     ("image_pipeline", "mixed_dag"), None),
    ("slice 3", ("matmul", "flash_attention", "flash_attention_fwd",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
     ("matmul", "flash_attention"), _warm_slice3, ("attention_block",),
     _attention_op),
)


def _check_outputs(name, outs, refs) -> float:
    """Each output within PARITY_TOL of its reference: absolute for
    outputs of magnitude up to 1, relative to the output's largest
    magnitude above that.  ``mixed_dag``'s join of six chained 384-deep
    products reaches about 1.8e5, where two correct fp32 summation orders
    already differ by far more than 1e-5 absolute."""
    if len(outs) != len(refs):
        raise RuntimeError(f"{name}: {len(outs)} outputs, {len(refs)} "
                           "references")
    err = 0.0
    for o, r in zip(outs, refs):
        if not torch.isfinite(o).all():
            raise RuntimeError(f"{name}: non-finite output")
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(o, r, rtol=PARITY_TOL,
                                   atol=PARITY_TOL * scale)
        err = max(err, (o - r).abs().max().item() / scale)
    return err


def _device_busy_s(fn) -> float:
    """Seconds the card spends in kernels during one call of ``fn``, from
    the profiler's CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6


def _run_workload(name, disp, device) -> tuple:
    """Trace, compile and run the ``large`` preset twice (the first call
    carries one-off costs such as library plans for new shapes), check
    both runs' outputs, and print the second run's breakdown and the
    card's busy share over a third, profiled run.  Returns the built
    workload and the second run's outputs."""
    from repro_torch.workloads import get_workload

    built = get_workload(name).build("large", registry=disp.registry,
                                     device=device)
    compiled = built.program.compile(devices=disp, bindings=built.bindings)
    refs = built.reference()
    walls = []
    for _ in range(2):
        # the dispatcher's counters cover the last run alone
        disp.reset_stats()
        t0 = time.perf_counter()
        outs = compiled()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        outs = outs if isinstance(outs, tuple) else (outs,)
        err = _check_outputs(name, outs, refs)
    sels = list(disp.selections)
    stats = disp.stats()
    chosen = [f"{t.name}={s.chosen}/{s.mode}/{s.kernel_s * 1e6:.0f}us"
              for t, s in zip(compiled.order, sels)]
    decide = sum(s.overhead_s for s in sels)
    execute = sum(s.kernel_s for s in sels)
    busy = _device_busy_s(compiled)
    print(f"main: {name} large: {len(compiled.order)} nodes, "
          f"predicted makespan {compiled.makespan * 1e3:.3f} ms, "
          f"first run {walls[0] * 1e3:.3f} ms, second run "
          f"{walls[1] * 1e3:.3f} ms (dispatch decisions "
          f"{decide * 1e3:.3f} ms, variant calls to synchronise "
          f"{execute * 1e3:.3f} ms; card busy {busy * 1e3:.3f} ms in a "
          f"profiled run, {100 * busy / walls[1]:.1f}% of the second "
          f"run), max abs err vs reference over max(1, |ref|) {err:.3g} "
          f"(budget {PARITY_TOL})")
    print(f"main: {name} second run, node=variant/mode/call to synchronise: "
          f"{' '.join(chosen)}")
    print(f"main: {name} second run, dispatcher stats(): "
          + json.dumps(stats))
    return built, outs


# the slice-4 path: the card and the host as two devices of one program
EXEC_DEVICES = ("cuda:0", "cpu")
EXEC_WORKLOADS = ("image_pipeline", "mixed_dag")
EXEC_MODES = ("sequential", "async", "adaptive")
# payload sweep of the measured copies, 4 KB to 8 MB: past the workloads'
# 4 MB planes
COPY_SIZES = (1 << 12, 1 << 16, 1 << 20, 1 << 23)


def _cudnn_lock_us(reps: int = 20000) -> float:
    """Microseconds to enter and leave ``kernels.cudnn_fp32`` (the
    process-wide lock around the TF32 flag) with no other holder."""
    from repro_torch.kernels import cudnn_fp32

    t0 = time.perf_counter()
    for _ in range(reps):
        with cudnn_fp32():
            pass
    return (time.perf_counter() - t0) / reps * 1e6


EXEC_RUNS = 4          # timed runs per executor; the first carries set-up


def _exec_mode(name, compiled, mode, outputs, refs) -> dict:
    """Run ``compiled`` under ``mode`` EXEC_RUNS times, hold every run's
    outputs to the references, and print each run's wall time and the
    part of it its online refits took, the predicted makespan, the last run's placements, picks, per-node and
    per-lane times, transfers and steals, and the card's busy share over
    one more, profiled run against the last run's wall time.  Returns
    node -> output of the last run."""
    walls, refits = [], []
    for _ in range(EXEC_RUNS):
        sels = {d: len(disp.selections)
                for d, disp in compiled.dispatchers.items()}
        r0 = _refit_s(compiled)
        t0 = time.perf_counter()
        outs = compiled(_executor=mode)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        refits.append(_refit_s(compiled) - r0)
        by_name = dict(zip(compiled.program.outputs, outs))
        err = _check_outputs(f"{name} {mode}",
                             tuple(by_name[o].cpu() for o in outputs), refs)
    trace = compiled.last_trace
    last = {d: list(disp.selections)[sels[d]:]
            for d, disp in compiled.dispatchers.items()}
    picks = {d: sorted({f"{s.kernel}{list(s.params.values())}={s.chosen}"
                        for s in got}) for d, got in last.items()}
    # where a node's time went: the dispatcher's decision (host Python)
    # and the variant's call up to the card's synchronise
    split = {d: f"decisions {sum(s.overhead_s for s in got) * 1e3:.3f} ms, "
                f"calls to synchronise "
                f"{sum(s.kernel_s for s in got) * 1e3:.3f} ms"
             for d, got in last.items()}
    # and between the nodes: the last run's start to the end of its bind
    # copies, on to its first node, the gaps between consecutive nodes of
    # a lane (a handoff through the executor), and its last node's end to
    # the caller's return
    comp = sorted((e for e in trace.events if e.kind == "compute"),
                  key=lambda e: e.begin_s)
    binds = [e for e in trace.events if e.note == "bind"]
    bound = max((e.end_s for e in binds), default=t0)
    gaps = 0.0
    for lane in {e.device for e in comp}:
        mine = [e for e in comp if e.device == lane]
        gaps += sum(max(0.0, b.begin_s - a.end_s)
                    for a, b in zip(mine, mine[1:]))
    timeline = (f"binds end {(bound - t0) * 1e3:.3f} ms into the run, first "
                f"node {(comp[0].begin_s - bound) * 1e6:.0f} us later, gaps "
                f"between a lane's nodes {gaps * 1e6:.0f} us, caller back "
                f"{(t0 + walls[-1] - max(e.end_s for e in comp)) * 1e6:.0f} "
                f"us after the last node")
    nodes = {e.name: f"{e.device}/{e.dur_s * 1e6:.0f}us"
             for e in trace.by_start() if e.kind == "compute"}
    moved = [e for e in trace.events if e.kind == "transfer"]
    busy = _device_busy_s(lambda: compiled(_executor=mode))
    share = "not measured (the profiler recorded no device activity)" \
        if busy <= 0 else (f"{busy * 1e3:.3f} ms in a profiled run, "
                           f"{100 * busy / walls[-1]:.1f}% of the last run")
    print(f"main: slice 4 {name} {mode}: predicted makespan "
          f"{compiled.makespan * 1e3:.3f} ms; runs "
          + ", ".join(f"{w * 1e3:.3f}" for w in walls)
          + " ms, of which online refits (on lane workers) "
          + ", ".join(f"{r * 1e3:.3f}" for r in refits)
          + f" ms; card busy {share}; max abs err vs reference over "
          f"max(1, |ref|) {err:.3g} (budget {PARITY_TOL})")
    print(f"main: slice 4 {name} {mode} last run: node=lane/time "
          f"{json.dumps(nodes)}; picks {json.dumps(picks)}; transfers "
          + json.dumps({e.name: f"{e.dur_s * 1e6:.0f}us" for e in moved})
          + f"; steals {[e.note for e in trace.steals()]}; busy per lane "
          + json.dumps({d: f"{trace.busy_s(d) * 1e3:.3f}ms"
                        for d in trace.devices()})
          + f"; per dispatcher {json.dumps(split)}; {timeline}")
    return by_name


def _refit_s(compiled) -> float:
    """Wall seconds the compiled program's online refiners have spent in
    refits so far."""
    return sum(sum(r.refit_s.values()) for r in compiled.refiners.values())


def _card_picks(disp, start: int) -> dict:
    """kernel -> variant -> dispatches on ``disp`` since its selection
    ``start``."""
    sels = list(disp.selections)
    if len(sels) == disp.selections.maxlen:
        raise RuntimeError("the selection log is full: picks since the "
                           "counters were zeroed cannot be tallied")
    tally: dict = {}
    for s in sels[start:]:
        per = tally.setdefault(s.kernel, {})
        per[s.chosen] = per.get(s.chosen, 0) + 1
    return tally


def _thread_cost(device) -> None:
    """Microseconds of one call, best of five, on the calling thread and
    on a thread started for the call (as an executor run without a lane
    pool starts its workers), for a cuDNN convolution, a cuBLAS product and
    a hand kernel at the workloads' shapes; then each call once on a
    compiled program's kind of lane worker (``exec.LanePool``, the card
    bound at its start) in the pool's first run and in its second."""
    import threading

    import torch.nn.functional as F

    from repro_torch.api.compile_ import _bind_lane_device
    from repro_torch.exec import LanePool
    from repro_torch.kernels import cudnn_fp32
    from repro_torch.kernels.conv2d import conv2d as mc

    gen = torch.Generator(device=device).manual_seed(4)
    a = torch.rand(1024, 1024, generator=gen, device=device)
    w = torch.rand(3, 3, generator=gen, device=device)
    b = torch.rand(384, 384, generator=gen, device=device)

    def conv():
        with cudnn_fp32():
            F.conv2d(a[None, None], w[None, None])
        torch.cuda.synchronize()

    calls = {"cudnn conv [1024,1024] r=3": conv,
             "cublas matmul 384^3": lambda: (b @ b, torch.cuda.synchronize()),
             "hand conv2d [1024,1024] r=3": lambda: (
                 mc.conv2d(a, w), torch.cuda.synchronize())}

    def timed(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    out = {}
    for label, fn in calls.items():
        fn()
        here = min(timed(fn) for _ in range(5))
        fresh = []
        for _ in range(5):
            box = []
            t = threading.Thread(target=lambda: box.append(timed(fn)))
            t.start()
            t.join()
            fresh.append(box[0])
        out[label] = f"{here * 1e6:.1f} / {min(fresh) * 1e6:.1f}"
    print("main: slice 4 one call, us on the calling thread / on a fresh "
          "thread: " + json.dumps(out))
    def loop():                 # host Python alone, no library call
        total = 0
        for i in range(20000):
            total += i
        return total

    calls["python loop of 20000 adds"] = loop
    here = min(timed(loop) for _ in range(5))
    pooled = {}
    for label, fn in calls.items():
        pool = LanePool(init=_bind_lane_device)
        lane = str(device)
        pool.reserve([(lane, 0)])
        runs = []
        for reps in (1, 5):     # the pool's first run, then its second
            box = []
            job = pool.submit((lane, 0), lambda: box.extend(
                timed(fn) for _ in range(reps)))
            job.done.wait()
            if job.error is not None:
                raise job.error
            runs.append(min(box))
        pool.close()
        pooled[label] = f"{runs[0] * 1e6:.1f} / {runs[1] * 1e6:.1f}"
    print("main: slice 4 one call, us on a lane-pool worker in its first "
          "run / in its second run (best of five): " + json.dumps(pooled)
          + f"; the python loop on the calling thread {here * 1e6:.1f} us")


CONTENTION_CHAIN = 100    # dispatched card matmuls in one timed chain
CONTENTION_HOST = 10      # host matmuls in one timed run
CONTENTION_ROUNDS = 5     # rounds per measurement; the median is printed
CONTENTION_WINDOW = 0.05  # seconds of a timed run of the other host work
# the cpu lane's work in the probe of fault 1's cause, in turns: today's
# 384^3 matmuls; a pure-Python loop holding the interpreter lock; a copy
# of 256 MB that releases the lock and loads the memory bus; sin over a
# [512, 512] plane (2 MB in and out, cache-resident) that releases the
# lock and leaves the bus idle
CONTENTION_WORK = ("matmul", "python", "copy", "cache")


def _lane_threads(threads: int) -> dict:
    """What ``torch.set_num_threads(threads)`` on a lane worker changes:
    the worker's own count, the calling thread's, and a thread started
    after it (which takes the process default)."""
    import threading

    from repro_torch.exec import LanePool

    default = torch.get_num_threads()
    pool = LanePool(init=lambda lane: torch.set_num_threads(threads))
    pool.reserve([("cpu", 0)])
    box = []
    job = pool.submit(("cpu", 0), lambda: box.append(torch.get_num_threads()))
    job.done.wait()
    pool.close()
    fresh = []
    t = threading.Thread(target=lambda: fresh.append(torch.get_num_threads()))
    t.start()
    t.join()
    torch.set_num_threads(default)     # the process default back
    return {"worker": box[0], "caller": torch.get_num_threads(),
            "later thread": fresh[0], "default": default}


def contention_probe(card, host, device, waits=("spin", "yield"),
                     thread_counts=None, works=("matmul",)) -> dict:
    """Fault 1's fixed probe, independent of placement: a ``LanePool`` with
    a ``cuda:0`` lane and a ``cpu`` lane; the cpu lane runs 384^3 fp32
    matmuls through the host dispatcher ``host`` (mixed_dag's products)
    while the card lane runs a chain of 384^3 card matmuls dispatched
    through ``card``, each followed by the dispatcher's synchronise; each
    side also alone.  Under each wait on the card lane (the spinning
    ``torch.cuda.synchronize``, a yielding blocking event) and each
    intra-op thread count of the cpu lane's worker (by default: the
    process default, 2 fewer, half).  The yielding wait replaces the
    dispatcher's ``synchronize`` for the probe alone.  ``works`` names the
    cpu lane's work (CONTENTION_WORK), each in turn within a round; a work
    other than the matmuls runs for CONTENTION_WINDOW seconds.  Returns
    (wait, threads, work) -> microseconds per op, the median of
    CONTENTION_ROUNDS rounds: card alone, card beside the host, host
    alone, host beside the card."""
    from repro_torch.api.compile_ import _bind_lane_device
    from repro_torch.exec import LanePool

    dispatch = sys.modules["repro_torch.runtime.dispatch"]
    spin = dispatch.synchronize

    def yielding(out):
        """The dispatcher's wait with the core given up: a blocking event
        on the output's stream."""
        if isinstance(out, torch.Tensor) and out.is_cuda:
            done = torch.cuda.Event(blocking=True)
            done.record(torch.cuda.current_stream(out.device))
            done.synchronize()
        return out

    gen = torch.Generator(device=device).manual_seed(5)
    a, b = (torch.rand(384, 384, generator=gen, device=device) - 0.5
            for _ in range(2))
    ha, hb = a.cpu(), b.cpu()
    card.dispatch("matmul", a, b)
    host.dispatch("matmul", ha, hb)

    def per_op(fn, reps) -> float:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6

    def chain():
        return per_op(lambda: card.dispatch("matmul", a, b),
                      CONTENTION_CHAIN)

    def host_mm():
        return per_op(lambda: host.dispatch("matmul", ha, hb),
                      CONTENTION_HOST)

    def windowed(fn) -> float:
        """Microseconds per call of ``fn`` over CONTENTION_WINDOW."""
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < CONTENTION_WINDOW:
            fn()
            n += 1
        return (time.perf_counter() - t0) / n * 1e6

    def python_loop():
        def block():               # 10^4 bytecode additions, lock held
            s = 0
            for i in range(10_000):
                s += i
            return s
        return windowed(block)

    big = small = None
    if "copy" in works:
        big = [torch.empty(1 << 26) for _ in range(2)]       # 256 MB each
        big[0].fill_(1.0)
    if "cache" in works:
        small = [torch.rand(512, 512) for _ in range(2)]
    host_jobs = {"matmul": host_mm, "python": python_loop,
                 "copy": lambda: windowed(lambda: big[1].copy_(big[0])),
                 "cache": lambda: windowed(
                     lambda: torch.sin(small[0], out=small[1]))}

    def run(pool, slots, jobs) -> dict:
        """Each job on its lane's worker, all at once; job -> its result."""
        boxes = {k: [] for k in jobs}
        handles = [pool.submit(slots[k], lambda k=k, f=f:
                               boxes[k].append(f()))
                   for k, f in jobs.items()]
        for h in handles:
            h.done.wait()
            if h.error is not None:
                raise h.error
        return {k: v[0] for k, v in boxes.items()}

    default = torch.get_num_threads()
    slots = {"card": (str(device), 0), "host": ("cpu", 0)}
    results = {}
    if thread_counts is None:
        thread_counts = (default, max(1, default - 2), max(1, default // 2))
    for wait in waits:
        for threads in sorted(set(thread_counts), reverse=True):
            def init(lane, _t=threads):
                _bind_lane_device(lane)
                if lane == "cpu":
                    torch.set_num_threads(_t)
            pool = LanePool(init=init)
            dispatch.synchronize = yielding if wait == "yield" else spin
            try:
                pool.reserve(slots.values())
                rounds = {work: [] for work in works}
                for _ in range(CONTENTION_ROUNDS):
                    for work in works:
                        job = host_jobs[work]
                        alone = {**run(pool, slots, {"card": chain}),
                                 **run(pool, slots, {"host": job})}
                        both = run(pool, slots, {"card": chain, "host": job})
                        rounds[work].append((alone["card"], both["card"],
                                             alone["host"], both["host"]))
            finally:
                dispatch.synchronize = spin
                pool.close()
                torch.set_num_threads(default)   # the process default back
            for work, rs in rounds.items():
                results[(wait, threads, work)] = tuple(
                    sorted(r[i] for r in rs)[len(rs) // 2] for i in range(4))
    return results


def _print_contention(card, host, device) -> None:
    print("main: slice 4 intra-op threads set on a lane worker: "
          + json.dumps(_lane_threads(2)))
    results = contention_probe(card, host, device)
    for (wait, threads, _), (ca, cb, ha, hb) in results.items():
        print(f"main: slice 4 lane contention probe, card lane {wait}, cpu "
              f"lane {threads} threads: card 384^3 dispatch alone {ca:.1f} "
              f"us, beside the host matmul {cb:.1f} us ({cb / ca:.2f}x); "
              f"host 384^3 matmul alone {ha:.1f} us, beside the card chain "
              f"{hb:.1f} us ({hb / ha:.2f}x)")
    # fault 1's cause: the same probe with the cpu lane's work in turns,
    # on every core and on one (core contention would fade on one)
    what = {"matmul": "384^3 matmul", "python": "python loop of 10^4 adds",
            "copy": "256 MB copy", "cache": "sin over [512,512]"}
    for (_, threads, work), (ca, cb, ha, hb) in contention_probe(
            card, host, device, waits=("spin",),
            thread_counts=(torch.get_num_threads(), 1),
            works=CONTENTION_WORK).items():
        print(f"main: slice 4 contention by cpu-lane work, {work} "
              f"({what[work]}, {threads} threads): card 384^3 dispatch "
              f"alone {ca:.1f} us, beside it {cb:.1f} us ({cb / ca:.2f}x); "
              f"the host op alone {ha:.1f} us, beside the card chain "
              f"{hb:.1f} us ({hb / ha:.2f}x)")


OMP_CHILDREN = ("default", "PASSIVE", "PASSIVE", "default")   # in turns


def _slice4_dispatchers(root) -> dict:
    """Slice 4's dispatchers over the tuning caches it wrote under
    ``root`` (fitted at its warm-up, so they start warm)."""
    from repro_torch.runtime import (Dispatcher, TuningCache,
                                     current_fingerprint, default_registry)

    return {name: Dispatcher(default_registry(), TuningCache(
        str(Path(root) / f"slice_4_{name.replace(':', '')}"),
        current_fingerprint("cpu" if name == "cpu" else "cuda")))
        for name in EXEC_DEVICES}


def contention_child(root) -> int:
    """One process's contention probe at today's settings (the spinning
    wait, the default intra-op thread count) over slice 4's caches under
    ``root``; prints the OpenMP wait policy it ran under, the parallel
    back end and the probe's four medians as a JSON line."""
    import os

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    disps = _slice4_dispatchers(root)
    threads = torch.get_num_threads()
    (ca, cb, ha, hb), = contention_probe(
        disps["cuda:0"], disps["cpu"], device, waits=("spin",),
        thread_counts=(threads,)).values()
    backend = [ln.strip() for ln in torch.__config__.parallel_info()
               .splitlines() if "OpenMP" in ln or "backend" in ln]
    print(json.dumps({"OMP_WAIT_POLICY": os.environ.get("OMP_WAIT_POLICY",
                                                        "unset"),
                      "threads": threads, "parallel": backend,
                      "card_alone_us": ca, "card_beside_us": cb,
                      "host_alone_us": ha, "host_beside_us": hb}))
    return 0


def _omp_wait_probe(root, card: str) -> None:
    """Fault 1's untried hypothesis, the OpenMP team spinning after a CPU
    matmul: the contention probe in child processes, in turns with the
    OpenMP runtime's default wait policy and with
    ``OMP_WAIT_POLICY=PASSIVE`` (read when the runtime starts, hence a
    process each).  The port's defaults are left as they are."""
    import os

    for policy in OMP_CHILDREN:
        env = {k: v for k, v in os.environ.items() if k != "OMP_WAIT_POLICY"}
        if policy != "default":
            env["OMP_WAIT_POLICY"] = policy
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                              "--contention-child", str(root)], env=env,
                             capture_output=True, text=True, timeout=300)
        if out.returncode:
            raise RuntimeError(f"contention child ({policy}) exited "
                               f"{out.returncode}: {out.stderr[-2000:]}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"main: slice 4 contention probe in a child process, "
              f"OMP_WAIT_POLICY={r['OMP_WAIT_POLICY']} "
              f"({time.perf_counter() - t0:.1f} s; cpu lane "
              f"{r['threads']} threads; {'; '.join(r['parallel'])}): card "
              f"384^3 dispatch alone {r['card_alone_us']:.1f} us, beside "
              f"the host matmul {r['card_beside_us']:.1f} us "
              f"({r['card_beside_us'] / r['card_alone_us']:.2f}x); host "
              f"384^3 matmul alone {r['host_alone_us']:.1f} us, beside the "
              f"card chain {r['host_beside_us']:.1f} us "
              f"({r['host_beside_us'] / r['host_alone_us']:.2f}x); {card}")


def _slice4(K, device, root, fp) -> tuple:
    """The exec path over the card and the host.  Returns path label ->
    launch counts, for the compiled runs and for the blur kernels on their
    planes, the card dispatcher's picks in the compiled runs, and the
    path's dispatchers and comm model."""
    from repro_torch.api import Program, ops, use_dispatcher
    from repro_torch.exec import (CommModel, StealPolicy, copy_to_dst,
                                  measure_copies)
    from repro_torch.kernels.blur import ops as blur_ops
    from repro_torch.runtime import TuningCache
    from repro_torch.workloads import get_workload

    disps = _slice4_dispatchers(root)
    t0 = time.perf_counter()
    for name, disp in disps.items():
        dev = torch.device(name)
        gen = torch.Generator(device=dev).manual_seed(3)
        with use_dispatcher(disp):
            _warm_slice2(ops, dev, gen)
        print(f"main: slice 4 {name} dispatcher "
              f"({disp.cache.fingerprint.key}): "
              f"{disp.n_measured} measured, {disp.n_gated} gated, "
              f"{disp.n_predicted} predicted")
    comm = CommModel(TuningCache(str(Path(root) / "slice_4_comm"), fp))
    pairs = [(a, b) for a in EXEC_DEVICES for b in EXEC_DEVICES if a != b]
    measure_copies(comm, pairs, sizes=COPY_SIZES)
    print(f"main: slice 4 warm-up and copy measurement "
          f"{time.perf_counter() - t0:.2f} s; predicted copies: " + ", ".join(
              f"{a}->{b} {nb >> 10} KB {comm.predict(a, b, nb) * 1e6:.0f}us"
              for a, b in pairs for nb in (4 * 384 * 384, 4 * 1024 * 1024)))
    print(f"main: slice 4 cudnn_fp32 block entered and left in "
          f"{_cudnn_lock_us():.3f} us with no other holder")
    _thread_cost(device)
    _print_contention(disps["cuda:0"], disps["cpu"], device)
    for disp in disps.values():          # the probe's dispatches
        disp.reset_stats()
    work = {}
    for name in EXEC_WORKLOADS:
        built = get_workload(name).build("large", registry=disps["cpu"]
                                         .registry, device="cpu")
        p = built.program
        # every node an output, so each node's value can be read back
        every = Program(p.inputs, p.nodes, tuple(n.name for n in p.nodes))
        compiled = every.compile(devices=disps, bindings=built.bindings,
                                 comm=comm, transfer=copy_to_dst,
                                 steal=StealPolicy(), online=True)
        print(f"main: slice 4 {name} large planned on "
              + json.dumps({n: compiled.device_of(n)
                            for n in compiled.assignments})
              + "; planned transfers "
              + json.dumps({t.name: t.nbytes for t in compiled.transfers}))
        work[name] = (built, compiled, built.reference())
    # the counted window: the compiled runs and nothing else
    card = disps[EXEC_DEVICES[0]]
    zero_counts(K)
    start = len(card.selections)
    runs = {name: {mode: _exec_mode(name, compiled, mode,
                                    built.program.outputs, refs)
                   for mode in EXEC_MODES}
            for name, (built, compiled, refs) in work.items()}
    counts = {"slice 4": launch_counts(K)}
    picks = _card_picks(card, start)
    planes = {}
    for name, (built, _, _) in work.items():
        seq = runs[name]["sequential"]
        if any(not torch.equal(runs[name]["async"][n], seq[n]) for n in seq):
            raise RuntimeError(f"{name}: async outputs differ from the "
                               "sequential run's")
        same = all(torch.equal(runs[name]["adaptive"][n], seq[n])
                   for n in seq)
        print(f"main: slice 4 {name}: async equals sequential bit for bit; "
              "adaptive " + ("equals it too" if same else
                             "differs from it within the budget above"))
        node = next(n for n in built.program.nodes if n.kernel == "blur")
        src = node.deps[0]
        plane = built.bindings[src] if src in built.bindings else seq[src]
        planes[name] = (plane.to(device), seq[node.name].to(device))
    for _, compiled, _ in work.values():
        compiled.close()
    zero_counts(K)
    for name, (plane, want) in planes.items():
        errs = {}
        for bm, bn in K["blur"].SCHEDULES:
            for separable in (False, True):
                got = blur_ops.blur(plane, bm=bm, bn=bn, separable=separable,
                                    use_kernel=True)
                torch.cuda.synchronize()
                errs[f"t{bm} separable={separable}"] = _check_outputs(
                    f"{name} blur kernel tile {bm} separable={separable}",
                    (got,), (want,))
        print(f"main: slice 4 blur kernels on {name}'s blur plane "
              f"{list(plane.shape)} vs the blur node's output, max abs err "
              f"over max(1, |out|): " + json.dumps(errs))
    counts["slice 4 blur"] = launch_counts(K)
    return counts, picks, {"disps": disps, "comm": comm}


# the obs path: telemetry, the memory ledger and explain on the slice-2
# dispatcher (one device) and on slice 4's pair (two)
OBS_WORKLOADS = ("image_pipeline", "mixed_dag")
OBS_RUNS = 5            # sequential calls with telemetry, one device
OBS_PAIRS = 5           # interleaved calls without and with telemetry
OBS_BOUND = 1.25        # async ledger peak vs predicted, both ways
HAND = ("matmul", "conv2d", "maxpool")   # kernels with pallas_* variants


def _hand_launches(label, K, disp) -> dict:
    """Hold each HAND kernel's launches since the counters were zeroed to
    the dispatches of ``disp`` (stats reset at the same moment) that chose
    its hand variant.  Returns the launch counts."""
    picks = _card_picks(disp, 0)
    want = {k: sum(n for v, n in picks.get(k, {}).items()
                   if v.startswith("pallas_")) for k in HAND}
    counts = launch_counts(K)
    got = {k: counts[k] for k in HAND}
    print(f"obs: {label}: hand-kernel launches {json.dumps(got)}, hand "
          f"picks {json.dumps(want)}")
    if got != want:
        raise RuntimeError(f"{label}: launches {got} differ from the hand "
                           f"picks {want}")
    return counts


def _print_telemetry(label, tel, card) -> None:
    s = tel.summary()
    decisions = {k: v for k, v in s["counters"].items()
                 if k.startswith(("dispatch.", "gate."))}
    hists = {n: f"p50 {h['p50'] * 1e6:.1f} us, p99 {h['p99'] * 1e6:.1f} "
                f"us, n {h['count']}"
             for n, h in s["histograms"].items() if h["count"]
             and (n == "dispatch.overhead_s" or n.startswith("kernel."))}
    drift = {k: f"live MAPE {d['live_mape_pct']:.1f}%, band "
                f"{d['fit_band_pct']:.1f}%, n {d['n']}, flagged {d['flagged']}"
             for k, d in s["drift"].items()}
    spans = [f"{e['args']['executor']} predicted "
             f"{e['args']['predicted_s'] * 1e3:.3f} ms, realized "
             f"{e['args']['realized_s'] * 1e3:.3f} ms, APE "
             f"{e['args']['ape_pct']:.0f}%" for e in tel.events("makespan")]
    print(f"obs: {label} telemetry: counters {json.dumps(decisions)}; "
          f"{json.dumps(hists)}; drift {json.dumps(drift)}; dispatch share "
          f"of dispatch+kernel time "
          f"{100 * s['overhead'].get('dispatch_frac', 0.0):.1f}%; {card}")
    print(f"obs: {label} makespan instants: {'; '.join(spans)}; {card}")


def _print_explain(label, doc, trace, card) -> None:
    span = doc["makespan_s"]
    groups: dict = {}
    for bucket, v in doc["buckets"].items():
        groups[bucket.split(".")[0]] = groups.get(bucket.split(".")[0], 0.0) \
            + v
    path = " -> ".join(f"{r['task']}@{r['lane']}({r['run_s'] * 1e6:.0f}"
                       f"+{(r['queue_s'] + r['overhead_s']) * 1e6:.0f}us)"
                       for r in doc["critical_path"])
    # bind copies run before the first node and are no node's dependency:
    # the chain head's wait, so overhead.dispatch, holds them
    binds = [e for e in trace.events if e.note == "bind"]
    if binds:
        path += (f"; {len(binds)} bind copies "
                 f"{(max(e.end_s for e in binds) - trace.t0) * 1e6:.0f} us "
                 "from the call's start (in overhead.dispatch)")
    print(f"obs: {label} explain: makespan {span * 1e3:.3f} ms (trace wall "
          f"{trace.wall_s * 1e3:.3f} ms), buckets sum "
          f"{doc['bucket_total_s'] * 1e3:.3f} ms (residual "
          f"{100 * doc['residual_frac']:.4f}%); "
          + json.dumps({g: f"{v * 1e6:.0f} us ({100 * v / span:.1f}%)"
                        for g, v in groups.items()})
          + "; by bucket "
          + json.dumps({b: f"{v * 1e6:.0f} us"
                        for b, v in doc["buckets"].items()})
          + f"; critical path (run + wait) {path}; {card}")


def _same_analysis(label, live, saved) -> None:
    """The saved Chrome document's analysis against the live one: the same
    critical path, the same buckets to a nanosecond (Chrome keeps
    microseconds as floats)."""
    if [r["task"] for r in saved["critical_path"]] \
            != [r["task"] for r in live["critical_path"]]:
        raise RuntimeError(f"{label}: the saved trace's critical path "
                           "differs from the live one's")
    if set(saved["buckets"]) != set(live["buckets"]) or any(
            abs(saved["buckets"][b] - v) > 1e-9
            for b, v in live["buckets"].items()):
        raise RuntimeError(f"{label}: the saved trace's buckets differ from "
                           "the live ones")


def _obs_one_device(K, disp, device, card) -> dict:
    """``image_pipeline`` and ``mixed_dag`` large on the warm slice-2
    dispatcher, compiled with a fresh ``Telemetry``, OBS_RUNS sequential
    calls each.  Returns workload -> launch counts of its calls."""
    from repro_torch.exec import ExecutionTrace
    from repro_torch.obs import Telemetry, analyze_chrome
    from repro_torch.workloads import get_workload

    counts = {}
    for name in OBS_WORKLOADS:
        built = get_workload(name).build("large", registry=disp.registry,
                                         device=device)
        refs = built.reference()
        tel = Telemetry(run_id=f"obs-{name}")
        traced = built.program.compile(devices=disp, bindings=built.bindings,
                                       telemetry=tel)
        disp.telemetry = None       # on for the traced program's calls only
        plain = built.program.compile(devices=disp, bindings=built.bindings)
        torch.cuda.synchronize()
        disp.reset_stats()
        zero_counts(K)
        disp.telemetry = tel
        rows = []
        for _ in range(OBS_RUNS):
            before = torch.cuda.memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
            outs = traced()
            torch.cuda.synchronize()
            top = torch.cuda.max_memory_allocated(device)
            outs = outs if isinstance(outs, tuple) else (outs,)
            err = _check_outputs(f"obs {name}", outs, refs)
            peak = traced.last_memory.peak_bytes()
            rows.append(f"ledger {json.dumps(peak)}, allocator peak {top} B "
                        f"({top - before} B above the call's start)")
            if peak != traced.predicted_peak_bytes:
                raise RuntimeError(
                    f"obs {name}: sequential ledger peak {peak} differs from "
                    f"the predicted {traced.predicted_peak_bytes}")
        disp.telemetry = None
        counts[name] = _hand_launches(f"one device {name}", K, disp)
        live = traced.explain()
        if abs(live["bucket_total_s"] - live["makespan_s"]) \
                > 0.01 * live["makespan_s"]:
            raise RuntimeError(f"obs {name}: explain's buckets sum to "
                               f"{live['bucket_total_s']} s of a "
                               f"{live['makespan_s']} s makespan")
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            traced.last_trace.save_chrome(str(path), telemetry=tel)
            doc = json.loads(path.read_text())
        back = ExecutionTrace.from_chrome(doc)
        _same_analysis(f"obs {name}", live, analyze_chrome(doc))
        tracks = sum(1 for e in doc["traceEvents"] if e["ph"] == "C")
        print(f"obs: one device {name} large, {OBS_RUNS} sequential calls: "
              f"max abs err vs reference over max(1, |ref|) {err:.3g} "
              f"(budget {PARITY_TOL}); predicted peak "
              f"{json.dumps(traced.predicted_peak_bytes)} B, per call "
              + "; ".join(rows) + f"; the Chrome round trip ({len(back.events)}"
              f" events, {tracks} counter points) gives the live critical "
              f"path and buckets; {card}")
        _print_telemetry(f"one device {name}", tel, card)
        _print_explain(f"one device {name}", live, traced.last_trace, card)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        if any(not torch.equal(o, w) for o, w in zip(outs, want)):
            raise RuntimeError(f"obs {name}: outputs with telemetry differ "
                               "from the program compiled without it")
        share = {"without": [], "with": []}
        for _ in range(OBS_PAIRS):
            for key, prog, t in (("without", plain, None),
                                 ("with", traced, tel)):
                disp.telemetry = t
                disp.reset_stats()
                prog()
                torch.cuda.synchronize()
                share[key].append(disp.stats().get("steady_overhead_pct",
                                                   float("nan")))
        disp.telemetry = None
        print(f"obs: one device {name}: outputs with telemetry equal those "
              f"without bit for bit; steady_overhead_pct in turns, without "
              f"telemetry " + ", ".join(f"{v:.1f}" for v in share["without"])
              + "; with " + ", ".join(f"{v:.1f}" for v in share["with"])
              + f" (information only); {card}")
    return counts


def _obs_two_devices(K, ctx, card) -> dict:
    """``mixed_dag`` large over slice 4's ``cuda:0`` + ``cpu`` pair under the
    async executor with a fresh ``Telemetry``: lane utilisation, queue and
    transfer waits and explain's buckets (the attribution of fault 1), the
    ledger peaks within OBS_BOUND of predicted, then one sequential call
    for comparison.  Returns the async calls' launch counts."""
    from repro_torch.exec import copy_to_dst
    from repro_torch.obs import Telemetry
    from repro_torch.workloads import get_workload

    disps, comm = ctx["disps"], ctx["comm"]
    card_disp = disps["cuda:0"]
    built = get_workload("mixed_dag").build(
        "large", registry=disps["cpu"].registry, device="cpu")
    refs = built.reference()
    tel = Telemetry(run_id="obs-mixed_dag-two-devices")
    compiled = built.program.compile(devices=disps, bindings=built.bindings,
                                     comm=comm, transfer=copy_to_dst,
                                     executor="async", telemetry=tel)
    walls, peaks = [], []
    try:
        for disp in disps.values():
            disp.reset_stats()
        zero_counts(K)
        for _ in range(EXEC_RUNS):
            t0 = time.perf_counter()
            outs = compiled()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            outs = outs if isinstance(outs, tuple) else (outs,)
            err = _check_outputs("obs two devices mixed_dag async",
                                 tuple(o.cpu() for o in outs), refs)
            peak = compiled.last_memory.peak_bytes()
            peaks.append(peak)
            for dev, got in peak.items():
                want = compiled.predicted_peak_bytes[dev]
                if not want / OBS_BOUND <= got <= OBS_BOUND * want:
                    raise RuntimeError(
                        f"obs two devices: async ledger peak on {dev} {got} "
                        f"B is outside {OBS_BOUND}x of the predicted {want}")
        counts = _hand_launches("two devices mixed_dag async", K, card_disp)
        doc = compiled.explain()
        trace = compiled.last_trace
        hists = tel.summary()["histograms"]
        waits = {n: f"p50 {h['p50'] * 1e6:.0f} us, p99 "
                    f"{h['p99'] * 1e6:.0f} us, n {h['count']}"
                 for n, h in hists.items()
                 if n.startswith(("exec.transfer_wait_s", "exec.task_wait_s"))
                 and h["count"]}
        depth = {n.removeprefix("exec.queue_depth."):
                 max(v for _, v in tel.series(n))
                 for n in tel.series_names()
                 if n.startswith("exec.queue_depth.")}
        lanes = {lane: f"{u['n_tasks']} tasks, busy {100 * u['busy_frac']:.1f}"
                       f"%, wait {100 * u['wait_frac']:.1f}%, idle "
                       f"{100 * u['idle_frac']:.1f}%"
                 for lane, u in doc["lanes"].items()}
        nodes = {e.name: f"{e.device}/{e.dur_s * 1e6:.0f}us"
                 for e in trace.by_start() if e.kind == "compute"}
        on_cpu = [n for n in compiled.assignments
                  if compiled.device_of(n) == "cpu"]
        print(f"obs: two devices mixed_dag large planned with "
              f"{len(on_cpu)} of {len(compiled.assignments)} nodes on cpu "
              f"{on_cpu}, {len(compiled.transfers)} planned transfers; "
              f"{card}")
        print(f"obs: two devices mixed_dag large async, {EXEC_RUNS} calls: "
              f"walls " + ", ".join(f"{w * 1e3:.3f}" for w in walls)
              + f" ms; max abs err vs reference over max(1, |ref|) {err:.3g}"
              f" (budget {PARITY_TOL}); ledger peaks per call "
              + json.dumps(peaks) + " B against predicted "
              + json.dumps(compiled.predicted_peak_bytes)
              + f" B (bound {OBS_BOUND}x); {card}")
        print(f"obs: two devices async last call: lanes {json.dumps(lanes)}; "
              f"max queue depth {json.dumps(depth)}; waits "
              f"{json.dumps(waits)}; node=lane/time {json.dumps(nodes)}; "
              f"{card}")
        _print_telemetry("two devices", tel, card)
        _print_explain("two devices async", doc, trace, card)
        t0 = time.perf_counter()
        compiled(_executor="sequential")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = compiled.last_memory.peak_bytes()
        if peak != compiled.predicted_peak_bytes:
            raise RuntimeError(f"obs two devices: sequential ledger peak "
                               f"{peak} differs from the predicted "
                               f"{compiled.predicted_peak_bytes}")
        print(f"obs: two devices sequential call for comparison: wall "
              f"{wall * 1e3:.3f} ms, ledger peak equal to predicted; {card}")
        _print_explain("two devices sequential", compiled.explain(),
                       compiled.last_trace, card)
    finally:
        compiled.close()
        for disp in disps.values():
            disp.telemetry = None
        comm.telemetry = None
    return counts


def phase_main_path(K, device) -> dict:
    """Each path through its own dispatcher over a fresh cache, then the
    obs path over the slice-2 and slice-4 dispatchers; returns path label
    -> kernel -> launches in that path's run."""
    from repro_torch.api import ops, use_dispatcher
    from repro_torch.runtime import (Dispatcher, TuningCache,
                                     current_fingerprint, default_registry)

    gen = torch.Generator(device=device).manual_seed(1)
    by_path = {}
    disps = {}
    card = card_line()
    with tempfile.TemporaryDirectory() as root:
        fp = current_fingerprint("cuda")
        print(f"main: fingerprint {fp.key}")
        for label, hand, fitted, warm, workloads, after in PATHS:
            cache_dir = str(Path(root) / label.replace(" ", "_"))
            disp = disps[label] = Dispatcher(default_registry(),
                                             TuningCache(cache_dir, fp))
            zero_counts(K)
            t0 = time.perf_counter()
            with use_dispatcher(disp):
                warm(ops, device, gen)
            print(f"main: {label} eager warm-up "
                  f"{time.perf_counter() - t0:.2f} s, {disp.n_measured} "
                  f"measured, {disp.n_gated} gated, {disp.n_predicted} "
                  f"predicted")
            for s in list(disp.selections):
                if s.measured_s:
                    times = ", ".join(f"{v} {t * 1e6:.1f} us"
                                      for v, t in s.measured_s.items())
                    print(f"main: {s.mode} {s.kernel} {s.params}: {times}")
            for kernel in fitted:
                entry = disp.cache.entry(kernel)
                if entry.model is None:
                    raise RuntimeError(f"no model fitted for {kernel}")
                print(f"main: {kernel} model fitted on {entry.n_rows} rows, "
                      f"fit MAPE {entry.fit_mape:.1f}%")
            runs = {name: _run_workload(name, disp, device)
                    for name in workloads}
            if after is not None:
                after(runs)
            counts = launch_counts(K)
            print(f"main: {label} hand-kernel launches: {counts}")
            for kernel in hand:
                if counts[kernel] <= 0:
                    raise RuntimeError(f"{kernel}: the {label} path never "
                                       "launched its hand kernel")
            by_path[label] = counts
        counts, picks, ctx = _slice4(K, device, root, fp)
        by_path.update(counts)
        _omp_wait_probe(root, card)
        for name, c in _obs_one_device(K, disps["slice 2"], device,
                                       card).items():
            by_path[f"obs {name}"] = c
        by_path["obs two devices"] = _obs_two_devices(K, ctx, card)
        # the predictor may pick only library variants on one workload
        # (the card's picks after slice 4's refits, say), not on all
        if not any(c[k] for label, c in by_path.items()
                   if label.startswith("obs ") for k in HAND):
            raise RuntimeError("the obs path launched no hand kernel")
    # on the exec path the card's dispatcher decides which kernels run: a
    # pick of a hand variant (pallas_*) launches its kernel at least once,
    # a pick of a library variant launches none of the hand kernels
    need = {k: sum(n for v, n in per.items() if v.startswith("pallas_"))
            for k, per in picks.items() if k in by_path["slice 4"]}
    print(f"main: slice 4 picks on cuda:0 in the compiled runs "
          f"(kernel -> variant -> dispatches): {json.dumps(picks)}")
    for label, want in (("slice 4", need),
                        ("slice 4 blur", dict.fromkeys(
                            ("blur_direct", "blur_h", "blur_v"), 1))):
        print(f"main: {label} hand-kernel launches: {by_path[label]}")
        for kernel, n in want.items():
            if by_path[label][kernel] < n:
                raise RuntimeError(
                    f"{kernel}: the {label} path launched its hand kernel "
                    f"{by_path[label][kernel]} times for {n} picks")
    return by_path


BENCH_HAND = ("matmul", "matvec", "conv2d", "maxpool")   # dispatch-path
#   hand kernels: each has pallas_* variants in the bench's registry


def _cli(main, argv) -> tuple:
    """``main(argv)`` in process: (exit code, standard output)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _bench_cuda(K, tmp: Path, card: str) -> tuple:
    """``run_bench`` over the five workloads at ``large`` on the ``cuda``
    config.  Returns the document and the launch counts of the run."""
    import repro_torch.bench.harness as harness
    from repro_torch.bench import summarize, validate_bench
    from repro_torch.runtime.cache import CacheEntry

    spent = {"measure": 0.0, "fit": 0.0, "fits": 0}
    per_workload, picks = {}, {}
    measure, fit, run_workload = (harness.measure_from_programs,
                                  CacheEntry.fit, harness._run_workload)

    def timed_measure(*args, **kw):
        t0 = time.perf_counter()
        try:
            return measure(*args, **kw)
        finally:
            spent["measure"] += time.perf_counter() - t0

    def timed_fit(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return fit(self, *args, **kw)
        finally:
            spent["fit"] += time.perf_counter() - t0
            spent["fits"] += 1

    def counted_workload(name, built, cfg, *args, **kw):
        before = launch_counts(K)
        out = run_workload(name, built, cfg, *args, **kw)
        after = launch_counts(K)
        per_workload[name] = {k: after[k] - before[k] for k in BENCH_HAND}
        # each mode's variant per node (the pinned rule's memoized choice)
        picks[name] = {}
        for mode, devmap in cfg["mode_maps"].items():
            d = devmap["local"]
            names = {n.kernel: d.registry.variant_names(n.kernel)
                     for n in built.program.nodes}
            picks[name][mode] = sorted({
                f"{n.kernel}:"
                f"{names[n.kernel][d._choose(n.kernel, n.params)[0]]}"
                for n in built.program.nodes})
        return out

    harness.measure_from_programs = timed_measure
    harness._run_workload = counted_workload
    CacheEntry.fit = timed_fit
    try:
        zero_counts(K)
        t0 = time.perf_counter()
        doc = harness.run_bench(size="large", configs=("cuda",),
                                adaptive=False,
                                out_path=str(tmp / "bench.json"),
                                results_dir=str(tmp))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts(K)
    finally:
        harness.measure_from_programs = measure
        harness._run_workload = run_workload
        CacheEntry.fit = fit
    validate_bench(doc)
    for line in summarize(doc):
        print(f"bench: {line}")
    print(f"bench: cuda large: run_bench {wall:.2f} s, of which "
          f"measure_from_programs {spent['measure']:.2f} s (its NN+C fits "
          f"included), {spent['fits']} NN+C fits {spent['fit']:.2f} s; "
          f"{card}")
    for name, w in doc["workloads"].items():
        r = w["configs"]["cuda"]
        walls = r["wall_s"]
        if not all(walls[m] > 0 for m in ("best", "default", "worst")):
            raise RuntimeError(f"bench {name}: a wall is not above 0: "
                               f"{walls}")
        if set(r["mape"]) != set(w["kernels"]):
            raise RuntimeError(f"bench {name}: MAPE for {sorted(r['mape'])}"
                               f", kernels {w['kernels']}")
        att = r["attribution"] or {}
        print(f"bench: {name} cuda large: walls best "
              f"{walls['best'] * 1e3:.3f} ms, default "
              f"{walls['default'] * 1e3:.3f} ms, worst "
              f"{walls['worst'] * 1e3:.3f} ms; speedup vs default "
              f"{r['speedup_vs_default']:.3f}x, vs worst "
              f"{r['speedup_vs_worst']:.3f}x; dispatch_frac "
              f"{r['overhead']['dispatch_frac']:.4f}, executor_frac "
              f"{r['overhead']['executor_frac']:.4f}; MAPE "
              + json.dumps({k: round(v, 2) for k, v in r["mape"].items()})
              + "; attribution buckets "
              + json.dumps({b: f"{v * 1e6:.0f} us"
                            for b, v in att.get("buckets", {}).items()})
              + f" (top {att.get('top_bottleneck')}); hand-kernel launches "
              + json.dumps(per_workload.get(name, {})) + "; variants by mode "
              + json.dumps(picks.get(name, {})) + f"; {card}")
    print("bench: cuda config device MAPE (grid): " + json.dumps(
        {k: f"{m['mape_pct']:.2f}% over {m['n_rows']} rows" for k, m in
         doc["configs"]["cuda"]["device_mape"]["local"].items()}))
    for kernel in BENCH_HAND:
        if counts[kernel] <= 0:
            raise RuntimeError(f"{kernel}: the bench path never launched "
                               "its hand kernel")
    print(f"bench: hand-kernel launches over the run: {json.dumps(counts)}")
    return doc, counts


def _bench_sim(tmp: Path) -> dict:
    """``run_bench`` quick over ``simdev2`` with its adaptive section: the
    reference's structural invariants."""
    from repro_torch.bench import run_bench, summarize

    t0 = time.perf_counter()
    doc = run_bench(quick=True, configs=("simdev2",),
                    out_path=str(tmp / "sim.json"), results_dir=str(tmp))
    wall = time.perf_counter() - t0
    for line in summarize(doc):
        print(f"bench: {line}")
    for name, w in doc["workloads"].items():
        walls = w["configs"]["simdev2"]["wall_s"]
        if not walls["best"] < walls["worst"]:
            raise RuntimeError(f"bench simdev2 {name}: best {walls['best']}"
                               f" s does not beat worst {walls['worst']} s")
    ad = doc["adaptive"]["workloads"]
    if not all(w["bit_exact"] for w in ad.values()):
        raise RuntimeError(f"bench adaptive: bit-exactness lost: {ad}")
    print(f"bench: simdev2 quick with the adaptive section {wall:.2f} s: "
          "best beats worst in every workload, adaptive bit-exact")
    return doc


def _bench_clis(doc, sim, tmp: Path) -> None:
    """The bench and obs CLIs in process over this run's documents."""
    import copy

    from repro_torch.bench.__main__ import main as bench_main
    from repro_torch.obs.report import main as obs_main

    cuda_path, sim_path = str(tmp / "bench.json"), str(tmp / "sim.json")
    rcs = {}
    rcs["compare cuda cuda"] = _cli(bench_main,
                                    ["compare", cuda_path, cuda_path])[0]
    # best walls 2x slower, with the speedups and geomeans they give: a
    # simulated config's speedups are held to the tolerance, a real
    # config's are never thresholded (host noise), so only the sim copy
    # regresses
    for label, src, cfg, want in (("sim", sim, "simdev2", 1),
                                  ("cuda", doc, "cuda", 0)):
        slow = copy.deepcopy(src)
        for w in slow["workloads"].values():
            r = w["configs"][cfg]
            r["wall_s"]["best"] *= 2
            for key, mode in (("speedup_vs_default", "default"),
                              ("speedup_vs_worst", "worst")):
                r[key] = r["wall_s"][mode] / r["wall_s"]["best"]
        for key in ("speedup_vs_default", "speedup_vs_worst"):
            slow["geomean"][cfg][key] /= 2
        path = str(tmp / f"{label}_slow.json")
        Path(path).write_text(json.dumps(slow))
        base = sim_path if label == "sim" else cuda_path
        rc, out = _cli(bench_main, ["compare", base, path])
        rcs[f"compare {label} vs best 2x slower"] = rc
        if rc != want:
            raise RuntimeError(f"bench compare {label} against 2x slower "
                               f"best walls: exit {rc}, want {want}: {out}")
    rcs["history"], out = _cli(bench_main, ["history", cuda_path, sim_path])
    print("bench: " + "\nbench: ".join(out.rstrip().splitlines()))
    ad = sim["adaptive"]
    rcs["obs report"], out = _cli(obs_main, ["report", ad["telemetry_path"],
                                             "--trace", ad["trace_path"]])
    # the real config's cache lies under its device type's name
    cache_root = str(tmp / "bench_devices" / doc["host_fingerprint"]
                     ["backend"].removeprefix("torch-"))
    rcs["obs cards"], out = _cli(obs_main, [
        "cards", "--json", "--root", cache_root, "--telemetry",
        str(tmp / "telemetry_*.json")])
    cards = json.loads(out) if rcs["obs cards"] == 0 else []
    measured = sorted(doc["configs"]["cuda"]["device_mape"]["local"])
    if sorted(c["kernel"] for c in cards) != measured:
        raise RuntimeError(f"obs cards: {[c['kernel'] for c in cards]}, "
                           f"measured kernels {measured}")
    html = tmp / "dashboard.html"
    rcs["obs dashboard"], _ = _cli(obs_main, ["dashboard", "-o", str(html),
                                              "--results-dir", str(tmp)])
    if not html.exists() or html.stat().st_size == 0:
        raise RuntimeError("obs dashboard wrote no page")
    print(f"bench: CLI exit codes {json.dumps(rcs)}; {len(cards)} model "
          f"cards; dashboard {html.stat().st_size} bytes")
    if any(rc != 0 for label, rc in rcs.items()
           if not label.startswith("compare sim")):
        raise RuntimeError(f"bench CLIs: exit codes {rcs}")


def phase_bench(K, card: str) -> dict:
    """The bench layer on the card: ``run_bench`` at ``large`` over the
    ``cuda`` config, ``simdev2`` quick with the adaptive section, then
    the bench and obs CLIs over their documents.  Returns path label ->
    launch counts of the ``cuda`` run."""
    with tempfile.TemporaryDirectory() as tmp:
        doc, counts = _bench_cuda(K, Path(tmp), card)
        sim = _bench_sim(Path(tmp))
        _bench_clis(doc, sim, Path(tmp))
    return {"bench": counts}


# the paper's experiments on the card: the 9 card combos through Tables
# 4-8's protocol, Fig. 4 and the runtime overhead on cuda:0
PAPER_EPOCHS = 4000    # benchmarks/run.py --quick
PAPER_CHECK = 5        # timed instances a card combo holds against the host
PAPER_HOST = {"mm": "blas", "mv": "blas", "mc": "window", "mp": "window"}
# shapes every card variant is held at besides the timed ones: m, n, k at 1
# and 1024, each conv2d r and maxpool (r, s) of Table 2's samplers, on the
# vector (even n) and the staged (odd n) path
PAPER_EDGES = {
    "mm": [{"m": m, "n": n, "k": k} for m, n, k in (
        (1, 1, 1), (1, 1024, 1), (1024, 1, 1024), (1, 1024, 1024),
        (1024, 1024, 1), (1024, 1024, 1024), (333, 517, 1023))],
    "mv": [{"m": m, "n": n} for m, n in (
        (1, 1), (1, 1024), (1024, 1), (1024, 1024), (1023, 517))],
    "mc": [{"m": m, "n": n, "r": r} for r in (3, 5, 7)
           for m, n in ((1024, 1024), (517, 1023), (r, r), (r, 1024))],
    "mp": [{"m": m, "n": n, "r": r, "s": s_} for r in (2, 3, 4, 5)
           for s_ in (1, 2)
           for m, n in ((1024, 1024), (517, 1023), (r, r))],
}


def _hold_card_variant(kernel: str, names, p: dict, ops, device,
                       worst: dict) -> None:
    """The named card variants of ``kernel`` on ``make_inputs``' operands
    ``ops`` against the host numpy variant in fp32, within FP32_TOL
    relative to the output's largest magnitude above 1; the worst error
    of each goes into ``worst``."""
    from repro_torch.perfdata import measure

    host = PAPER_HOST[kernel]
    want = measure.HOST_VARIANTS[kernel][host](
        p, *(None if x is None else x.astype(np.float32) for x in ops))
    args = measure.to_device(*ops, device)
    scale = max(1.0, float(np.abs(want).max()))
    for name in names:
        out = measure.card_call(kernel, name, p, *args).cpu().numpy()
        if out.shape != want.shape:
            raise RuntimeError(f"paper {kernel}|{name}: shape {out.shape} "
                               f"for {want.shape} at {p}")
        err = float(np.abs(out - want).max()) / scale
        if not err <= FP32_TOL:
            raise RuntimeError(f"paper {kernel}|{name}|cuda at {p}: error "
                               f"{err:.3g} over the host {host} variant")
        key = f"{kernel}|{name}|cuda"
        worst[key] = max(worst.get(key, 0.0), err)


def _check_card_variants(combos, X: dict, device) -> tuple:
    """Every card combo's variant on the first PAPER_CHECK instances it
    timed (drawn anew from its own generator, each one's feature row held
    equal to the dataset's), then every card variant at PAPER_EDGES, all
    against the host variant (``_hold_card_variant``).  Returns the worst
    error of each combo key on the timed instances and at the edges."""
    from repro_torch.core.features import KERNELS as SPECS, feature_vector
    from repro_torch.perfdata import datasets, measure

    timed, edges = {}, {}
    for combo in combos:
        rng = datasets.instance_rng(combo, 0)
        for i in range(PAPER_CHECK):
            p = SPECS[combo.kernel].sample(rng)
            if not np.array_equal(feature_vector(combo.kernel, p),
                                  X[combo.key][i]):
                raise RuntimeError(f"paper {combo.key}: instance {i} is not "
                                   "the one that was timed")
            ops = measure.make_inputs(combo.kernel, p, rng)
            _hold_card_variant(combo.kernel, [combo.variant], p, ops, device,
                               timed)
    rng = np.random.RandomState(0)
    for kernel, cases in PAPER_EDGES.items():
        for p in cases:
            ops = measure.make_inputs(kernel, p, rng)
            _hold_card_variant(kernel, measure.card_variants(kernel), p, ops,
                               device, edges)
    return timed, edges


def phase_paper(K, card: str) -> dict:
    """The paper's experiments on the card: each card combo generated at
    500 instances (``tables.run_combo``'s), seed 0, into a temporary
    cache (the launch counters zeroed just before, read just after), then
    the five methods fitted and scored on the held-out half; Table 8's
    rows; each card variant held against the host variant on its timed
    instances and at PAPER_EDGES; Fig. 4 and the runtime overhead on
    cuda:0.  Returns path label -> launch counts of the measurement."""
    from repro_torch.paper import runtime_overhead, tables, variant_selection
    from repro_torch.perfdata import datasets

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cache = str(Path(tmp) / "perfdata")
        combos = datasets.card_combos("cuda")
        measured = {}
        zero_counts(K)
        for combo in combos:
            t0 = time.perf_counter()
            X, y, _ = datasets.generate(combo, n=500, seed=0,
                                        cache_dir=cache)
            measured[combo.key] = (time.perf_counter() - t0, X, y)
        counts = launch_counts(K)
        print(f"paper: card combos measured (500 instances each) in "
              f"{sum(t for t, _, _ in measured.values()):.1f} s; hand-kernel "
              f"launches {json.dumps({k: counts[k] for k in BENCH_HAND})}")
        for kernel in BENCH_HAND:
            if counts[kernel] <= 0:
                raise RuntimeError(f"{kernel}: the paper path never launched "
                                   "its hand kernel")
        results = {}
        for combo in combos:
            t0 = time.perf_counter()
            row = results[combo.key] = tables.run_combo(
                combo, PAPER_EPOCHS, cache_dir=cache)
            fit_s = time.perf_counter() - t0
            mapes = [row[m]["mape"] for m in tables.METHODS]
            if not all(np.isfinite(mapes)):
                raise RuntimeError(f"paper {combo.key}: a MAPE is not "
                                   f"finite: {mapes}")
            if not 0 < row["nnc"]["n_params"] <= 75:
                raise RuntimeError(f"paper {combo.key}: NN+C has "
                                   f"{row['nnc']['n_params']} weights")
            t_meas, _, y = measured[combo.key]
            print(f"paper: {combo.key}: held-out MAE "
                  + ", ".join(f"{m} {row[m]['mae'] * 1e6:.2f} us"
                              for m in tables.METHODS)
                  + "; MAPE " + ", ".join(f"{m} {row[m]['mape']:.1f}%"
                                          for m in tables.METHODS)
                  + f"; NN+C {row['nnc']['n_params']} weights; targets "
                  f"{np.min(y) * 1e6:.1f} / {np.median(y) * 1e6:.1f} / "
                  f"{np.max(y) * 1e6:.1f} us (min / median / max); "
                  f"measured {t_meas:.1f} s, fitted {fit_s:.1f} s; {card}")
        for line in tables.summarize(results):
            if line.strip() and not line.startswith(("--", "combo", "==")) \
                    and "|" not in line:
                print(f"paper: {line.strip()} ({card})")
        timed, edges = _check_card_variants(
            combos, {k: X for k, (_, X, _) in measured.items()},
            torch.device("cuda", 0))
        for what, worst in ((f"its first {PAPER_CHECK} timed instances",
                             timed),
                            (f"{sum(map(len, PAPER_EDGES.values()))} edge "
                             f"shapes (every conv2d r, maxpool (r, s), m, n, "
                             f"k at 1 and 1024, even and odd n)", edges)):
            print(f"paper: each card variant against the host variant on "
                  f"{what}, max abs err over max(1, |out|): " + json.dumps(
                      {k: float(f"{v:.3g}") for k, v in worst.items()}))
        t0 = time.perf_counter()
        vs = variant_selection.run(out_path=str(Path(tmp) / "vs.json"),
                                   device="cuda")
        vs_s = time.perf_counter() - t0
        for size, r in vs["cases"].items():
            if not all(t > 0 for t in r["times"].values()):
                raise RuntimeError(f"paper Fig. 4 {size}: a time is not "
                                   f"above 0: {r['times']}")
        for line in variant_selection.summarize(vs):
            print(f"paper: {line}")
        for size, r in vs["cases"].items():
            print(f"paper: Fig. 4 on cuda:0 {size}: " + ", ".join(
                f"{k} {t * 1e6:.1f} us" for k, t in r["times"].items())
                + f"; {card}")
        print(f"paper: Fig. 4 on cuda:0 in {vs_s:.1f} s")
        t0 = time.perf_counter()
        rt = runtime_overhead.run(quick=True,
                                  out_path=str(Path(tmp) / "rt.json"),
                                  cache_root=str(Path(tmp) / "tunecache"),
                                  device="cuda")
        for line in runtime_overhead.summarize(rt):
            print(f"paper: {line}")
        print(f"paper: runtime overhead on cuda:0 in "
              f"{time.perf_counter() - t0:.1f} s; {card}")
    print(f"paper: phase {time.perf_counter() - t_phase:.1f} s")
    return {"paper": counts}


# the model path: (arch, layers kept or None for all, the planted fault) —
# gemma3-1b uncut and yi-9b at full width cut to 2 of 48 layers (0.87 B
# parameters, 3.5 GB in fp32); a forward over MODEL_SEQ tokens at B = 1
# (train_4k, the batch cut to 1), serving SERVE_BATCH prompts of
# SERVE_PROMPT tokens then SERVE_STEPS greedy decode steps.  The fault is
# given to every kernel launch of one more forward, which MODEL_TOL must
# catch: gemma3-1b's local layers lose their window, yi-9b (no window)
# its causal mask
MODELS = (("gemma3-1b", None, {"window": 0}), ("yi-9b", 2, {"causal": False}))
MODEL_SEQ = 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 2, 2048, 32
# kernel against plain logits (and prefill caches), relative to their
# largest magnitude.  fp32: 3xTF32 products and another summation order
# than attend_chunked's, about 1e-6 a layer, carried through 26 layers, so
# 1e-3 leaves two orders of margin.  bf16: attend_chunked rounds scores and
# probabilities to bf16 (the reference's order) where the kernel keeps
# them in fp32, and an ulp of 2**-9 in one layer's output moves every later
# layer.  Sound bf16 readings on an H100 reach 2.0e-2 (gemma3-1b's prefill
# cache; a 26-layer reduced-width gemma pattern gives up to 2.3e-2 on the
# CPU), the planted faults 1.23-1.27, so 5e-2 lies between
MODEL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def _tree_err(got: dict, want: dict) -> float:
    """The largest _rel_err over the leaves of two trees of one layout."""
    from repro_torch.models import module

    a, b = module.leaves(got), module.leaves(want)
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise RuntimeError("models: two cache trees of different layouts")
    return max(_rel_err(x, y) for x, y in zip(a, b))


def _fa_delta(fa, before: dict) -> dict:
    return {k: fa.LAUNCHES[k] - before[k] for k in fa.LAUNCHES}


def _gate(name, what, err, dtype) -> str:
    if err > MODEL_TOL[dtype]:
        raise RuntimeError(f"models {name} {dtype}: {what} {err:.3g}, "
                           f"above {MODEL_TOL[dtype]}")
    return f"{what} {err:.3g}"


def _model_forward_check(name, model, params, batch, fa, layers,
                         card) -> None:
    """One forward through the kernel (exactly one ``flash_attention``
    launch a layer, no other kernel) and one through the plain
    attend_chunked; the logits within MODEL_TOL of each other."""
    dtype = model.cfg.compute_dtype
    before = dict(fa.LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, aux = model.forward(params, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = _fa_delta(fa, before)
    want_delta = dict.fromkeys(delta, 0)
    want_delta["flash_attention"] = layers
    if delta != want_delta:
        raise RuntimeError(f"models {name} {dtype}: a forward launched "
                           f"{delta}, not {want_delta}")
    want, _ = model.forward(params, batch, use_kernel=False)
    torch.cuda.synchronize()
    if _fa_delta(fa, before) != want_delta:
        raise RuntimeError(f"models {name}: the plain forward launched a "
                           "kernel")
    b, s = batch["tokens"].shape
    if tuple(got.shape) != (b, s, model.cfg.vocab_size) \
            or not bool(torch.isfinite(got).all()) \
            or not bool(torch.isfinite(aux)):
        raise RuntimeError(f"models {name} {dtype}: logits "
                           f"{tuple(got.shape)}, not all finite")
    err = _rel_err(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"models: {name} {dtype} forward B={b} S={s}: kernel against "
          f"plain attend_chunked, max |diff| / max |logit| {err:.3g} "
          f"(bound {MODEL_TOL[dtype]}), top-1 agreement {top1:.4f}; "
          f"flash launches {delta['flash_attention']} ({layers} layers); "
          f"first-call wall {wall * 1e3:.1f} ms; {card}")
    _gate(name, "kernel logits from plain", err, dtype)


def _serve_check(name, model, params, prompts, fa, layers, cache_dtype,
                 card) -> None:
    """prefill then SERVE_STEPS greedy decode steps: the prefill launches
    the kernel once a layer, decode never.  The prefill's logits and every
    cache leaf are held against the plain prefill's; in fp32 the decode
    logits against forward's at the same positions, and that forward (a
    ragged length, the kernel's key padding) against its plain twin."""
    b, s = prompts.shape
    dtype = model.cfg.compute_dtype
    batch = {"tokens": prompts}
    before = dict(fa.LAUNCHES)
    logits, cache = model.prefill(params, batch, max_seq=s + SERVE_STEPS,
                                  cache_dtype=cache_dtype)
    prefill_launches = _fa_delta(fa, before)["flash_attention"]
    want, want_cache = model.prefill(params, batch, max_seq=s + SERVE_STEPS,
                                     cache_dtype=cache_dtype,
                                     use_kernel=False)
    plain_launches = sum(_fa_delta(fa, before).values()) - prefill_launches
    checks = [_gate(name, "prefill logits from plain", _rel_err(logits, want),
                    dtype),
              _gate(name, "prefill cache from plain",
                    _tree_err(cache, want_cache), dtype)]
    del want, want_cache
    tok = logits[:, -1].argmax(-1, keepdim=True)
    del logits
    toks, outs = [tok], []
    before = dict(fa.LAUNCHES)
    for t in range(SERVE_STEPS):
        lg, cache = model.decode_step(params, cache, tok, s + t)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        outs.append(lg)
        toks.append(tok)
    decode_launches = sum(_fa_delta(fa, before).values())
    if prefill_launches != layers or plain_launches or decode_launches:
        raise RuntimeError(f"models {name} {dtype} serving: prefill "
                           f"launched {prefill_launches} (want {layers}), "
                           f"the plain prefill {plain_launches} and decode "
                           f"{decode_launches} (want 0)")
    dec = torch.cat(outs, dim=1)
    if not bool(torch.isfinite(dec).all()):
        raise RuntimeError(f"models {name} {dtype}: non-finite decode logits")
    if dtype == "float32":
        seq = {"tokens": torch.cat([prompts] + toks[:-1], dim=1)}
        got, _ = model.forward(params, seq)
        want, _ = model.forward(params, seq, use_kernel=False)
        checks.append(_gate(name, f"forward S={seq['tokens'].shape[1]} "
                            "from plain", _rel_err(got, want), dtype))
        del want
        checks.append(_gate(name, f"decode at positions {s}.."
                            f"{s + SERVE_STEPS - 1} from forward",
                            _rel_err(dec, got[:, s:]), dtype))
    print(f"models: {name} {dtype} serving {b} x {s} tokens, cache "
          f"{str(cache_dtype).removeprefix('torch.')} of {s + SERVE_STEPS}: "
          f"prefill {prefill_launches} flash launches, {SERVE_STEPS} decode "
          f"steps {decode_launches}; max |diff| / max |value|: "
          f"{', '.join(checks)} (bound {MODEL_TOL[dtype]}); {card}")


def _serve_time(model, params, prompts, cache_dtype) -> dict:
    """One prefill and SERVE_STEPS greedy decode steps, timed, the peak
    device memory taken over them alone."""
    b, s = prompts.shape
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  max_seq=s + SERVE_STEPS,
                                  cache_dtype=cache_dtype)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    del logits
    t0 = time.perf_counter()
    for t in range(SERVE_STEPS):
        lg, cache = model.decode_step(params, cache, tok, s + t)
        tok = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return {"prefill_ms": prefill_s * 1e3,
            "decode_tokens_s": b * SERVE_STEPS / decode_s,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes": resident}


def _planted_fault(name, model, params, batch, fa, fault, card) -> float:
    """A forward whose every kernel launch gets ``fault``, against the plain
    forward: MODEL_TOL must catch it.  Returns its error."""
    dtype = model.cfg.compute_dtype
    want, _ = model.forward(params, batch, use_kernel=False)
    real = fa.flash_attention
    fa.flash_attention = lambda *args, **kw: real(*args, **{**kw, **fault})
    try:
        got, _ = model.forward(params, batch)
    finally:
        fa.flash_attention = real
    err = _rel_err(got, want)
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"models: {name} {dtype} planted fault {fault} on every launch: "
          f"max |diff| / max |logit| {err:.3g} (bound {MODEL_TOL[dtype]}), "
          f"top-1 agreement {top1:.4f}; {card}")
    if not err > MODEL_TOL[dtype]:
        raise RuntimeError(f"models {name} {dtype}: the bound "
                           f"{MODEL_TOL[dtype]} misses the planted fault "
                           f"{fault} ({err:.3g})")
    return err


def _kernel_share(model, params, batch, fa, reps: int = 2) -> dict:
    """The forward timed by CUDA events, and each flash-attention launch
    in it by an event pair around the wrapper: (the fastest of ``reps``
    forwards) its wall, the kernel's summed time and its share."""
    real = fa.flash_attention
    spans = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        spans.append((start, end))
        return out

    best = None
    fa.flash_attention = timed
    try:
        for _ in range(reps):
            spans.clear()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.forward(params, batch)
            end.record()
            end.synchronize()
            wall = start.elapsed_time(end)
            kernel = sum(a.elapsed_time(b) for a, b in spans)
            if best is None or wall < best[0]:
                best = (wall, kernel, len(spans))
    finally:
        fa.flash_attention = real
    return {"forward_ms": best[0], "flash_ms": best[1],
            "flash_launches": best[2], "share": best[1] / best[0]}


def phase_models(K, device, card: str) -> tuple:
    """The model stack on the card (module docstring, phase 7).  Returns
    (path label -> launch counts of the counted run, "<model> <dtype>" ->
    the forward's wall and the kernel's share of it, the serving walls and
    memory, the planted fault's error)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, module

    fa = K["flash_attention"]
    t_phase = time.perf_counter()

    def params_of(models):
        # the same seed each time: one model's weights on the card at once
        return models["float32"].init_params(
            torch.Generator().manual_seed(0), device=device)

    runs = []
    zero_counts(K)
    for name, layers, fault in MODELS:
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        layers = cfg.n_layers
        models = {dt: build_model(dataclasses.replace(cfg, compute_dtype=dt))
                  for dt in ("float32", "bfloat16")}
        t0 = time.perf_counter()
        params = params_of(models)
        torch.cuda.synchronize()
        print(f"models: {name}: {layers} layers, d_model {cfg.d_model}, "
              f"heads {cfg.n_heads}/{cfg.n_kv_heads}, head_dim "
              f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}: "
              f"{module.count_params(params) / 1e9:.3f} B fp32 parameters "
              f"({module.param_bytes(params) / 2**30:.2f} GiB) initialised "
              f"on the card in {time.perf_counter() - t0:.1f} s; {card}")
        gen = torch.Generator(device=device).manual_seed(1)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, MODEL_SEQ),
                                         generator=gen, device=device)}
        prompts = torch.randint(1, cfg.vocab_size,
                                (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                                device=device)
        with torch.no_grad():
            for dt, model in models.items():
                _model_forward_check(name, model, params, batch, fa, layers,
                                     card)
                _serve_check(name, model, params, prompts, fa, layers,
                             getattr(torch, dt), card)
        del params
        torch.cuda.empty_cache()
        runs.append((name, fault, models, batch, prompts))
    counts = launch_counts(K)
    print(f"models: launches of the model path "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    if counts["flash_attention"] <= 0:
        raise RuntimeError("models: the flash-attention kernel never "
                           "launched")
    timing = {}
    with torch.no_grad():
        for name, fault, models, batch, prompts in runs:
            params = params_of(models)
            for dt, model in models.items():
                rec = _kernel_share(model, params, batch, fa)
                _serve_time(model, params, prompts, getattr(torch, dt))
                rec.update(_serve_time(model, params, prompts,
                                       getattr(torch, dt)))
                rec["planted_fault_err"] = _planted_fault(
                    name, model, params, batch, fa, fault, card)
                timing[f"{name} {dt}"] = rec
                print(f"models: {name} {dt} forward B=1 S={MODEL_SEQ}: "
                      f"{rec['forward_ms']:.2f} ms by events, the flash "
                      f"kernel {rec['flash_ms']:.2f} ms over "
                      f"{rec['flash_launches']} launches = "
                      f"{100 * rec['share']:.1f}% of it; serving "
                      f"{SERVE_BATCH} x {SERVE_PROMPT} (the second run): "
                      f"prefill {rec['prefill_ms']:.1f} ms, "
                      f"{SERVE_STEPS} decode steps at "
                      f"{rec['decode_tokens_s']:.1f} tokens/s, peak "
                      f"{rec['peak_bytes'] / 2**30:.2f} GiB "
                      f"({rec['resident_bytes'] / 2**30:.2f} GiB resident "
                      f"before the prefill); {card}")
            del params
            torch.cuda.empty_cache()
    print(f"models: phase {time.perf_counter() - t_phase:.1f} s")
    return {"models": counts}, timing


# serving on the card (phase 8): gemma3-1b uncut.  generate and the
# launcher at phase_models' SERVE_* shapes; the engine at 4 slots of 256
# over the bench serve protocol's traces drawn at the full vocabulary
SERVE_ARCH = "gemma3-1b"
ENGINE_SLOTS, ENGINE_SEQ = 4, 256
ENGINE_STEP_PRIOR_S = 1e-4 + 1e-8 * ENGINE_SLOTS * ENGINE_SEQ   # the seeded
#   serve_step prior (serve.engine._seed_serve_step_entry) at this shape
ENGINE_TIMED_STEPS = 5    # unprofiled steps timed for the busy share
PIGGYBACK_PROMPTS = (2, 4, 8, 24)   # the traces' prompt lengths


def _engine_traces(vocab: int) -> dict:
    """bench serve's traces and seeds (``seed`` 0), at ``vocab``."""
    from repro_torch.serve import bursty_trace, poisson_trace

    return {"bursty": lambda: bursty_trace(2, seed=2, burst_gap=16,
                                           vocab=vocab),
            "poisson": lambda: poisson_trace(8, seed=1, rate=0.4,
                                             vocab=vocab)}


class _Counted:
    """A model for ``generate`` whose prefill and decode steps count the
    flash-attention launches they make and time themselves (synchronised
    before and after each call)."""

    def __init__(self, model, fa):
        self.model, self.fa = model, fa
        self.launches = {"prefill": {}, "decode": {}}
        self.seconds = {"prefill": 0.0, "decode": 0.0}

    def _run(self, kind, fn, *args, **kw):
        before = dict(self.fa.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        self.seconds[kind] += time.perf_counter() - t0
        for k, n in _fa_delta(self.fa, before).items():
            if n:
                self.launches[kind][k] = self.launches[kind].get(k, 0) + n
        return out

    def prefill(self, *args, **kw):
        return self._run("prefill", self.model.prefill, *args, **kw)

    def decode_step(self, *args, **kw):
        return self._run("decode", self.model.decode_step, *args, **kw)


def _margin(logits: torch.Tensor) -> float:
    """The top-2 gap of one row of logits over its largest magnitude."""
    top = logits.float().topk(2).values
    return ((top[0] - top[1]) / logits.float().abs().max()).item()


def _hold_tokens(label, got, want, logits_at) -> str:
    """Hold token rows ``got`` to ``want`` (lists of lists): equal, or at
    the first token where a row differs the plain run's top-2 margin there
    (``logits_at(row, j)``) within MODEL_TOL["float32"] — a near tie that
    another summation order may break.  Returns a note for the print."""
    notes = []
    for b, (g, w) in enumerate(zip(got, want)):
        j = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if j is None and len(g) == len(w):
            continue
        if j is None:
            raise RuntimeError(f"{label}: row {b} has {len(g)} tokens, the "
                               f"plain run {len(w)}")
        margin = _margin(logits_at(b, j))
        notes.append(f"row {b} first differs at token {j}, the plain run's "
                     f"top-2 margin there {margin:.3g}")
        if margin > MODEL_TOL["float32"]:
            raise RuntimeError(f"{label}: {notes[-1]}, above "
                               f"{MODEL_TOL['float32']}: not a near tie")
    return "; ".join(notes) if notes else "equal token for token"


def _plain_generate(model, params, prompts, steps: int) -> tuple:
    """``generate``'s loop with the plain prefill (``use_kernel=False``):
    (tokens [B, steps], the logits each token was taken from, [B, V] a
    step)."""
    b, s = prompts.shape
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  max_seq=s + steps, use_kernel=False)
    rows = [logits[:, -1].float()]
    del logits
    tok = rows[0].argmax(-1, keepdim=True).to(torch.int32)
    toks = [tok]
    for i in range(steps - 1):
        lg, cache = model.decode_step(params, cache, tok, s + i)
        rows.append(lg[:, -1].float())
        tok = rows[-1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(tok)
    return torch.cat(toks, dim=1), rows


def _serve_generate(models, params, prompts, fa, layers, card) -> dict:
    """``generate`` in each dtype: one flash launch a layer in the prefill,
    none in decode; in fp32 its tokens held to the plain prefill's run;
    then a second, timed run.  Returns dtype -> timings."""
    from repro_torch.serve.decode import generate

    b, s = prompts.shape
    out = {}
    for dt, model in models.items():
        counted = _Counted(model, fa)
        toks = generate(counted, params, prompts, SERVE_STEPS,
                        s + SERVE_STEPS)
        if counted.launches != {"prefill": {"flash_attention": layers},
                                "decode": {}}:
            raise RuntimeError(f"serve: generate {dt} launched "
                               f"{counted.launches}, not {layers} in the "
                               "prefill and none in decode")
        if tuple(toks.shape) != (b, SERVE_STEPS) \
                or toks.dtype != torch.int32 \
                or not bool(((toks >= 0) & (toks < model.cfg.vocab_size))
                            .all()):
            raise RuntimeError(f"serve: generate {dt} gave {toks.dtype} "
                               f"{tuple(toks.shape)} out of the vocabulary")
        note = "not held (bf16)"
        if dt == "float32":
            with torch.inference_mode():
                want, rows = _plain_generate(model, params, prompts,
                                             SERVE_STEPS)
            note = _hold_tokens(f"serve: generate {dt}", toks.tolist(),
                                want.tolist(), lambda r, j: rows[j][r])
            del rows
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timed = _Counted(model, fa)
        again = generate(timed, params, prompts, SERVE_STEPS,
                         s + SERVE_STEPS)
        if not torch.equal(again, toks):
            raise RuntimeError(f"serve: generate {dt} gave other tokens on "
                               "its second run")
        rec = {"prefill_ms": timed.seconds["prefill"] * 1e3,
               "decode_tokens_s": b * (SERVE_STEPS - 1)
               / timed.seconds["decode"],
               "decode_step_ms": timed.seconds["decode"] * 1e3
               / (SERVE_STEPS - 1),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        out[dt] = rec
        print(f"serve: generate {SERVE_ARCH} {dt} {b} x {s} tokens + "
              f"{SERVE_STEPS} new: flash launches {counted.launches} "
              f"({layers} layers); against the plain prefill's run: {note}; "
              f"the second run: prefill {rec['prefill_ms']:.1f} ms, "
              f"{SERVE_STEPS - 1} decode steps at "
              f"{rec['decode_step_ms']:.2f} ms = "
              f"{rec['decode_tokens_s']:.1f} tokens/s, peak "
              f"{rec['peak_bytes'] / 2**30:.2f} GiB; {card}")
    return out


def _serve_launcher(fa, layers, device, card) -> None:
    """``launch.serve.main`` in process at phase_models' serving shape
    (the config's bf16 compute), then through a checkpoint of the same
    weights saved and restored by the port's manager: the same tokens,
    one flash launch a layer each."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as launch
    from repro_torch.models import build_model

    argv = ["--arch", SERVE_ARCH, "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--max-new",
            str(SERVE_STEPS), "--seed", "0", "--device", str(device)]
    before = fa.LAUNCHES["flash_attention"]
    plain, text = _cli(launch.main, argv)
    plain = plain.cpu()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        params = build_model(get_arch(SERVE_ARCH)).init_params(
            torch.Generator().manual_seed(0), device=device)
        t0 = time.perf_counter()
        CheckpointManager(tmp).save(7, {"params": params})
        save_s = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, restored_text = _cli(launch.main,
                                       argv + ["--checkpoint-dir", tmp])
        restore_s = time.perf_counter() - t0
    launches = fa.LAUNCHES["flash_attention"] - before
    if "[serve] restored checkpoint step 7" not in restored_text:
        raise RuntimeError("serve: launch.serve did not restore the "
                           "checkpoint")
    if not torch.equal(restored.cpu(), plain) or launches != 2 * layers:
        raise RuntimeError(f"serve: launch.serve through the checkpoint "
                           f"gave other tokens, or {launches} flash "
                           f"launches in two runs (want {2 * layers})")
    said = [ln for ln in (text + restored_text).splitlines()
            if ln.startswith("[serve] generated")]
    print(f"serve: launch.serve {SERVE_ARCH} {SERVE_BATCH} x {SERVE_PROMPT} "
          f"+ {SERVE_STEPS}: {said}; through a checkpoint saved in "
          f"{save_s:.1f} s, restored and served in {restore_s:.1f} s: the "
          f"same tokens; flash launches {launches} in the two runs; {card}")


def _bare_step_ms(model, params, device) -> float:
    """The model's decode step alone at the engine's batch, over a cache of
    its own (median of ENGINE_TIMED_STEPS, each synchronised)."""
    cache = model.init_cache(ENGINE_SLOTS, ENGINE_SEQ, device=device)
    tokens = torch.ones((ENGINE_SLOTS, 1), dtype=torch.int32, device=device)
    start = torch.zeros(ENGINE_SLOTS, dtype=torch.int32, device=device)
    walls = []
    with torch.inference_mode():
        for i in range(ENGINE_TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = model.decode_step(params, cache, tokens, i,
                                          start=start)
            lg.argmax(-1).cpu()
            walls.append(time.perf_counter() - t0)
    return float(np.median(walls[1:])) * 1e3


def _profiled_step(eng) -> dict:
    """One engine with a request in flight: ENGINE_TIMED_STEPS steps timed
    by the host's clock (each ends synchronised), then one step under the
    profiler: its device time, its kernels and its copies."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeRequest

    eng.submit(ServeRequest(rid=10**6, prompt=[1, 2, 3],
                            max_new=ENGINE_TIMED_STEPS + 4))
    eng.step()
    walls = []
    for _ in range(ENGINE_TIMED_STEPS):
        t0 = time.perf_counter()
        eng.step()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in cuda)
    step_s = float(np.median(walls))
    busy = sum(e.device_time_total for e in cuda) / 1e6
    return {"step_ms": step_s * 1e3, "busy_ms": busy * 1e3,
            "busy_share": busy / step_s, "launches": len(cuda) - copies,
            "copies": copies}


def _hold_telemetry(label, tel, stats, n) -> int:
    """The engine's telemetry contract (serve.engine's docstring).  Returns
    the iterations that ran the model (``engine_steps`` also counts the
    steps the clock skipped while the engine stood idle)."""
    s = tel.summary()["histograms"]
    c = tel.counters()
    tokens = stats["tokens_generated"]
    steps = len(tel.events(cat="serve.step"))
    checks = {
        "model steps within engine_steps": (
            0 < steps <= stats["engine_steps"], True),
        "serve.ttft_s count": (s["serve.ttft_s"]["count"], n),
        "serve.token_latency_s count": (s["serve.token_latency_s"]["count"],
                                        tokens - n),
        "kernel.serve_step.s count": (s["kernel.serve_step.s"]["count"],
                                      steps),
        "serve.requests_completed": (c.get("serve.requests_completed"), n),
        "serve.tokens_generated": (c.get("serve.tokens_generated"), tokens),
        "dispatch.predicted": (c.get("dispatch.predicted"), steps),
        "dispatch.measured": (c.get("dispatch.measured", 0), 0),
        "admission instants": (len(tel.events(cat="admission")), n),
        "request.done instants": (sum(
            e["name"].startswith("request.done:")
            for e in tel.events(cat="serve.request")), n)}
    bad = {k: v for k, v in checks.items() if v[0] != v[1]}
    for name in ("serve.queue_depth", "serve.goodput_tok_s",
                 "serve.kv_cache_bytes", "serve.kv_live_bytes"):
        if not tel.series(name):
            bad[name] = "no series"
    if bad:
        raise RuntimeError(f"serve: {label}: telemetry contract broken: "
                           f"{bad}")
    return steps


def _serve_engine(model, params, fa, device, card) -> dict:
    """bench serve's protocol at gemma3-1b: a FIFO warm-up recording rows,
    a LinearModel fit, then fresh engines per trace and policy.  Every
    request completes, no flash launch, the telemetry contract holds."""
    from repro_torch.core.nnc import LinearModel
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.runtime import TuningCache, current_fingerprint
    from repro_torch.serve import ServeEngine, fit_cost_entries
    from repro_torch.serve import poisson_trace

    vocab = model.cfg.vocab_size
    out = {"bare_step_ms": _bare_step_ms(model, params, device)}
    before = sum(fa.LAUNCHES.values())
    with tempfile.TemporaryDirectory() as tmp:
        cache = TuningCache(root=tmp, fingerprint=current_fingerprint(device))
        warm = ServeEngine(model, cache, params=params,
                           max_slots=ENGINE_SLOTS, max_seq=ENGINE_SEQ,
                           admission="fifo")
        t0 = time.perf_counter()
        ws = warm.run_trace(poisson_trace(8, seed=0, rate=0.5, vocab=vocab))
        warm_s = time.perf_counter() - t0
        fitted = fit_cost_entries(cache, model_factory=LinearModel,
                                  save=False)
        prefill_ms = fitted.prefill_seconds(24) * 1e3
        token_ms = fitted.decode_seconds_per_token(32) * 1e3
        print(f"serve: engine {SERVE_ARCH} {model.cfg.compute_dtype} "
              f"{ENGINE_SLOTS} slots x {ENGINE_SEQ}: FIFO warm-up "
              f"{ws['completed']} requests in {ws['engine_steps']} steps, "
              f"{warm_s:.2f} s; fitted prefill {prefill_ms:.1f} ms at "
              f"prompt 24, decode {token_ms:.2f} ms a token at ctx 32 "
              f"(fit MAPE, the worse entry, {fitted.fit_band_pct:.1f}%); "
              f"{card}")
        if ws["completed"] != 8:
            raise RuntimeError(f"serve: the warm-up completed {ws}")
        for tname, mk in _engine_traces(vocab).items():
            for policy in ("fifo", "sjf"):
                tel = Telemetry()
                eng = ServeEngine(model, cache, params=params,
                                  max_slots=ENGINE_SLOTS,
                                  max_seq=ENGINE_SEQ, admission=policy,
                                  telemetry=tel, record_rows=False)
                reqs = mk()
                stats = eng.run_trace(reqs)
                label = f"engine {tname} {policy}"
                if stats["completed"] != len(reqs) or stats["rejected"] \
                        or stats["policy"] != policy \
                        or not all(r.done and len(r.generated) == r.max_new
                                   for r in reqs):
                    raise RuntimeError(f"serve: {label}: {stats}")
                ran = _hold_telemetry(label, tel, stats, len(reqs))
                h = tel.summary()["histograms"]
                step = _profiled_step(eng)
                rec = {"ttft_ms": (h["serve.ttft_s"]["p50"] * 1e3,
                                   h["serve.ttft_s"]["p99"] * 1e3),
                       "token_ms": (h["serve.token_latency_s"]["p50"] * 1e3,
                                    h["serve.token_latency_s"]["p99"] * 1e3),
                       "goodput_tok_s": stats["goodput_tok_s"],
                       "engine_steps": stats["engine_steps"],
                       "model_steps": ran,
                       "occupancy": stats["occupancy"],
                       "step_s_mean": h["kernel.serve_step.s"]["mean"],
                       **step}
                out[f"{tname} {policy}"] = rec
                print(f"serve: {label} ({len(reqs)} requests): TTFT p50 "
                      f"{rec['ttft_ms'][0]:.1f} / p99 {rec['ttft_ms'][1]:.1f}"
                      f" ms, token latency p50 {rec['token_ms'][0]:.2f} / "
                      f"p99 {rec['token_ms'][1]:.2f} ms, goodput "
                      f"{rec['goodput_tok_s']:.1f} tokens/s, "
                      f"{rec['engine_steps']} engine steps ({ran} ran the "
                      f"model), occupancy "
                      f"{rec['occupancy']:.3f}; kernel.serve_step.s mean "
                      f"{rec['step_s_mean'] * 1e3:.2f} ms against the "
                      f"seeded prior {ENGINE_STEP_PRIOR_S * 1e3:.3f} ms; one "
                      f"step {step['step_ms']:.2f} ms by the host's clock, "
                      f"the card busy {step['busy_ms']:.2f} ms of it = "
                      f"{100 * step['busy_share']:.1f}%, "
                      f"{step['launches']} kernels and {step['copies']} "
                      f"copies; the model's decode step alone "
                      f"{out['bare_step_ms']:.2f} ms; {card}")
    flash = sum(fa.LAUNCHES.values()) - before
    if flash:
        raise RuntimeError(f"serve: the engine launched {flash} "
                           "flash-attention kernels (its steps decode)")
    return out


def _serve_engine_exact(model, params, device, card) -> None:
    """fp32: the engine's tokens for the bursty trace against each request
    run alone through ContinuousBatcher(max_slots=1), under the margin
    rule (batches of other sizes may sum in another order)."""
    from repro_torch.runtime import TuningCache, current_fingerprint
    from repro_torch.serve import ContinuousBatcher, ServeEngine

    class Solo(ContinuousBatcher):
        """The plain batcher, keeping each step's slot-0 logits."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.rows = []

            def step(params, cache, tokens, index, start):
                with torch.inference_mode():
                    lg, cache = self.model.decode_step(
                        params, cache, tokens, index, start=start)
                self.rows.append(lg[0, -1].float())
                return lg.argmax(-1).to(torch.int32), cache
            self._step = step

    trace = _engine_traces(model.cfg.vocab_size)["bursty"]
    reqs = trace()
    with tempfile.TemporaryDirectory() as tmp:
        eng = ServeEngine(model, TuningCache(
            root=tmp, fingerprint=current_fingerprint(device)),
            params=params, max_slots=ENGINE_SLOTS, max_seq=ENGINE_SEQ,
            admission="fifo")
        eng.run_trace(reqs)
    notes = []
    for req, alone in zip(reqs, trace()):
        solo = Solo(model, params, max_slots=1, max_seq=ENGINE_SEQ)
        solo.submit(alone)
        solo.run()
        first = len(alone.prompt) - 1       # the step of generated token 0
        note = _hold_tokens(
            f"serve: engine fp32 request {req.rid}", [req.generated],
            [alone.generated], lambda r, j: solo.rows[first + j])
        if note != "equal token for token":
            notes.append(f"request {req.rid}: {note}")
    print(f"serve: engine {SERVE_ARCH} float32 bursty trace ({len(reqs)} "
          f"requests) against each request alone: "
          f"{'; '.join(notes) or 'equal token for token'}; {card}")


def _piggyback(model, params, engine: dict, device, card) -> None:
    """TTFT under piggyback prefill (about prompt x one engine step)
    beside generate's batched prefill of the same prompt at B = 1."""
    step_ms = engine["bursty fifo"]["step_ms"]
    parts = []
    with torch.inference_mode():
        for p in PIGGYBACK_PROMPTS:
            toks = torch.ones((1, p), dtype=torch.int32, device=device)
            model.prefill(params, {"tokens": toks}, max_seq=p + 1)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            model.prefill(params, {"tokens": toks}, max_seq=p + 1)
            end.record()
            end.synchronize()
            parts.append(f"prompt {p}: {p} x {step_ms:.2f} = "
                         f"{p * step_ms:.1f} ms piggyback, "
                         f"{start.elapsed_time(end):.2f} ms batched")
    print(f"serve: {SERVE_ARCH} {model.cfg.compute_dtype} TTFT by prefill "
          f"design: {'; '.join(parts)}; {card}")


def _serve_bench(device, card) -> None:
    """``run_serve(quick=False)`` on the card (reduced yi-9b), merged into
    a copy of the committed bench document and validated; then
    ``python -m repro_torch.bench serve --quick`` in process."""
    import shutil

    from repro_torch.bench.__main__ import main as bench_main
    from repro_torch.bench.schema import load_bench, validate_bench
    from repro_torch.bench.serve_trace import (run_serve, summarize_serve,
                                               write_serve)

    sample = Path(__file__).resolve().parent / "benchmarks" \
        / "sample_results" / "bench.json"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        section = run_serve(quick=False, results_dir=tmp, device=device)
        wall = time.perf_counter() - t0
        shutil.copy(sample, Path(tmp) / "bench.json")
        written = write_serve(section, out_path=str(Path(tmp) / "bench.json"),
                              results_dir=tmp)
        validate_bench(load_bench(written))
        for line in summarize_serve(section):
            print(f"serve bench: {line}; {card}")
        done = {(t, p): r["completed"] == section["traces"][t]["n_requests"]
                for t, tr in section["traces"].items()
                for p, r in tr["policies"].items()}
        if not all(done.values()):
            raise RuntimeError(f"serve bench: requests left over: {done}")
        rc, text = _cli(bench_main, [
            "serve", "--quick", "--results-dir", f"{tmp}/cli",
            "--out", f"{tmp}/cli/bench.json", "--device", str(device)])
        if rc not in (0, 1) or not (Path(tmp) / "cli"
                                    / "bench_serve.json").exists():
            raise RuntimeError(f"serve bench: the CLI exited {rc}")
    print(f"serve bench: run_serve(quick=False) on {device} in {wall:.1f} s, "
          f"sjf_beats_fifo_bursty {section['sjf_beats_fifo_bursty']}, the "
          f"document validates; bench serve --quick exited {rc} "
          f"({text.splitlines()[-2].strip()}); {card}")


def phase_serve(K, device, card: str) -> tuple:
    """Serving on the card (module docstring, phase 8).  Returns (path
    label -> launch counts of the counted run, the serving numbers)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    fa = K["flash_attention"]
    t_phase = time.perf_counter()
    cfg = get_arch(SERVE_ARCH)
    layers = cfg.n_layers
    models = {dt: build_model(dataclasses.replace(cfg, compute_dtype=dt))
              for dt in ("float32", "bfloat16")}
    zero_counts(K)
    params = models["float32"].init_params(torch.Generator().manual_seed(0),
                                           device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(1, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=device, dtype=torch.int32)
    timing = {"generate": _serve_generate(models, params, prompts, fa,
                                          layers, card)}
    timing["engine"] = _serve_engine(models["bfloat16"], params, fa, device,
                                     card)
    _serve_engine_exact(models["float32"], params, device, card)
    del params
    torch.cuda.empty_cache()
    _serve_launcher(fa, layers, device, card)
    _serve_bench(device, card)
    counts = launch_counts(K)
    print(f"serve: launches of the serving path "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    # generate twice in each dtype, the launcher twice: a launch a layer
    want = {k: 0 for k in counts}
    want["flash_attention"] = 6 * layers
    if counts != want:
        raise RuntimeError(f"serve: launches {counts}, not {want}")
    params = models["bfloat16"].init_params(
        torch.Generator().manual_seed(0), device=device)
    _piggyback(models["bfloat16"], params, timing["engine"], device, card)
    del params
    torch.cuda.empty_cache()
    print(f"serve: phase {time.perf_counter() - t_phase:.1f} s")
    return {"serve": counts}, timing


# training on the card (phase 9): gemma3-1b uncut.  The gradient gate, the
# planted backward fault, the counted step and the launcher at TRAIN_*; the
# crash-and-resume children at 2 of 26 layers (a checkpoint of params and
# both moments in fp32 near 3.6 GB, against 12 GB uncut)
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS, TRAIN_WARMUP = 8, 2
RESUME_LAYERS, RESUME_SEQ, RESUME_STEPS = 2, 1024, 6
RESUME_EVERY, RESUME_FAIL = 4, 5
# one training step with remat: the lse forward once a layer (26), again in
# the recompute of the 4 checkpointed periods of 6 layers (24; the 2 tail
# layers are not checkpointed), the dq and dk/dv kernels once a layer
TRAIN_LAUNCHES = {"flash_attention": 0, "flash_attention_fwd": 50,
                  "flash_attention_bwd_dq": 26,
                  "flash_attention_bwd_dkv": 26}
# the training path's wrappers and the names of the kernels they launch
FA_KERNEL_NAMES = {"flash_attention_fwd": "fa_fwd_kernel",
                   "flash_attention_bwd_dq": "fa_bwd_dq_kernel",
                   "flash_attention_bwd_dkv": "fa_bwd_dkv_kernel"}
TRAIN_KERNELS = tuple(FA_KERNEL_NAMES)


def _grads(model, params, batch, use_kernel: bool) -> tuple:
    """make_loss_fn's (loss, grads) at the step's config, through the
    kernels or the plain attend_chunked."""
    from repro_torch.train.step import (TrainStepConfig, _value_and_grad,
                                        make_loss_fn)

    fn = _value_and_grad(make_loss_fn(model, TrainStepConfig(),
                                      use_kernel=use_kernel))
    (loss, _), grads = fn(params, batch)
    return loss, grads


def _grad_errs(got, want) -> tuple:
    """(the loss's relative error, the largest leaf error of the grads, its
    leaf): each leaf's max |diff| over that leaf's largest magnitude."""
    (loss, grads), (loss_w, grads_w) = got, want
    errs = {path: _rel_err(g, w)
            for (path, g), (_, w) in zip(_paths(grads), _paths(grads_w))}
    leaf = max(errs, key=errs.get)
    return abs(loss.item() - loss_w.item()) / abs(loss_w.item()), \
        errs[leaf], leaf


def _paths(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _train_gate(models, params, batch, fa, card) -> dict:
    """(a) and (b): the loss and every gradient leaf through the kernels
    against the plain twin, fp32 and bf16, within MODEL_TOL; then a fault
    planted in the backward kernels alone (the local layers' window
    dropped) must land above the bound."""
    out = {}
    for dt, model in models.items():
        t0 = time.perf_counter()
        want = _grads(model, params, batch, use_kernel=False)
        got = _grads(model, params, batch, use_kernel=True)
        torch.cuda.synchronize()
        loss_err, grad_err, leaf = _grad_errs(got, want)
        out[dt] = {"loss_err": loss_err, "grad_err": grad_err}
        print(f"train: {TRAIN_ARCH} {dt} value-and-grad B={TRAIN_BATCH} "
              f"S={TRAIN_SEQ}: loss {got[0].item():.6f} through the kernels, "
              f"{want[0].item():.6f} plain, relative {loss_err:.3g}; the "
              f"worst gradient leaf {leaf} {grad_err:.3g} of its largest "
              f"magnitude (bound {MODEL_TOL[dt]}); both in "
              f"{time.perf_counter() - t0:.1f} s; {card}")
        _gate(TRAIN_ARCH, "train loss from plain", loss_err, dt)
        _gate(TRAIN_ARCH, f"train gradient {leaf} from plain", grad_err, dt)
        real = {k: getattr(fa, k) for k in ("flash_attention_bwd_dq",
                                            "flash_attention_bwd_dkv")}
        for k, fn in real.items():
            setattr(fa, k, lambda *a, _fn=fn, **kw: _fn(*a, **{**kw,
                                                             "window": 0}))
        try:
            bad = _grads(model, params, batch, use_kernel=True)
        finally:
            for k, fn in real.items():
                setattr(fa, k, fn)
        loss_err, grad_err, leaf = _grad_errs(bad, want)
        out[dt]["planted_fault_err"] = grad_err
        print(f"train: {TRAIN_ARCH} {dt} planted fault: the dq and dk/dv "
              f"kernels launched with window=0 on every layer, the forward "
              f"right: loss relative {loss_err:.3g}, the worst gradient leaf "
              f"{leaf} {grad_err:.3g} (bound {MODEL_TOL[dt]}); {card}")
        if not grad_err > MODEL_TOL[dt]:
            raise RuntimeError(f"train {dt}: the bound {MODEL_TOL[dt]} "
                               f"misses the planted backward fault "
                               f"({grad_err:.3g})")
        del want, got, bad
        torch.cuda.empty_cache()
    return out


def _fresh_step(model, device) -> tuple:
    """make_train_step at the default config over seed-0 weights: (the
    step, params, AdamW state, the step-0 batch at TRAIN_*)."""
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.optim import AdamW
    from repro_torch.train.step import TrainStepConfig, make_train_step

    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    opt = AdamW(learning_rate=1e-4)
    batch = batch_at(DataConfig(model.cfg.vocab_size, TRAIN_SEQ,
                                TRAIN_BATCH), 0, device=device)
    return (make_train_step(model, opt, TrainStepConfig()), params,
            opt.init(params), batch)


def _train_step_counted(model, device, fa, card) -> None:
    """(c): one training step (remat) from fresh weights: TRAIN_LAUNCHES
    exactly."""
    cfg = model.cfg
    step, params, state, batch = _fresh_step(model, device)
    before = dict(fa.LAUNCHES)
    params, state, metrics = step(params, state, batch)
    loss = metrics["loss"].item()
    delta = _fa_delta(fa, before)
    print(f"train: {TRAIN_ARCH} {cfg.compute_dtype} one step (remat) B="
          f"{TRAIN_BATCH} S={TRAIN_SEQ}: loss {loss:.4f}, grad norm "
          f"{metrics['grad_norm'].item():.4f}; flash launches "
          f"{json.dumps(delta)}; {card}")
    if delta != TRAIN_LAUNCHES or not np.isfinite(loss):
        raise RuntimeError(f"train: one step launched {delta}, not "
                           f"{TRAIN_LAUNCHES} (loss {loss})")


def _train_launcher(fa, device, card) -> dict:
    """(d): launch.train.main in process, TRAIN_STEPS steps: every loss
    and grad norm finite, the last loss below the first, TRAIN_LAUNCHES a
    step; the warm steps' time, tokens/s and the peak device memory."""
    from repro_torch.launch import train as launch

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "metrics.json"
        argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                "--seq-len", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                "--warmup", str(TRAIN_WARMUP), "--device", str(device),
                "--metrics-out", str(out)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(fa.LAUNCHES)
        t0 = time.perf_counter()
        log, text = _cli(launch.main, argv)
        wall = time.perf_counter() - t0
        delta = _fa_delta(fa, before)
        peak = torch.cuda.max_memory_allocated()
        if json.loads(out.read_text()) != log:
            raise RuntimeError("train: --metrics-out differs from the log")
    losses = [m["loss"] for m in log]
    norms = [m["grad_norm"] for m in log]
    want = {k: TRAIN_STEPS * v for k, v in TRAIN_LAUNCHES.items()}
    if len(log) != TRAIN_STEPS or not np.all(np.isfinite(losses + norms)) \
            or not losses[-1] < losses[0] or delta != want:
        raise RuntimeError(f"train: the launcher gave losses {losses}, grad "
                           f"norms {norms}, flash launches {delta} (want "
                           f"{want})")
    warm = [m["step_time_s"] for m in log[1:]]
    step_s = float(np.median(warm))
    rec = {"losses": losses, "first_step_s": log[0]["step_time_s"],
           "step_ms": step_s * 1e3,
           "tokens_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
           "peak_bytes": peak, "wall_s": wall}
    print(f"train: launch.train {TRAIN_ARCH} --seq-len {TRAIN_SEQ} --batch "
          f"{TRAIN_BATCH} --steps {TRAIN_STEPS} --warmup {TRAIN_WARMUP}: "
          f"{[ln for ln in text.splitlines() if ln.startswith('[train]')]}; "
          f"losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}; first step "
          f"{rec['first_step_s']:.2f} s, the warm steps' median "
          f"{rec['step_ms']:.1f} ms ({min(warm) * 1e3:.1f}-"
          f"{max(warm) * 1e3:.1f}) = {rec['tokens_s']:.0f} tokens/s; peak "
          f"device memory {peak / 2**30:.2f} GiB; flash launches "
          f"{json.dumps(delta)}; {wall:.1f} s in all; {card}")
    return rec


def _pct(share) -> str:
    return "not measured" if share is None else f"{100 * share:.1f}%"


def _event_step(step, params, state, batch, fa) -> tuple:
    """One step by CUDA events, an event pair around every flash launch:
    (its ms, per kernel the summed ms of its spans and their count, the
    params and state)."""
    spans = {k: [] for k in TRAIN_KERNELS}
    real = {k: getattr(fa, k) for k in TRAIN_KERNELS}

    def timed(name):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real[name](*args, **kw)
            end.record()
            spans[name].append((start, end))
            return out
        return run

    for k in TRAIN_KERNELS:
        setattr(fa, k, timed(k))
    try:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, _ = step(params, state, batch)
        end.record()
        end.synchronize()
    finally:
        for k, fn in real.items():
            setattr(fa, k, fn)
    flash = {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
             for k, v in spans.items()}
    return start.elapsed_time(end), flash, params, state


def _train_profile(model, device, fa, card) -> dict:
    """A warm step by the host's clock; one under the profiler (the
    card's busy share, its kernels, the flash kernels' device time by
    name, the kernels that take most of it); two by CUDA events with an
    event pair around every flash launch (the faster kept: the kernels'
    share by events); the resident bytes of params, grads and both
    moments beside them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import module

    cfg = model.cfg
    step, params, state, batch = _fresh_step(model, device)
    params, state, _ = step(params, state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state, m = step(params, state, batch)
    m["loss"].item()
    host_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
    cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = sum(e.name.startswith(("Memcpy", "Memset")) for e in cuda)
    busy_s = sum(e.device_time_total for e in cuda) / 1e6
    by_name = {}
    for e in cuda:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    device_ms = {k: sum(ms for n, ms in by_name.items() if kernel in n)
                 for k, kernel in FA_KERNEL_NAMES.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    best = None
    for _ in range(2):
        ms, flash, params, state = _event_step(step, params, state, batch,
                                               fa)
        if best is None or ms < best[0]:
            best = (ms, flash)
    step_ms, flash = best
    flash_ms = sum(v[0] for v in flash.values())
    rec = {"host_step_ms": host_s * 1e3, "busy_ms": busy_s * 1e3,
           "busy_share": busy_s / host_s, "launches": len(cuda) - copies,
           "copies": copies, "flash_device_ms": device_ms,
           "flash_device_share": sum(device_ms.values()) / (busy_s * 1e3)
           if busy_s > 0 else None,
           "event_step_ms": step_ms,
           "flash_ms": {k: v[0] for k, v in flash.items()},
           "flash_launches": {k: v[1] for k, v in flash.items()},
           "flash_share": flash_ms / step_ms,
           "resident_bytes": 4 * module.param_bytes(params)}
    print(f"train: {TRAIN_ARCH} {cfg.compute_dtype} a warm step B="
          f"{TRAIN_BATCH} S={TRAIN_SEQ}: {rec['host_step_ms']:.1f} ms by the "
          f"host's clock, the card busy {rec['busy_ms']:.1f} ms of it = "
          f"{100 * rec['busy_share']:.1f}% over {rec['launches']} kernels "
          f"and {copies} copies (profiled step), the flash kernels' device "
          f"time " + ", ".join(f"{k} {v:.2f} ms" for k, v in device_ms.items())
          + f" = {_pct(rec['flash_device_share'])} of the busy time; "
          f"most device time: " + "; ".join(f"{n[:48]} {ms:.1f} ms"
                                           for n, ms in top)
          + f"; by events (the faster of two steps) {step_ms:.1f} ms, the "
          f"flash spans " + ", ".join(
              f"{k} {v[0]:.2f} ms ({v[1]})" for k, v in flash.items())
          + f" = {100 * rec['flash_share']:.1f}% of it; params + grads + "
          f"mu + nu resident {rec['resident_bytes'] / 2**30:.2f} GiB; "
          f"{card}")
    return rec


def train_child(argv) -> int:
    """``python3 chip_smoke.py --train-child LAYERS ARGS...``:
    ``launch.train.main(ARGS)`` with the arch cut to LAYERS layers."""
    import dataclasses

    from repro_torch.launch import train as launch

    layers, args = int(argv[0]), argv[1:]
    full = launch.get_arch
    launch.get_arch = lambda name: dataclasses.replace(full(name),
                                                       n_layers=layers)
    launch.main(args)
    return 0


def _train_resume(card) -> dict:
    """(e): launch.train in child processes at full width, RESUME_LAYERS
    layers: one run uninterrupted, one crashing at RESUME_FAIL (exit 42,
    after the checkpoint at RESUME_EVERY), one resuming from it; the
    resumed steps' losses against the uninterrupted run's."""
    def child(*extra):
        argv = [sys.executable, str(Path(__file__).resolve()),
                "--train-child", str(RESUME_LAYERS), "--arch", TRAIN_ARCH,
                "--steps", str(RESUME_STEPS), "--seq-len", str(RESUME_SEQ),
                "--batch", str(TRAIN_BATCH), "--warmup", str(TRAIN_WARMUP),
                *extra]
        t0 = time.perf_counter()
        run = subprocess.run(argv, capture_output=True, text=True,
                             timeout=300)
        return run, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = ["--checkpoint-dir", str(tmp / "ckpt"), "--checkpoint-every",
                str(RESUME_EVERY)]
        whole, whole_s = child("--metrics-out", str(tmp / "whole.json"))
        crash, crash_s = child(*ckpt, "--fail-at-step", str(RESUME_FAIL))
        resume, resume_s = child(*ckpt, "--metrics-out",
                                 str(tmp / "resumed.json"))
        for run, rc in ((whole, 0), (crash, 42), (resume, 0)):
            if run.returncode != rc:
                raise RuntimeError(f"train: a launcher child exited "
                                   f"{run.returncode}, not {rc}: "
                                   f"{run.stdout[-1500:]} {run.stderr[-3000:]}")
        if f"resumed from step {RESUME_EVERY}" not in resume.stdout:
            raise RuntimeError(f"train: no resume: {resume.stdout[-1500:]}")
        a = json.loads((tmp / "whole.json").read_text())[RESUME_EVERY:]
        b = json.loads((tmp / "resumed.json").read_text())
    got = [m["loss"] for m in b]
    want = [m["loss"] for m in a]
    if [m["step"] for m in a] != [m["step"] for m in b]:
        raise RuntimeError(f"train: resumed steps {b}, want {a}")
    rel = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    exact = got == want
    print(f"train: crash and resume, {TRAIN_ARCH} full width at "
          f"{RESUME_LAYERS} layers, {TRAIN_BATCH} x {RESUME_SEQ}, "
          f"{RESUME_STEPS} steps: the crash at step {RESUME_FAIL} exited 42 "
          f"({crash_s:.1f} s), the next run resumed from step "
          f"{RESUME_EVERY} ({resume_s:.1f} s); losses of steps "
          f"{[m['step'] for m in b]} {got} against the uninterrupted run's "
          f"{want} ({whole_s:.1f} s): "
          f"{'bit-equal' if exact else f'relative {rel:.3g}'}; {card}")
    if not exact and not rel <= 1e-6:
        raise RuntimeError(f"train: resumed losses {got} differ from "
                           f"{want} by {rel:.3g}")
    return {"resume_exact": exact, "resume_rel": rel}


def phase_train(K, device, card: str) -> tuple:
    """Training on the card (module docstring, phase 9).  Returns (path
    label -> launch counts of the counted run, the training numbers)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.models import build_model

    fa = K["flash_attention"]
    t_phase = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    models = {dt: build_model(dataclasses.replace(cfg, compute_dtype=dt))
              for dt in ("float32", "bfloat16")}
    params = models["float32"].init_params(torch.Generator().manual_seed(0),
                                           device=device)
    batch = batch_at(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 0,
                     device=device)
    timing = {"gate": _train_gate(models, params, batch, fa, card)}
    del params
    torch.cuda.empty_cache()
    zero_counts(K)
    _train_step_counted(models[cfg.compute_dtype], device, fa, card)
    torch.cuda.empty_cache()
    timing["launcher"] = _train_launcher(fa, device, card)
    counts = launch_counts(K)
    print(f"train: launches of the training path "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    want = {k: 0 for k in counts}
    want.update({k: (TRAIN_STEPS + 1) * v for k, v in TRAIN_LAUNCHES.items()})
    if counts != want:
        raise RuntimeError(f"train: launches {counts}, not {want}")
    torch.cuda.empty_cache()
    timing["step"] = _train_profile(models[cfg.compute_dtype], device, fa,
                                    card)
    torch.cuda.empty_cache()
    timing.update(_train_resume(card))
    print(f"train: phase {time.perf_counter() - t_phase:.1f} s")
    return {"train": counts}, timing


DIST_ARCH = "gemma3-1b"
DIST_DEVICE = "cuda:0"   # the one card the ranks share
DIST_RANKS = 4           # ranks sharing DIST_DEVICE over gloo
DIST_SEQ = 4096          # the ring forward, B = 1
DIST_PROMPT, DIST_STEPS = 2048, 32   # the decode ring: max_seq 2080 = 4 x 520
DIST_MOE = "qwen3-moe-235b-a22b"     # reduced(): the full model is 470 GB
DIST_MOE_TOL = 1e-5      # the JAX package's own bounds (test_moe_shardmap)
DP_LAYERS, DP_STEPS = 2, 3           # the two gloo ranks of --data-parallel
DP_TOL = {"nccl": 1e-6, "gloo": 1e-5}
DIST_DEADLINE_S = 300    # each group of child processes, from its start
DIST_GROUP_TIMEOUT_S = 120.0   # a collective no peer answers fails the rank


def _kernels() -> dict:
    """Kernel name -> the module of its wrapper (and launch counter)."""
    from repro_torch.kernels.blur import blur as bk
    from repro_torch.kernels.conv2d import conv2d as mc
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.matmul import matmul as mm
    from repro_torch.kernels.matvec import matvec as mv
    from repro_torch.kernels.maxpool import maxpool as mp

    return {"matmul": mm, "matvec": mv, "conv2d": mc, "maxpool": mp,
            "blur": bk, "flash_attention": fa}


def _delta(K, before: dict) -> dict:
    return {k: v - before[k] for k, v in launch_counts(K).items()
            if v != before[k]}


def _checksum(tensors) -> str:
    """One hex fingerprint of a sequence of tensors' bits."""
    from repro_torch.dist import collectives

    total = 0
    for t in tensors:
        total = (total * 1000003 + collectives.fingerprint(t)) % (1 << 64)
    return f"{total:016x}"


def _same_on_ranks(label, value) -> None:
    from repro_torch.dist import collectives

    got = collectives.all_ranks(value)
    if any(v != got[0] for v in got):
        raise RuntimeError(f"dist: {label} differs between ranks: {got}")


def _dist_ring(model, params, batch, mesh, K, rank) -> dict:
    """(1) gemma3-1b's forward with ring=True under the 4-rank model mesh;
    on rank 0 also the one-process forward through the flash kernel and
    the planted fault (every rotation the wrong way round)."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import train_rules, use_mesh

    link, rules = mesh.transport, train_rules(seq_parallel=True)

    def ring():
        with torch.no_grad(), use_mesh(mesh, rules):
            return model.forward(params, batch, remat=False, ring=True)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    t0 = time.perf_counter()
    logits = ring()
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "host_bytes": link.host_bytes - host0[0],
           "host_s": link.host_s - host0[1],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "flash": _delta(K, before)}
    prints = collectives.all_ranks(collectives.fingerprint(logits))
    rec["ranks_bit_equal"] = all(p == prints[0] for p in prints)
    if rank == 0:
        before = launch_counts(K)
        with torch.no_grad():
            want, _ = model.forward(params, batch, remat=False)
        torch.cuda.synchronize()
        rec["one_process_flash"] = _delta(K, before)
        rec["err"] = _rel_err(logits, want)
        rec["logit_max"] = want.abs().max().item()
    del logits
    real = collectives.ppermute
    collectives.ppermute = lambda t, m, name, perm: real(
        t, m, name, [(d, s) for s, d in perm])
    try:
        bad = ring()
    finally:
        collectives.ppermute = real
    if rank == 0:
        rec["fault_err"] = _rel_err(bad, want)
    return rec


def _dist_decode(model, params, prompt, mesh, K, rank) -> dict:
    """(2) prefill DIST_PROMPT tokens and DIST_STEPS decode steps with
    stream_kv under serve_rules(long_context=True) (the cache's sequence
    over the 4 ranks); on rank 0 the same in one process, and the tokens
    held to it."""
    from repro_torch.dist.sharding import serve_rules, use_mesh

    def generate():
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      max_seq=DIST_PROMPT + DIST_STEPS,
                                      cache_dtype=torch.float32)
        rows = [logits[:, -1].float()]
        del logits
        toks = [rows[0].argmax(-1, keepdim=True).to(torch.int32)]
        for i in range(DIST_STEPS):
            lg, cache = model.decode_step(params, cache, toks[-1],
                                          DIST_PROMPT + i, stream_kv=True)
            rows.append(lg[:, -1].float())
            toks.append(rows[-1].argmax(-1, keepdim=True).to(torch.int32))
        return torch.cat(toks, dim=1), rows

    link = mesh.transport
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), use_mesh(mesh, serve_rules(long_context=True)):
        toks, _ = generate()
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "host_bytes": link.host_bytes - host0[0],
           "host_s": link.host_s - host0[1], "flash": _delta(K, before),
           "tokens": toks.tolist()}
    _same_on_ranks("the decode ring's tokens", rec["tokens"])
    if rank == 0:
        with torch.no_grad():
            want, rows = generate()
        rec["want"] = want.tolist()
        rec["note"] = _hold_tokens("dist decode ring", rec["tokens"],
                                   rec["want"], lambda b, j: rows[j][b])
    return rec


def _dist_moe(device) -> dict:
    """(3) the shard_map MoE on a (2, 2) ("data", "model") mesh: output
    against moe_reference, expert-weight gradients against the global
    dispatch's."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import compat
    from repro_torch.dist.sharding import train_rules, use_mesh
    from repro_torch.models import module
    from repro_torch.models.moe import moe_apply, moe_reference, moe_spec

    cfg = dataclasses.replace(get_arch(DIST_MOE).reduced(),
                              compute_dtype="float32", capacity_factor=8.0,
                              moe_dispatch="shardmap")
    mesh = compat.make_mesh((2, 2), ("data", "model"), device=device)
    params = module.init(torch.Generator().manual_seed(0), moe_spec(cfg),
                         device=device)
    x = (torch.randn(4, 8, cfg.d_model, generator=torch.Generator()
                     .manual_seed(0)) * 0.3).to(device)
    keys = ("w_gate", "w_up", "w_down")

    def run(dispatch, on_mesh):
        live = module.tree_map(lambda p: p.detach().requires_grad_(), params)
        c = dataclasses.replace(cfg, moe_dispatch=dispatch)
        with use_mesh(mesh if on_mesh else None,
                      train_rules() if on_mesh else None):
            y, aux = moe_apply(c, live, x)
        (y ** 2).sum().backward()
        return y.detach(), aux.detach(), [live[k].grad for k in keys]

    y, aux, grads = run("shardmap", True)
    _, _, want = run("global", False)
    with torch.no_grad():
        ref = moe_reference(cfg, params, x)
    _same_on_ranks("the shard_map MoE's output",
                   [_checksum([y, aux]), _checksum(grads)])
    return {"transport": mesh.transport.describe(),
            "err": (y - ref).abs().max().item(), "aux": aux.item(),
            "grad_err": {k: (g - w).abs().max().item()
                         for k, g, w in zip(keys, grads, want)}}


def dist_child(argv) -> int:
    """``python3 chip_smoke.py --dist-child RANK WORLD URL OUT``: one rank
    of phase_dist's (1)-(3) on cuda:0, joined over gloo at URL; writes its
    report to OUT.RANK.json."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import compat
    from repro_torch.models import build_model, module

    rank, world, url, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    K = _kernels()
    device = compat.init_process_group(
        DIST_DEVICE, backend="gloo", init_method=url, rank=rank,
        world_size=world, timeout_s=DIST_GROUP_TIMEOUT_S)
    mesh = compat.make_mesh((world,), ("model",), device=device)
    cfg = dataclasses.replace(get_arch(DIST_ARCH), compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    checksum = _checksum(module.leaves(params))
    _same_on_ranks("the params' checksum", checksum)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, DIST_SEQ), generator=gen,
                           dtype=torch.int32).to(device)
    rep = {"rank": rank, "params_checksum": checksum,
           "transport": mesh.transport.describe()}
    rep["ring"] = _dist_ring(model, params, {"tokens": tokens}, mesh, K,
                             rank)
    torch.cuda.empty_cache()
    rep["decode"] = _dist_decode(model, params, tokens[:, :DIST_PROMPT],
                                 mesh, K, rank)
    del params
    torch.cuda.empty_cache()
    rep["moe"] = _dist_moe(device)
    rep["launches"] = launch_counts(K)
    Path(f"{out}.{rank}.json").write_text(json.dumps(rep))
    torch.distributed.destroy_process_group()
    return 0


def dp_child(argv) -> int:
    """``python3 chip_smoke.py --dp-child LAYERS ARGS...``:
    ``launch.train.main(ARGS)`` with the arch cut to LAYERS layers at fp32
    compute; prints a ``DP_CHILD {json}`` line: its flash launches and,
    under --data-parallel, the mesh's transport and host staging."""
    import dataclasses

    from repro_torch.dist import compat
    from repro_torch.launch import train as launch

    K = _kernels()
    layers, args = int(argv[0]), argv[1:]
    full, make = launch.get_arch, compat.make_mesh
    launch.get_arch = lambda name: dataclasses.replace(
        full(name), n_layers=layers, compute_dtype="float32")
    meshes = []

    def made(*a, **kw):
        meshes.append(make(*a, **kw))
        return meshes[-1]

    compat.make_mesh = made
    launch.main(args)
    rep = {"launches": launch_counts(K)}
    if meshes:
        link = meshes[0].transport
        rep.update(transport=link.describe(), host_bytes=link.host_bytes,
                   host_s=link.host_s)
    print("DP_CHILD " + json.dumps(rep))
    return 0


def _children(argvs, envs, label) -> list:
    """Run child processes of this script together; kill them all at the
    first failure or at the deadline, and fail the phase then.  Returns
    their standard outputs."""
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               *argv], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in zip(argvs, envs)]
    deadline = time.monotonic() + DIST_DEADLINE_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [(p.wait(), p.stdout.read(), p.stderr.read()) for p in procs]
    for i, (rc, out, err) in enumerate(outs):
        if rc != 0:
            raise RuntimeError(f"dist: {label} child {i} exited {rc}: "
                               f"{out[-1500:]} {err[-3000:]}")
    return [out for _, out, _ in outs]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _add(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] += v


def _dist_ranks(counts, card) -> dict:
    """(1)-(3) in DIST_RANKS children on cuda:0 over gloo."""
    import os

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/rank"
        argvs = [["--dist-child", str(r), str(DIST_RANKS),
                  f"file://{tmp}/rendezvous", out]
                 for r in range(DIST_RANKS)]
        t0 = time.perf_counter()
        _children(argvs, [dict(os.environ)] * DIST_RANKS, "ring")
        wall = time.perf_counter() - t0
        reps = [json.loads(Path(f"{out}.{r}.json").read_text())
                for r in range(DIST_RANKS)]
    for rep in reps:
        _add(counts, rep["launches"])
    r0 = reps[0]
    print(f"dist: {DIST_RANKS} ranks on {DIST_DEVICE} in {wall:.1f} s, "
          f"transport {sorted({r['transport'] for r in reps})}; {DIST_ARCH} "
          f"seed-0 "
          f"fp32 params checksum {r0['params_checksum']} on every rank; "
          f"{card}")
    for rep in reps:
        ring = rep["ring"]
        print(f"dist: ring forward rank {rep['rank']}: B=1 S={DIST_SEQ} "
              f"wall {ring['wall_s']:.2f} s, {ring['host_bytes']} bytes "
              f"staged through the host in {ring['host_s']:.3f} s, peak "
              f"device memory {ring['peak_bytes'] / 2**30:.2f} GiB, flash "
              f"launches {json.dumps(ring['flash'])}; {card}")
        if any(ring["flash"].values()):
            raise RuntimeError(f"dist: the ring forward launched "
                               f"{ring['flash']}")
    ring = r0["ring"]
    print(f"dist: ring logits against the one-process forward through the "
          f"flash kernel ({json.dumps(ring['one_process_flash'])}): "
          f"{ring['err']:.3g} of the largest logit {ring['logit_max']:.4g} "
          f"(bound {MODEL_TOL['float32']}); the 4 ranks' logits "
          f"{'bit-equal' if ring['ranks_bit_equal'] else 'DIFFER'}; "
          f"planted fault (every rotation the wrong way round) "
          f"{ring['fault_err']:.3g}; {card}")
    _gate(DIST_ARCH, "ring logits from the flash forward", ring["err"],
          "float32")
    if not ring["ranks_bit_equal"]:
        raise RuntimeError("dist: the ranks' ring logits differ")
    if not ring["fault_err"] > MODEL_TOL["float32"]:
        raise RuntimeError(f"dist: the bound misses the planted rotation "
                           f"fault ({ring['fault_err']:.3g})")
    dec = r0["decode"]
    print(f"dist: decode ring, prefill {DIST_PROMPT} + {DIST_STEPS} steps "
          f"with stream_kv, cache_seq over {DIST_RANKS} ranks: rank 0 wall "
          f"{dec['wall_s']:.2f} s, {dec['host_bytes']} bytes staged in "
          f"{dec['host_s']:.3f} s, flash launches "
          f"{json.dumps(dec['flash'])}; fp32 tokens against one process: "
          f"{dec['note']}; {card}")
    moe = r0["moe"]
    worst = max(moe["grad_err"].values())
    print(f"dist: shard_map MoE {DIST_MOE} reduced on (2, 2) ('data', "
          f"'model'), transport {moe['transport']}: output {moe['err']:.3g} "
          f"from moe_reference, expert gradients from the global dispatch "
          f"{json.dumps(moe['grad_err'])} (bound {DIST_MOE_TOL}); aux "
          f"{moe['aux']:.6f}; {card}")
    if not (moe["err"] <= DIST_MOE_TOL and worst <= DIST_MOE_TOL):
        raise RuntimeError(f"dist: the shard_map MoE {moe}")
    return {"ring_wall_s": [r["ring"]["wall_s"] for r in reps],
            "ring_host_bytes": [r["ring"]["host_bytes"] for r in reps],
            "ring_err": ring["err"], "fault_err": ring["fault_err"],
            "decode_wall_s": dec["wall_s"], "moe_err": moe["err"],
            "moe_grad_err": worst}


def _dist_dp_nccl(K, device, card, launcher) -> dict:
    """(4a) launch.train --data-parallel in process, a world of one on
    NCCL, phase 9's launcher argv: the losses against that run's, the warm
    step and tokens/s beside its, the grad all-reduce's time by events."""
    from repro_torch.dist import collectives, compat
    from repro_torch.launch import train as launch

    spans, meshes = [], []
    reduce, make = collectives.reduce_sum_, compat.make_mesh

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        reduce(*a, **kw)
        end.record()
        spans.append((start, end))

    def made(*a, **kw):
        meshes.append(make(*a, **kw))
        return meshes[-1]

    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--seq-len",
            str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--warmup",
            str(TRAIN_WARMUP), "--device", str(device), "--data-parallel"]
    collectives.reduce_sum_, compat.make_mesh = timed, made
    try:
        log, _ = _cli(launch.main, argv)
    finally:
        collectives.reduce_sum_, compat.make_mesh = reduce, make
    torch.cuda.synchronize()
    reduce_ms = [s.elapsed_time(e) for s, e in spans]
    losses = [m["loss"] for m in log]
    want = launcher["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, want))
    step_s = float(np.median([m["step_time_s"] for m in log[1:]]))
    print(f"dist: launch.train --data-parallel, a world of one, transport "
          f"{meshes[0].transport.describe()}: {TRAIN_ARCH} B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ} {TRAIN_STEPS} steps, losses "
          f"{[round(x, 6) for x in losses]} against the plain launcher's: "
          f"{'bit-equal' if losses == want else f'relative {rel:.3g}'} "
          f"(bound {DP_TOL['nccl']}); warm step {step_s * 1e3:.1f} ms = "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:.0f} tokens/s against "
          f"{launcher['step_ms']:.1f} ms = {launcher['tokens_s']:.0f}; the "
          f"grad all-reduce {np.median(reduce_ms):.3f} ms a step by events "
          f"({len(reduce_ms)} calls); {card}")
    if len(losses) != len(want) or not rel <= DP_TOL["nccl"]:
        raise RuntimeError(f"dist: --data-parallel losses {losses}, the "
                           f"plain launcher's {want}")
    return {"dp_nccl_rel": rel, "dp_nccl_step_ms": step_s * 1e3,
            "dp_allreduce_ms": float(np.median(reduce_ms))}


def _dist_dp_gloo(counts, card) -> dict:
    """(4b) two --data-parallel ranks over gloo on cuda:0 (torchrun's
    environment) and one process, DP_LAYERS layers at fp32 compute, the
    same global batch: the losses within DP_TOL['gloo']."""
    import os

    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        args = ["--arch", TRAIN_ARCH, "--steps", str(DP_STEPS), "--seq-len",
                str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--warmup",
                str(TRAIN_WARMUP), "--device", DIST_DEVICE]
        dp = args + ["--data-parallel", "--dist-backend", "gloo",
                     "--metrics-out", f"{tmp}/dp.json"]
        one = args + ["--metrics-out", f"{tmp}/one.json"]
        envs = [{**os.environ, "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port), "RANK": str(r),
                 "WORLD_SIZE": "2", "LOCAL_RANK": "0"} for r in range(2)]
        t0 = time.perf_counter()
        outs = _children([["--dp-child", str(DP_LAYERS), *dp]] * 2
                         + [["--dp-child", str(DP_LAYERS), *one]],
                         envs + [dict(os.environ)], "data-parallel")
        wall = time.perf_counter() - t0
        got = [m["loss"] for m in json.loads(Path(f"{tmp}/dp.json")
                                             .read_text())]
        want = [m["loss"] for m in json.loads(Path(f"{tmp}/one.json")
                                              .read_text())]
    reps = [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("DP_CHILD "))[9:])
            for out in outs]
    for rep in reps:
        _add(counts, rep["launches"])
    rel = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    print(f"dist: launch.train --data-parallel, 2 ranks on {DIST_DEVICE}, "
          f"transport {reps[0]['transport']}, {reps[0]['host_bytes']} bytes "
          f"staged through the host in {reps[0]['host_s']:.2f} s (rank 0): "
          f"{TRAIN_ARCH} at {DP_LAYERS} of 26 layers, fp32, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ} {DP_STEPS} steps, losses {got} against one "
          f"process's {want}: relative {rel:.3g} (bound {DP_TOL['gloo']}); "
          f"{wall:.1f} s for the three children; {card}")
    if len(got) != DP_STEPS or not rel <= DP_TOL["gloo"]:
        raise RuntimeError(f"dist: 2-rank losses {got}, one process {want}")
    return {"dp_gloo_rel": rel}


def phase_dist(K, device, card: str, launcher: dict) -> tuple:
    """The dist slice on the card (module docstring, phase 10).  Returns
    (path label -> launch counts of the path's run, the numbers)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    zero_counts(K)
    counts = launch_counts(K)
    timing = _dist_ranks(counts, card)
    torch.cuda.empty_cache()
    timing.update(_dist_dp_nccl(K, device, card, launcher))
    _add(counts, launch_counts(K))
    torch.cuda.empty_cache()
    timing.update(_dist_dp_gloo(counts, card))
    print(f"dist: launches of the dist path (every rank and child) "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    print(f"dist: phase {time.perf_counter() - t_phase:.1f} s")
    return {"dist": counts}, timing


def _time_ms(fn, operand_sets, reps: int = 3) -> float:
    """Milliseconds per call, CUDA events over ``reps`` sweeps of
    ``operand_sets`` after one warm sweep."""
    for ops_ in operand_sets:
        fn(*ops_)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for ops_ in operand_sets:
            fn(*ops_)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(operand_sets))


def _operand_sets(shapes, nbytes, device, gen) -> list:
    """Enough distinct operand sets to exceed the L2 cache together."""
    count = max(2, -(-2 * L2_BYTES // nbytes))
    return [tuple(torch.randn(*s, generator=gen, device=device)
                  for s in shapes) for _ in range(count)]


def _best(fns, sets) -> dict:
    """Each function timed twice, in turns; the lower of the two."""
    times = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            times[name].append(_time_ms(fn, sets))
    return {name: min(t) for name, t in times.items()}


def _device_ms(fn, sets):
    """Milliseconds per call that the card spends in kernels, from the
    profiler over one sweep — the call's time without the host's launch
    cost.  None when the profiler records no device activity."""
    busy = _device_busy_s(lambda: [fn(*ops_) for ops_ in sets])
    return busy * 1e3 / len(sets) if busy > 0 else None


def _fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f} us"


def _bound(flops, nbytes, card, route: str = "fp32") -> tuple:
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flops`` operations on ``nbytes`` of device memory traffic, the
    operations at the peak of their route: fp32 FMAs outside the tensor
    cores, or "3xtf32", three TF32 tensor-core products for each fp32-grade
    one."""
    fp32, tf32, bandwidth = card_peaks(card)
    ops_s = flops / fp32 if route == "fp32" else 3 * flops / tf32
    bound_by = "operations" if ops_s >= nbytes / bandwidth else "bytes"
    return max(ops_s, nbytes / bandwidth) * 1e3, bound_by


def _measure(label, fns, sets, flops, nbytes, card,
             route: str = "fp32") -> dict:
    """Time each function (events and device time) and print one line
    with the bound of the work: the larger of operations over the peak of
    their route (``_bound``) and bytes (each input read once, the output
    written once) over the memory rate."""
    t = _best(fns, sets)
    dev = {name: _device_ms(fn, sets) for name, fn in fns.items()}
    bound, bound_by = _bound(flops, nbytes, card, route)
    print(f"times: {label}: " + ", ".join(
        f"{v} {ms * 1e3:.1f} us (device {_fmt_us(dev[v])})"
        for v, ms in t.items())
        + f"; bound {bound * 1e3:.2f} us ({bound_by}, {route}); {card}")
    return {"ms": t, "device_ms": dev, "bound_ms": bound,
            "bound_by": bound_by, "nbytes": nbytes}


def _bandwidth(label, res, card) -> dict:
    """Print the device-memory rate each timed function achieved: the
    bytes the work must move (each input read once, each output written
    once) over its device time, and that as a share of the card's peak
    rate.  Returns function -> share."""
    peak = card_peaks(card)[2]
    rates = {name: res["nbytes"] / (ms * 1e-3)
             for name, ms in res["device_ms"].items() if ms}
    print(f"times: {label}: achieved by device time " + ", ".join(
        f"{name} {rate / 1e12:.2f} TB/s ({100 * rate / peak:.1f}%)"
        for name, rate in rates.items())
        + f" of {peak / 1e12:.2f} TB/s; {card}")
    return {name: rate / peak for name, rate in rates.items()}


def _record(name, schedule, shape, res, worst, by_path) -> dict:
    """One kernel's record; ``launches`` sums the paths' runs, and
    ``launches_by_path`` gives each path's own count."""
    return {"name": name, "route": "cuda", "source": source_of(name),
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": worst[name],
            "ms": res["ms"][schedule], "plain_ms": res["ms"]["plain"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            "library_ms": res["ms"].get("library"),
            "device_ms": res["device_ms"][schedule],
            "schedule": schedule, "shape": list(shape), "dtype": "float32"}


def _times_mm_mv(mm, mv, device, gen, card, worst, by_path) -> list:
    """One matmul record per main-path product shape, for the faster hand
    schedule there, with both schedules' times beside it; one matvec
    record."""
    records = []
    for m, n, k in WORK_MM + WORK_MM_DAG + WORK_MM_ATT:
        nbytes = 4 * (m * k + k * n + m * n)
        fns = {f"pallas_{bm}": (lambda a, b, _s=(bm, bn, bk):
                                mm.matmul(a, b, bm=_s[0], bn=_s[1], bk=_s[2]))
               for bm, bn, bk in mm.SCHEDULES}
        fns.update(plain=mm.plain, library=torch.matmul)
        res = _measure(f"matmul fp32 [{m},{k}]x[{k},{n}]", fns,
                       _operand_sets([(m, k), (k, n)], nbytes, device, gen),
                       2.0 * m * n * k, nbytes, card)
        hand = [v for v in fns if v.startswith("pallas")]
        rec = _record("matmul", min(hand, key=res["ms"].get), (m, n, k), res,
                      worst, by_path)
        rec["schedules"] = {v: {"ms": res["ms"][v],
                                "device_ms": res["device_ms"][v]}
                            for v in hand}
        records.append(rec)
    for m, k in WORK_MV:
        nbytes = 4 * (m * k + k + m)
        res = _measure(f"matvec fp32 [{m},{k}]x[{k}]",
                       {"pallas_128": mv.matvec, "plain": mv.plain,
                        "library": torch.mv},
                       _operand_sets([(m, k), (k,)], nbytes, device, gen),
                       2.0 * m * k, nbytes, card)
        records.append(_record("matvec", "pallas_128", (m, k), res, worst,
                               by_path))
    return records


def _times_conv_pool(mc, mp, device, gen, card, worst, by_path) -> list:
    import torch.nn.functional as F

    from repro_torch.kernels import cudnn_fp32

    records = []
    for m, n, r in WORK_MC:
        om, on = m - r + 1, n - r + 1
        nbytes = 4 * (m * n + r * r + om * on)
        fns = {f"pallas_{bm}": (lambda a, w, _b=bm: mc.conv2d(a, w, bm=_b,
                                                              bn=_b))
               for bm, _ in mc.SCHEDULES}
        fns.update(plain=mc.plain, library=lambda a, w: F.conv2d(
            a[None, None], w[None, None])[0, 0])
        label = f"conv2d fp32 [{m},{n}] r={r}"
        with cudnn_fp32():            # the library call in full fp32
            res = _measure(label, fns,
                           _operand_sets([(m, n), (r, r)], nbytes, device,
                                         gen),
                           2.0 * om * on * r * r, nbytes, card)
        shares = _bandwidth(label, res, card)
        rec = _record("conv2d", "pallas_32", (m, n, r), res, worst, by_path)
        rec["bandwidth_share"] = shares.get("pallas_32")
        rec["geometry"] = mc.geometry(m, n, r, 4, 32)._asdict()
        records.append(rec)
    for idx, (m, n, r, s) in enumerate(WORK_MP):
        om, on = (m - r) // s + 1, (n - r) // s + 1
        nbytes = 4 * (m * n + om * on)
        fns = {f"pallas_{bm}": (lambda a, _b=bm: mp.maxpool(
                   a, r=r, s=s, bm=_b, bn=_b)) for bm, _ in mp.SCHEDULES}
        fns.update(plain=lambda a: mp.plain(a, r=r, s=s),
                   library=lambda a: F.max_pool2d(a[None, None], r, s)[0, 0])
        label = f"maxpool fp32 [{m},{n}] r={r} s={s}"
        res = _measure(label, fns,
                       _operand_sets([(m, n)], nbytes, device, gen),
                       float(om * on * r * r), nbytes, card)
        shares = _bandwidth(label, res, card)
        if idx == 0:
            rec = _record("maxpool", "pallas_32", (m, n, r, s), res, worst,
                          by_path)
            rec["bandwidth_share"] = shares.get("pallas_32")
            rec["geometry"] = mp.geometry(m, n, r, s, 4, 32)._asdict()
            records.append(rec)
    return records


def _times_blur(bk, device, gen, card, worst, by_path) -> list:
    """The blur kernels at the workloads' planes: the fused kernel and the
    separable pair at both tiles beside the plain version, ``F.avg_pool2d``
    (one PyTorch call of the same function) and the ``conv`` host schedule
    (cuDNN, which pins TF32 off itself); then each separable pass alone beside its plain
    version and its ``F.avg_pool2d``.  Bounds count each input read once
    and each output written once.  The five host schedules' times follow,
    for information.  Records hold [1024,1024] at tile 128."""
    import torch.nn.functional as F

    from repro_torch.kernels.blur import ops

    records = []
    for idx, (m, n) in enumerate(WORK_BLUR):
        om, on = m - 2, n - 2
        nbytes = 4 * (m * n + om * on)
        sets = _operand_sets([(m, n)], nbytes, device, gen)
        fns = {}
        for bm, bn in bk.SCHEDULES:
            for sep in (False, True):
                fns[f"t{bm} {'separable' if sep else 'direct'}"] = (
                    lambda a, _t=(bm, bn), _s=sep: bk.blur(
                        a, bm=_t[0], bn=_t[1], separable=_s))
        fns.update(plain=bk.plain, library=lambda a: F.avg_pool2d(
            a[None, None], 3, stride=1)[0, 0], conv=ops.HOST_SCHEDULES["conv"])
        whole = _measure(f"blur fp32 [{m},{n}]", fns, sets, 9.0 * om * on,
                         nbytes, card)
        h_bytes = 4 * (m * n + m * on)
        passes = {
            "blur_h": _measure(
                f"blur pass h fp32 [{m},{n}] -> [{m},{on}]",
                {"blur_h": bk.blur_h, "plain": bk.plain_h,
                 "library": lambda a: F.avg_pool2d(
                     a[None, None], (1, 3), stride=1)[0, 0]},
                sets, 3.0 * m * on, h_bytes, card),
            "blur_v": _measure(
                f"blur pass v fp32 [{m},{on}] -> [{om},{on}]",
                {"blur_v": bk.blur_v, "plain": bk.plain_v,
                 "library": lambda h: F.avg_pool2d(
                     h[None, None], (3, 1), stride=1)[0, 0]},
                [(bk.blur_h(a),) for (a,) in sets], 3.0 * om * on,
                4 * (m * on + om * on), card)}
        shares = {"t128 direct": _bandwidth(f"blur fp32 [{m},{n}]", whole,
                                            card).get("t128 direct")}
        for name, res in passes.items():
            shares[name] = _bandwidth(f"blur pass {name[-1]} fp32 [{m},{n}]",
                                      res, card).get(name)
        t = _best(ops.HOST_SCHEDULES, sets)
        print(f"times: blur host schedules fp32 [{m},{n}] (TF32 as PyTorch "
              f"sets it): " + ", ".join(f"{v} {ms * 1e3:.1f} us"
                                        for v, ms in t.items()))
        if idx == 0:
            rec = _record("blur_direct", "t128 direct", (m, n), whole, worst,
                          by_path)
            rec["bandwidth_share"] = shares["t128 direct"]
            rec["geometry"] = bk.geometry((3, 3), m, n, 4, 128)._asdict()
            records.append(rec)
            for name, res in passes.items():
                rec = _record(name, name, (m, n), res, worst, by_path)
                rec["schedule"] = "t128"
                rec["bandwidth_share"] = shares[name]
                rec["geometry"] = bk.geometry(
                    bk._TAPS[name], m, n if name == "blur_h" else on, 4,
                    128)._asdict()
                records.append(rec)
    return records


def _visible_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs an [s, s] attention sees, counted exactly:
    the work that remains once the kernels skip masked tiles."""
    q = torch.arange(s)
    lo = (q - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(q)
    hi = q if causal else torch.full_like(q, s - 1)
    return int((hi - lo + 1).clamp(min=0).sum())


def _fa_sets(fa, dims, kw, device, gen) -> tuple:
    """Forward operand sets (q, k, v) and backward ones (q, k, v, do, lse,
    delta), together past the L2 cache, the residuals from the forward."""
    b, h, kv, s, d = dims
    count = max(2, -(-2 * L2_BYTES // (8 * (b * h + b * kv) * s * d)))
    fwd, bwd = [], []
    for _ in range(count):
        q, k, v, do = _fa_inputs(b, h, kv, s, d, torch.float32, device, gen)
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        fwd.append((q, k, v))
        bwd.append((q, k, v, do, lse, (do * o).sum(dim=-1)))
    return fwd, bwd


def _sdpa(causal, window, s, device) -> tuple:
    """``scaled_dot_product_attention`` forward and forward+backward, fp32,
    GQA, the window as a boolean mask: the library yardstick, called here
    only."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ref

    mask = None if window == 0 else ref.visible(
        s, s, causal=causal, window=window, sk_orig=0, device=device)

    def fwd(q, k, v):
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)

    def fwd_bwd(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fwd(*leaves), leaves, do)

    return fwd, fwd_bwd


def _times_flash_attention(fa, device, gen, card, worst, by_path) -> list:
    """The four kernels at FA_SHAPES, each beside its plain version and its
    bound over the visible pairs; the forward beside SDPA's forward, and
    the op's forward+backward (the lse forward, delta, the two backward
    kernels, the GQA sum) beside SDPA's.  Records hold attention_block's
    numbers, with every shape's under ``shapes``."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    per_shape = {}
    for label, b, h, kv, s, d, causal, window in FA_SHAPES:
        kw = {"causal": causal, "window": window, "bq": 256, "bk": 256}
        pkw = {"causal": causal, "window": window}
        fwd_sets, bwd_sets = _fa_sets(fa, (b, h, kv, s, d), kw, device, gen)
        fb_sets = [t[:4] for t in bwd_sets]
        pairs = _visible_pairs(s, causal, window)
        work = float(b * h * pairs * d)
        q_bytes, kv_bytes, row_bytes = (4 * b * h * s * d, 4 * b * kv * s * d,
                                        4 * b * h * s)
        tag = (f"fp32 {label} B={b} H={h} KV={kv} S={s} D={d} "
               f"causal={causal} window={window}, {pairs} visible pairs of "
               f"{s * s}")
        sdpa_fwd, sdpa_fwd_bwd = _sdpa(causal, window, s, device)
        # every kernel runs its products 3xTF32 on the tensor cores: its
        # bound is that route's, the fp32 FMA bound beside it
        fwd_bytes = 2 * q_bytes + 2 * kv_bytes
        fwd = _measure(
            f"flash attention forward {tag}",
            {"flash_attention": lambda q, k, v: fa.flash_attention(
                q, k, v, **kw),
             "flash_attention_fwd": lambda q, k, v: fa.flash_attention_fwd(
                 q, k, v, **kw),
             "plain": lambda q, k, v: fa.plain_fwd(q, k, v, **pkw),
             "library": sdpa_fwd},
            fwd_sets, 4 * work, fwd_bytes, card, route="3xtf32")
        bound, bound_by = _bound(4 * work, fwd_bytes + row_bytes, card,
                                 "3xtf32")
        fwd_lse = dict(fwd, bound_ms=bound, bound_by=bound_by)
        for res, nbytes in ((fwd, fwd_bytes), (fwd_lse,
                                               fwd_bytes + row_bytes)):
            res.update(route="3xtf32", bound_fp32_ms=_bound(
                4 * work, nbytes, card)[0])
        print(f"times: flash attention forward {tag}: bound "
              f"{fwd['bound_ms'] * 1e3:.2f} us (3xtf32), "
              f"{fwd['bound_fp32_ms'] * 1e3:.2f} us on fp32 FMAs; with lse "
              f"{fwd_lse['bound_ms'] * 1e3:.2f} us, "
              f"{fwd_lse['bound_fp32_ms'] * 1e3:.2f} us; {card}")
        bwd_in = 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
        dq = _measure(
            f"flash attention backward dq {tag}",
            {"flash_attention_bwd_dq": lambda *a: fa.flash_attention_bwd_dq(
                *a, **kw),
             "plain": lambda *a: fa.plain_bwd_dq(*a, **pkw)},
            bwd_sets, 6 * work, bwd_in + q_bytes, card, route="3xtf32")
        dkv = _measure(
            f"flash attention backward dk/dv {tag}",
            {"flash_attention_bwd_dkv":
                lambda *a: fa.flash_attention_bwd_dkv(*a, **kw),
             "plain": lambda *a: fa.plain_bwd_dkv(*a, **pkw)},
            bwd_sets, 8 * work, bwd_in + 2 * q_bytes, card, route="3xtf32")

        def op_fwd_bwd(q, k, v, do):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(fa_ops.attention(*leaves, **kw),
                                       leaves, do)

        both = _measure(f"flash attention op forward+backward {tag}",
                        {"op": op_fwd_bwd, "library": sdpa_fwd_bwd},
                        fb_sets, 18 * work, 3 * q_bytes + 4 * kv_bytes, card)
        # SDPA's backward: its forward+backward less its forward, by
        # events and by the device time of the kernels each launches
        dev_fb, dev_f = both["device_ms"]["library"], \
            fwd["device_ms"]["library"]
        sdpa_bwd = {"sdpa_bwd_ms": both["ms"]["library"]
                    - fwd["ms"]["library"],
                    "sdpa_bwd_device_ms": None if dev_fb is None
                    or dev_f is None else dev_fb - dev_f,
                    "op_fwd_bwd_ms": both["ms"]["op"],
                    "sdpa_fwd_bwd_ms": both["ms"]["library"]}
        print(f"times: SDPA backward {tag}: "
              f"{sdpa_bwd['sdpa_bwd_ms'] * 1e3:.1f} us by events (device "
              f"{_fmt_us(sdpa_bwd['sdpa_bwd_device_ms'])}); {card}")
        for res, flops in ((dq, 6 * work), (dkv, 8 * work)):
            res.update(sdpa_bwd, route="3xtf32", bound_fp32_ms=_bound(
                flops, res["nbytes"], card)[0])
        per_shape[label] = {"flash_attention": fwd,
                            "flash_attention_fwd": fwd_lse,
                            "flash_attention_bwd_dq": dq,
                            "flash_attention_bwd_dkv": dkv}
        del fwd_sets, bwd_sets, fb_sets
        torch.cuda.empty_cache()
    main_label, *dims = FA_SHAPES[0]
    records = []
    for name in per_shape[main_label]:
        rec = _record(name, name, dims[:5], per_shape[main_label][name],
                      worst, by_path)
        rec["shapes"] = {}
        for label, shapes in per_shape.items():
            res = shapes[name]
            rec["shapes"][label] = {
                "ms": res["ms"][name], "device_ms": res["device_ms"][name],
                "plain_ms": res["ms"]["plain"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res["ms"].get("library"),
                **{key: res[key] for key in (
                    "route", "bound_fp32_ms", "sdpa_bwd_ms",
                    "sdpa_bwd_device_ms", "op_fwd_bwd_ms", "sdpa_fwd_bwd_ms")
                   if key in res}}
        if "route" in per_shape[main_label][name]:
            rec["route_note"] = "3xTF32 on mma.sync tensor cores"
            rec["bound_fp32_ms"] = per_shape[main_label][name]["bound_fp32_ms"]
        records.append(rec)
    return records


def phase_times(K, device, card: str, worst: dict, by_path: dict) -> list:
    gen = torch.Generator(device=device).manual_seed(2)
    records = _times_mm_mv(K["matmul"], K["matvec"], device, gen, card,
                           worst, by_path)
    records += _times_conv_pool(K["conv2d"], K["maxpool"], device, gen, card,
                                worst, by_path)
    records += _times_blur(K["blur"], device, gen, card, worst, by_path)
    records += _times_flash_attention(K["flash_attention"], device, gen, card,
                                      worst, by_path)
    return records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no port beside this script ({src / 'repro_torch'}"
              " is missing); run it from a checkout of the repo",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    if sys.argv[1:2] == ["--contention-child"]:
        return contention_child(sys.argv[2])
    if sys.argv[1:2] == ["--train-child"]:
        return train_child(sys.argv[2:])
    if sys.argv[1:2] == ["--dist-child"]:
        return dist_child(sys.argv[2:])
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(sys.argv[2:])
    from repro_torch.kernels import build

    # TF32 stays at PyTorch's defaults (off for matmul, on for cuDNN): the
    # port pins fp32 around its own cuDNN calls
    K = _kernels()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    line = card_line()
    name = torch.cuda.get_device_name(0)
    print(line)                  # the card's name and power limit
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)")
    phase_build(build)
    worst = phase_kernels(K, device)
    by_path = phase_main_path(K, device)
    by_path.update(phase_bench(K, line))
    by_path.update(phase_paper(K, line))
    counts, model_timing = phase_models(K, device, line)
    by_path.update(counts)
    counts, serve_timing = phase_serve(K, device, line)
    by_path.update(counts)
    counts, train_timing = phase_train(K, device, line)
    by_path.update(counts)
    counts, dist_timing = phase_dist(K, device, line,
                                     train_timing["launcher"])
    by_path.update(counts)
    records = phase_times(K, device, name, worst, by_path)
    for rec in records:
        if rec["name"] == "flash_attention":
            rec["models"] = model_timing
            rec["serve"] = serve_timing
            rec["dist"] = dist_timing
        if rec["name"] in TRAIN_KERNELS:
            rec["train"] = {"launches": by_path["train"][rec["name"]],
                            **train_timing}
    print(line)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
