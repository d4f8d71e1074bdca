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
   B = 1 of the train_4k shape's global batch of 256), at two shapes
   whose backward tiles are wholly visible (D = 128) or end in a sk_orig
   tail (D = 256), and at whisper-medium's two non-causal shapes at D =
   64 over its 1500 frames padded to 1536 (the decoder's cross-attention,
   2048 queries, Sq != Sk; the encoder's self-attention), at 1e-4
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
   before; the contention probe again in two child processes (today's
   spinning wait and thread count), one under the OpenMP runtime's
   default wait policy and one under ``OMP_WAIT_POLICY=PASSIVE``.  Then the
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
   scored on the 250 held out (PAPER_EPOCHS); per combo the five MAEs and
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
   launch counters zeroed just before and read just after: gemma3-1b and
   whisper-medium uncut (whisper: 24 encoder and 24 decoder layers), and
   at full width cut to 2 layers yi-9b, internvl2-26b, nemotron-4-15b
   and deepseek-67b, fp32 parameters from a seeded ``torch.Generator``;
   whisper's 1500 frames and internvl2's 256 patches (rows of d_model,
   standard normal times 0.05, as ``launch.serve`` draws them) in every
   batch.  Each model's ``forward`` at B = 1, S = 4096 tokens (train_4k,
   the batch cut to 1; internvl2's behind its patches) through the hand
   flash-attention kernel and through the plain ``attend_chunked``
   (``use_kernel=False``), in fp32 compute and in the config's bf16: the
   kernel's launches rise by one an attention (``flash_attention``; the
   lse forward by none; whisper 72: encoder, self and cross) and the
   logits agree within MODEL_TOL relative to their largest magnitude,
   top-1 agreement printed.  Then serving: ``prefill`` of two 2048-token
   prompts into a cache of 2048 + 32 (internvl2: 256 + 2048 + 32; the
   same launches as the forward), its logits and every cache leaf held
   against the plain prefill's, and 32 greedy ``decode_step``s (no
   launch) from the first position past the prompt, in fp32 — the decode
   logits held against ``forward``'s at the same positions, that forward
   (2080 tokens, a ragged length the kernel pads, with the same frames
   or patches) against its plain twin — and in bf16 with a bf16 cache.
   Each model's weights are freed before the next one's are made.  Last
   (outside the counted window, the weights made anew from the same
   seed) each forward timed by CUDA events, with an event pair around
   every kernel launch: the kernel's share of the forward's wall; the
   serving run timed (prefill wall, decode tokens/s, peak device memory
   over it; the checks above ran its shapes first); and a planted fault
   (gemma3-1b's window dropped, whisper's encoder and cross-attention
   made causal, the others' causal mask dropped) that must land above
   MODEL_TOL.
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
   uninterrupted run and beside it one that crashes at step 5 (exit 42,
   after the step-4 checkpoint), then one that resumes from it; the
   resumed steps' losses equal the uninterrupted run's bit for bit, or within 1e-6
   relative (which held is printed); (f) the chunked CE's autograd
   Function (``train.step._CESegment``) at whisper-medium's vocabulary of
   51865, fp32: its loss and gradients within CE_TOL of the checkpointed
   autograd segment it replaced, each backward's peak and time printed.
   (a) and (b) also run, B = 1 and seed-0 weights, for TRAIN_GATES:
   whisper-medium uncut over 2048 decoder tokens and 1500 frames (its dq
   and dk/dv at Sq != Sk in the cross-attention; the planted fault makes
   the encoder and cross-attention causal in the backward kernels),
   internvl2-26b at 2 of 48 layers over 256 patches and 2048 tokens, and
   nemotron-4-15b at 2 of 32 layers over 1024 tokens (their fault drops
   the causal mask); each value-and-grad's flash launches held to the
   stack's (the lse forward twice an attention, in the forward and the
   period's recompute, dq and dk/dv once), each gate's peak printed, at
   most two gradient trees alive at once.
10. dist   — the dist slice (``repro_torch.dist``, the shard_map MoE,
   ``launch.train --data-parallel``) on ``torch.distributed``.  (1)-(3)
   run in DIST_RANKS child processes (``--dist-child``) that share
   ``cuda:0`` over gloo, their CUDA tensors staged through host memory
   (NCCL refuses two ranks on one card; ``tools/dist_probe.py``): (1)
   gemma3-1b uncut, seed-0 fp32 weights (their checksum equal on every
   rank), the forward at B = 1, S = DIST_SEQ with ``ring=True`` under a
   4-rank ``("model",)`` mesh and ``train_rules(seq_parallel=True)``:
   the logits within MODEL_TOL["float32"] of the one-process forward
   through the flash kernel (rank 0), bit-equal on every rank, no flash
   launch in a ring layer; a planted fault (every rotation the wrong way
   round) must land above the bound; per rank the wall, the bytes staged
   through the host and their seconds, the peak device memory; (1b) first,
   with no whole leaf alive, the same ring forward over the params held
   as blocks (``dist.sharding.shard_tree``: each rank its block, gathered
   per layer where it is used): its logits bit-equal to (1)'s on every
   rank and within MODEL_TOL of the flash forward, per rank the wall, the
   bytes staged (the gathers' beside (1)'s), the peak and the bytes held;
   (2)
   prefill DIST_PROMPT tokens under ``serve_rules(long_context=True)``, the
   cache cut into each rank's block of its sequence (``cache_seq`` over
   the 4 ranks, a quarter of its bytes a rank, printed) and 4 decode
   steps on the blocks with ``stream_kv`` and with the plain
   ``make_serve_step``: each run's fp32 tokens equal the one-process
   run's (or a top-2 margin within 1e-3); (2b) a blocked decode: gemma3-1b cut to 2 of 26
   layers, fp32, four prompts of DIST_PROMPT tokens and 32 steps through
   ``make_prefill_step``/``make_serve_step`` on a 4-rank ``("data",)``
   mesh under ``serve_rules()``, the tokens and the bf16 cache held as
   each rank's row: the tokens equal one process's (the same margin
   rule), the cache bytes held printed; (3) the shard_map MoE (qwen3-moe reduced, fp32,
   capacity factor 8) on a (2, 2) ``("data", "model")`` mesh: the output
   within 1e-5 of ``moe_reference``, the expert gradients within 1e-5 of
   the global dispatch's.  (4) ``launch.train --data-parallel``: in
   process on a world of one over NCCL with phase 9's launcher argv, the
   losses within 1e-6 of that run's, the warm step and tokens/s beside
   its, a step's gradient all-reduce calls summed by events; then two
   ranks over gloo on
   ``cuda:0`` (``--dp-child``, torchrun's environment) and one process,
   2 of 26 layers at fp32 compute, the losses within 1e-5.  (5) The
   tensor-parallel layers, in the same DIST_RANKS children on a
   ``("model",)`` mesh of 4, gemma3-1b fp32 with its params held as
   blocks (each rank its heads, MLP and vocabulary rows): (5a) the forward
   uncut at B = 1, S = DIST_SEQ under ``train_rules()``: each rank's
   vocabulary block of the logits within MODEL_TOL["float32"] of the
   matching slice of the one-process flash forward (gathered to rank 0),
   the final hidden states bit-equal on every rank, exactly 26 flash
   launches a rank at one head and one KV head; per rank the wall, the
   bytes staged and their seconds, the peak and the bytes held; (5b) one
   ``make_train_step`` step with AdamW at 2 of 26 layers, B = 1, S = 2048,
   on the hand kernels: the loss and every gradient leaf within
   MODEL_TOL["float32"] of the same step in one process, exactly 2 lse
   forward, 2 dq and 2 dk/dv launches a rank (as one process), and a
   planted fault (``reduce_from``'s backward a psum) above the bound;
   (5c) (2b)'s prompts and steps through ``make_prefill_step``/
   ``make_serve_step`` under ``serve_rules()``: the tokens equal (2b)'s
   one-process run's by the margin rule, 2 flash launches a rank.  (5f)
   The global MoE dispatch in DIST_RANKS children of its own
   (``--moe-child``): qwen3-moe-235b-a22b at full width (d_model 4096,
   64/4 heads of 128, 128 experts of 1536, top-8, vocabulary 151936) cut
   to 1 of 94 layers, fp32, S = 512, on a ``("model",)`` mesh of 4 (B =
   1, 32 experts a rank) and on (2, 2) ``("data", "model")`` (B = 2, the
   second row one token repeated so that its data shard overflows its
   experts; 64 experts a rank, the train, prefill and decode steps
   data-parallel regions that route the whole batch), the params held as
   blocks drawn leaf by leaf: the logits, one ``make_train_step`` step's
   loss and every gradient leaf, and the prefill + 4 decode tokens against
   one process's, which rank 0 runs first while the others wait (its
   results on the host, each rank's block sent to it), within
   DIST_TP_REC_TOL; the planted per-shard routing (on (2, 2): the logits
   of a forward inside a data-parallel region of the rows) and the
   experts' ``reduce_from`` made a psum (on 4: a step's MoE gradients)
   above the bound; the (token,
   slot)s dropped routing the whole batch (as one process) and per shard
   (which must differ), the expert bytes held a rank, each rank's step
   peak beside one process's and flash launches equal to its; on (2, 2)
   one more step under ``train_rules(fsdp=True)``, each rank's experts a
   Block over ("model", "data") that the global dispatch computes on its
   blocks of d: its loss and every gradient leaf against one process's
   within DIST_TP_REC_TOL, and the same step with the cotangents entering
   the experts' all-gather unweighted (planted) above it.  (5g)
   xlstm-1.3b's first layer (an mLSTM) at full width, B = 2, S = 512, in
   DIST_ROWS_RANKS children (``--rows-child``) on a ``("model",)`` mesh of
   8, which its 4 heads do not divide: (5e)'s checks, with C held as each
   rank's 128 of its 1024 value rows, and the intra-chunk q.k on each
   rank's one of the 8 (batch, head) pairs against the whole einsum on
   the same inputs (bound DIST_TP_REC_TOL); it prints the bytes each
   part staged through the host and those its all-to-alls received a
   rank (each rank's blocks of w_up's and w_down's parts, regrouped from
   the blocks held).  (5d) and (5e) print the
   clipped blocked AdamW step's global norm: its peak bytes above what
   was allocated when it began, beside one period's largest stacked
   gradient leaf gathered whole.  The
   decode ring (2) reads each rank's vocabulary block of the logits
   gathered whole.  The counters are zeroed just before; every rank and
   child reports its launches, and their sum is the ``dist`` path's.
11. launch — the launch analysis stack (``repro_torch.launch.{mesh,
   hlo_analysis,roofline,dryrun,profile}``) and ``autotune.tuner``.  The
   dry-run runs in a child process (``--launch-child``) started just
   before the dist phase (it traces on the host beside it, and beside (a)
   and (c)): gemma3-1b x ``train_4k`` (through ``run_cell``,
   its profile's top rows kept) and ``decode_32k`` at both meshes (the
   CLI, ``--both-meshes``), each on a fake process group of the mesh's
   ranks with fake CPU tensors; every cell ``ok`` with the reference's
   result keys and skip records, ``model_flops`` equal to 6 N_active B S
   (train) or 2 N_active B (decode) from ``count_params_split``, no kernel
   launched and CUDA never initialised in the child; each cell's
   report line, memory per rank in the blocked layout (``layout:
   "blocked"``) beside PR 26's figure with every leaf whole and the
   sharded argument figure, and the profile's top rows for ``train_4k``
   are printed, with FLOPs and collective bytes a rank; the attention
   heads, MLP and vocabulary computed on each rank's block where the rules
   split them: ``decode_32k`` at most 8.45 GiB a rank at pod16x16 and 5.19
   GiB (and lower) at pod2x16x16, ``train_4k`` at most TRAIN_BOUND_GIB
   and TRAIN_FLOPS_BOUND FLOPs a rank, printed beside the JAX package's
   dry-run figures; and llama4-maverick ``train_4k`` cut to 2 of 48
   layers, whose FLOPs and bytes a rank must equal the CPU's
   (MOE_LAUNCH_CPU), its experts' products on 8 of 128 experts a rank and
   on its 320 of d = 5120 (exactly the shapes of
   ``_moe_launch_products``), no product or dispatched tokens over all
   128 and no expert weight of a rank gathered over "data" (AdamW's
   global norm gathers one period of each expert gradient whole, printed
   beside); and gemma3-1b and hymba-1.5b ``long_500k`` uncut, the KV cache
   held as each rank's block of its sequence: FLOPs and peak a rank equal
   to the CPU's (LONG_LAUNCH_CPU), printed beside the JAX package's, and
   the cache's bytes a rank 1/16 of the whole cache's.  (a) The tuner
   on the card at gemma3-1b's attention width (h
   = 4, d = 256, fp32): ``collect`` over S = 2048 and 4096 x the 16 grid
   schedules (every ``attend_chunked`` call on cuda:0), ``fit``, and
   ``best_schedule`` for those and S = 3072 (also measured over the
   grid); every schedule's ms, each pick and its regret against the best
   measured schedule (printed, not gated: host-bound walls), the fit's
   seconds; the pick lies in the grid, and its ``attend_chunked`` at S =
   2048 lies within TUNE_TOL of ``attend_full``, relative to its largest
   magnitude.  (c) The estimator against the card on phase 9's
   configuration (gemma3-1b bf16, B = 2, S = 2048, ``TrainStepConfig()``,
   a world of one): one real step with ``use_kernel=False`` under
   ``FlopCounterMode``, and the dry-run's counter over the same step on
   fake tensors: the FLOPs equal exactly, and the counter's peak lies
   within EST_PEAK_TOL of ``torch.cuda.max_memory_allocated`` over the
   real step (from ``reset_peak_memory_stats``, less what was allocated
   before its arguments), with no device memory allocated by the fake
   trace.  The counters are zeroed just before: the path launches no
   hand kernel.
12. examples — ``repro_torch.examples`` on the card, each in a temporary
   working directory, the counters zeroed just before and read just
   after: ``schedule_dag``, ``program_compile``, ``async_pipeline`` and
   ``serve_blur_pipeline`` (simulated devices, on the host), then
   ``quickstart``, ``runtime_dispatch`` (its reload in a child process),
   ``autotune_attention`` and ``train_100m`` (10 steps, cut from 200) on
   cuda:0; each one's wall, hand-kernel launches and result; the matmul
   kernels must launch in ``quickstart`` and the three training flash
   kernels in ``train_100m``.  Then ``paper.roofline.summarize`` over the
   launch phase's document, and ``paper.kernel_projection`` for gemma3-1b
   ``train_4k``: the projected memory term beside the hand kernels (the
   lse forward, dq, dk/dv) timed by events at the rank's shape in bf16.
13. times  — each kernel at the workloads' shapes, timed with CUDA events
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
import math
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
# (label, B, H, KV, Sq, Sk, D, causal, window, sk_orig) the kernels meet
# otherwise: every backward tile visible (no mask evaluated) at D = 128, a
# key tail past sk_orig that ends inside a 16-row tile at D = 256, and
# whisper-medium's two non-causal shapes at D = 64 over its 1500 encoder
# frames padded to 1536 (src/repro/configs/whisper_medium.py): the
# decoder's cross-attention, 2048 queries over them, and the encoder's
# self-attention
FA_EDGES = (("whole-tiles", 1, 8, 2, 512, 512, 128, False, 0, 0),
            ("sk_orig-tail", 1, 4, 2, 512, 512, 256, True, 0, 437),
            ("whisper-cross", 1, 16, 16, 2048, 1536, 64, False, 0, 1500),
            ("whisper-encoder", 1, 16, 16, 1536, 1536, 64, False, 0, 1500))

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


def _fa_inputs(b, h, kv, sq, sk, d, dtype, device, gen) -> tuple:
    """q [B,H,Sq,D], k [B,KV,Sk,D] scaled by 0.5 and v, do standard normal,
    as the JAX flash-attention tests draw them."""
    q, k = (torch.randn(b, n, s, d, generator=gen, device=device) * 0.5
            for n, s in ((h, sq), (kv, sk)))
    v, do = (torch.randn(b, n, s, d, generator=gen, device=device)
             for n, s in ((kv, sk), (h, sq)))
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
                  (2, h, kv, 128, 128, 32),
                  {"causal": c, "window": w, "bq": 32, "bk": 32,
                   "sk_orig": 100}) for h, kv, c, w in FA_GRID]
        cases += [(label, (b, h, kv, s, s, d),
                   {"causal": c, "window": w, "bq": 256, "bk": 256})
                  for label, b, h, kv, s, d, c, w in FA_SHAPES]
        cases += [(label, (b, h, kv, sq, sk, d),
                   {"causal": c, "window": w, "bq": 256, "bk": 256,
                    "sk_orig": sk_orig})
                  for label, b, h, kv, sq, sk, d, c, w, sk_orig in FA_EDGES]
        for label, dims, kw in cases:
            q, k, v, do = _fa_inputs(*dims, dtype, device, gen)
            if kw.get("sk_orig"):         # zero padding, as ops.attention:
                # the keys past sk_orig, and the queries of self-attention
                for t in (q, k, v, do) if dims[3] == dims[4] else (k, v):
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


# one child a policy: four in turns took 65 s of the script's 1200 s, and
# no policy has moved fault 1 yet; with one sample each, a swing between
# processes cannot be told from a policy's effect
OMP_CHILDREN = ("default", "PASSIVE")


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
    matmul: the contention probe in child processes, one with the
    OpenMP runtime's default wait policy and one with
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
# a quarter of benchmarks/run.py --quick's 4000: the fits took 110 s of
# the script's 1200 s on a slow host at 4000, and about 45 s at 2000 once
# the models phase came to carry four more configurations; no gate reads
# their MAPE but finiteness
PAPER_EPOCHS = 1000
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
# gemma3-1b and whisper-medium uncut (24 encoder and 24 decoder layers,
# 0.82 B parameters), and at full width cut to 2 layers yi-9b (of 48; 0.87
# B parameters, 3.5 GB in fp32), internvl2-26b (of 48; 1.91 B, 7.7 GB),
# nemotron-4-15b (of 32; 3.93 B, 15.7 GB, 12.6 GB of it its two untied
# 256000 x 6144 tables) and deepseek-67b (of 95; 3.06 B, 12.2 GB); a
# forward over MODEL_SEQ tokens at B = 1 (train_4k, the batch cut to 1),
# serving SERVE_BATCH prompts of SERVE_PROMPT tokens then SERVE_STEPS
# greedy decode steps, whisper's over FRONTEND_SCALE-scaled frames and
# internvl2's behind as many patches (their n_frontend_tokens rows of
# d_model, as launch.serve draws them).  The fault is given to every kernel
# launch of one more forward, which MODEL_TOL must catch: gemma3-1b's local
# layers lose their window, whisper's encoder and cross-attention gain a
# causal mask, the others (no window) lose theirs
MODELS = (("gemma3-1b", None, {"window": 0}), ("yi-9b", 2, {"causal": False}),
          ("whisper-medium", None, {"causal": True}),
          ("internvl2-26b", 2, {"causal": False}),
          ("nemotron-4-15b", 2, {"causal": False}),
          ("deepseek-67b", 2, {"causal": False}))
FRONTEND_SCALE = 0.05
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


def _dtype_models(name, layers=None) -> tuple:
    """(the config of ``name`` cut to ``layers`` if given, {compute dtype:
    its model} in fp32 and bf16 over the same fp32 parameters)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model

    cfg = get_arch(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg, {dt: build_model(dataclasses.replace(cfg, compute_dtype=dt))
                 for dt in ("float32", "bfloat16")}


def _attn_launches(cfg) -> tuple:
    """(the flash launches of one forward of ``cfg``: one a decoder layer,
    two with cross-attention, one an encoder layer; those of them in the
    checkpointed periods, which a training step's backward recomputes).
    Every layer kind of MODELS attends."""
    from repro_torch.models import transformer as tfm

    per = 2 if cfg.encdec else 1
    full, _ = tfm._segments(cfg, cfg.n_layers)
    launches = per * cfg.n_layers
    rematted = per * full * len(cfg.layer_pattern)
    if cfg.encdec:
        full, _ = tfm._segments(cfg, cfg.n_encoder_layers)
        launches += cfg.n_encoder_layers
        rematted += full * len(cfg.layer_pattern)
    return launches, rematted


def _frontend(cfg, b: int, gen, device) -> dict:
    """whisper's frames or internvl2's patches for ``b`` sequences:
    n_frontend_tokens rows of d_model, standard normal times
    FRONTEND_SCALE, fp32 (each model casts them to its compute type)."""
    key = {"frame": "frames", "patch": "patches"}.get(cfg.frontend)
    if key is None:
        return {}
    return {key: torch.randn(b, cfg.n_frontend_tokens, cfg.d_model,
                             generator=gen, device=device) * FRONTEND_SCALE}


def _prefix(batch: dict) -> int:
    """The positions the patches take before the tokens (0 without)."""
    return batch["patches"].shape[1] if "patches" in batch else 0


def _model_forward_check(name, model, params, batch, fa, launches,
                         card) -> None:
    """One forward through the kernel (exactly ``launches`` launches of
    ``flash_attention``, no other kernel) and one through the plain
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
    want_delta["flash_attention"] = launches
    if delta != want_delta:
        raise RuntimeError(f"models {name} {dtype}: a forward launched "
                           f"{delta}, not {want_delta}")
    want, _ = model.forward(params, batch, use_kernel=False)
    torch.cuda.synchronize()
    if _fa_delta(fa, before) != want_delta:
        raise RuntimeError(f"models {name}: the plain forward launched a "
                           "kernel")
    b, s = batch["tokens"].shape
    s += _prefix(batch)
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
          f"flash launches {delta['flash_attention']} (want {launches}); "
          f"first-call wall {wall * 1e3:.1f} ms; {card}")
    _gate(name, "kernel logits from plain", err, dtype)


def _serve_check(name, model, params, prompts, extras, fa, launches,
                 cache_dtype, card) -> None:
    """prefill then SERVE_STEPS greedy decode steps: the prefill launches
    the kernel ``launches`` times, decode never.  The prefill's logits and
    every cache leaf are held against the plain prefill's; in fp32 the
    decode logits against forward's at the same positions, and that
    forward (a ragged length, the kernel's key padding) against its plain
    twin.  ``extras`` are the frontend's rows (:func:`_frontend`); patches
    take the first positions, so decode starts after them."""
    b, s = prompts.shape
    dtype = model.cfg.compute_dtype
    batch = {"tokens": prompts, **extras}
    s += _prefix(batch)
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
    dec = torch.cat(outs, dim=1)
    if tuple(dec.shape) != (b, SERVE_STEPS, model.cfg.vocab_size) \
            or prefill_launches != launches or plain_launches \
            or decode_launches:
        raise RuntimeError(f"models {name} {dtype} serving: decode logits "
                           f"{tuple(dec.shape)}, prefill "
                           f"launched {prefill_launches} (want {launches}), "
                           f"the plain prefill {plain_launches} and decode "
                           f"{decode_launches} (want 0)")
    if not bool(torch.isfinite(dec).all()):
        raise RuntimeError(f"models {name} {dtype}: non-finite decode logits")
    if dtype == "float32":
        seq = {"tokens": torch.cat([prompts] + toks[:-1], dim=1), **extras}
        got, _ = model.forward(params, seq)
        want, _ = model.forward(params, seq, use_kernel=False)
        checks.append(_gate(name, f"forward S={got.shape[1]} "
                            "from plain", _rel_err(got, want), dtype))
        del want
        checks.append(_gate(name, f"decode at positions {s}.."
                            f"{s + SERVE_STEPS - 1} from forward",
                            _rel_err(dec, got[:, s:]), dtype))
    front = "".join(f", {t.shape[1]} {key}" for key, t in extras.items())
    print(f"models: {name} {dtype} serving {b} x {s} positions{front}, cache "
          f"{str(cache_dtype).removeprefix('torch.')} of {s + SERVE_STEPS}: "
          f"prefill {prefill_launches} flash launches, {SERVE_STEPS} decode "
          f"steps {decode_launches}; max |diff| / max |value|: "
          f"{', '.join(checks)} (bound {MODEL_TOL[dtype]}); {card}")


def _serve_time(model, params, prompts, extras, cache_dtype) -> dict:
    """One prefill and SERVE_STEPS greedy decode steps, timed, the peak
    device memory taken over them alone."""
    batch = {"tokens": prompts, **extras}
    b, s = prompts.shape
    s += _prefix(batch)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch,
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


def _kernel_share(model, params, batch, fa) -> dict:
    """One forward timed by CUDA events, and each flash-attention launch
    in it by an event pair around the wrapper: its wall, the kernel's
    summed time and its share (the checks ran the forward first)."""
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

    fa.flash_attention = timed
    try:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        model.forward(params, batch)
        end.record()
        end.synchronize()
    finally:
        fa.flash_attention = real
    wall = start.elapsed_time(end)
    kernel = sum(a.elapsed_time(b) for a, b in spans)
    return {"forward_ms": wall, "flash_ms": kernel,
            "flash_launches": len(spans), "share": kernel / wall}


def phase_models(K, device, card: str) -> tuple:
    """The model stack on the card (module docstring, phase 7).  Returns
    (path label -> launch counts of the counted run, "<model> <dtype>" ->
    the forward's wall and the kernel's share of it, the serving walls and
    memory, the planted fault's error)."""
    from repro_torch.models import module

    fa = K["flash_attention"]
    t_phase = time.perf_counter()

    def params_of(models):
        # the same seed each time: one model's weights on the card at once
        return models["float32"].init_params(
            torch.Generator().manual_seed(0), device=device)

    runs = []
    zero_counts(K)
    for name, layers, fault in MODELS:
        t_model = time.perf_counter()
        cfg, models = _dtype_models(name, layers)
        launches, _ = _attn_launches(cfg)
        t0 = time.perf_counter()
        params = params_of(models)
        torch.cuda.synchronize()
        enc = (f"{cfg.n_encoder_layers} encoder and "
               if cfg.encdec else "")
        print(f"models: {name}: {enc}{cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, "
              f"head_dim {cfg.resolved_head_dim}, vocab {cfg.vocab_size}, "
              f"{cfg.mlp_kind} MLP, {cfg.norm_kind}: "
              f"{module.count_params(params) / 1e9:.3f} B fp32 parameters "
              f"({module.param_bytes(params) / 2**30:.2f} GiB) initialised "
              f"on the card in {time.perf_counter() - t0:.1f} s; {card}")
        gen = torch.Generator(device=device).manual_seed(1)
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (1, MODEL_SEQ),
                                         generator=gen, device=device),
                 **_frontend(cfg, 1, gen, device)}
        prompts = torch.randint(1, cfg.vocab_size,
                                (SERVE_BATCH, SERVE_PROMPT), generator=gen,
                                device=device)
        extras = _frontend(cfg, SERVE_BATCH, gen, device)
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for dt, model in models.items():
                _model_forward_check(name, model, params, batch, fa,
                                     launches, card)
                _serve_check(name, model, params, prompts, extras, fa,
                             launches, getattr(torch, dt), card)
        print(f"models: {name} checked in {time.perf_counter() - t_model:.1f}"
              f" s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB; {card}")
        del params
        torch.cuda.empty_cache()
        runs.append((name, fault, models, batch, prompts, extras))
    counts = launch_counts(K)
    print(f"models: launches of the model path "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    if counts["flash_attention"] <= 0:
        raise RuntimeError("models: the flash-attention kernel never "
                           "launched")
    timing = {}
    with torch.no_grad():
        for name, fault, models, batch, prompts, extras in runs:
            t_model = time.perf_counter()
            params = params_of(models)
            for dt, model in models.items():
                rec = _kernel_share(model, params, batch, fa)
                rec.update(_serve_time(model, params, prompts, extras,
                                       getattr(torch, dt)))
                rec["planted_fault_err"] = _planted_fault(
                    name, model, params, batch, fa, fault, card)
                timing[f"{name} {dt}"] = rec
                print(f"models: {name} {dt} forward B=1 S="
                      f"{MODEL_SEQ + _prefix(batch)}: "
                      f"{rec['forward_ms']:.2f} ms by events, the flash "
                      f"kernel {rec['flash_ms']:.2f} ms over "
                      f"{rec['flash_launches']} launches = "
                      f"{100 * rec['share']:.1f}% of it; serving "
                      f"{SERVE_BATCH} x {SERVE_PROMPT}: "
                      f"prefill {rec['prefill_ms']:.1f} ms, "
                      f"{SERVE_STEPS} decode steps at "
                      f"{rec['decode_tokens_s']:.1f} tokens/s, peak "
                      f"{rec['peak_bytes'] / 2**30:.2f} GiB "
                      f"({rec['resident_bytes'] / 2**30:.2f} GiB resident "
                      f"before the prefill); {card}")
            del params
            torch.cuda.empty_cache()
            print(f"models: {name} timed in "
                  f"{time.perf_counter() - t_model:.1f} s")
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
    fa = K["flash_attention"]
    t_phase = time.perf_counter()
    cfg, models = _dtype_models(SERVE_ARCH)
    layers = cfg.n_layers
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
# the gradient gate beside TRAIN_ARCH's: (arch, layers kept or None for
# all, decoder tokens at B = 1, the fault planted in the backward
# kernels).  whisper-medium uncut is the one path whose dq and dk/dv run
# at Sq != Sk (2048 decoder queries over the 1500 frames' keys); it has
# no window to drop, so its encoder and cross-attention gain a causal
# mask.  internvl2-26b's tokens follow its 256 patches
TRAIN_GATES = (("whisper-medium", None, 2048, {"causal": True}),
               ("internvl2-26b", 2, 2048, {"causal": False}),
               ("nemotron-4-15b", 2, 1024, {"causal": False}))


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


def _train_gate(name, models, params, batch, fa, fault, card) -> dict:
    """(a) and (b): the loss and every gradient leaf through the kernels
    against the plain twin, fp32 and bf16, within MODEL_TOL, the flash
    launches of the kernel run held to what the stack implies (the lse
    forward once an attention, again in each checkpointed period's
    recompute; dq and dk/dv once an attention); then ``fault`` planted in
    the backward kernels alone (the forward right) must land above the
    bound.  At most two gradient trees are held at once."""
    out = {}
    attn, rematted = _attn_launches(models["float32"].cfg)
    want_launches = {"flash_attention": 0, "flash_attention_fwd":
                     attn + rematted, "flash_attention_bwd_dq": attn,
                     "flash_attention_bwd_dkv": attn}
    b, s = batch["tokens"].shape
    front = "".join(f" + {t.shape[1]} {key}" for key, t in batch.items()
                    if key in ("frames", "patches"))
    for dt, model in models.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        want = _grads(model, params, batch, use_kernel=False)
        before = dict(fa.LAUNCHES)
        got = _grads(model, params, batch, use_kernel=True)
        torch.cuda.synchronize()
        launches = _fa_delta(fa, before)
        loss_err, grad_err, leaf = _grad_errs(got, want)
        out[dt] = {"loss_err": loss_err, "grad_err": grad_err,
                   "launches": launches}
        print(f"train: {name} {dt} value-and-grad B={b} S={s}{front}: loss "
              f"{got[0].item():.6f} through the kernels, "
              f"{want[0].item():.6f} plain, relative {loss_err:.3g}; the "
              f"worst gradient leaf {leaf} {grad_err:.3g} of its largest "
              f"magnitude (bound {MODEL_TOL[dt]}); both in "
              f"{time.perf_counter() - t0:.1f} s; flash launches "
              f"{json.dumps(launches)} (want {json.dumps(want_launches)}); "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{card}")
        del got
        if launches != want_launches:
            raise RuntimeError(f"train {name} {dt}: value-and-grad launched "
                               f"{launches}, not {want_launches}")
        _gate(name, "train loss from plain", loss_err, dt)
        _gate(name, f"train gradient {leaf} from plain", grad_err, dt)
        real = {k: getattr(fa, k) for k in ("flash_attention_bwd_dq",
                                            "flash_attention_bwd_dkv")}
        for k, fn in real.items():
            setattr(fa, k, lambda *a, _fn=fn, **kw: _fn(*a, **{**kw,
                                                             **fault}))
        try:
            bad = _grads(model, params, batch, use_kernel=True)
        finally:
            for k, fn in real.items():
                setattr(fa, k, fn)
        loss_err, grad_err, leaf = _grad_errs(bad, want)
        del bad, want
        out[dt]["planted_fault_err"] = grad_err
        out[dt]["peak_bytes"] = torch.cuda.max_memory_allocated()
        print(f"train: {name} {dt} planted fault: the dq and dk/dv kernels "
              f"launched with {fault} on every layer, the forward right: "
              f"loss relative {loss_err:.3g}, the worst gradient leaf {leaf} "
              f"{grad_err:.3g} (bound {MODEL_TOL[dt]}); peak "
              f"{out[dt]['peak_bytes'] / 2**30:.2f} GiB; {card}")
        if not grad_err > MODEL_TOL[dt]:
            raise RuntimeError(f"train {name} {dt}: the bound "
                               f"{MODEL_TOL[dt]} misses the planted backward "
                               f"fault ({grad_err:.3g})")
        torch.cuda.empty_cache()
    return out


def _train_gates(device, card, fa) -> dict:
    """The gate of :func:`_train_gate` for each of TRAIN_GATES, at full
    width, seed-0 weights and the step-0 batch of ``data.pipeline`` (its
    frontend rows as ``launch.train`` draws them)."""
    from repro_torch.data.pipeline import DataConfig, batch_at

    out = {}
    for name, layers, seq, fault in TRAIN_GATES:
        t0 = time.perf_counter()
        cfg, models = _dtype_models(name, layers)
        params = models["float32"].init_params(
            torch.Generator().manual_seed(0), device=device)
        batch = batch_at(DataConfig(cfg.vocab_size, seq, 1), 0,
                         frontend=cfg.frontend,
                         n_frontend_tokens=cfg.n_frontend_tokens,
                         d_model=cfg.d_model, device=device)
        out[name] = _train_gate(name, models, params, batch, fa, fault, card)
        del params, batch
        torch.cuda.empty_cache()
        print(f"train: {name} at {cfg.n_layers} layers gated in "
              f"{time.perf_counter() - t0:.1f} s; {card}")
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


# the chunked CE's autograd Function against the autograd segment it
# replaced (train.step._CESegment), at whisper-medium's vocabulary and
# width: B = 2, two segments of 512 tokens, fp32
CE_CHECK = (2, 1024, 1024, 51865, 512)     # B, S, d, V, chunk
CE_TOL = 1e-5


def _ce_autograd_segment(h, lab, t32, axes=()):
    """The chunked CE's segment before its autograd Function: the logits,
    ``_lse_gold`` and the sums under autograd, recomputed in the backward
    by ``torch.utils.checkpoint``."""
    from torch.utils import checkpoint

    from repro_torch.train import step

    def segment(h, lab, t32):
        logits = torch.matmul(h.to(torch.float32), t32.t())
        mask = lab != step.IGNORE_LABEL
        safe = torch.where(mask, lab, 0).long()
        lse, gold = step._lse_gold(logits, safe)
        return (((lse - gold) * mask).sum(),
                (torch.square(lse) * mask).sum(), mask.sum())
    return checkpoint.checkpoint(segment, h, lab, t32, use_reentrant=False)


def _train_ce_check(device, card) -> dict:
    """The CE Function's loss and gradients (hidden states and table) on
    the card against the autograd segment's, with ignored labels and the
    z-loss, within CE_TOL of each one's largest magnitude; each one's
    backward peak above what it was given, and its time."""
    from repro_torch.train import step

    b, s, d, v, chunk = CE_CHECK
    gen = torch.Generator().manual_seed(5)
    h0 = torch.randn(b, s, d, generator=gen).to(device)
    tab = (torch.randn(v, d, generator=gen) * d ** -0.5).to(device)
    labels = torch.randint(0, v, (b, s), generator=gen).to(device)
    labels[0, :100] = step.IGNORE_LABEL
    real, out = step._ce_segment, {}
    try:
        for name, seg in (("function", real),
                          ("autograd", _ce_autograd_segment)):
            step._ce_segment = seg
            h = h0.clone().requires_grad_()
            table = tab.clone().requires_grad_()
            loss, _ = step.chunked_cross_entropy(h, table, labels,
                                                 chunk=chunk, z_loss=1e-2)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            grads = torch.autograd.grad(loss, (h, table))
            torch.cuda.synchronize()
            out[name] = {"ms": (time.perf_counter() - t1) * 1e3,
                         "peak": torch.cuda.max_memory_allocated() - base,
                         "values": (loss.detach(),) + grads}
            del h, table, loss, grads
    finally:
        step._ce_segment = real
    errs = [_rel_err(g, w) for g, w in zip(out["function"]["values"],
                                           out["autograd"]["values"])]
    f, a = out["function"], out["autograd"]
    buf = b * chunk * v * 4
    print(f"train: chunked CE autograd Function at whisper-medium's V = {v}, "
          f"d = {d}, B = {b}, S = {s} in segments of {chunk}, fp32: loss, "
          f"dh, dtable against the checkpointed autograd segment "
          f"{', '.join(f'{e:.3g}' for e in errs)} (bound {CE_TOL}); the "
          f"backward's peak over its inputs {f['peak'] / 2**30:.3f} GiB "
          f"against {a['peak'] / 2**30:.3f} GiB ({f['peak'] / buf:.2f} and "
          f"{a['peak'] / buf:.2f} [B, chunk, V] fp32 buffers), "
          f"{f['ms']:.1f} ms against {a['ms']:.1f} ms; {card}")
    if not max(errs) <= CE_TOL:
        raise RuntimeError(f"train: the CE Function differs from the "
                           f"autograd segment: {errs}")
    return {"errs": errs, "peak": f["peak"], "autograd_peak": a["peak"],
            "ms": f["ms"], "autograd_ms": a["ms"]}


NORM_CHECK = (("rmsnorm", 8192), ("layernorm", 6144))   # kind, d
NORM_ROWS = (2, 4096)                                    # B, S
# forward and fp32 gradients; bf16 dx: at most one ulp of its largest
# magnitude (both sides round fp32 sums, so an element near zero may
# differ by more of its own ulps)
NORM_TOL = {"forward": 1e-6, "grads": 1e-5, "bf16_dx": 2.0 ** -7}


def _plain_norm(kind, params, x, impl="f32"):
    """The norms as the port composed them before the autograd Function
    (``impl`` "f32"): every fp32 [rows, d] intermediate kept by autograd."""
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        var = x.square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + 1e-6) * params["scale"]).to(dtype)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    return (x * params["scale"] + params["bias"]).to(dtype)


def _norm_run(fn, kind, x0, params0, dy) -> dict:
    """fn's output and gradients from fresh leaves, and the allocator's
    peak over its forward and backward above what it was given."""
    x = x0.clone().requires_grad_()
    params = {k: v.clone().requires_grad_() for k, v in params0.items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    y = fn(kind, params, x)
    grads = torch.autograd.grad(y, [x] + [params[k] for k in sorted(params)],
                                dy)
    torch.cuda.synchronize()
    return {"ms": (time.perf_counter() - t1) * 1e3,
            "peak": torch.cuda.max_memory_allocated() - base,
            "y": y.detach(), "grads": grads}


def _train_norm_check(device, card) -> dict:
    """The norm Function (``models.layers``, ``impl`` "f32") on the card
    against the plain composition it replaced: RMSNorm at d = 8192 and
    LayerNorm at d = 6144 on [2, 4096, d].  In fp32 the forward within
    1e-6 and every gradient within 1e-5 of the largest magnitude; in bf16
    the forward the same and the scale's and bias's gradients within
    1e-5, x's within 2**-7 of its largest magnitude (one bf16 ulp there);
    the allocator's peak over forward and backward at most the
    composition's."""
    from repro_torch.models import layers

    def function(kind, params, x):
        return layers.apply_norm(kind, params, x)

    out = {}
    gen = torch.Generator().manual_seed(6)
    for kind, d in NORM_CHECK:
        params = {"scale": 1 + 0.1 * torch.randn(d, generator=gen)}
        if kind == "layernorm":
            params["bias"] = 0.1 * torch.randn(d, generator=gen)
        params = {k: v.to(device) for k, v in params.items()}
        x32 = (torch.randn(*NORM_ROWS, d, generator=gen) * 2 + 0.5).to(device)
        dy32 = torch.randn(*NORM_ROWS, d, generator=gen).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dtype), dy32.to(dtype)
            got = _norm_run(function, kind, x, params, dy)
            want = _norm_run(_plain_norm, kind, x, params, dy)
            fwd = _rel_err(got["y"], want["y"])
            errs = [_rel_err(g, w) for g, w in zip(got["grads"],
                                                   want["grads"])]
            ok = fwd <= NORM_TOL["forward"] and got["peak"] <= want["peak"]
            dx_tol = (NORM_TOL["grads"] if dtype == torch.float32
                      else NORM_TOL["bf16_dx"])
            ok = (ok and errs[0] <= dx_tol
                  and max(errs[1:]) <= NORM_TOL["grads"])
            dx = f"dx {errs[0]:.3g} (bound {dx_tol:.3g})"
            name = f"{kind}/{str(dtype).split('.')[-1]}"
            print(f"train: norm Function {name} [{NORM_ROWS[0]},"
                  f"{NORM_ROWS[1]},{d}] against the plain composition: "
                  f"forward {fwd:.3g} (bit-equal "
                  f"{bool(torch.equal(got['y'], want['y']))}, bound "
                  f"{NORM_TOL['forward']}), {dx}, "
                  f"dscale{'/dbias' if kind == 'layernorm' else ''} "
                  f"{', '.join(f'{e:.3g}' for e in errs[1:])} (bound "
                  f"{NORM_TOL['grads']}); peak over "
                  f"forward+backward {got['peak'] / 2**20:.1f} MiB against "
                  f"{want['peak'] / 2**20:.1f} MiB; {got['ms']:.2f} ms "
                  f"against {want['ms']:.2f} ms (first calls); {card}")
            if not ok:
                raise RuntimeError(f"train: the norm Function {name} fails "
                                   f"its gate: forward {fwd}, grads {errs}, "
                                   f"peak {got['peak']} against "
                                   f"{want['peak']}")
            out[name] = {"forward": fwd, "grads": errs, "peak": got["peak"],
                         "plain_peak": want["peak"], "ms": got["ms"],
                         "plain_ms": want["ms"]}
            del got, want, x, dy
    return out


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
    layers: one run uninterrupted, beside it one crashing at RESUME_FAIL
    (exit 42, after the checkpoint at RESUME_EVERY), then one resuming
    from it; the resumed steps' losses against the uninterrupted run's."""
    def child(*extra):
        argv = [sys.executable, str(Path(__file__).resolve()),
                "--train-child", str(RESUME_LAYERS), "--arch", TRAIN_ARCH,
                "--steps", str(RESUME_STEPS), "--seq-len", str(RESUME_SEQ),
                "--batch", str(TRAIN_BATCH), "--warmup", str(TRAIN_WARMUP),
                *extra]
        return subprocess.Popen(argv, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def wait(proc, t0):
        try:
            out, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        return (subprocess.CompletedProcess(proc.args, proc.returncode, out,
                                            err), time.perf_counter() - t0)

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ckpt = ["--checkpoint-dir", str(tmp / "ckpt"), "--checkpoint-every",
                str(RESUME_EVERY)]
        # the uninterrupted run shares nothing with the other two: it runs
        # beside the crashing one
        t0 = time.perf_counter()
        proc = child("--metrics-out", str(tmp / "whole.json"))
        try:
            crash, crash_s = wait(child(*ckpt, "--fail-at-step",
                                        str(RESUME_FAIL)), t0)
        finally:
            whole, whole_s = wait(proc, t0)
        resume, resume_s = wait(child(*ckpt, "--metrics-out",
                                      str(tmp / "resumed.json")),
                                time.perf_counter())
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
    from repro_torch.data.pipeline import DataConfig, batch_at

    fa = K["flash_attention"]
    t_phase = time.perf_counter()
    cfg, models = _dtype_models(TRAIN_ARCH)
    params = models["float32"].init_params(torch.Generator().manual_seed(0),
                                           device=device)
    batch = batch_at(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH), 0,
                     device=device)
    timing = {"gate": _train_gate(TRAIN_ARCH, models, params, batch, fa,
                                  {"window": 0}, card)}
    del params
    torch.cuda.empty_cache()
    timing["gates"] = _train_gates(device, card, fa)
    timing["ce"] = _train_ce_check(device, card)
    torch.cuda.empty_cache()
    timing["norm"] = _train_norm_check(device, card)
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
# the ring forward and (5a), B = 1: 2048 since the models phase came to
# carry four more configurations (4096 before; the dist phase's time)
DIST_SEQ = 2048
# (2), (2b) and (5c): 4 prompts, max_seq 1056 (from 2048 tokens when the
# models phase came to carry four more configurations; past gemma3-1b's
# window of 512 all the same)
DIST_PROMPT, DIST_STEPS = 1024, 32
# the decode ring (2): max_seq 1028 = 4 x 257; cut from 32 steps when its
# MLP and vocabulary came to be split (53 psums a step through gloo), and
# from 8 when (5d)/(5e) came
DIST_RING_STEPS = 4
DIST_MOE = "qwen3-moe-235b-a22b"     # reduced(): the full model is 470 GB
DIST_MOE_TOL = 1e-5      # the JAX package's own bounds (test_moe_shardmap)
DP_LAYERS, DP_STEPS = 2, 3           # the two gloo ranks of --data-parallel
DIST_DECODE_LAYERS = 2   # the blocked decode: gemma3-1b cut to 2 of 26 layers
DIST_DECODE_BATCH = 4    # one row a rank of the 4-rank ("data",) mesh
DIST_TP_TRAIN_LAYERS = 2       # (5b): gemma3-1b cut to 2 of 26 layers
DIST_TP_TRAIN_SEQ = 2048       # (5b): B = 1
# (5d) hymba-1.5b and (5e) xlstm-1.3b tensor-parallel: (layers, B = 1
# tokens) at full width; hymba cut to 2 of 32 layers, xlstm to one period
# (7 mLSTM and 1 sLSTM) of 48 and to 256 tokens (from 1024 when (5g)
# came to carry the mLSTM core at 1024: the sLSTM steps one token at a
# time, thrice a step), and to 128 (from 256) when the models phase came
# to carry four more configurations; hymba keeps 2048, past its window of
# 1024
DIST_TP_RECURRENT = {"hymba-1.5b": (2, 2048), "xlstm-1.3b": (8, 128)}
DIST_TP_REC_STEPS = 4          # decode tokens after the prefill
# logits, loss and gradient leaves against one process: the row-parallel
# psums add in another order, and hymba's norm of its SSM branch and the
# mLSTM's exponential gates scale that up; at full width on an H100 hymba
# came to 3.0e-5 (logits) and 3.2e-5 (gradients), xlstm to 7.9e-5 and
# 1.0e-4, and on a CPU's plain fp32 attention hymba to 7.3e-6 / 1.2e-5
# (S=2048); the planted faults land at 11 and 2.3e7: the bound is twice
# the largest
DIST_TP_REC_TOL = 2e-4
DIST_MOE_SHARED = "llama4-maverick-400b-a17b"   # its shared expert, reduced()
# (5f) the global MoE dispatch: DIST_MOE_GLOBAL at full width cut to 1 of
# its 94 layers (llama4 at full width does not fit: its experts are 32 GB
# a layer in bf16), fp32, S = DIST_MOE_GLOBAL_SEQ, on DIST_RANKS ranks:
# (label, mesh shape, axis names, B)
DIST_MOE_GLOBAL = "qwen3-moe-235b-a22b"
# 512: with the fsdp step at 2048 the script took past 1100 s, and at
# 1024 too once the long-context decode ran twice (1117 s on a slow host)
DIST_MOE_GLOBAL_SEQ = 512
DIST_MOE_GLOBAL_MESHES = (("model4", (4,), ("model",), 1),
                          ("2x2", (2, 2), ("data", "model"), 2))
DIST_MOE_GLOBAL_STEPS = 4      # decode tokens after the prefill
# the 4-rank train step's peak a rank that PERF.md records from before the
# combine ran over blocks of tokens, at another sequence length, printed
# beside this run's: (GiB, S)
DIST_MOE_EARLIER_PEAK = (7.22, 2048)
DIST_MOE_GLOBAL_TIMEOUT_S = 300.0   # the ranks wait on rank 0's one process
# (5g) the mLSTM core on value rows: (arch, layers, B, tokens) on a
# ("model",) mesh of DIST_ROWS_RANKS, whose 4 heads it does not divide;
# B = 2 (from B = 1 at 1024 tokens, as many tokens) so that the B*H = 8
# (batch, head) pairs divide the ranks and the intra-chunk q.k is split
DIST_ROWS = ("xlstm-1.3b", 1, 2, 512)
DIST_ROWS_RANKS = 8
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


def _dist_ring_blocked(model, held, batch, mesh, K, rank) -> tuple:
    """(1b) the same ring forward over params held as blocks (each rank
    its block under train_rules(seq_parallel=True), gathered per layer at
    use): per rank the wall, bytes staged, peak, the bytes held, the
    logits' fingerprint; rank 0's logits come back on the host."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import local, train_rules, use_mesh
    from repro_torch.models import module

    link, rules = mesh.transport, train_rules(seq_parallel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    t0 = time.perf_counter()
    with torch.no_grad(), use_mesh(mesh, rules):
        logits = model.forward(held, batch, remat=False, ring=True)[0]
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "host_bytes": link.host_bytes - host0[0],
           "host_s": link.host_s - host0[1],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "held_bytes": sum(local(p).numel() * local(p).element_size()
                             for p in module.leaves(held)),
           "flash": _delta(K, before),
           "fingerprint": collectives.fingerprint(logits)}
    prints = collectives.all_ranks(rec["fingerprint"])
    rec["ranks_bit_equal"] = all(p == prints[0] for p in prints)
    return rec, (logits.cpu() if rank == 0 else None)


def _dist_ring(model, params, batch, mesh, K, rank, blocked) -> dict:
    """(1) gemma3-1b's forward with ring=True under the 4-rank model mesh,
    the params whole (the global view): its logits against (1b)'s bit for
    bit; on rank 0 also the one-process forward through the flash kernel,
    both rings held to it, and the planted fault (every rotation the wrong
    way round)."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import train_rules, use_mesh

    link, rules = mesh.transport, train_rules(seq_parallel=True)
    blocked_rec, blocked_logits = blocked

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
    same = collectives.all_ranks(prints[0] == blocked_rec["fingerprint"])
    rec["blocked_bit_equal"] = all(same)
    if rank == 0:
        before = launch_counts(K)
        with torch.no_grad():
            want, _ = model.forward(params, batch, remat=False)
        torch.cuda.synchronize()
        rec["one_process_flash"] = _delta(K, before)
        rec["err"] = _rel_err(logits, want)
        rec["blocked_err"] = _rel_err(blocked_logits.to(want.device), want)
        rec["logit_max"] = want.abs().max().item()
    del logits, blocked_logits
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


def _last_row(model, logits) -> torch.Tensor:
    """The last position's logits [B, V] in fp32, whole: under a mesh whose
    rules split the vocabulary, every rank's block gathered."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import active_mesh

    row = logits[:, -1].float()
    axes = model.vocab_axes(logits.shape[0], logits.shape[1])
    return collectives._gather_whole(row, active_mesh(), (None, axes)) \
        if axes else row


def _dist_decode(model, params, prompt, mesh, K, rank) -> dict:
    """(2) prefill DIST_PROMPT tokens under serve_rules(long_context=True),
    the cache then cut into each rank's block of its sequence
    (``shard_tree`` with ``cache_shardings``: cache_seq over the 4 ranks)
    and the whole cache freed, and DIST_RING_STEPS decode steps on the
    blocks twice: with stream_kv (the decode ring) and with the plain step
    (``make_serve_step``: the softmax stats merged by a max all-reduce and
    one psum); on rank 0 the same in one process, and each run's tokens
    held to it."""
    from repro_torch.dist.sharding import (Block, cache_shardings,
                                           serve_rules, shard_tree,
                                           use_mesh)
    from repro_torch.models import module
    from repro_torch.serve.decode import make_serve_step

    rules = serve_rules(long_context=True)
    max_seq = DIST_PROMPT + DIST_RING_STEPS

    def prefill():
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      max_seq=max_seq,
                                      cache_dtype=torch.float32)
        row = _last_row(model, logits)
        return row, row.argmax(-1, keepdim=True).to(torch.int32), cache

    def decode(cache, first, stream: bool):
        toks, rows = [first], []
        serve = make_serve_step(model)
        for i in range(DIST_RING_STEPS):
            if stream:
                lg, cache = model.decode_step(params, cache, toks[-1],
                                              DIST_PROMPT + i, stream_kv=True)
                rows.append(_last_row(model, lg))
                toks.append(rows[-1].argmax(-1, keepdim=True).to(torch.int32))
            else:
                tok, lg, cache = serve(params, cache, toks[-1],
                                       DIST_PROMPT + i)
                rows.append(lg[:, -1].float())
                toks.append(tok)
        return torch.cat(toks, dim=1), rows

    link = mesh.transport
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = {}
    with torch.no_grad(), use_mesh(mesh, rules):
        row, first, cache = prefill()
        held = shard_tree(cache, cache_shardings(model.cache_specs(
            prompt.shape[0], max_seq, torch.float32), mesh, rules), mesh)
        del cache
        torch.cuda.empty_cache()
        kv = [c for c in module.leaves(held) if isinstance(c, Block)]
        rec["cache_bytes"] = sum(c.local.numel() * c.local.element_size()
                                 for c in kv)
        rec["cache_whole_bytes"] = sum(
            math.prod(c.whole_shape()) * c.local.element_size() for c in kv)
        copy = module.tree_map(lambda c: c.with_local(c.local.clone())
                               if isinstance(c, Block) else c.clone(), held)
        t1 = time.perf_counter()
        stream, _ = decode(held, first, True)
        t2 = time.perf_counter()
        plain, _ = decode(copy, first, False)
    torch.cuda.synchronize()
    rec.update({"wall_s": time.perf_counter() - t0, "stream_s": t2 - t1,
                "plain_s": time.perf_counter() - t2,
                "host_bytes": link.host_bytes - host0[0],
                "host_s": link.host_s - host0[1], "flash": _delta(K, before),
                "tokens": stream.tolist(), "plain_tokens": plain.tolist()})
    _same_on_ranks("the decode ring's tokens", rec["tokens"])
    _same_on_ranks("the plain step's tokens", rec["plain_tokens"])
    if rank == 0:
        with torch.no_grad():
            row, first, cache = prefill()
            want, rows = decode(cache, first, True)
        rows = [row] + rows
        rec["want"] = want.tolist()
        rec["note"] = _hold_tokens("dist decode ring", rec["tokens"],
                                   rec["want"], lambda b, j: rows[j][b])
        rec["plain_note"] = _hold_tokens(
            "dist decode, plain step", rec["plain_tokens"], rec["want"],
            lambda b, j: rows[j][b])
    return rec


def _dist_decode_blocked(device, rank, world, K) -> tuple:
    """(2b) DIST_DECODE_BATCH prompts of DIST_PROMPT tokens and DIST_STEPS
    decode steps through ``make_prefill_step``/``make_serve_step`` on a
    ("data",) mesh of the ranks under serve_rules(), the tokens and the KV
    cache held as each rank's rows (gemma3-1b at full width cut to
    DIST_DECODE_LAYERS layers, fp32, the bf16 cache); on rank 0 the same
    in one process through the model's prefill and decode_step, and the
    tokens held to it.  Returns the record and, on rank 0, the one-process
    run's (tokens, logits rows) for (5c)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import compat
    from repro_torch.dist.sharding import (Block, held_batch_shardings,
                                           local, serve_rules, shard_tree,
                                           use_mesh)
    from repro_torch.models import build_model, module
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_arch(DIST_ARCH), n_layers=DIST_DECODE_LAYERS,
                              compute_dtype="float32")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    prompt = torch.randint(0, cfg.vocab_size, (DIST_DECODE_BATCH,
                                               DIST_PROMPT),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32).to(device)
    mesh, rules = compat.make_mesh((world,), ("data",), device=device), \
        serve_rules()
    link = mesh.transport

    def held(tokens):
        return shard_tree(tokens, held_batch_shardings(
            {"tokens": tokens}, mesh, rules)["tokens"], mesh)

    prefill = make_prefill_step(model, DIST_PROMPT + DIST_STEPS)
    step = make_serve_step(model)
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), use_mesh(mesh, rules):
        tok, cache = prefill(params, {"tokens": held(prompt)})
        toks = [tok]
        for i in range(DIST_STEPS):
            tok, _, cache = step(params, cache, held(toks[-1]),
                                 DIST_PROMPT + i)
            toks.append(tok)
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "host_bytes": link.host_bytes - host0[0],
           "host_s": link.host_s - host0[1], "flash": _delta(K, before),
           "tokens": torch.cat(toks, dim=1).tolist(),
           "cache_bytes": sum(local(c).numel() * local(c).element_size()
                              for c in module.leaves(cache)),
           "cache_whole_bytes": sum(
               math.prod(c.whole_shape()) * c.local.element_size()
               if isinstance(c, Block) else c.numel() * c.element_size()
               for c in module.leaves(cache))}
    del cache
    _same_on_ranks("the blocked decode's tokens", rec["tokens"])
    ref = None
    if rank == 0:
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": prompt},
                                          max_seq=DIST_PROMPT + DIST_STEPS)
            # a copy: a view would keep the whole prompt's logits alive
            # while (5c) holds these rows
            rows = [logits[:, -1].float().clone()]
            del logits
            want = [rows[0].argmax(-1, keepdim=True).to(torch.int32)]
            for i in range(DIST_STEPS):
                lg, cache = model.decode_step(params, cache, want[-1],
                                              DIST_PROMPT + i)
                rows.append(lg[:, -1].float())
                want.append(rows[-1].argmax(-1, keepdim=True).to(
                    torch.int32))
        rec["want"] = torch.cat(want, dim=1).tolist()
        rec["note"] = _hold_tokens("dist blocked decode", rec["tokens"],
                                   rec["want"], lambda b, j: rows[j][b])
        ref = (rec["want"], rows)
    return rec, ref


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


def _dist_tp_forward(model, tokens, mesh, K, rank, world, device) -> dict:
    """(5a) gemma3-1b's forward tensor-parallel on the ("model",) mesh of
    the ranks under train_rules(), fp32, B = 1, S = DIST_SEQ: the params
    held as each rank's blocks (its heads, MLP and vocabulary rows), every
    layer computed on them.  Per rank the wall, the bytes staged through
    the host and their seconds, the peak, the bytes held, the flash
    launches and the heads each ran on; the final hidden states'
    fingerprint (the same on every rank); each rank's vocabulary block of
    the logits gathered to rank 0 and held to the matching slice of the
    one-process flash forward there."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import (local, shard_tree, train_rules,
                                           tree_shardings, use_mesh)
    from repro_torch.models import attention, module

    rules, link = train_rules(), mesh.transport
    held = shard_tree(model.init_params(torch.Generator().manual_seed(0),
                                        device=device),
                      tree_shardings(model.param_specs(), mesh, rules), mesh)
    torch.cuda.empty_cache()
    heads, real = [], attention._attend_kernel

    def counted(q, k, v, **kw):
        heads.append([q.shape[2], k.shape[2]])
        return real(q, k, v, **kw)

    batch = {"tokens": tokens}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    torch.distributed.barrier()
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    attention._attend_kernel = counted
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), use_mesh(mesh, rules):
            hidden, _ = model.forward(held, batch, remat=False,
                                      return_hidden=True)
            logits = model._logits(held, hidden)
            axes = model.vocab_axes(*tokens.shape)
        torch.cuda.synchronize()
    finally:
        attention._attend_kernel = real
    rec = {"wall_s": time.perf_counter() - t0,
           "host_bytes": link.host_bytes - host0[0],
           "host_s": link.host_s - host0[1],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "held_bytes": sum(local(p).numel() * local(p).element_size()
                             for p in module.leaves(held)),
           "flash": _delta(K, before), "heads": heads,
           "width": logits.shape[-1], "axes": list(axes)}
    prints = collectives.all_ranks(collectives.fingerprint(hidden))
    rec["ranks_bit_equal"] = all(p == prints[0] for p in prints)
    del held, hidden
    part = logits.cpu()
    del logits
    torch.cuda.empty_cache()
    parts = [torch.empty_like(part) for _ in range(world)] \
        if rank == 0 else None
    torch.distributed.gather(part, parts, dst=0)
    del part
    if rank == 0:
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=device)
        before = launch_counts(K)
        with torch.no_grad():
            want = model.forward(params, batch, remat=False)[0]
        torch.cuda.synchronize()
        rec["one_process_flash"] = _delta(K, before)
        del params
        top = want.abs().max()
        v = want.shape[-1] // world
        rec["errs"] = [((p.to(device) - want[..., r * v:(r + 1) * v]).abs()
                        .max() / top).item() for r, p in enumerate(parts)]
        rec["logit_max"] = top.item()
        del want
    del parts
    torch.cuda.empty_cache()
    return rec


def _dist_tp_train(mesh, K, rank, device) -> dict:
    """(5b) one make_train_step step with AdamW of gemma3-1b at full width
    cut to DIST_TP_TRAIN_LAYERS layers, fp32, B = 1, S = DIST_TP_TRAIN_SEQ,
    on the hand flash kernels, tensor-parallel on the ("model",) mesh under
    train_rules() with the params held as blocks: the loss and every
    gradient leaf (gathered whole) against the same step in one process
    (rank 0) on the same weights; then the planted fault, reduce_from's
    backward made a psum, which must land above the bound."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import (Block, gather_tree, shard_tree,
                                           train_rules, tree_shardings,
                                           use_mesh)
    from repro_torch.models import build_model, module
    from repro_torch.optim import AdamW
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cfg = dataclasses.replace(get_arch(DIST_ARCH),
                              n_layers=DIST_TP_TRAIN_LAYERS,
                              compute_dtype="float32")
    model = build_model(cfg)
    rules, link = train_rules(), mesh.transport
    batch = batch_at(DataConfig(cfg.vocab_size, DIST_TP_TRAIN_SEQ, 1), 0,
                     device=device)

    def step(on_mesh):
        """(loss, the whole gradient tree, launches, wall, staged bytes and
        seconds, peak) of one step from the seed-0 weights."""
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=device)
        if on_mesh:
            params = shard_tree(params, tree_shardings(
                model.param_specs(), mesh, rules), mesh)
        grads = []

        class Capture(AdamW):
            def update(self, g, state, p):
                grads.append(module.tree_map(
                    lambda x, q: q.with_local(x) if isinstance(q, Block)
                    else x, g, p))
                return super().update(g, state, p)

        opt = Capture(learning_rate=1e-4)
        state = opt.init(params)
        fn = make_train_step(model, opt, TrainStepConfig())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if on_mesh:
            torch.distributed.barrier()
        host0, before = (link.host_bytes, link.host_s), launch_counts(K)
        t0 = time.perf_counter()
        with use_mesh(mesh if on_mesh else None, rules if on_mesh else None):
            params, state, metrics = fn(params, state, batch)
            loss = metrics["loss"].item()
        torch.cuda.synchronize()
        out = {"wall_s": time.perf_counter() - t0,
               "host_bytes": link.host_bytes - host0[0],
               "host_s": link.host_s - host0[1],
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "flash": _delta(K, before), "loss": loss}
        del params, state
        whole = gather_tree(grads[0]) if on_mesh else grads[0]
        return out, whole

    rec, got = step(True)
    _same_on_ranks("the tensor-parallel step's loss", rec["loss"])
    real = collectives._ReduceFrom.backward

    def psum_backward(ctx, g):
        return None, None, collectives._all_reduce(g, ctx.mesh, ctx.names)

    collectives._ReduceFrom.backward = staticmethod(psum_backward)
    try:
        bad_rec, bad = step(True)
    finally:
        collectives._ReduceFrom.backward = real
    if rank == 0:
        want_rec, want = step(False)
        rec["one_process"] = want_rec
        errs = {path: _rel_err(g, w) for (path, g), (_, w) in zip(
            _paths(got), _paths(want))}
        worst = max(errs, key=errs.get)
        rec["loss_err"] = abs(rec["loss"] - want_rec["loss"]) / abs(
            want_rec["loss"])
        rec["grad_err"], rec["grad_worst"] = errs[worst], worst
        rec["fault_err"] = max(_rel_err(g, w) for g, w in zip(
            module.leaves(bad), module.leaves(want)))
        rec["fault_loss"] = bad_rec["loss"]
    del got, bad
    torch.cuda.empty_cache()
    return rec


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _paths(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _dist_tp_decode(mesh, K, rank, device, ref) -> dict:
    """(5c) (2b)'s prompts and steps through ``make_prefill_step``/
    ``make_serve_step`` tensor-parallel on the ("model",) mesh of the
    ranks under serve_rules(), the params held as blocks, the tokens and
    the bf16 cache whole: the tokens against (2b)'s one-process run (rank
    0's ``ref``) by the margin rule."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (serve_rules, shard_tree,
                                           tree_shardings, use_mesh)
    from repro_torch.models import build_model
    from repro_torch.serve.decode import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(get_arch(DIST_ARCH),
                              n_layers=DIST_DECODE_LAYERS,
                              compute_dtype="float32")
    model = build_model(cfg)
    rules, link = serve_rules(), mesh.transport
    held = shard_tree(model.init_params(torch.Generator().manual_seed(0),
                                        device=device),
                      tree_shardings(model.param_specs(), mesh, rules), mesh)
    prompt = torch.randint(0, cfg.vocab_size, (DIST_DECODE_BATCH,
                                               DIST_PROMPT),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32).to(device)
    prefill = make_prefill_step(model, DIST_PROMPT + DIST_STEPS)
    step = make_serve_step(model)
    torch.cuda.synchronize()
    torch.distributed.barrier()
    host0, before = (link.host_bytes, link.host_s), launch_counts(K)
    t0 = time.perf_counter()
    with torch.no_grad(), use_mesh(mesh, rules):
        tok, cache = prefill(held, {"tokens": prompt})
        toks = [tok]
        for i in range(DIST_STEPS):
            tok, _, cache = step(held, cache, toks[-1], DIST_PROMPT + i)
            toks.append(tok)
    torch.cuda.synchronize()
    rec = {"wall_s": time.perf_counter() - t0,
           "host_bytes": link.host_bytes - host0[0],
           "host_s": link.host_s - host0[1], "flash": _delta(K, before),
           "tokens": torch.cat(toks, dim=1).tolist()}
    del cache, held
    _same_on_ranks("the tensor-parallel decode's tokens", rec["tokens"])
    if rank == 0:
        want, rows = ref
        rec["note"] = _hold_tokens("dist tensor-parallel decode",
                                   rec["tokens"], want,
                                   lambda b, j: rows[j][b])
    return rec


class _PlantedReduce:
    """A stand-in for ``dist.collectives`` in one layer module whose
    ``reduce_from`` has a psum for its backward (the planted fault of
    (5d)/(5e)): the row-parallel gradient is counted once a rank."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def reduce_from(self, t, mesh, names):
        return self._real.psum(t, mesh, names)


def _dist_tp_recurrent(arch, mesh, K, rank, device, layers=None,
                       seq=None, plant_cut=False, batch=1) -> dict:
    """(5d)/(5e)/(5g): ``arch`` at full width cut to ``layers`` (by default
    DIST_TP_RECURRENT's layers and tokens), fp32, B = ``batch``,
    tensor-parallel on the ("model",) mesh of the ranks with
    the params held as blocks: the forward's logits (each rank's
    vocabulary block where it is split), one make_train_step step's loss
    and every gradient leaf, the same step with the planted fault (the
    row-parallel ``reduce_from`` of the recurrent layer's module made a
    psum; with ``plant_cut`` instead the forward with the mLSTM's gate
    and ``w_down`` cut contiguously, where the value rows cut them per
    head), a prefill and DIST_TP_REC_STEPS decode steps with the cache
    held as blocks; on rank 0 each against one process on the same
    weights.  Per rank the walls, staged bytes, the step's peak and the
    flash launches of each part, and the blocked step's global norm's
    peak bytes beside the largest period of a stacked gradient leaf; with
    ``plant_cut`` the intra-chunk q.k on the mesh against the whole
    einsum."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import (Block, cache_shardings,
                                           gather_tree, serve_rules,
                                           shard_tree, take, train_rules,
                                           tree_shardings, use_mesh)
    from repro_torch.models import build_model, module
    from repro_torch.models import transformer, xlstm
    from repro_torch.optim import AdamW, adamw
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    from repro_torch.train.step import TrainStepConfig, make_train_step

    if layers is None:
        layers, seq = DIST_TP_RECURRENT[arch]
    cfg = dataclasses.replace(get_arch(arch), n_layers=layers,
                              compute_dtype="float32")
    model = build_model(cfg)
    link = mesh.transport
    plant = transformer if cfg.family == "hybrid" else xlstm
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32).to(device)
    rec = {"layers": layers, "seq": seq, "batch": batch}
    batch = batch_at(DataConfig(cfg.vocab_size, seq, batch), 0,
                     device=device)

    def weights(on_mesh, rules=None):
        params = model.init_params(torch.Generator().manual_seed(0),
                                   device=device)
        if on_mesh:
            params = shard_tree(params, tree_shardings(
                model.param_specs(), mesh, rules), mesh)
        return params

    def timed(on_mesh, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if on_mesh:
            torch.distributed.barrier()
        host0, before = (link.host_bytes, link.host_s), launch_counts(K)
        received, real_a2a = [], collectives._all_to_all

        def counted(t, *args):
            got = real_a2a(t, *args)
            received.append(got.numel() * got.element_size())
            return got
        collectives._all_to_all = counted
        t0 = time.perf_counter()
        try:
            out = fn()
        finally:
            collectives._all_to_all = real_a2a
        torch.cuda.synchronize()
        return out, {"wall_s": time.perf_counter() - t0,
                     "host_bytes": link.host_bytes - host0[0],
                     "host_s": link.host_s - host0[1],
                     "a2a_bytes": sum(received),
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "flash": _delta(K, before)}

    def forward(on_mesh):
        rules = train_rules()
        params = weights(on_mesh, rules)
        with torch.no_grad(), use_mesh(mesh if on_mesh else None,
                                       rules if on_mesh else None):
            logits, _ = model.forward(params, {"tokens": tokens},
                                      remat=False)
            axes = model.vocab_axes(*tokens.shape) if on_mesh else ()
            if axes:
                logits = collectives._gather_whole(logits, mesh,
                                                   (None, None, axes))
        return logits, list(axes)

    def step(on_mesh):
        rules = train_rules()
        params = weights(on_mesh, rules)
        grads = []

        class Capture(AdamW):
            def update(self, g, state, p):
                grads.append(module.tree_map(
                    lambda x, q: q.with_local(x) if isinstance(q, Block)
                    else x, g, p))
                return super().update(g, state, p)

        opt = Capture(learning_rate=1e-4)
        state = opt.init(params)
        fn = make_train_step(model, opt, TrainStepConfig())
        norm = {}

        def measured(tree, like=None):
            # the norm's own peak above what the step holds as it begins
            torch.cuda.synchronize()
            norm["prior"] = torch.cuda.max_memory_allocated()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = real_norm(tree, like)
            torch.cuda.synchronize()
            norm["bytes"] = torch.cuda.max_memory_allocated() - base
            return out

        def run():
            with use_mesh(mesh if on_mesh else None,
                          rules if on_mesh else None):
                _, _, metrics = fn(params, state, batch)
                return metrics["loss"].item()
        real_norm = adamw.global_norm
        adamw.global_norm = measured
        try:
            loss, info = timed(on_mesh, run)
        finally:
            adamw.global_norm = real_norm
        info["peak_bytes"] = max(info["peak_bytes"], norm["prior"])
        info["norm_bytes"] = norm["bytes"]
        if on_mesh:
            info["norm_period"] = _largest_period(params)
        whole = gather_tree(grads[0]) if on_mesh else grads[0]
        return loss, whole, info

    def decode(on_mesh):
        rules = serve_rules()
        params = weights(on_mesh, rules)
        prefill = make_prefill_step(model, seq + DIST_TP_REC_STEPS)
        serve = make_serve_step(model)
        held = []

        def run():
            with torch.no_grad(), use_mesh(mesh if on_mesh else None,
                                           rules if on_mesh else None):
                tok, cache = prefill(params, {"tokens": tokens})
                if on_mesh:
                    cache = shard_tree(cache, cache_shardings(
                        model.cache_specs(1, seq + DIST_TP_REC_STEPS), mesh,
                        rules), mesh)
                    held.extend(sorted({f"{tuple(c.shape)} of "
                                        f"{c.whole_shape()}"
                                        for c in module.leaves(cache)
                                        if isinstance(c, Block)}))
                toks, rows = [tok], []
                for i in range(DIST_TP_REC_STEPS):
                    tok, lg, cache = serve(params, cache, toks[-1], seq + i)
                    toks.append(tok)
                    rows.append(lg[:, -1].float().cpu())
                return torch.cat(toks, dim=1).tolist(), rows
        (toks, rows), info = timed(on_mesh, run)
        return toks, rows, held, info

    (logits, axes), rec["forward"] = timed(True, lambda: forward(True))
    rec["axes"] = axes
    prints = collectives.all_ranks(collectives.fingerprint(logits))
    rec["ranks_bit_equal"] = all(p == prints[0] for p in prints)
    bad = None
    if plant_cut:
        rec["qk"] = _split_qk(cfg, mesh, batch["tokens"].shape[0], device)
    if plant_cut:
        # the gate's and w_down's rows cut contiguously where the value
        # rows take each head's block of them (a forward's fault)
        rec["fault_name"] = "the gate and w_down cut contiguously"
        real = xlstm.take_parts

        def contiguous(leaf, dim, axes, parts):
            if parts == cfg.n_heads:
                return take(leaf, dim, axes)
            if parts == (1, cfg.n_heads):
                return real(leaf, dim, axes, 2)  # the gate half's block
            return real(leaf, dim, axes, parts)
        xlstm.take_parts = contiguous
        try:
            bad, _ = forward(True)
        finally:
            xlstm.take_parts = real
    if rank == 0:
        (want, _), rec["one_forward"] = timed(False, lambda: forward(False))
        rec["forward_err"] = _rel_err(logits, want)
        if plant_cut:
            rec["fault_err"] = _rel_err(bad, want)
        del want
    del logits, bad
    loss, got, rec["step"] = step(True)
    rec["loss"] = loss
    _same_on_ranks(f"the tensor-parallel {arch} step's loss", loss)
    bad = None
    if not plant_cut:
        rec["fault_name"] = "the recurrent layer's reduce_from a psum"
        real = plant.collectives
        plant.collectives = _PlantedReduce(real)
        try:
            _, bad, _ = step(True)
        finally:
            plant.collectives = real
    if rank == 0:
        want_loss, want, rec["one_step"] = step(False)
        errs = {path: _rel_err(g, w) for (path, g), (_, w) in zip(
            _paths(got), _paths(want))}
        worst = max(errs, key=errs.get)
        rec["loss_err"] = abs(loss - want_loss) / abs(want_loss)
        rec["grad_err"], rec["grad_worst"] = errs[worst], worst
        if not plant_cut:
            rec["fault_err"] = max(_rel_err(g, w) for g, w in zip(
                module.leaves(bad), module.leaves(want)))
        del want
    del got, bad
    toks, _, rec["held"], rec["decode"] = decode(True)
    rec["tokens"] = toks
    _same_on_ranks(f"the tensor-parallel {arch} decode's tokens", toks)
    if rank == 0:
        want, rows, _, rec["one_decode"] = decode(False)

        def logits_at(b, j):
            if j:
                return rows[j - 1][b]
            with torch.no_grad():           # the prefill's last position
                return model.forward(weights(False), {"tokens": tokens},
                                     remat=False)[0][b, -1]
        rec["note"] = _hold_tokens(f"dist tensor-parallel {arch} decode",
                                   toks, want, logits_at)
    torch.cuda.empty_cache()
    return rec


def _largest_period(params) -> dict:
    """The largest period of a stacked (``scan``) leaf held as a Block:
    its bytes whole (what the global norm gathers at a time) and this
    rank's, or {} where no stacked leaf is split."""
    from repro_torch.dist.sharding import Block
    from repro_torch.models import module

    best = {}
    for leaf, by_period in zip(module.leaves(params), module.stacked(params)):
        if not (by_period and isinstance(leaf, Block)):
            continue
        size = leaf.dtype.itemsize
        whole = math.prod(leaf.whole_shape()[1:]) * size
        if whole > best.get("whole_bytes", 0):
            best = {"whole_bytes": whole,
                    "local_bytes": math.prod(leaf.shape[1:]) * size,
                    "shape": list(leaf.whole_shape()[1:]),
                    "periods": leaf.shape[0]}
    return best


def _split_qk(cfg, mesh, batch: int, device) -> dict:
    """(5g): the mLSTM's intra-chunk q.k [B,L,L,H] over fp32 q and k of
    one chunk at ``cfg``'s width (seeded), on the mesh (each rank's block
    of the (batch, head) pairs, gathered) against the whole einsum in
    this process: the largest difference over the largest magnitude."""
    from repro_torch.dist import collectives
    from repro_torch.dist.sharding import train_rules, use_mesh
    from repro_torch.models import xlstm

    di = 2 * cfg.d_model
    dh = di // cfg.n_heads
    gen = torch.Generator().manual_seed(2)
    q, k = (torch.randn(batch, 256, cfg.n_heads, dh, generator=gen)
            .to(device) for _ in range(2))
    with torch.no_grad(), use_mesh(mesh, train_rules()):
        axes, heads, rows = xlstm.mlstm_axes(cfg, batch, 256, di)
        got = xlstm._intra_qk(q, k, rows)
    want = torch.einsum("blhd,bjhd->bljh", q, k)
    blocks = collectives.block_index(mesh, rows)[1] if rows else 0
    return {"rows": list(rows), "pairs": batch * cfg.n_heads,
            "split": bool(blocks) and batch * cfg.n_heads % blocks == 0,
            "err": _rel_err(got, want)}


def _dist_moe_shared(device) -> dict:
    """(3b) DIST_MOE_SHARED's MoE (its shared expert) at reduced(), fp32,
    on a (2, 2) ("data", "model") mesh with the local and the shard_map
    dispatch: the output against moe_reference, the shared expert's
    gradients (its hidden width split over "model" in the local dispatch,
    its f-shard in the shard_map one) against the global dispatch with no
    mesh."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import compat
    from repro_torch.dist.sharding import train_rules, use_mesh
    from repro_torch.models import module
    from repro_torch.models.moe import moe_apply, moe_reference, moe_spec

    cfg = dataclasses.replace(get_arch(DIST_MOE_SHARED).reduced(),
                              compute_dtype="float32", param_dtype="float32",
                              capacity_factor=8.0)
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
            y, _ = moe_apply(c, live, x)
        (y ** 2).sum().backward()
        return y.detach(), [live["shared"][k].grad for k in keys]

    with torch.no_grad():
        ref = moe_reference(cfg, params, x)
    _, want = run("global", False)
    out = {}
    for dispatch in ("local", "shardmap"):
        y, grads = run(dispatch, True)
        _same_on_ranks(f"the {dispatch} MoE's shared expert",
                       [_checksum([y]), _checksum(grads)])
        out[dispatch] = {"err": (y - ref).abs().max().item(),
                         "grad_err": max((g - w).abs().max().item()
                                         for g, w in zip(grads, want))}
    return out


def _grads_only(captured: list):
    """An AdamW without moments that appends each step's gradient tree
    (Blocks where the params are) to ``captured`` and leaves the params as
    they are: (5f) holds the gradients, and one process's moments would
    take 30 GB of the card at its size."""
    from repro_torch.dist.sharding import Block
    from repro_torch.models import module
    from repro_torch.optim.adamw import AdamW, AdamWState

    class GradsOnly(AdamW):
        def init(self, params):
            return AdamWState(step=torch.zeros((), dtype=torch.int32),
                              mu={}, nu={})

        def update(self, grads, state, params):
            captured.append(module.tree_map(
                lambda g, p: p.with_local(g) if isinstance(p, Block) else g,
                grads, params))
            return params, state, torch.zeros(())
    return GradsOnly(learning_rate=0.0)


def _blocked_init(model, mesh, rules, device, seed: int = 0):
    """``model.init_params`` of ``seed`` held as this rank's blocks under
    ``rules`` (``shard_tree``), one leaf at a time: each leaf drawn whole
    on the card from its own generator, as ``module.init`` draws it, then
    cut and freed, so that no rank holds the whole params."""
    from repro_torch.dist.sharding import shard_tree, tree_shardings
    from repro_torch.models import module

    specs = model.param_specs()
    count = iter(range(len(module.leaves(specs))))

    def one(spec, sh):
        g = torch.Generator(device=device)
        g.manual_seed(module._fold_in(seed, next(count)))
        return shard_tree(spec.instantiate(g, device), sh, mesh)
    return module.tree_map(one, specs, tree_shardings(specs, mesh, rules))


def _coords(mesh, rank: int) -> dict:
    """Global rank ``rank``'s coordinate along each of ``mesh``'s axes
    (laid out row-major, as ``init_device_mesh`` lays them)."""
    return dict(zip(mesh.mesh_dim_names,
                    (int(c) for c in np.unravel_index(rank,
                                                      tuple(mesh.shape)))))


def _block_at(t: torch.Tensor, spec, mesh, rank: int) -> torch.Tensor:
    """The block of ``t`` that global rank ``rank`` holds under ``spec``."""
    from repro_torch.dist.collectives import axis_size, names_of

    coords = _coords(mesh, rank)
    for dim, entry in enumerate(spec):
        index, blocks = 0, 1
        for name in names_of(entry):
            size = axis_size(mesh, name)
            index, blocks = index * size + coords[name], blocks * size
        if blocks > 1:
            length = t.shape[dim] // blocks
            t = t.narrow(dim, index * length, length)
    return t


def _against_host(got, spec, mesh, rank: int, want, need) -> float:
    """max |got - want's block| over max |want|, where ``got`` is this
    rank's block (on the card) of a tensor that rank 0 holds whole on the
    host (``want``: the tensor and its largest magnitude; None on the
    other ranks), sent block by block over gloo to the ranks in ``need``;
    nan on the others."""
    import torch.distributed as dist

    from repro_torch.dist import collectives

    mine = None
    if rank == 0:
        want, top = want
        for r in need:
            if r:
                dist.send(_block_at(want, spec, mesh, r).contiguous(), r)
        mine = _block_at(want, spec, mesh, 0)
    elif rank in need:
        mine = torch.empty(got.shape, dtype=got.dtype)
        dist.recv(mine, 0)
    top = collectives.all_ranks(top if rank == 0 else None)[0]
    if mine is None:
        return float("nan")
    return _max_diff(got, mine) / max(top, 1e-30)


def _max_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| with one temporary on ``got``'s device (``want``
    may lie on the host)."""
    d = want.to(got.device, dtype=torch.float32, copy=True)
    d.sub_(got)
    return d.abs_().max().item()


def _moe_leaves(tree) -> list:
    """The (path, leaf) pairs of the MoE's router and experts."""
    return [(p, x) for p, x in _paths(tree)
            if re.search(r"moe/(router|w_gate|w_up|w_down)$", p)]


def _dist_moe_global(mesh, rows: int, K, rank: int, world: int,
                     device) -> dict:
    """(5f): DIST_MOE_GLOBAL at full width cut to 1 layer, fp32, B = ``rows``
    S = DIST_MOE_GLOBAL_SEQ (with 2 rows the second is one token repeated,
    so that its data shard overflows its experts' capacity), on ``mesh``
    under train_rules() with the params held as blocks (each rank's
    experts a Block over "model"), through the global MoE dispatch: the
    forward's logits, one make_train_step step's loss and every gradient
    leaf, a prefill and DIST_MOE_GLOBAL_STEPS decode steps, against the
    same in one process, which rank 0 runs first while the other ranks
    wait, keeping its results on the host (each rank's block of them sent
    to it over gloo; on the (2, 2) mesh to the ranks of data coordinate 0
    only, the others held bit-equal to them).  The planted faults: on a
    mesh with a data axis the per-shard routing (the dispatch blind to
    the data-parallel region), on a forward inside a region of each
    rank's rows against the same with the whole batch's routing; else
    the experts' reduce_from a psum, on a step's MoE gradients.  The
    (token, slot)s dropped under each routing, the expert bytes held, the
    walls, staged bytes, peaks and flash launches."""
    import dataclasses
    import resource

    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.dist import collectives, compat
    from repro_torch.dist.sharding import (Block, data_region, local,
                                           serve_rules, train_rules,
                                           use_mesh)
    from repro_torch.models import build_model, module, moe
    from repro_torch.serve.decode import make_prefill_step, make_serve_step
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cfg = dataclasses.replace(get_arch(DIST_MOE_GLOBAL), n_layers=1,
                              compute_dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    seq, steps = DIST_MOE_GLOBAL_SEQ, DIST_MOE_GLOBAL_STEPS
    tokens = torch.randint(0, cfg.vocab_size, (rows, seq),
                           generator=torch.Generator().manual_seed(1),
                           dtype=torch.int32)
    if rows > 1:
        tokens[1] = tokens[1, 0]
    tokens = tokens.to(device)
    batch = {"tokens": tokens, "labels": tokens}
    link, rules = mesh.transport, train_rules()
    data = [n for n in mesh.mesh_dim_names if n != "model"]
    need = [r for r in range(world)
            if not any(_coords(mesh, r)[n] for n in data)]
    drops = []
    real_routing = moe._global_routing

    def routing(*args):
        out = real_routing(*args)
        drops.append(int((out[3] >= cfg.n_experts * out[4]).sum()))
        return out

    def timed(on_mesh, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if on_mesh:
            dist.barrier()
        host0, before = (link.host_bytes, link.host_s), launch_counts(K)
        drops.clear()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, {"wall_s": time.perf_counter() - t0,
                     "host_bytes": link.host_bytes - host0[0],
                     "host_s": link.host_s - host0[1],
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "flash": _delta(K, before),
                     "dropped": drops[0] if drops else None}

    def frame(on_mesh, r):
        return use_mesh(mesh if on_mesh else None, r if on_mesh else None)

    def forward(params, on_mesh):
        with torch.no_grad(), frame(on_mesh, rules):
            logits, _ = model.forward(params, {"tokens": tokens},
                                      remat=False)
            axes = model.vocab_axes(rows, seq) if on_mesh else ()
        return logits, axes

    def step(params, on_mesh, r=rules):
        captured = []
        opt = _grads_only(captured)
        state = opt.init(params)
        fn = make_train_step(model, opt, TrainStepConfig())

        def run():
            with frame(on_mesh, r):
                _, _, metrics = fn(params, state, batch)
                return metrics["loss"].item()
        loss, info = timed(on_mesh, run)
        # the list gives the tree up: the optimizer's class (a reference
        # cycle, freed only by the collector) keeps the list alive
        return loss, captured.pop(), info

    def region_forward(params):
        part = collectives.block(tokens, mesh, (tuple(data), None))
        with torch.no_grad(), data_region(mesh, tuple(data)), \
                use_mesh(compat.submesh(mesh, ["model"]), rules):
            return model.forward(params, {"tokens": part}, remat=False)[0]

    def decode(params, on_mesh):
        prefill = make_prefill_step(model, seq + steps)
        serve = make_serve_step(model)

        def run():
            with torch.no_grad(), frame(on_mesh, serve_rules()):
                tok, cache = prefill(params, {"tokens": tokens})
                toks, last = [tok], []
                for i in range(steps):
                    tok, lg, cache = serve(params, cache, toks[-1], seq + i)
                    toks.append(tok)
                    last.append(lg[:, -1].float().cpu())
                return torch.cat(toks, dim=1).tolist(), last
        (toks, last), info = timed(on_mesh, run)
        return toks, last, info

    rec = {"rows": rows, "seq": seq, "need": need}
    want = {}
    moe._global_routing = routing
    t0 = time.perf_counter()
    try:
        if rank == 0:
            params = model.init_params(torch.Generator().manual_seed(0),
                                       device=device)
            (logits, _), rec["one_forward"] = timed(
                False, lambda: forward(params, False))
            want["logits"] = (logits.cpu(), logits.abs().max().item())
            del logits
            want["loss"], grads, rec["one_step"] = step(params, False)
            want["grads"] = [(g.cpu(), g.abs().max().item())
                             for g in module.leaves(grads)]
            del grads
            want["tokens"], want["rows"], rec["one_decode"] = decode(
                params, False)
            del params
            torch.cuda.empty_cache()
        dist.barrier()
        rec["one_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        params = _blocked_init(model, mesh, rules, device)
        rec["init_s"] = time.perf_counter() - t0
        rec["expert_bytes"] = sum(
            local(x).numel() * local(x).element_size()
            for p, x in _moe_leaves(params) if not p.endswith("router"))
        rec["expert_shape"] = [list(local(x).shape)
                               for p, x in _moe_leaves(params)
                               if p.endswith("w_gate")]
        (logits, axes), rec["forward"] = timed(
            True, lambda: forward(params, True))
        spec = (None, None, tuple(axes) or None)
        rec["forward_err"] = _against_host(logits, spec, mesh, rank,
                                           want.get("logits"), need)
        prints = collectives.all_ranks(collectives.fingerprint(logits))
        del logits
        if rank == 0:                   # the prefill's last position
            want["last"] = want.pop("logits")[0][:, -1].clone()

        loss, grads, rec["step"] = step(params, True)
        rec["loss"] = loss
        _same_on_ranks("the global MoE step's loss", loss)
        t0 = time.perf_counter()
        errs = {}
        for i, (path, g) in enumerate(_paths(grads)):
            spec = g.spec if isinstance(g, Block) else (None,) * g.ndim
            errs[path] = _against_host(local(g), spec, mesh, rank,
                                       want["grads"][i] if rank == 0
                                       else None, need)
            prints.append(collectives.fingerprint(local(g)))
        rec["compare_s"] = time.perf_counter() - t0
        worst = max((p for p in errs if errs[p] == errs[p]),
                    key=errs.get, default=None)
        rec["grad_err"] = errs[worst] if worst else float("nan")
        rec["grad_worst"] = worst
        rec["prints"] = prints
        if rank == 0:
            rec["loss_err"] = abs(loss - want["loss"]) / abs(want["loss"])
            if not data:
                del want["grads"]
        good = [(p, local(g).cpu()) for p, g in _moe_leaves(grads)] \
            if not data else None
        del grads
        torch.cuda.empty_cache()

        if data:
            # the routing blind to the region: a forward over this rank's
            # rows inside the region, against the same with the whole
            # batch's routing
            rec["fault"] = "per-shard routing"
            rec["fault_on"] = "logits of a forward in the region"
            got, _ = timed(True, lambda: region_forward(params))
            real = moe.active_region
            moe.active_region = lambda: None
            try:
                bad, bad_info = timed(True, lambda: region_forward(params))
            finally:
                moe.active_region = real
            rec["fault_err"] = _rel_err(bad, got)
            del got, bad
        else:
            rec["fault"] = "experts' reduce_from a psum"
            rec["fault_on"] = "MoE gradients in a step"
            real = moe.collectives
            moe.collectives = _PlantedReduce(real)
            try:
                _, bad, bad_info = step(params, True)
            finally:
                moe.collectives = real
            bad = [local(g) for _, g in _moe_leaves(bad)]   # the rest freed
            rec["fault_err"] = max(
                _max_diff(g, w) / max(w.abs().max().item(), 1e-30)
                for g, (_, w) in zip(bad, good))
            del bad, good
        rec["fault_s"] = bad_info["wall_s"]
        rec["fault_dropped"] = bad_info["dropped"]
        torch.cuda.empty_cache()

        toks, _, rec["decode"] = decode(params, True)
        rec["tokens"] = toks
        _same_on_ranks("the global MoE decode's tokens", toks)
        del params
        torch.cuda.empty_cache()
        if data:
            rec["fsdp"] = _moe_fsdp_step(step, mesh, rank, world, device,
                                         model, want)
        if rank == 0:
            rec["note"] = _hold_tokens(
                f"dist global MoE decode on {tuple(mesh.shape)}", toks,
                want["tokens"], lambda b, j: want["rows"][j - 1][b] if j
                else want["last"][b])
            rec["one_dropped"] = rec["one_step"]["dropped"]
    finally:
        moe._global_routing = real_routing
    rec["max_rss_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    return rec


class _Unweighted:
    """A stand-in for ``dist.collectives`` in ``models.moe`` whose
    ``gather_weighted`` leaves the cotangents unweighted (the planted
    fault of (5f)'s fsdp step): each rank's tokens enter the experts'
    shared products at weight 1."""

    def __init__(self, real):
        self._real = real

    def __getattr__(self, name):
        return getattr(self._real, name)

    def gather_weighted(self, t, mesh, names, dim, weight):
        return self._real.gather_weighted(t, mesh, names, dim,
                                          torch.ones_like(weight))


def _moe_fsdp_step(step, mesh, rank: int, world: int, device, model,
                   want) -> dict:
    """(5f)'s step on the (2, 2) mesh under ``train_rules(fsdp=True)``: the
    params held as blocks, each rank's experts a Block over ("model",
    "data"), so the global dispatch computes them on its blocks of d
    (``models.moe``); the loss and every gradient leaf against rank 0's
    one-process run (``want``, whose gradients it then frees), each rank
    its own blocks; and the same step with the cotangents entering the
    experts' all-gather unweighted (planted), its MoE gradients against
    the step's."""
    from repro_torch.dist.sharding import Block, local, train_rules
    from repro_torch.models import moe

    rules = train_rules(fsdp=True)
    t0 = time.perf_counter()
    params = _blocked_init(model, mesh, rules, device)
    rec = {"init_s": time.perf_counter() - t0, "expert": [
        [list(local(x).shape), list(map(str, x.spec))]
        for p, x in _moe_leaves(params) if not p.endswith("router")]}
    ways = []
    real_blocks = moe._experts_on_embed_blocks

    def on_blocks(*args):
        ways.append(args[3])
        return real_blocks(*args)

    moe._experts_on_embed_blocks = on_blocks
    try:
        loss, grads, rec["step"] = step(params, True, rules)
    finally:
        moe._experts_on_embed_blocks = real_blocks
    rec["ways"] = sorted(set(ways))
    _same_on_ranks("the fsdp MoE step's loss", loss)
    t0 = time.perf_counter()
    errs = {}
    for i, (path, g) in enumerate(_paths(grads)):
        spec = g.spec if isinstance(g, Block) else (None,) * g.ndim
        errs[path] = _against_host(local(g), spec, mesh, rank,
                                   want["grads"][i] if rank == 0 else None,
                                   range(world))
    rec["compare_s"] = time.perf_counter() - t0
    worst = max(errs, key=errs.get)
    rec["grad_err"], rec["grad_worst"] = errs[worst], worst
    if rank == 0:
        rec["loss_err"] = abs(loss - want["loss"]) / abs(want["loss"])
        del want["grads"]
    good = [local(g).clone() for _, g in _moe_leaves(grads)]
    del grads
    torch.cuda.empty_cache()
    real = moe.collectives
    moe.collectives = _Unweighted(real)
    try:
        _, bad, rec["fault_step"] = step(params, True, rules)
    finally:
        moe.collectives = real
    rec["fault_err"] = max(
        _max_diff(local(g), w) / max(w.abs().max().item(), 1e-30)
        for (_, g), w in zip(_moe_leaves(bad), good))
    del bad, good, params
    torch.cuda.empty_cache()
    return rec


def moe_child(argv) -> int:
    """``python3 chip_smoke.py --moe-child RANK WORLD URL OUT``: one rank of
    phase_dist's (5f) on cuda:0, joined over gloo at URL, on each mesh of
    DIST_MOE_GLOBAL_MESHES in turn; writes its report to OUT.RANK.json."""
    from repro_torch.dist import compat

    import gc

    rank, world, url, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    K = _kernels()
    device = compat.init_process_group(
        DIST_DEVICE, backend="gloo", init_method=url, rank=rank,
        world_size=world, timeout_s=DIST_MOE_GLOBAL_TIMEOUT_S)
    rep = {"rank": rank}
    for label, shape, names, rows in DIST_MOE_GLOBAL_MESHES:
        mesh = compat.make_mesh(shape, names, device=device)
        gc.collect()
        torch.cuda.empty_cache()
        rep[label] = _dist_moe_global(mesh, rows, K, rank, world, device)
        print(f"{label}: device memory left allocated "
              f"{torch.cuda.memory_allocated()} bytes, host peak "
              f"{rep[label]['max_rss_bytes']} bytes", flush=True)
    rep["launches"] = launch_counts(K)
    Path(f"{out}.{rank}.json").write_text(json.dumps(rep))
    torch.distributed.destroy_process_group()
    return 0


def rows_child(argv) -> int:
    """``python3 chip_smoke.py --rows-child RANK WORLD URL OUT``: one rank of
    phase_dist's (5g) on cuda:0 over gloo, on a ("model",) mesh of WORLD;
    writes its report to OUT.RANK.json."""
    from repro_torch.dist import compat

    rank, world, url, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    K = _kernels()
    device = compat.init_process_group(
        DIST_DEVICE, backend="gloo", init_method=url, rank=rank,
        world_size=world, timeout_s=DIST_GROUP_TIMEOUT_S)
    mesh = compat.make_mesh((world,), ("model",), device=device)
    arch, layers, batch, seq = DIST_ROWS
    rep = {"rank": rank, "rows": _dist_tp_recurrent(
        arch, mesh, K, rank, device, layers, seq, plant_cut=True,
        batch=batch)}
    rep["launches"] = launch_counts(K)
    Path(f"{out}.{rank}.json").write_text(json.dumps(rep))
    torch.distributed.destroy_process_group()
    return 0


def _group(mode: str, world: int, label: str, counts, env=None) -> tuple:
    """``world`` children ``--MODE-child`` on cuda:0 over gloo, with
    ``env`` added to their environment: (their reports, the wall)."""
    import os

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/rank"
        argvs = [[f"--{mode}-child", str(r), str(world),
                  f"file://{tmp}/rendezvous", out] for r in range(world)]
        t0 = time.perf_counter()
        _children(argvs, [{**os.environ, **(env or {})}] * world, label)
        wall = time.perf_counter() - t0
        reps = [json.loads(Path(f"{out}.{r}.json").read_text())
                for r in range(world)]
    for rep in reps:
        _add(counts, rep["launches"])
    return reps, wall


def _flash_of(part: dict) -> dict:
    return {k: v for k, v in part["flash"].items() if v}


def _dist_moe_global_report(counts, card) -> dict:
    """(5f) in DIST_RANKS children: the prints and gates."""
    from repro_torch.configs import get_arch

    # the four ranks on (2, 2) hold 7.5 GB of params and as much of
    # gradients each: the allocator's segments grow in place rather than
    # leave each rank 3 GB reserved and unused
    reps, wall = _group("moe", DIST_RANKS, "global MoE", counts, {
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    cfg = get_arch(DIST_MOE_GLOBAL)
    whole = 3 * cfg.n_experts * cfg.d_model * cfg.expert_d_ff * 4
    tol, out = DIST_TP_REC_TOL, {"moe_global_wall_s": wall}
    print(f"dist: global MoE, {DIST_MOE_GLOBAL} at full width (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, {cfg.n_experts} experts of "
          f"{cfg.expert_d_ff}, top-{cfg.moe_top_k}, vocabulary "
          f"{cfg.vocab_size}) cut to 1 of {cfg.n_layers} layers, fp32, "
          f"{DIST_RANKS} ranks on {DIST_DEVICE}: {wall:.1f} s; {card}")
    for label, shape, names, rows in DIST_MOE_GLOBAL_MESHES:
        r0 = reps[0][label]
        model_n = shape[names.index("model")]
        one = {p: _flash_of(r0[f"one_{p}"])
               for p in ("forward", "step", "decode")}
        for rep in reps:
            rec = rep[label]
            flash = {p: _flash_of(rec[p]) for p in ("forward", "step",
                                                    "decode")}
            print(f"dist: global MoE on {shape} {names} rank {rep['rank']}, "
                  f"B={rows} S={rec['seq']}: experts held "
                  f"{rec['expert_shape']} a leaf, {rec['expert_bytes']} "
                  f"bytes of the whole {whole}; forward "
                  f"{rec['forward']['wall_s']:.2f} s, train step "
                  f"{rec['step']['wall_s']:.2f} s, "
                  f"{rec['step']['host_bytes']} bytes staged in "
                  f"{rec['step']['host_s']:.3f} s, peak "
                  f"{rec['step']['peak_bytes'] / 2**30:.2f} GiB against one "
                  f"process's {r0['one_step']['peak_bytes'] / 2**30:.2f} "
                  f"GiB, host peak {rec['max_rss_bytes'] / 2**30:.1f} GiB; "
                  f"prefill + {DIST_MOE_GLOBAL_STEPS} decode steps "
                  f"{rec['decode']['wall_s']:.2f} s; flash launches "
                  f"{json.dumps(flash)}, one process's {json.dumps(one)}; "
                  f"{card}")
            if flash != one:
                raise RuntimeError(f"dist: global MoE rank {rep['rank']} "
                                   f"launched {flash}, one process {one}")
            if rec["expert_bytes"] * model_n != whole:
                raise RuntimeError(f"dist: global MoE rank {rep['rank']} "
                                   f"holds {rec['expert_bytes']} expert "
                                   f"bytes of {whole}")
        firsts = [rep[label] for rep in reps
                  if rep["rank"] in reps[0][label]["need"]]
        errs = [r["forward_err"] for r in firsts]
        worst = max((r["grad_err"], r["grad_worst"]) for r in firsts)
        # model is the mesh's last axis: rank r's replica of data
        # coordinate 0 is r % model_n, and the ranks of model coordinate 0
        # hold the data shards
        replicas = all(rep[label]["prints"]
                       == reps[rep["rank"] % model_n][label]["prints"]
                       for rep in reps)
        shards = range(0, DIST_RANKS, model_n)
        whole_drop = sum(reps[r][label]["step"]["dropped"] for r in shards)
        shard_drop = sum(reps[r][label]["fault_dropped"] for r in shards)
        fault = max(rep[label]["fault_err"] for rep in reps)
        print(f"dist: global MoE on {shape} against one process: logits "
              f"{max(errs):.3g} of the largest (bound {tol}), the step's "
              f"loss {r0['loss_err']:.3g} relative, gradients "
              f"{worst[0]:.3g} of their leaf's largest at worst "
              f"({worst[1]}), the data replicas "
              f"{'bit-equal' if replicas else 'DIFFER'}; (token, slot)s "
              f"dropped {whole_drop} routing the whole batch (one process "
              f"{r0['one_dropped']}), {shard_drop} under the planted "
              f"{r0['fault']}, whose {r0['fault_on']} land at "
              f"{fault:.3g}; "
              f"decode tokens against one process: {r0['note']}; rank 0's "
              f"one-process run and the others' wait {r0['one_s']:.1f} s, "
              f"the blocked init {r0['init_s']:.1f} s, the gradients sent "
              f"and compared {r0['compare_s']:.1f} s, the planted run "
              f"{r0['fault_s']:.1f} s; {card}")
        if not (max(errs) <= tol and r0["loss_err"] <= tol
                and worst[0] <= tol and replicas):
            raise RuntimeError(f"dist: the global MoE on {shape} misses its "
                               f"bound: {errs}, {r0['loss_err']}, {worst}, "
                               f"replicas {replicas}")
        if whole_drop != r0["one_dropped"] or not fault > tol:
            raise RuntimeError(f"dist: the global MoE on {shape}: dropped "
                               f"{whole_drop} against one process's "
                               f"{r0['one_dropped']}, the planted fault "
                               f"{fault:.3g}")
        if len(names) > 1 and shard_drop == whole_drop:
            raise RuntimeError(f"dist: the per-shard routing dropped as "
                               f"many as the whole batch's ({whole_drop})")
        peaks = [rep[label]["step"]["peak_bytes"] for rep in reps]
        gib, seq = DIST_MOE_EARLIER_PEAK
        earlier = (f"; PERF.md records {gib} GiB for 4 ranks at S = {seq} "
                   f"before it, not comparable" if len(names) == 1 else "")
        print(f"dist: global MoE on {shape}: the train step's peak "
              f"{max(peaks) / 2**30:.2f} GiB a rank at most at S = "
              f"{DIST_MOE_GLOBAL_SEQ} (the combine over blocks of "
              f"tokens){earlier}; {card}")
        out[f"moe_global_{label}"] = {
            "logits": max(errs), "grads": worst[0],
            "loss": r0["loss_err"], "fault": fault,
            "dropped": [whole_drop, shard_drop],
            "step_peak_bytes": [rep[label]["step"]["peak_bytes"]
                                for rep in reps],
            "one_step_peak_bytes": r0["one_step"]["peak_bytes"]}
        if len(names) > 1:
            out[f"moe_global_{label}_fsdp"] = _moe_fsdp_report(
                reps, label, shape, tol, card)
    return out


def _moe_fsdp_report(reps, label, shape, tol, card) -> dict:
    """(5f)'s fsdp step: the prints and gates."""
    fs = [rep[label]["fsdp"] for rep in reps]
    worst = max((f["grad_err"], f["grad_worst"]) for f in fs)
    fault = max(f["fault_err"] for f in fs)
    loss = fs[0]["loss_err"]
    specs = {json.dumps(e) for f in fs for e in f["expert"]}
    for rep, f in zip(reps, fs):
        print(f"dist: global MoE on {shape} under train_rules(fsdp=True) "
              f"rank {rep['rank']}: experts held {f['expert']}, computed "
              f"{f['ways']} on blocks of d; blocked init "
              f"{f['init_s']:.1f} s, train step "
              f"{f['step']['wall_s']:.2f} s, "
              f"{f['step']['host_bytes']} bytes staged in "
              f"{f['step']['host_s']:.3f} s, peak "
              f"{f['step']['peak_bytes'] / 2**30:.2f} GiB; gradients sent "
              f"and compared {f['compare_s']:.1f} s; {card}")
    print(f"dist: global MoE on {shape} under fsdp against one process: "
          f"the step's loss {loss:.3g} relative, gradients {worst[0]:.3g} "
          f"of their leaf's largest at worst ({worst[1]}) (bound {tol}); "
          f"the planted unweighted cotangents of the experts' all-gather "
          f"land at {fault:.3g} on the MoE gradients; {card}")
    held = all(f["ways"] == ["held"] for f in fs) and all(
        {"model", "data"} <= set(json.loads(e)[1]) for e in specs)
    if not (held and loss <= tol and worst[0] <= tol and fault > tol):
        raise RuntimeError(f"dist: the global MoE under fsdp on {shape}: "
                           f"experts {sorted(specs)} computed "
                           f"{[f['ways'] for f in fs]}, loss {loss}, "
                           f"gradients {worst}, planted {fault}")
    return {"grads": worst[0], "loss": loss, "fault": fault,
            "step_peak_bytes": [f["step"]["peak_bytes"] for f in fs]}


def _dist_rows_report(counts, card) -> dict:
    """(5g) in DIST_ROWS_RANKS children: the prints and gates, and C held
    as each rank's block of its value rows."""
    reps, wall = _group("rows", DIST_ROWS_RANKS, "value rows", counts)
    arch, layers, batch, seq = DIST_ROWS
    cfg = _arch(arch)
    dh = 2 * cfg.d_model // cfg.n_heads
    rows = dh // DIST_ROWS_RANKS
    print(f"dist: {arch}'s first layer (an mLSTM, {cfg.n_heads} heads of "
          f"{dh}, which do not divide {DIST_ROWS_RANKS}) at full width, "
          f"fp32, B={batch} S={seq}, on a ('model',) mesh of "
          f"{DIST_ROWS_RANKS} ranks on {DIST_DEVICE}: {wall:.1f} s; {card}")
    out = _tp_recurrent_case(reps, "rows", arch, card)
    parts = ("forward", "step", "decode")
    staged = {part: [rep["rows"][part]["host_bytes"] for rep in reps]
              for part in parts}
    received = {part: [rep["rows"][part]["a2a_bytes"] for rep in reps]
                for part in parts}
    d, di = cfg.d_model, 2 * cfg.d_model
    leaves = (d * 2 * di + di * d) * 4      # w_up and w_down, fp32
    print(f"dist: {arch}'s first layer, bytes staged through the host a "
          f"rank (forward, train step, prefill + decode): "
          f"{json.dumps(staged)}; bytes the all-to-alls received a rank: "
          f"{json.dumps(received)}, where its w_up and w_down are {leaves} "
          f"bytes whole; {card}")
    out["rows_staged_bytes"] = staged
    out["rows_a2a_bytes"] = received
    qk = [rep["rows"]["qk"] for rep in reps]
    worst = max(q["err"] for q in qk)
    mine = qk[0]["pairs"] // DIST_ROWS_RANKS
    print(f"dist: {arch}'s intra-chunk q.k [{batch}, 256, 256, "
          f"{cfg.n_heads}] on each rank's {mine} of the {qk[0]['pairs']} "
          f"(batch, head) pairs "
          f"over {qk[0]['rows']}, against the whole einsum: {worst:.3g} of "
          f"the largest at worst over the ranks (bound {DIST_TP_REC_TOL}); "
          f"{card}")
    if not all(q["split"] for q in qk) or not worst <= DIST_TP_REC_TOL:
        raise RuntimeError(f"dist: {arch}'s split q.k: {qk}")
    out["rows_qk_err"] = worst
    held = reps[0]["rows"]["held"]
    want = f"{rows}, {dh}) of "
    if not any(want in h and h.endswith(f"{dh}, {dh})") for h in held):
        raise RuntimeError(f"dist: {arch}'s C is not held as {rows} of "
                           f"{dh} value rows a rank: {held}")
    print(f"dist: {arch}'s C held as each rank's {rows} of {dh} value rows: "
          f"{held}; {card}")
    out["rows_wall_s"] = wall
    return out


def dist_child(argv) -> int:
    """``python3 chip_smoke.py --dist-child RANK WORLD URL OUT``: one rank
    of phase_dist's (1)-(3) on cuda:0, joined over gloo at URL; writes its
    report to OUT.RANK.json."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.dist import compat
    from repro_torch.dist.sharding import (shard_tree, train_rules,
                                           tree_shardings)
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
    # the blocked ring first, with no whole leaf alive: its peak is the
    # blocked layout's; then the same weights again, whole
    held = shard_tree(params, tree_shardings(
        model.param_specs(), mesh, train_rules(seq_parallel=True)), mesh)
    del params
    torch.cuda.empty_cache()
    blocked = _dist_ring_blocked(model, held, {"tokens": tokens}, mesh, K,
                                 rank)
    rep["ring_blocked"] = blocked[0]
    del held
    torch.cuda.empty_cache()
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    rep["ring"] = _dist_ring(model, params, {"tokens": tokens}, mesh, K,
                             rank, blocked)
    del blocked
    torch.cuda.empty_cache()
    rep["decode"] = _dist_decode(model, params, tokens[:, :DIST_PROMPT],
                                 mesh, K, rank)
    del params
    torch.cuda.empty_cache()
    rep["decode_blocked"], ref = _dist_decode_blocked(device, rank, world, K)
    torch.cuda.empty_cache()
    rep["moe"] = _dist_moe(device)
    torch.cuda.empty_cache()
    rep["tp_forward"] = _dist_tp_forward(model, tokens, mesh, K, rank, world,
                                         device)
    torch.cuda.empty_cache()
    rep["tp_train"] = _dist_tp_train(mesh, K, rank, device)
    torch.cuda.empty_cache()
    rep["tp_decode"] = _dist_tp_decode(mesh, K, rank, device, ref)
    del ref
    torch.cuda.empty_cache()
    rep["moe_shared"] = _dist_moe_shared(device)
    for arch in DIST_TP_RECURRENT:
        torch.cuda.empty_cache()
        rep[f"tp_{arch}"] = _dist_tp_recurrent(arch, mesh, K, rank, device)
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
    first = None            # the child that failed first
    try:
        while any(p.poll() is None for p in procs):
            first = next((i for i, p in enumerate(procs)
                          if p.poll() not in (None, 0)), None)
            if first is not None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [(p.wait(), p.stdout.read(), p.stderr.read()) for p in procs]
    order = ([first] if first is not None else []) + list(range(len(outs)))
    for i in order:
        rc, out, err = outs[i]
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
    for rep in reps:
        ring, blk = rep["ring"], rep["ring_blocked"]
        print(f"dist: ring forward, params held as blocks, rank "
              f"{rep['rank']}: wall {blk['wall_s']:.2f} s, "
              f"{blk['host_bytes']} bytes staged through the host in "
              f"{blk['host_s']:.3f} s ({blk['host_bytes'] - ring['host_bytes']:+d}"
              f" against the whole params' ring, the per-layer gathers), "
              f"peak device memory {blk['peak_bytes'] / 2**30:.2f} GiB "
              f"against {ring['peak_bytes'] / 2**30:.2f} GiB whole, params "
              f"held {blk['held_bytes'] / 2**30:.3f} GiB, flash launches "
              f"{json.dumps(blk['flash'])}; logits bit-equal to the whole "
              f"params' ring: {ring['blocked_bit_equal']}; {card}")
        if any(blk["flash"].values()):
            raise RuntimeError(f"dist: the blocked ring launched "
                               f"{blk['flash']}")
    ring = r0["ring"]
    if not (ring["blocked_bit_equal"] and r0["ring_blocked"]
            ["ranks_bit_equal"]):
        raise RuntimeError("dist: the blocked ring's logits differ from the "
                           "whole params' ring or between ranks")
    print(f"dist: blocked ring logits against the one-process forward "
          f"through the flash kernel: {ring['blocked_err']:.3g} of the "
          f"largest logit (bound {MODEL_TOL['float32']}); {card}")
    _gate(DIST_ARCH, "blocked ring logits from the flash forward",
          ring["blocked_err"], "float32")
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
    print(f"dist: long-context decode, prefill {DIST_PROMPT} + "
          f"{DIST_RING_STEPS} steps on the cache held as each rank's block "
          f"of its sequence (cache_seq over {DIST_RANKS} ranks): the fp32 "
          f"cache {dec['cache_bytes'] / 2**20:.2f} MiB a rank of "
          f"{dec['cache_whole_bytes'] / 2**20:.2f} MiB whole; rank 0 wall "
          f"{dec['wall_s']:.2f} s (stream_kv steps {dec['stream_s']:.2f} s, "
          f"plain steps {dec['plain_s']:.2f} s), {dec['host_bytes']} bytes "
          f"staged in {dec['host_s']:.3f} s, flash launches "
          f"{json.dumps(dec['flash'])}; fp32 tokens against one process: "
          f"stream_kv {dec['note']}, plain step {dec['plain_note']}; {card}")
    for rep in reps:
        d = rep["decode"]
        if d["cache_bytes"] * DIST_RANKS != d["cache_whole_bytes"]:
            raise RuntimeError(f"dist: rank {rep['rank']} holds "
                               f"{d['cache_bytes']} bytes of the cache, not "
                               f"1/{DIST_RANKS} of {d['cache_whole_bytes']}")
    blk = r0["decode_blocked"]
    print(f"dist: blocked decode, {DIST_ARCH} at {DIST_DECODE_LAYERS} of 26 "
          f"layers, fp32, {DIST_DECODE_BATCH} prompts of {DIST_PROMPT} + "
          f"{DIST_STEPS} steps through make_prefill_step/make_serve_step on "
          f"a ('data',) mesh of {DIST_RANKS} ranks, tokens and bf16 cache "
          f"held as each rank's rows: rank 0 wall {blk['wall_s']:.2f} s, "
          f"{blk['host_bytes']} bytes staged in {blk['host_s']:.3f} s, cache "
          f"held {blk['cache_bytes'] / 2**20:.1f} MiB of "
          f"{blk['cache_whole_bytes'] / 2**20:.1f} MiB whole, flash launches "
          f"{json.dumps(blk['flash'])}; tokens against one process: "
          f"{blk['note']}; {card}")
    moe = r0["moe"]
    worst = max(moe["grad_err"].values())
    print(f"dist: shard_map MoE {DIST_MOE} reduced on (2, 2) ('data', "
          f"'model'), transport {moe['transport']}: output {moe['err']:.3g} "
          f"from moe_reference, expert gradients from the global dispatch "
          f"{json.dumps(moe['grad_err'])} (bound {DIST_MOE_TOL}); aux "
          f"{moe['aux']:.6f}; {card}")
    if not (moe["err"] <= DIST_MOE_TOL and worst <= DIST_MOE_TOL):
        raise RuntimeError(f"dist: the shard_map MoE {moe}")
    tp = _dist_tp_report(reps, card)
    tp.update(_dist_tp_recurrent_report(reps, card))
    return {**tp, "ring_wall_s": [r["ring"]["wall_s"] for r in reps],
            "ring_host_bytes": [r["ring"]["host_bytes"] for r in reps],
            "ring_peak_bytes": [r["ring"]["peak_bytes"] for r in reps],
            "blocked_ring_wall_s": [r["ring_blocked"]["wall_s"]
                                    for r in reps],
            "blocked_ring_host_bytes": [r["ring_blocked"]["host_bytes"]
                                        for r in reps],
            "blocked_ring_peak_bytes": [r["ring_blocked"]["peak_bytes"]
                                        for r in reps],
            "blocked_ring_err": ring["blocked_err"],
            "blocked_decode_wall_s": blk["wall_s"],
            "ring_err": ring["err"], "fault_err": ring["fault_err"],
            "decode_wall_s": dec["wall_s"], "moe_err": moe["err"],
            "moe_grad_err": worst}


def _dist_tp_report(reps, card) -> dict:
    """(5a)-(5c)'s prints and gates over the ranks' reports."""
    r0 = reps[0]
    layers = _dist_layers()
    want_fwd = {"flash_attention": layers}
    for rep in reps:
        fwd = rep["tp_forward"]
        flash = {k: v for k, v in fwd["flash"].items() if v}
        heads = sorted({tuple(h) for h in fwd["heads"]})
        print(f"dist: tensor-parallel forward rank {rep['rank']}, "
              f"{DIST_ARCH} fp32 B=1 S={DIST_SEQ} on a ('model',) mesh of "
              f"{len(reps)} under train_rules(), params held as blocks: wall "
              f"{fwd['wall_s']:.2f} s, {fwd['host_bytes']} bytes staged "
              f"through the host in {fwd['host_s']:.3f} s, peak device "
              f"memory {fwd['peak_bytes'] / 2**30:.2f} GiB, params held "
              f"{fwd['held_bytes'] / 2**30:.3f} GiB, logits block "
              f"{fwd['width']} wide over {fwd['axes']}, flash launches "
              f"{json.dumps(flash)} at (heads, KV heads) {heads}; {card}")
        if flash != want_fwd or heads != [(1, 1)]:
            raise RuntimeError(f"dist: the tensor-parallel forward launched "
                               f"{flash} at heads {heads} (want {want_fwd} "
                               f"at one head)")
    fwd = r0["tp_forward"]
    print(f"dist: tensor-parallel forward, each rank's vocabulary block "
          f"against the one-process flash forward's "
          f"({json.dumps(fwd['one_process_flash'])}): "
          f"{[float(f'{e:.3g}') for e in fwd['errs']]} of the largest logit "
          f"{fwd['logit_max']:.4g} (bound {MODEL_TOL['float32']}); the "
          f"ranks' final hidden states "
          f"{'bit-equal' if fwd['ranks_bit_equal'] else 'DIFFER'}; {card}")
    if not fwd["ranks_bit_equal"] or len(fwd["errs"]) != len(reps):
        raise RuntimeError("dist: the tensor-parallel forward's ranks differ")
    for e in fwd["errs"]:
        _gate(DIST_ARCH, "tensor-parallel logits from the flash forward", e,
              "float32")
    want_train = {"flash_attention_fwd": DIST_TP_TRAIN_LAYERS,
                  "flash_attention_bwd_dq": DIST_TP_TRAIN_LAYERS,
                  "flash_attention_bwd_dkv": DIST_TP_TRAIN_LAYERS}
    for rep in reps:
        tr = rep["tp_train"]
        flash = {k: v for k, v in tr["flash"].items() if v}
        print(f"dist: tensor-parallel train step rank {rep['rank']}, "
              f"{DIST_ARCH} at {DIST_TP_TRAIN_LAYERS} of {layers} layers, "
              f"fp32, B=1 S={DIST_TP_TRAIN_SEQ}, AdamW: wall "
              f"{tr['wall_s']:.2f} s, {tr['host_bytes']} bytes staged in "
              f"{tr['host_s']:.3f} s, peak {tr['peak_bytes'] / 2**30:.2f} "
              f"GiB, loss {tr['loss']:.6f}, flash launches "
              f"{json.dumps(flash)}; {card}")
        if flash != want_train:
            raise RuntimeError(f"dist: the tensor-parallel step launched "
                               f"{flash}, want {want_train}")
    tr = r0["tp_train"]
    one = tr["one_process"]
    one_flash = {k: v for k, v in one["flash"].items() if v}
    print(f"dist: tensor-parallel train step against one process (wall "
          f"{one['wall_s']:.2f} s, peak {one['peak_bytes'] / 2**30:.2f} GiB, "
          f"flash {json.dumps(one_flash)}): loss {tr['loss_err']:.3g} "
          f"relative, gradients {tr['grad_err']:.3g} of their leaf's largest "
          f"magnitude at worst ({tr['grad_worst']}), bound "
          f"{MODEL_TOL['float32']}; planted fault (reduce_from's backward a "
          f"psum) {tr['fault_err']:.3g}, its loss {tr['fault_loss']:.6f}; "
          f"{card}")
    _gate(DIST_ARCH, "tensor-parallel loss", tr["loss_err"], "float32")
    _gate(DIST_ARCH, "tensor-parallel gradients", tr["grad_err"], "float32")
    if one_flash != want_train:
        raise RuntimeError(f"dist: the one-process step launched {one_flash}")
    if not tr["fault_err"] > MODEL_TOL["float32"]:
        raise RuntimeError(f"dist: the bound misses the planted reduce_from "
                           f"fault ({tr['fault_err']:.3g})")
    want_dec = {"flash_attention": DIST_DECODE_LAYERS}
    for rep in reps:
        dec = rep["tp_decode"]
        flash = {k: v for k, v in dec["flash"].items() if v}
        if flash != want_dec:
            raise RuntimeError(f"dist: the tensor-parallel decode launched "
                               f"{flash}, want {want_dec}")
    dec = r0["tp_decode"]
    print(f"dist: tensor-parallel decode, {DIST_ARCH} at "
          f"{DIST_DECODE_LAYERS} of {layers} layers, fp32, "
          f"{DIST_DECODE_BATCH} prompts of {DIST_PROMPT} + {DIST_STEPS} "
          f"steps through make_prefill_step/make_serve_step on a ('model',) "
          f"mesh of {len(reps)} under serve_rules(), params held as blocks: "
          f"rank 0 wall {dec['wall_s']:.2f} s, {dec['host_bytes']} bytes "
          f"staged in {dec['host_s']:.3f} s, flash launches a rank "
          f"{json.dumps(want_dec)}; tokens against one process: "
          f"{dec['note']}; {card}")
    return {"tp_forward_wall_s": [r["tp_forward"]["wall_s"] for r in reps],
            "tp_forward_host_bytes": [r["tp_forward"]["host_bytes"]
                                      for r in reps],
            "tp_forward_peak_bytes": [r["tp_forward"]["peak_bytes"]
                                      for r in reps],
            "tp_forward_err": max(fwd["errs"]),
            "tp_train_grad_err": tr["grad_err"],
            "tp_train_fault_err": tr["fault_err"],
            "tp_decode_wall_s": dec["wall_s"]}


def _ssm_unrematted_bytes(arch, ranks) -> int:
    """What the SSM scan's loop kept for the backward before its chunk
    step was remat'ed, worked out from (5d)'s shapes: at least A_bar and
    Bx whole over the sequence, [B, S, d_inner / ranks, state] fp32 each,
    a layer (the associative scan's own products besides)."""
    cfg = _arch(arch)
    layers, seq = DIST_TP_RECURRENT[arch]
    return layers * 2 * seq * (cfg.d_model // ranks) * cfg.ssm_state * 4


def _dist_tp_recurrent_report(reps, card) -> dict:
    """(5d)/(5e)'s prints and gates over the ranks' reports."""
    out = {}
    for arch in DIST_TP_RECURRENT:
        out.update(_tp_recurrent_case(reps, f"tp_{arch}", arch, card))
    shared = reps[0]["moe_shared"]
    print(f"dist: {DIST_MOE_SHARED} reduced MoE with its shared expert on "
          f"(2, 2) ('data', 'model'), fp32: "
          + "; ".join(f"{d} output {v['err']:.3g} from moe_reference, shared "
                      f"expert gradients {v['grad_err']:.3g} from the global "
                      f"dispatch" for d, v in shared.items())
          + f" (bound {DIST_MOE_TOL}); {card}")
    for d, v in shared.items():
        if not (v["err"] <= DIST_MOE_TOL and v["grad_err"] <= DIST_MOE_TOL):
            raise RuntimeError(f"dist: the {d} MoE's shared expert {v}")
    return out


def _tp_recurrent_case(reps, key, arch, card) -> dict:
    """One arch's prints and gates over the ranks' reports under
    ``key``: (5d), (5e) and (5g)."""
    out = {}
    r0 = reps[0][key]
    one = {part: {k: v for k, v in r0[f"one_{part}"]["flash"].items()
                  if v} for part in ("forward", "step", "decode")}
    for rep in reps:
        rec = rep[key]
        flash = {part: {k: v for k, v in rec[part]["flash"].items() if v}
                 for part in ("forward", "step", "decode")}
        print(f"dist: tensor-parallel {arch} rank {rep['rank']}, "
              f"{rec['layers']} layers at full width, fp32, "
              f"B={rec['batch']} S={rec['seq']}, on a ('model',) mesh of "
              f"{len(reps)} "
              f"with the params held as blocks: forward "
              f"{rec['forward']['wall_s']:.2f} s, "
              f"{rec['forward']['host_bytes']} bytes staged; train step "
              f"{rec['step']['wall_s']:.2f} s, "
              f"{rec['step']['host_bytes']} bytes staged in "
              f"{rec['step']['host_s']:.3f} s, peak "
              f"{rec['step']['peak_bytes'] / 2**30:.2f} GiB; prefill + "
              f"{DIST_TP_REC_STEPS} decode steps "
              f"{rec['decode']['wall_s']:.2f} s, cache blocks "
              f"{rec['held']}; flash launches {json.dumps(flash)}, one "
              f"process's {json.dumps(one)}; {card}")
        if flash != one:
            raise RuntimeError(f"dist: the tensor-parallel {arch} rank "
                               f"{rep['rank']} launched {flash}, one "
                               f"process {one}")
        if _arch(arch).family == "ssm" and any(flash.values()):
            raise RuntimeError(f"dist: {arch} launched {flash}")
        period = rec["step"]["norm_period"]
        if period:
            print(f"dist: tensor-parallel {arch} rank {rep['rank']}: the "
                  f"clipped blocked AdamW step's global norm peaked "
                  f"{rec['step']['norm_bytes']} bytes above what was "
                  f"allocated when it began, beside one period of its "
                  f"largest stacked gradient leaf ({period['shape']} of "
                  f"{period['periods']}) {period['whole_bytes']} bytes "
                  f"gathered whole "
                  f"({period['local_bytes']} a rank); {card}")
    tol = DIST_TP_REC_TOL
    print(f"dist: tensor-parallel {arch} against one process: logits "
          f"over {r0['axes'] or 'the whole vocabulary'} "
          f"{r0['forward_err']:.3g} of the largest (bound "
          f"{DIST_TP_REC_TOL}), the ranks' gathered logits "
          f"{'bit-equal' if r0['ranks_bit_equal'] else 'DIFFER'}; the "
          f"step's loss {r0['loss_err']:.3g} relative (bound "
          f"{DIST_TP_REC_TOL}), gradients {r0['grad_err']:.3g} of "
          f"their leaf's largest at worst ({r0['grad_worst']}, bound "
          f"{tol}); planted fault ({r0['fault_name']}) "
          f"{r0['fault_err']:.3g}; one process's step "
          f"{r0['one_step']['wall_s']:.2f} s, peak "
          f"{r0['one_step']['peak_bytes'] / 2**30:.2f} GiB; decode "
          f"tokens against one process: {r0['note']}; {card}")
    if arch == "hymba-1.5b":
        print(f"dist: {arch}'s SSM scan without its remat kept at least "
              f"{_ssm_unrematted_bytes(arch, len(reps))} bytes a rank "
              f"(A_bar and Bx whole, [1, {r0['seq']}, "
              f"{_arch(arch).d_model // len(reps)}, "
              f"{_arch(arch).ssm_state}] fp32 a layer), "
              f"beside the step's peak "
              f"{r0['step']['peak_bytes'] / 2**30:.2f} GiB a rank; "
              f"{card}")
    if not (r0["forward_err"] <= DIST_TP_REC_TOL
            and r0["loss_err"] <= DIST_TP_REC_TOL
            and r0["grad_err"] <= tol and r0["ranks_bit_equal"]):
        raise RuntimeError(f"dist: the tensor-parallel {arch} step or "
                           f"forward misses its bound: {r0}")
    if not r0["fault_err"] > tol:
        raise RuntimeError(f"dist: the bound misses the planted {arch} "
                           f"reduce_from fault ({r0['fault_err']:.3g})")
    out[f"{key}_grad_err"] = r0["grad_err"]
    out[f"{key}_step_peak_bytes"] = [r[key]["step"]["peak_bytes"]
                                     for r in reps]
    return out


def _arch(name):
    from repro_torch.configs import get_arch

    return get_arch(name)


def _dist_layers() -> int:
    from repro_torch.configs import get_arch

    return get_arch(DIST_ARCH).n_layers


def _dist_dp_nccl(K, device, card, launcher) -> dict:
    """(4a) launch.train --data-parallel in process, a world of one on
    NCCL, phase 9's launcher argv: the losses against that run's, the warm
    step and tokens/s beside its, the grad all-reduce's time a step by
    events (the step's reduce_sum_ calls summed)."""
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
    # every step makes the same reduce_sum_ calls: a step's all-reduce time
    # is the sum of its calls' spans
    calls = len(spans) // len(log)
    if not calls or calls * len(log) != len(spans):
        raise RuntimeError(f"dist: {len(spans)} reduce_sum_ calls over "
                           f"{len(log)} --data-parallel steps")
    reduce_ms = [sum(s.elapsed_time(e) for s, e in spans[i:i + calls])
                 for i in range(0, len(spans), calls)]
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
          f"(the median step's {calls} calls summed); {card}")
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
    timing.update(_dist_moe_global_report(counts, card))
    timing.update(_dist_rows_report(counts, card))
    torch.cuda.empty_cache()
    timing.update(_dist_dp_nccl(K, device, card, launcher))
    _add(counts, launch_counts(K))
    torch.cuda.empty_cache()
    timing.update(_dist_dp_gloo(counts, card))
    print(f"dist: launches of the dist path (every rank and child) "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    print(f"dist: phase {time.perf_counter() - t_phase:.1f} s")
    return {"dist": counts}, timing


LAUNCH_ARCH = "gemma3-1b"
TUNE_SHAPES = ((1, 4, 2048, 256), (1, 4, 4096, 256))   # gemma3-1b: 4 x 256
TUNE_PROBE = (1, 4, 3072, 256)       # unseen by the fit, measured to score it
TUNE_TOL = 1e-5         # fp32 chunked against full: another summation order
EST_PEAK_TOL = 0.10     # the allocator's rounding and cuBLAS workspaces
LAUNCH_DEADLINE_S = 600              # the dry-run child, from its start
PROFILE_TOP = 5
# the reference's dry-run result keys (RooflineReport's fields and run_cell's)
DRYRUN_KEYS = ("arch", "shape", "mesh", "chips", "per_device_flops",
               "per_device_bytes", "per_device_collective_bytes",
               "collective_breakdown", "compute_s", "memory_s",
               "collective_s", "model_flops", "hlo_flops_global",
               "useful_ratio", "bottleneck", "raw_flops", "raw_bytes",
               "memory_per_device_bytes", "lower_s", "compile_s", "ok",
               "variant")
DRYRUN_MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes",
                      "alias_bytes", "total_bytes")
# GiB a rank with every leaf whole (the dry-run before the blocked
# layout), printed beside the blocked figure
WHOLE_GIB = {"train_4k": 129.56, "decode_32k": 107.11}
# the blocked layout's figures with every activation whole: gates that the
# tensor-parallel layers raise no cell
DECODE_BOUND_GIB = {"pod16x16": 8.45, "pod2x16x16": 5.19}
# train_4k at pod16x16: at most the JAX package's peak (115.75 GiB whole,
# 95.59 before the scan steps' remat)
TRAIN_BOUND_GIB = 25.77
# train_4k a rank (6.251e14 whole): 1.812e14 before the remat, plus the
# recompute of the chunked attention's q.k a tile, which the reference's
# jax.checkpoint also pays (its p.v there is dead code, which XLA drops
# and the port's recompute skips): 26 layers x 32 tiles x
# 2*16*4*512*1024*256 = 1.429e13; with the whole attention's weight
# gradients on a rank's block of d, 1.860e14 on the CPU (JAX package
# 1.874e14)
TRAIN_FLOPS_BOUND = 1.90e14
# the JAX package's dry-run of train_4k at pod16x16 on the CPU
# (``python -m repro.launch.dryrun``): FLOPs and GiB a rank, printed beside
REFERENCE_TRAIN = (1.874e14, 25.77)
# the global MoE dispatch on each rank's experts in the dry-run:
# llama4-maverick train_4k at pod16x16 cut to 2 of its 48 layers (one
# attention, one MoE layer), its per-rank FLOPs and bytes as the dry-run
# counts them on a CPU (tests/dryrun_depth.py), and its experts a rank;
# under fsdp each rank's experts compute on its block of d over the 16
# data ranks
MOE_LAUNCH_ARCH = "llama4-maverick-400b-a17b"
MOE_LAUNCH_LAYERS = 2
MOE_LAUNCH_CPU = (147628763381760, 43110955461)
MOE_LAUNCH_EXPERTS = (8, 128)
MOE_LAUNCH_DATA = 16
# the long-context decode (long_500k: 524288 cached positions, the cache
# held as each rank's block of its sequence) at full depth: per rank
# FLOPs and peak bytes as the dry-run counts them on a CPU
# (tests/dryrun_depth.py), and the JAX package's from ``tests/
# dryrun_depth.py --package repro`` on the same CPU, printed beside (its
# HLO also counts elementwise FLOPs the port's product count leaves out)
LONG_LAUNCH_CPU = {"gemma3-1b": (3758399488, 1216845828),
                   "hymba-1.5b": (7346281600, 2338474888)}
LONG_LAUNCH_JAX = {"gemma3-1b": (4656048679, 2038788268),
                   "hymba-1.5b": (8861547499, 4620656232)}
LONG_LAUNCH_RANKS = 16     # the model axis the cache's sequence splits over


def _long_cells() -> dict:
    """The long_500k cells of LONG_LAUNCH_CPU's archs, uncut, on the fake
    group of pod16x16: per arch the FLOPs and peak a rank, and the bytes
    of the KV cache's blocks a rank against the whole cache's."""
    from repro_torch.dist.sharding import Block
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.module import leaves

    out = {}
    for arch in LONG_LAUNCH_CPU:
        cell = dryrun.run_cell(arch, "long_500k", verbose=False)
        with dryrun.fake_group(LONG_LAUNCH_RANKS * LONG_LAUNCH_RANKS):
            _, args, *_ = dryrun.build_cell(arch, "long_500k",
                                            make_production_mesh())
        kv = [c for c in leaves(args[1])
              if isinstance(c, Block) and c.local.ndim >= 4]
        out[arch] = {
            "flops": int(cell["per_device_flops"]),
            "peak": cell["memory_per_device_bytes"]["total_bytes"],
            "cache": sum(c.local.numel() * c.local.element_size()
                         for c in kv),
            "cache_whole": sum(math.prod(c.whole_shape())
                               * c.local.element_size() for c in kv),
            "lower_s": cell["lower_s"]}
    return out


def _moe_launch_products() -> set:
    """The shapes of MOE_LAUNCH_ARCH's expert products a rank in the
    dry-run: its 8 experts at the whole batch's capacity on its block of
    d: the gate and up products in one [cap, 2f] and the down product's
    [cap, f] input gradient, the down product and the input's gradient
    [cap, d/D], the weights' gradients [d/D, 2f] and [f, d/D]; none on the
    whole d."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import get_shape
    from repro_torch.models.moe import capacity

    cfg = get_arch(MOE_LAUNCH_ARCH)
    shape = get_shape("train_4k")
    cap = capacity(cfg, shape.global_batch * shape.seq_len)
    r, f = MOE_LAUNCH_EXPERTS[0], cfg.expert_d_ff
    dr = cfg.d_model // MOE_LAUNCH_DATA
    return {f"bf16[{r},{cap},{2 * f}]", f"bf16[{r},{cap},{f}]",
            f"bf16[{r},{cap},{dr}]", f"bf16[{r},{dr},{2 * f}]",
            f"bf16[{r},{f},{dr}]"}


def launch_child(argv) -> int:
    """``python3 chip_smoke.py --launch-child OUT``: phase 11's dry-run
    cells on fake process groups, the results document to OUT (the CLI's
    for decode_32k at both meshes, ``train_4k``'s from ``run_cell`` merged
    under its key), and OUT.child.json: the profile's top rows for
    ``train_4k``, the launch counts, whether CUDA was initialised."""
    import dataclasses

    from repro_torch.launch import dryrun, profile
    from repro_torch.models.moe import capacity

    torch.set_num_threads(1)
    K = _kernels()
    out = Path(argv[0])
    t0 = time.perf_counter()
    dryrun.main(["--arch", LAUNCH_ARCH, "--shape", "decode_32k",
                 "--both-meshes", "--out", str(out)])
    counters = []
    train = dryrun.run_cell(LAUNCH_ARCH, "train_4k", counter_out=counters)
    doc = json.loads(out.read_text())
    doc[f"{LAUNCH_ARCH}|train_4k|pod16x16"] = train
    out.write_text(json.dumps(doc, indent=1))
    traffic, flops, colls = profile.profile_counter(counters[0])
    profile.print_tables(traffic, flops, colls, PROFILE_TOP)
    full = dryrun.get_arch
    dryrun.get_arch = lambda name: dataclasses.replace(
        full(name), n_layers=MOE_LAUNCH_LAYERS) \
        if name == MOE_LAUNCH_ARCH else full(name)
    counters = []
    try:
        moe = dryrun.run_cell(MOE_LAUNCH_ARCH, "train_4k", verbose=False,
                              counter_out=counters)
    finally:
        dryrun.get_arch = full
    rank, whole = MOE_LAUNCH_EXPERTS
    moe["experts"] = {shape: v for (op, shape), v in counters[0].flops.items()
                      if op == "aten.bmm"
                      and shape.startswith(f"bf16[{rank},")}
    # the experts' products and dispatched tokens over all experts; AdamW's
    # global norm gathers one period of each expert gradient whole by
    # design (a [whole, ...] tensor the products never see)
    shape = dryrun.get_shape("train_4k")
    cap = capacity(full(MOE_LAUNCH_ARCH), shape.global_batch * shape.seq_len)
    moe["experts_whole"] = sorted(
        {shp for (op, shp) in counters[0].flops
         if op == "aten.bmm" and shp.startswith(f"bf16[{whole},")}
        | {shp for _, shp in counters[0].traffic
           if shp.startswith(f"bf16[{whole},{cap},")})
    moe["norm_whole"] = sorted({
        shp for _, shp in counters[0].traffic
        if shp.startswith(f"bf16[{whole},")} - set(moe["experts_whole"]))
    # a rank's expert weights gathered over "data" (whole d), in the
    # params' type
    cfg = full(MOE_LAUNCH_ARCH)
    d, f = cfg.d_model, cfg.expert_d_ff
    dt = {"bfloat16": "bf16", "float32": "f32"}[cfg.param_dtype]
    moe["gathered_over_data"] = sorted(
        {f"{dt}[{rank},{d},{f}]", f"{dt}[{rank},{f},{d}]"}
        & {shp for _, shp in counters[0].traffic})
    long = _long_cells()
    Path(f"{out}.child.json").write_text(json.dumps({
        "moe": moe, "long": long,
        "top": {"traffic": traffic[:PROFILE_TOP],
                "flops": flops[:PROFILE_TOP], "colls": colls[:PROFILE_TOP]},
        "launches": launch_counts(K),
        "cuda_initialized": torch.cuda.is_initialized(),
        "wall_s": time.perf_counter() - t0}))
    return 0


def _launch_tuner(device, card) -> dict:
    """(a): the attention tuner on the card."""
    from repro_torch.autotune import tuner
    from repro_torch.models.attention import attend_full

    calls = []
    real = tuner.attend_chunked

    def on_card(q, k, v, **kw):
        calls.append({t.device for t in (q, k, v)} == {device})
        out = real(q, k, v, **kw)
        calls[-1] &= out.device == device
        return out

    tuner.attend_chunked = on_card
    try:
        t0 = time.perf_counter()
        tun = tuner.AttentionTuner()
        X, y = tun.collect(TUNE_SHAPES, seed=0, device=device)
        rng = np.random.RandomState(1)
        probe = [tuner.measure_schedule(*TUNE_PROBE, qc, kc, rng=rng,
                                        device=device)
                 for qc, kc in tuner.SCHEDULES]
        measure_s = time.perf_counter() - t0
    finally:
        tuner.attend_chunked = real
    want_calls = 3 * len(tuner.SCHEDULES) * (len(TUNE_SHAPES) + 1)
    if len(calls) != want_calls or not all(calls):
        raise RuntimeError(f"launch: {len(calls)} tuner calls (want "
                           f"{want_calls}), {calls.count(False)} off "
                           f"{device}")
    t0 = time.perf_counter()
    tun.fit(X, y)
    fit_s = time.perf_counter() - t0
    n = len(tuner.SCHEDULES)
    times = {shape: dict(zip(tuner.SCHEDULES, y[i * n:(i + 1) * n].tolist()))
             for i, shape in enumerate(TUNE_SHAPES)}
    times[TUNE_PROBE] = dict(zip(tuner.SCHEDULES, probe))
    picks = {}
    for shape, by in times.items():
        pick = tun.best_schedule(*shape)
        if pick not in tuner.SCHEDULES:
            raise RuntimeError(f"launch: the tuner picked {pick} for "
                               f"{shape}, not a grid schedule")
        best = min(by, key=by.get)
        picks[shape] = {"pick": pick, "pick_ms": by[pick] * 1e3,
                        "best": best, "best_ms": by[best] * 1e3,
                        "regret": by[pick] / by[best]}
        print(f"launch: tuner {shape} ms by (q_chunk, k_chunk): "
              + ", ".join(f"{qc}x{kc} {t * 1e3:.2f}"
                          for (qc, kc), t in by.items())
              + f"; pick {pick} {by[pick] * 1e3:.2f} ms, best measured "
              f"{best} {by[best] * 1e3:.2f} ms, regret "
              f"{picks[shape]['regret']:.3f}; {card}")
    b, h, s, d = TUNE_SHAPES[0]
    rng = np.random.RandomState(2)
    q, k, v = (torch.as_tensor(rng.randn(b, s, h, d) * sc, dtype=torch.float32,
                               device=device) for sc in (0.3, 0.3, 1.0))
    qc, kc = picks[TUNE_SHAPES[0]]["pick"]
    with torch.inference_mode():
        got = real(q, k, v, causal=True, k_chunk=kc, q_chunk=qc)
        want = attend_full(q, k, v, causal=True)
    on = {t.device for t in (q, k, v, got, want)} == {device}
    err = _rel_err(got, want)
    print(f"launch: tuner collect + probe {measure_s:.1f} s over "
          f"{len(calls)} attend_chunked calls on {device}, fit "
          f"{fit_s:.1f} s ({X.shape[0]} rows, MLP {tun.model.layers}, "
          f"{tun.model.epochs} epochs); the S={s} pick {qc}x{kc} against "
          f"attend_full: {err:.3g} of the largest magnitude (bound "
          f"{TUNE_TOL}); {card}")
    if not on or not err <= TUNE_TOL:
        raise RuntimeError(f"launch: the tuner's pick at S={s}: error "
                           f"{err:.3g}, devices on {device}: {on}")
    return {"measure_s": measure_s, "fit_s": fit_s, "err": err,
            "picks": {str(k): v for k, v in picks.items()}}


def _launch_estimator(device, card) -> dict:
    """(c): the dry-run's counter against one real step on the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import TrainStepConfig, make_train_step

    model = build_model(get_arch(TRAIN_ARCH))
    opt = AdamW(learning_rate=1e-4)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    state = opt.init(params)
    batch = batch_at(DataConfig(model.cfg.vocab_size, TRAIN_SEQ,
                                TRAIN_BATCH), 0, device=device)
    step = make_train_step(model, opt, TrainStepConfig(), use_kernel=False)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        params, state, metrics = step(params, state, batch)
        loss = metrics["loss"].item()
    real_s = time.perf_counter() - t0
    real_peak = torch.cuda.max_memory_allocated() - base
    real_flops = fc.get_total_flops()
    before = torch.cuda.memory_allocated()
    counter, mem, fake_s = dryrun.trace(
        make_train_step(model, opt, TrainStepConfig(), use_kernel=False),
        (params, state, batch))
    fake_alloc = torch.cuda.memory_allocated() - before
    del params, state, batch
    torch.cuda.empty_cache()
    fake_peak = mem["total_bytes"]
    rel = (fake_peak - real_peak) / real_peak
    print(f"launch: estimator, {TRAIN_ARCH} {model.cfg.compute_dtype} one "
          f"step B={TRAIN_BATCH} S={TRAIN_SEQ} (use_kernel=False, world of "
          f"one): the card {real_s:.2f} s, loss {loss:.4f}, "
          f"FlopCounterMode {real_flops:.6e} FLOPs, peak "
          f"{real_peak / 2**30:.3f} GiB over {resident / 2**30:.3f} GiB of "
          f"arguments; the fake trace {fake_s:.1f} s over {counter.ops} ops, "
          f"{counter.totals.flops:.6e} FLOPs ("
          f"{'equal' if counter.totals.flops == real_flops else 'DIFFERENT'}"
          f"), peak {fake_peak / 2**30:.3f} GiB ({100 * rel:+.2f}% of the "
          f"card's; bound {100 * EST_PEAK_TOL:.0f}%), arguments "
          f"{mem['argument_bytes'] / 2**30:.3f} GiB, {fake_alloc} bytes "
          f"allocated on the card by it; {card}")
    if counter.totals.flops != real_flops or not abs(rel) <= EST_PEAK_TOL \
            or fake_alloc != 0:
        raise RuntimeError(
            f"launch: estimator FLOPs {counter.totals.flops} against "
            f"{real_flops}, peak {fake_peak} against {real_peak} "
            f"({rel:+.3f}), {fake_alloc} bytes allocated by the fake trace")
    return {"real_s": real_s, "fake_s": fake_s, "flops": real_flops,
            "real_peak": real_peak, "fake_peak": fake_peak,
            "peak_rel": rel, "resident": resident}


def _launch_cells(doc: dict, child: dict, text: str, card) -> dict:
    """(b)'s gates over the child's results document and report."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import roofline
    from repro_torch.models import build_model

    for line in text.splitlines():
        if line.startswith("[dryrun]"):
            print(f"launch: {line}")
    _, active = roofline.count_params_split(build_model(get_arch(LAUNCH_ARCH)))
    out = {}
    for shape_name, mesh in (("train_4k", "pod16x16"),
                             ("decode_32k", "pod16x16"),
                             ("decode_32k", "pod2x16x16")):
        key = f"{LAUNCH_ARCH}|{shape_name}|{mesh}"
        cell = doc.get(key, {})
        shape = get_shape(shape_name)
        want = (2.0 * active * shape.global_batch if shape.is_decode
                else 6.0 * active * shape.global_batch * shape.seq_len)
        mem = cell.get("memory_per_device_bytes") or {}
        missing = [k for k in DRYRUN_KEYS if k not in cell] \
            + [k for k in DRYRUN_MEMORY_KEYS if k not in mem]
        if not cell.get("ok") or missing or cell["model_flops"] != want:
            raise RuntimeError(f"launch: dry-run cell {key}: {cell} "
                               f"(missing keys {missing}, model_flops want "
                               f"{want})")
        out[key] = {k: cell[k] for k in ("per_device_flops",
                                         "per_device_bytes",
                                         "per_device_collective_bytes",
                                         "bottleneck", "lower_s")}
        out[key].update(held=mem["total_bytes"],
                        sharded=mem["sharded_argument_bytes"])
        if cell.get("layout") != "blocked":
            raise RuntimeError(f"launch: dry-run cell {key} has layout "
                               f"{cell.get('layout')}")
        print(f"launch: dry-run {key}: per rank {mem['total_bytes'] / 2**30:.2f}"
              f" GiB in the blocked layout (every leaf whole: "
              f"{WHOLE_GIB[shape_name]:.2f} GiB), "
              f"{cell['per_device_flops']:.4g} FLOPs, collectives "
              f"{json.dumps(cell['collective_breakdown'])} bytes, arguments "
              f"{mem['argument_bytes'] / 2**30:.3f} GiB held against "
              f"{mem['sharded_argument_bytes'] / 2**30:.3f} GiB of sharded "
              f"arguments in the reference's layout; model_flops "
              f"{cell['model_flops']:.6e} = "
              f"{'2 N B' if shape.is_decode else '6 N B S'}, N_active "
              f"{active}; fake trace {cell['lower_s']:.1f} s; {card}")
    gib = {k: v["held"] / 2**30 for k, v in out.items()}
    dec, dec2, train = (gib[f"{LAUNCH_ARCH}|{c}"] for c in (
        "decode_32k|pod16x16", "decode_32k|pod2x16x16", "train_4k|pod16x16"))
    flops = out[f"{LAUNCH_ARCH}|train_4k|pod16x16"]["per_device_flops"]
    print(f"launch: tensor-parallel layers, per rank: decode_32k {dec:.2f} "
          f"GiB at pod16x16 (bound {DECODE_BOUND_GIB['pod16x16']}), "
          f"{dec2:.2f} GiB at pod2x16x16 (bound "
          f"{DECODE_BOUND_GIB['pod2x16x16']}); train_4k {train:.2f} GiB "
          f"(bound {TRAIN_BOUND_GIB}) and {flops:.4g} FLOPs (bound "
          f"{TRAIN_FLOPS_BOUND:.3g}), the JAX package's dry-run "
          f"{REFERENCE_TRAIN[1]} GiB and {REFERENCE_TRAIN[0]:.4g} FLOPs; "
          f"{card}")
    if not (dec <= DECODE_BOUND_GIB["pod16x16"]
            and dec2 <= DECODE_BOUND_GIB["pod2x16x16"] and dec2 < dec
            and train <= TRAIN_BOUND_GIB and flops <= TRAIN_FLOPS_BOUND):
        raise RuntimeError(f"launch: the dry-run figures {gib}, train_4k "
                           f"FLOPs {flops}")
    skips = [k for k, v in doc.items() if v.get("skipped")]
    if not skips or not all(doc[k]["ok"] and doc[k]["reason"] for k in skips):
        raise RuntimeError(f"launch: skip records {skips}")
    if any(child["launches"].values()) or child["cuda_initialized"]:
        raise RuntimeError(f"launch: the dry-run child launched "
                           f"{child['launches']}, CUDA initialised: "
                           f"{child['cuda_initialized']}")
    for name, rows in child["top"].items():
        print(f"launch: profile {LAUNCH_ARCH}|train_4k|pod16x16 top "
              f"{PROFILE_TOP} by {name}: " + "; ".join(
                  f"{v / 1e9:.1f} G {op} {shp}" for v, op, shp, _ in rows))
    moe = child["moe"]
    mem = moe["memory_per_device_bytes"]["total_bytes"]
    rank, whole = MOE_LAUNCH_EXPERTS
    want = _moe_launch_products()
    print(f"launch: dry-run {MOE_LAUNCH_ARCH}|train_4k|pod16x16 cut to "
          f"{MOE_LAUNCH_LAYERS} layers, the global MoE dispatch on {rank} of "
          f"{whole} experts a rank: {moe['per_device_flops']:.6e} FLOPs and "
          f"{mem} bytes = {mem / 2**30:.2f} GiB a rank (the CPU's "
          f"{MOE_LAUNCH_CPU[0]:.6e} and {MOE_LAUNCH_CPU[1]}), collectives "
          f"{json.dumps(moe['collective_breakdown'])} bytes; the experts' "
          f"products " + "; ".join(f"{shp} {v:.6e} FLOPs" for shp, v in
                                    sorted(moe["experts"].items()))
          + f" (on blocks of d over {MOE_LAUNCH_DATA} data ranks, want "
          f"{sorted(want)}); products or dispatched tokens over all "
          f"{whole} experts: {moe['experts_whole'] or 'none'} (the global "
          f"norm's period gathers {moe['norm_whole']}); a rank's expert "
          f"weights gathered over data: "
          f"{moe['gathered_over_data'] or 'none'}; fake trace "
          f"{moe['lower_s']:.1f} s; {card}")
    if (moe["per_device_flops"], mem) != MOE_LAUNCH_CPU \
            or set(moe["experts"]) != want or moe["experts_whole"] \
            or moe["gathered_over_data"]:
        raise RuntimeError(f"launch: the dry-run of {MOE_LAUNCH_ARCH}: "
                           f"{moe['per_device_flops']}, {mem} bytes, "
                           f"experts {moe['experts']}, whole "
                           f"{moe['experts_whole']}, gathered over data "
                           f"{moe['gathered_over_data']}")
    for arch, got in child["long"].items():
        cpu, jax = LONG_LAUNCH_CPU[arch], LONG_LAUNCH_JAX[arch]
        print(f"launch: dry-run {arch}|long_500k|pod16x16 uncut, the KV "
              f"cache held as each rank's block of its sequence: "
              f"{got['flops']} FLOPs and {got['peak']} bytes = "
              f"{got['peak'] / 2**30:.2f} GiB a rank (the CPU's {cpu[0]} and "
              f"{cpu[1]}; the JAX package's {jax[0]:.4g} FLOPs, "
              f"{got['flops'] / jax[0]:.3f}x, and {jax[1] / 1e9:.2f} GB, "
              f"{got['peak'] / jax[1]:.3f}x), cache {got['cache']} bytes a "
              f"rank of {got['cache_whole']} whole; fake trace "
              f"{got['lower_s']:.1f} s; {card}")
        if (got["flops"], got["peak"]) != cpu \
                or got["cache"] * LONG_LAUNCH_RANKS != got["cache_whole"]:
            raise RuntimeError(f"launch: the dry-run of {arch} long_500k: "
                               f"{got}, the CPU's {cpu}")
    print(f"launch: the dry-run child {child['wall_s']:.1f} s, "
          f"{len(skips)} skip records, no kernel launched, CUDA never "
          f"initialised in it")
    return {"cells": out, "child_s": child["wall_s"]}


def launch_child_start() -> tuple:
    """Start phase 11's dry-run child (``--launch-child``) now, beside
    whatever runs next: it only traces on the host, launches nothing and
    never initialises CUDA.  Returns (its temporary directory, the
    process, its start) for :func:`phase_launch`, or for
    :func:`launch_child_stop` where the phases between fail."""
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name)
    with open(path / "child.out", "w") as so, \
            open(path / "child.err", "w") as se:
        child = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--launch-child", str(path / "dryrun.json")],
            stdout=so, stderr=se)
    return tmp, child, time.perf_counter()


def launch_child_stop(started) -> None:
    tmp, child, _ = started
    if child.poll() is None:
        child.kill()
        child.wait()
    tmp.cleanup()


def phase_launch(K, device, card: str, started) -> tuple:
    """The launch slice on the card (module docstring, phase 11), its
    dry-run child ``started`` earlier by :func:`launch_child_start`.
    Returns (path label -> launch counts of the path's run, the
    numbers)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    zero_counts(K)
    tmp_dir, child, t_child = started
    tmp = Path(tmp_dir.name)
    out = tmp / "dryrun.json"
    try:
        try:
            timing = {"tuner": _launch_tuner(device, card)}
            torch.cuda.empty_cache()
            timing["estimator"] = _launch_estimator(device, card)
            rc = child.wait(timeout=max(
                1.0, LAUNCH_DEADLINE_S - (time.perf_counter() - t_child)))
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        text = (tmp / "child.out").read_text()
        if rc != 0:
            raise RuntimeError(f"launch: the dry-run child exited {rc}: "
                               f"{text[-1500:]} "
                               f"{(tmp / 'child.err').read_text()[-3000:]}")
        doc = json.loads(out.read_text())
        timing["dryrun"] = _launch_cells(
            doc, json.loads(Path(f"{out}.child.json").read_text()), text,
            card)
    finally:
        tmp_dir.cleanup()
    counts = launch_counts(K)
    print(f"launch: launches of the launch path {json.dumps(counts)}")
    if any(counts.values()):
        raise RuntimeError(f"launch: the path launched hand kernels: "
                           f"{counts}")
    print(f"launch: phase {time.perf_counter() - t_phase:.1f} s")
    return {"launch": counts}, timing, doc


EXAMPLES = ("schedule_dag", "program_compile", "async_pipeline",
            "serve_blur_pipeline", "quickstart", "runtime_dispatch",
            "autotune_attention", "train_100m")
EXAMPLES_TRAIN_STEPS = 10     # train_100m, cut from its 200
PROJECTION_CASE = f"{LAUNCH_ARCH}|train_4k|pod16x16|pallas"


def _example_note(name, res) -> str:
    """One example's result in a few words, and its checks beyond the
    asserts it makes itself."""
    if name == "schedule_dag":
        return f"placement {res['placement']}"
    if name == "program_compile":
        return f"executed, max rel err {res['err']:.2e}"
    if name == "async_pipeline":
        return (f"sequential {res['seq_wall_s'] * 1e3:.1f} ms, async "
                f"{res['async_wall_s'] * 1e3:.1f} ms (predicted "
                f"{res['makespan_s'] * 1e3:.1f}), outputs bit-identical")
    if name == "serve_blur_pipeline":
        return (f"makespan {res['makespan_s'] * 1e3:.2f} ms against one "
                f"device's best {min(res['single_s'].values()) * 1e3:.2f} "
                f"ms")
    if name == "quickstart":
        if not all(np.isfinite(res["lm"]["losses"])):
            raise RuntimeError(f"examples: quickstart losses {res['lm']}")
        return (f"api picks {res['api']['picks']}, max err "
                f"{res['api']['err']:.2e}; NN+C {res['nnc']['n_params']} "
                f"weights, MAPE {res['nnc']['mape']:.1f}%; reduced gemma3-1b "
                f"losses {[round(x, 4) for x in res['lm']['losses']]}")
    if name == "runtime_dispatch":
        return (f"cold/warm/reload selections {res['warm']}, the child "
                f"measured {res['child']['measured']}; steady overhead "
                f"{res['overhead_pct']:.2f}% (target <5%: "
                f"{res['overhead_ok']})")
    if name == "autotune_attention":
        return (f"chosen {res['chosen']}, best {res['best']}, regret "
                f"{res['regret']:.2f}x, speedup vs default "
                f"{res['speedup_vs_default']:.2f}x")
    losses = [m["loss"] for m in res]
    if len(res) != EXAMPLES_TRAIN_STEPS or not all(np.isfinite(losses)):
        raise RuntimeError(f"examples: train_100m losses {losses}")
    return (f"{len(res)} steps, losses {losses[0]:.4f} -> {losses[-1]:.4f}, "
            f"warm step median "
            f"{np.median([m['step_time_s'] for m in res[1:]]) * 1e3:.1f} ms")


def phase_examples(K, device, card: str, doc: dict) -> tuple:
    """The examples and the last benchmark scripts on the card (module
    docstring, phase 12).  Returns (path label -> launch counts of the
    path's run, the numbers)."""
    import importlib
    import os

    from repro_torch.paper import kernel_projection, roofline

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    zero_counts(K)
    argv = {"quickstart": [], "runtime_dispatch": [],
            "autotune_attention": [],
            "train_100m": ["--steps", str(EXAMPLES_TRAIN_STEPS)]}
    rows, cwd = {}, os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)             # the examples write under results/torch/
        try:
            for name in EXAMPLES:
                mod = importlib.import_module(f"repro_torch.examples.{name}")
                before = launch_counts(K)
                t0 = time.perf_counter()
                if name in argv:
                    res = mod.main(argv[name] + ["--device", str(device)])
                else:
                    res = mod.main()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = _delta(K, before)
                rows[name] = {"wall_s": wall, "launches": launched}
                print(f"examples: {name} in {wall:.1f} s, hand-kernel "
                      f"launches {json.dumps(launched)}: "
                      f"{_example_note(name, res)}; {card}")
        finally:
            os.chdir(cwd)
    hand = {"quickstart": ("matmul",),
            "train_100m": ("flash_attention_fwd", "flash_attention_bwd_dq",
                           "flash_attention_bwd_dkv")}
    for name, kernels in hand.items():
        if not all(rows[name]["launches"].get(k) for k in kernels):
            raise RuntimeError(f"examples: {name} launched "
                               f"{rows[name]['launches']}, not {kernels}")
    table = roofline.summarize(doc)
    for line in table:
        print(f"examples: roofline | {line}")
    if not any(ln.startswith(f"{LAUNCH_ARCH}|train_4k") for ln in table):
        raise RuntimeError(f"examples: the roofline table lacks "
                           f"{LAUNCH_ARCH}|train_4k: {table}")
    before = launch_counts(K)
    proj = kernel_projection.project(
        doc, {PROJECTION_CASE: kernel_projection.CASES[PROJECTION_CASE]},
        device=device)[PROJECTION_CASE]
    rows["kernel_projection"] = {"launches": _delta(K, before),
                                 "kernel_ms": proj["kernel_ms"],
                                 "kernel_s": proj["kernel_s"],
                                 "memory_s": proj["memory_s"],
                                 "attn_plain_bytes": proj["attn_hlo_bytes"],
                                 "attn_kernel_bytes":
                                     proj["attn_kernel_bytes"]}
    cell = doc[PROJECTION_CASE.rsplit("|", 1)[0]]
    print(f"examples: kernel projection {PROJECTION_CASE}: memory term "
          f"{cell['memory_s']:.3f} s -> {proj['memory_s']:.3f} s; the hand "
          f"kernels measured at the rank's shape (bf16) "
          f"{json.dumps({k: round(v, 4) for k, v in proj['kernel_ms'].items()})}"
          f" ms a layer, {proj['kernel_s']:.3f} s a step over 26 layers; "
          f"{card}")
    if not (proj["memory_s"] < cell["memory_s"]
            and all(v > 0 for v in proj["kernel_ms"].values())):
        raise RuntimeError(f"examples: the projection {proj}")
    counts = launch_counts(K)
    print(f"examples: launches of the examples path {json.dumps(counts)}")
    print(f"examples: phase {time.perf_counter() - t_phase:.1f} s")
    return {"examples": counts}, rows


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
        q, k, v, do = _fa_inputs(b, h, kv, s, s, d, torch.float32, device,
                                 gen)
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
    if sys.argv[1:2] == ["--moe-child"]:
        return moe_child(sys.argv[2:])
    if sys.argv[1:2] == ["--rows-child"]:
        return rows_child(sys.argv[2:])
    if sys.argv[1:2] == ["--dp-child"]:
        return dp_child(sys.argv[2:])
    if sys.argv[1:2] == ["--launch-child"]:
        return launch_child(sys.argv[2:])
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
    # the launch phase's dry-run child traces on the host beside the dist
    # phase (about 100-150 s of it), so that the script keeps its margin
    started = launch_child_start()
    try:
        counts, dist_timing = phase_dist(K, device, line,
                                         train_timing["launcher"])
    except BaseException:
        launch_child_stop(started)
        raise
    by_path.update(counts)
    counts, launch_timing, dryrun_doc = phase_launch(K, device, line,
                                                     started)
    by_path.update(counts)
    counts, examples_timing = phase_examples(K, device, line, dryrun_doc)
    by_path.update(counts)
    records = phase_times(K, device, name, worst, by_path)
    for rec in records:
        if rec["name"] == "flash_attention":
            rec["models"] = model_timing
            rec["serve"] = serve_timing
            rec["dist"] = dist_timing
            rec["launch"] = launch_timing
            rec["examples"] = examples_timing
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
