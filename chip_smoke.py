#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout; it puts ``<checkout>/src`` on
``sys.path`` itself, imports only the port (``repro_torch``) and never
JAX. Phases, in order; any failed check raises, so the exit code is
nonzero:

1. **build** — compile every CUDA kernel in ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` each, all at once) and print the build time; the phases
   through the lockstep ones need only the decode kernels, so they run
   while the training kernels still compile (their ptxas report prints
   before train-kernels).
2. **kernels** — hold each decode kernel against its plain PyTorch
   version on the card, on rows that attend at least one slot. K4 (paged
   slab): (a) the serve phase's shapes in bf16 with ragged ``t`` past the
   ring wrap and shuffled physical pages, (b) the same in f32, (c) page 8,
   rep 1, hd 128, dilation 2, f16, one all-PAD row, (d) the serve shapes
   with an int8 slab (bf16 compute) and page statistics, (e) the serve
   shapes in f32 with ``return_state`` and page statistics, one all-PAD
   row (which must give the (0, NEG_INF, 0) identity), (f) one request
   (B = 1) at the serve shapes, t = 3000 (the single-user long-cache
   decode), (g) gemma-7b's decode (16 heads of hd 256, no GQA) at the
   serve shapes in bf16, (l) arctic-480b's decode (56 query heads on 8 KV
   heads of hd 128, rep 7: one full row group of 4 and a partial one of
   3) at the serve shapes in bf16, (s) ``return_state`` on each shard's own
   slab at the serve shapes split over 2 shards (33 pages of 16 a shard;
   shard 1 holds no slot of the rows at t = 5 and 300, which must give
   exactly (0, NEG_INF, 0)), each against its plain version
   (``salo_attention.OUT_TOL`` / ``STATS_TOL``), and the shards' partials
   merged by ``masked_psum_merge`` (a ``StackedGroup`` on the card)
   against unsharded K4 within ``OUT_TOL``. ``page_m`` must be equal where
   either side is NEG_INF. K5
   (contiguous caches, read through the transposed view of the lockstep
   (B, S, Hkv, hd) cache): (a) the lockstep phase's cache in bf16, slot =
   position, (b) the same in f32, (c) the ring layout (window 512 + 4
   sinks, dilation 2, PAD ring slots), (k) recurrentgemma-9b's decode (16
   query heads on one KV head of hd 256, bf16, a 2304-slot full cache, t
   past the 2048 window, 4 sinks), (l) arctic-480b's decode on the MoE
   lockstep phases' cache (56 query heads on 8 KV heads of hd 128, bf16,
   288 slots), (m) qwen2-vl-2b's decode (12 query heads on 2 KV heads of
   hd 128, rep 6: row groups of 4 and 2) and (n) whisper-base's (8 heads
   on 8 of hd 64, rep 1, window 512) on the same 288 slots. Tolerances:
   f32 1e-5, bf16/f16
   2e-2 (abs and rel; the kernels round p to the 16-bit type before the
   PV product, the plain versions keep it in f32). Every case's outputs
   must be bitwise equal over repeated calls (the split-KV merge does not
   depend on which block finishes last). Prints the split the planner
   chose (``n_split``, ``split_len``) and each kernel's, its plain
   version's and ``scaled_dot_product_attention``'s times (a yardstick
   only; for K4 on the pre-gathered view, gather not timed) beside the
   bound.
3. **serve-check** — a 2-layer, hd-64 f32 model served on the card
   (kernel) and on the CPU (plain version): greedy tokens must be equal,
   (1) on the fp slab, (2) on the int8 slab with page skipping (window 64,
   threshold -3, decay 0.3), where the page counters must be equal too and
   0 < pages read < pages total; (3) gemma-7b (hd 256, geglu, soft-capped
   logits, tied embeddings), phi4-mini (hd 128, GQA 3) and granite (hd
   128, GQA 4) at narrowed widths, 2 layers, on the fp slab; (4)
   arctic-480b and kimi-k2 at narrowed widths (d 256, hd 128 at their
   published rep 7 and 8, expert width 64, every other MoE field of the
   published config: 128 experts top-2 with the dense residual, 384
   top-8 with the shared expert and the leading dense layer; smoke depth),
   f32, on the fp slab.
3b. **lockstep-check** — recurrentgemma-9b (one griffin group, one KV
   head of hd 256 under 2 query heads, local window 32 + 4 sinks) and
   mamba2-370m (smoke widths), and serve-check (4)'s arctic-480b and
   kimi-k2, and qwen2-vl-2b (d 256, 6 query heads on one KV head of hd
   128: rep 6, the published M-RoPE sections) and whisper-base (d 128,
   hd 64, rep 1, 1500 audio frames; the cross caches filled from the
   encoder over seeded frames on each device), at narrowed widths, f32,
   residual branches amplified (not whisper's cross attention), on the
   lockstep ``ServeEngine`` on the card and on the CPU from the same
   weights: batch 2, prompt 40 (past the window), 8 new tokens; greedy
   tokens equal, K5 launched once per attention layer (a griffin group
   has one) a step on the card and never on the CPU (its plain version
   the reverse).
4. **lockstep** — smollm-135m at full width and depth, bf16, on the
   lockstep ``ServeEngine``: batch 8, a 1088-token prompt prefilled token
   by token, 32 new tokens. Checks finite logits every step, 30 K5
   launches per decode step, no plain call; prints the step times,
   tokens/s and peak memory.
4b. **lockstep recurrentgemma-9b**, **lockstep mamba2-370m** — the same
   at full width and depth (recurrentgemma: 38 layers, d 4096, 16 heads on
   one KV head of hd 256, local window 2048, vocab 256000; mamba2: 48 SSD
   layers, d 1024), batch 8, prompt 256, 32 new tokens: 12 K5 launches a
   decode step (one a griffin group) for recurrentgemma, none for mamba2.
5. **serve-int8** — the serve phase's requests and weights on
   ``ContinuousEngine`` with ``kv_dtype="int8"``, threshold -3, decay 0.3.
   Checks as the serve phase, and the slab's resident bytes; prints the
   decode step median, tokens/s, prefill time, the page counters and how
   many tokens agree with the serve phase's (not gated: random weights).
6. **serve** — smollm-135m at full width (30 layers, d 576, 9/3 heads,
   vocab 49152), bf16, random weights from ``--seed``, on
   ``ContinuousEngine``: 8 requests with prompts over 600-2000 tokens and
   64 new tokens each. Checks every request's tokens, the prefill launch
   count, that the kernel launched once per layer per decode step and
   that the plain version never ran. Three decode-only steps, and then
   one prefill chunk of an extra request, run under ``torch.profiler``:
   device time by kernel name and the idle share.
6b. **serve-sharded** — sequence-parallel serving: 2 ranks through
   ``dist.group.run_ranks`` (NCCL with one card a rank where the machine
   has the cards, else gloo ranks sharing cuda:0; the phase names its
   backend), in the one spawn of 2 ranks that also runs 18b-18f and
   18h-18l (after phase 19, ``spawn_jobs``: a spawn's ranks take ~20 s
   to start and warm up). First serve-sharded-check: the serve-check's
   narrowed f32 model on the fp slab (window 24) and the int8 page-sparse
   slab (window 56; windows where a request's pages stripe over 2 shards
   with no padding), greedy tokens and every counter equal to the unsharded
   engine's on the card. Then the serve phase's weights and traffic at full
   width on the bf16 slab, ``seq_shards=2``: every rank launches K4 30
   times a decode step in ``return_state`` mode and never its plain
   version; every layer of one decode step has its merged attention
   checked against unsharded K4 on the whole logical view within
   ``OUT_TOL``; the ranks' tokens and counters are equal and every first
   token equals the serve phase's. Prints how many of the served tokens
   agree (not gated), the decode step median, the prefill time, one
   profiled decode step's collectives by name and the idle share.
6c. **serve-sharded-int8** — the same on the int8 page-sparse slab
   (threshold -3, decay 0.3), against serve-int8, in serve-sharded's
   spawn of 2 ranks after it. Both serve the first 2 of the 8 requests
   (prompts 634 and 825) at 2 shards (cuts for time;
   ``tools/serve_sharded.py`` runs all 8 at 2 and 4 shards).
7. **serve-ft** — kill and resume: the serve phase's weights and requests
   under ``ft.ServeSupervisor`` (a fresh engine every boot, a snapshot
   every 16 engine steps under ``build/``, removed at the end), with two
   injected crashes: one while requests still prefill (before the first
   snapshot, so a restart from scratch), one in decode (a restore).
   Checks the greedy tokens and every engine counter equal to the serve
   phase's, 2 restarts with at most 16 steps lost, every allocator back
   to n_pages - 1 free, the slabs and slot map on the card after each
   restore; prints the snapshot bytes, the median state_dict + save and
   restore times and the steps lost.
8. **serve-ft-int8** — the same on the serve-int8 phase's engine (int8
   slab, page skipping): the scales and the page-stats history go
   through the snapshots; tokens and counters (pages read) equal to the
   serve-int8 phase's.
9. **serve gemma-7b** — the serve phase's traffic on gemma-7b at full
   width and depth (28 layers, d 3072, 16 heads of hd 256, vocab 256000),
   bf16, random weights: the same checks (28 K4 launches a decode step),
   one decode-only step profiled.
9b. **lockstep profiles** — one lockstep decode step each of
   recurrentgemma-9b and mamba2-370m (full size, at position 256 on zeroed
   caches) under the profiler, after the serve phases' timings.
9c. **lockstep arctic-480b**, **serve arctic-480b**, **lockstep
   kimi-k2**, **serve kimi-k2** — every published width, the depth cut
   to the deepest whose reckoned serving peak (``serve_bytes``, printed
   first: bf16 weights, slab, lockstep caches, a prefill chunk's MoE
   dispatch temporaries, the logits) fits 92 % of the card; one set of
   bf16 weights drawn on the card serves the lockstep phase's traffic
   (batch 8, prompt 128, 32 new; one K5 launch a layer a step) and then
   the serve phase's on the continuous engine (the serve checks, one K4
   launch a layer a decode step, one decode step profiled). Then the
   decode step split: one MoE layer's ``moe_apply`` on 8 rows timed
   against its expert products alone and its shared expert (the rest is
   routing and dispatch), K4 / K5 case (l) per layer, and the remainder.
9d. **lockstep qwen2-vl-2b**, **lockstep whisper-base** — full width and
   depth (qwen2-vl: 28 layers, d 1536, 12 query heads on 2 KV heads of hd
   128, M-RoPE text decode; whisper: 6 decoder layers, d 512, 8 heads of
   hd 64), bf16, batch 8, prompt 128, 32 new: one K5 launch a layer a
   step. For whisper the phase first fills every layer's cross caches
   from ``Model._encode`` over seeded audio frames (8 x 1500 x 512; one
   K1 launch an encoder layer) through the layer's cross-attention
   ``wk``/``wv`` (``fill_cross_caches``: the package's engine leaves them
   zero, as the reference's does).
10. **train-kernels** — hold the training kernels K1 (forward; with
   16-bit inputs on the tensor cores, in 16-row x 64-key warp sub-tiles),
   K2 (dQ) and K3 (dK/dV) against their plain versions on the plan tables
   and working-space tensors the op hands them: (a) the train phase's shapes
   (smollm-135m's pattern, 8 x 9 flat heads, n 4096, hd 64, block 256,
   bf16), (b) the same in f32, (c) ViL 2-D multi-band with a global token,
   block_q 128 != block_k 64, hd 128, f16, padded rows, (d) a causal
   dilated window with sinks (reordered; a transposed row splits), block
   32, f32, (e) case (a) in f16, (f) gemma-7b's attention (its pattern, 2
   x 16 heads, n 4096, hd 256, block 256, bf16), (g) case (f) in f32,
   (h) longformer-4k's (bidirectional window 512, one global token with
   global rows, 8 x 12 heads, hd 64, bf16), (i), (j) the paper's ViL
   stages 1 and 2 (56 x 56 and 28 x 28 grids, 15 x 15 window, one global
   token, 3 and 6 heads of hd 64, block 128, bf16), (k) recurrentgemma-9b's
   local attention (its one KV head copied to 16 query heads, n 4096, hd
   256, window 2048, 4 sinks, block 256, bf16), (l) kimi-k2's attention
   (64 query heads from 8 KV heads, batch 1, n 4096, hd 128, window 1024,
   4 sinks, block 256, bf16), (m) whisper-base's encoder attention
   (bidirectional window 512 with 4 global tokens, global rows too, 8 x 8
   heads, n 1500 padded to 1536, hd 64, block 256, bf16), (t) one
   sequence shard's view tables (``dist.sharded_plan.shard_plan``: shard 1
   of 2 at smollm-135m's train shapes, 8 x 9 flat heads, window 1024 + 4
   sinks, 128-blocks: q on its 16 local blocks, K/V on its view of 16
   local tiles, 8 + 1 halo slots (distances -1 and +1, the +1 slot padding
   on this shard) and 1 global tile, bf16; timed, SDPA with the mask the
   view tables imply), (tp) one model rank's heads of gemma-7b's train
   attention at 2 ranks (batch 1 x 8 of its 16 heads of hd 256, bf16: what
   each rank of train-tp launches), (ep) one model rank's heads of
   arctic-480b's train attention at 2 ranks (batch 1 x 28 of its 56 query
   heads on 4 of its 8 KV heads, hd 128, bf16: what each rank of train-ep
   launches), (k-tp) one model rank of 2 of recurrentgemma-9b's local
   attention (batch 1 x 8 of its 16 query heads on its one KV head, hd
   256, window 2048, bf16: what each rank of train-tp recurrentgemma-9b
   launches). Tolerances: out
   8e-3 in 16 bits and
   1e-5 in f32, m and l 1e-5 (``salo_attention.OUT_TOL``, ``STATS_TOL``);
   padded rows must give (0, NEG_INF, 0); dk/dv 1e-3 (bf16) and 1e-4
   (f16) in the 16-bit cases, where K2/K3 split every f32 operand into
   16-bit hi + lo on the tensor cores; 1e-4 in f32; dq 2e-2 in 16 bits
   (returned in the 16-bit type), and equal to the plain f32 dq rounded
   to that type on all but 2 % of its elements (``salo_backward.DKV_TOL``,
   ``DQ_OFF_SHARE``). The 16-bit cases run K2/K3 again with dout at 2^-20
   of its scale (a train step's) and compare relative to it. Checks that
   two K3 runs give bitwise-equal dK/dV. Prints for (a), (b), (f), (g),
   (h), (k), (l), (m) each kernel's, and for (i), (j) K1's, the plain
   version's and the
   bound's time (and the same for (tp); 16-bit K2/K3: each
   product once at the 16-bit tensor rate, 6 and 8 x hd flops per
   attended pair; f32: all but q.k^T at the f32 rate), the flops the
   kernel runs and their rate (K1: 4 x hd per pair of the sub-tiles it
   executes, 16 x 64 warp sub-tiles in 16 bits and 64 x 64 block
   sub-tiles in f32; K2/K3: the split's 10 and 16 x hd per attended
   pair; at hd 256 the 16-bit kernels' column split adds the products
   each of its two blocks recomputes), and
   ``scaled_dot_product_attention`` with the dense mask (forward, and its
   backward beside K2 and K3) as a yardstick.
10b. **analysis** — the launch contract of ``repro_torch.analysis
    .launch_lint`` with CUDA tensors: for every registry target of the
    plan prover (a block below the kernels' smallest raised to 32, head
    dim 64, bf16) one forward of ``kernels.ops.salo_attention`` books 1
    launch and launches K1 once, one forward + backward books 3 and
    launches K1 and K2 once and K3's two kernels. Then the shared-memory
    budget (``phase_smem``): every instantiation's bytes as its ``.cu``
    file exports them (the launchers' dynamic sizes; the decode kernels'
    and the owner sum's static bytes as compiled) equal
    ``analysis/smem_budget.py``'s mirror, and no launch of any registry
    target at hd 64-256 in f32/bf16/f16 is over the card's limit. Any
    finding or difference fails.
11. **dynamic** — runtime plans: ``hybrid_attention(plan="dynamic")``
   fwd + bwd with a seeded cotangent at smollm-135m's attention (its
   pattern, 8 x 9 query heads on 3 KV heads, n 4096, hd 64, block 256,
   bf16) with keep 4 (61 of the static plan's 96 steps) and full keep
   (7), and at longformer-4k's (bidirectional window 512, one global token
   with global rows, 8 x 12 heads) with keep 4 (62 of 74). Each call must
   launch K1 once and K2 once on the step tables selected on the card, K3
   never, and no plain version. At full keep the device tables must equal
   the static plan's, out and dQ the static path's (bitwise printed), and
   the scatter dK/dV twin K3's on the packed tables within
   ``salo_backward.DKV_TOL``; at keep 4, K1 and K2 on the device tables
   must match their plain versions on the same tables (the train-kernels
   tolerances). Two calls of the scatter dK/dV must be bitwise equal.
   Prints, for smollm at keep 4, the selection's time, K1's and K2's
   (beside their plain versions, bounds and SDPA with the mask the
   selection implies), the scatter twin's against K3's, the op's fwd +
   bwd dynamic against static, the host's time to issue each of those
   calls, and the executed-tile ratio; one fwd + bwd runs under
   ``torch.cuda.set_sync_debug_mode("error")``: no host read on the
   call path.
12. **dynamic-check** — narrowed f32 cases (causal sinks, longformer with
   global rows, dilated sinks with hd 128), keep below ``max_steps``, on
   the card and on the CPU from the same tensors: equal tables; out and
   the three gradients within 1e-4. Then how many rows of smollm's bf16
   keep-4 tables differ between the card and the CPU (near-ties may flip;
   not gated).
13. **train-check** — a 2-layer, hd-64 f32 model trained 3 steps on the
   card (kernels) and on the CPU (plain versions) from the same
   parameters and batches: losses and grad norms agree within 1e-4; then
   the same for gemma-7b (hd 256) and longformer-4k (hd 64, bidirectional,
   global rows) at narrowed widths, and the lockstep-check's recurrentgemma
   (K1-K3 at hd 256 on one KV head; dK/dV of the 16 copies summed by
   autograd of the GQA expand) and mamba2 (no kernel may launch), and
   serve-check (4)'s arctic-480b and kimi-k2 (hd 128 at rep 7 and 8, the
   published routing), whose load balance, router z and dropped share
   must agree within 1e-4 too, and lockstep-check's qwen2-vl-2b (the
   vision extras and (3, B, S) positions of ``SyntheticLM``) and
   whisper-base (the encoder's K1-K3 over 1500 frames).
13b. **train qwen2-vl-2b** — every published width at the largest batch
   of 8, 4, 2, 1 whose full depth's reckoned peak fits 92 % of the card
   (``train_shape``, printed), seq 4096 with 1024 vision slots, 4 steps,
   lr 1e-3, warmup 3; **train whisper-base** at full size, 10 steps,
   batch 8, 1500 audio frames a sample; per step and attention layer K1
   2, K2 1, K3 2
   (whisper's 6 decoder and 6 encoder layers); the loss falls.
14. **train** — smollm-135m at full width and depth, bf16, remat full,
   random weights from ``--seed``, ``SyntheticLM`` at seq 4096, batch 8,
   20 steps, lr 3e-3, warmup 10. Checks finite losses, that the mean of
   the last 5 is below the first, K1 launches = 2 x 30 x steps, K2 = 30 x
   steps, K3 = 2 x 30 x steps (its row walk and its owner-tile sum), and
   that no plain version ran; prints the median step
   time, tokens/s and peak memory, then profiles one more step. After step
   10, {"params", "opt"} go to ``build/`` through an async
   ``ft.CheckpointManager`` (the device-to-host copy synchronous, the
   write in the background), a clone stays on the card; the steps that
   overlap the write are printed and left out of the median.
15. **train-ft** — the checkpoint restored into a freshly initialised
   state: every parameter, m and v bit-equal to the clone on the card, the
   step an int; steps 10 and 11 replayed from it give the train phase's
   losses and grad norms bit for bit. Prints the checkpoint bytes, the
   synchronous snapshot ms, the background write s and the restore ms.
16. **train-dots** — the train phase's first 5 steps (same seed,
    weights, batches and 20-step schedule) under ``remat="dots"``: losses
    equal to the train phase's within 1e-4 (bitwise printed), K1 = 2 x 30
    x steps (the attention forward replays under dots too), K2 = 30 x
    steps, K3 = 2 x 30 x steps. Prints ``train_bytes``' reckoning of what
    dots saves first, then the step time and peak memory beside the train
    phase's, and profiles one more step. Each train phase collects Python's
   cyclic garbage before it resets the peak-memory counter and prints
   what is allocated when it starts, draws each step's batch on the host
   before the step's clock starts (its median printed apart) and prints
   the caching allocator's retries over its steps.
17. **train gemma-7b** — every published width of gemma-7b kept, the
    depth cut to the deepest whose reckoned step peak (``train_bytes``,
    printed first) fits 92 % of the card, seq 4096, batch 1, 10 steps,
    lr 1e-3, warmup 3; the same checks and lines as the train phase.
18. **train longformer-4k** — at full width and depth (12 layers, d
    768), seq 4096, batch 8, 20 steps, as the train phase. Its LM trains
    on the causal form of its pattern (window 512 + 1 sink), as the
    reference's model does; the bidirectional band with its global row is
    train-kernels case (h).
18'. **train smollm-135m dilation 2** — smollm-135m at full size with
    its attention's dilation raised to 2 (no published config sets one:
    the reordered schedule, SALO's data reordering), the train phase's
    first 2 steps of its 20-step schedule and a profiled third, as the
    train phase: the losses train-sharded smollm-135m dilation 2 is held
    to.
18b. **train-sharded-check** — sequence-parallel training
    (``dist.sharded_plan``), 18b-18d2 each a job of the shared spawn
    (``train_sharded_parts``): the narrowed f32 smollm of
    train-check and the narrowed longformer (hd 64) trained 3 steps on 2
    ranks (``dist.group.run_ranks``: NCCL with one card a rank where the
    machine has the cards, else gloo ranks sharing cuda:0; the phase names
    its backend) and unsharded on the card from the same parameters and
    batches, and the narrowed f32 kimi-k2 of the MoE checks with 2
    dispatch groups (each one sequence split over both shards: the router
    logits gathered, every group routed on every rank) against its
    unsharded run on the CPU (cuda == cpu), and the narrowed smollm at
    dilation 2 (the stride exchange: each rank's working slice one
    residue class, a halo tile and a global tile) against its unsharded
    runs on the card and on the CPU (cuda == cpu): losses (and the MoE's
    aux metrics) within 1e-4, parameters and optimizer state bitwise
    equal on both ranks (sha256 of their bytes), K1-K3 launched on each.
18c. **train-sharded** — smollm-135m at full width and depth, bf16, remat
    full, seq 4096 split over 2 ranks, global batch 8, the train phase's
    first 2 steps (same seed, weights, batches and 20-step schedule). On
    every rank first one layer's ``sharded_attention`` (the halo exchange,
    K1-K3 on the view) forward and backward against unsharded
    ``salo_attention`` on the whole sequence within ``OUT_TOL`` /
    ``GRAD_TOL``. Gates: step-0 loss within 5e-3 of the train phase's
    step 0, every step within 2e-2, the loss falling; parameters and
    optimizer state bitwise equal on both ranks; per rank and step 60 K1,
    30 K2 and 30 K3 calls (60 kernels), no plain call. Prints
    ``ShardedPlan.stats`` first (the exchange's bytes against an
    all-gather's, as counted), then the step median beside the train
    phase's, the peak per rank, and one more step profiled on rank 0:
    device time by kernel, the idle share and the collectives' host time
    by profiler name. On one card the ranks are gloo processes sharing
    cuda:0, whose point-to-point sends stage through host tensors (gloo's
    send/recv take host memory only): the phase times the path, not
    NCCL's transport.
18d. **train-sharded longformer-4k** — the same at longformer-4k's full
    size (its causal LM: one-sided halos), 3 steps, against train
    longformer-4k; its one-layer gate runs the paper's bidirectional
    Longformer layer (window 512, one global token with its global row:
    halos on both sides and the global-row epilogue over the group).
18d'. **train-sharded smollm-135m dilation 2** — a reordered schedule
    under the group: 18c at dilation 2, against train smollm-135m
    dilation 2, with 18c's gates (its one-layer gate on the dilated
    pattern). q, k and v enter each rank's slice of the working stream
    (rank r holds residue class r of the stride-2 permutation) through
    one all_to_all, the output leaves through one, the backward's
    cotangent enters and dq, dk and dv leave the same way: 6 a layer
    under remat full. Gated: rank 0's profiled step ran exactly that many
    all_to_alls (by the process group's op name) and no collective but
    the sums, the halo's sends and receives and those. Prints the
    exchange's bytes (counted from the shapes) beside the halo's, the
    step median, idle share and collectives by name. Train-kernels case
    (t-d): shard 1 of its 2 (residue class 1: 16 query blocks against a
    view of 16 local, 8 halo and 2 global tiles, the halo's pairs all
    masked, 8 x 9 flat heads, hd 64, bf16), timed as (t).
18d2. **train-sharded-moe** — arctic-480b at every published width, 1 of
    35 layers, bf16, remat full, seq 4096 split over the 2 ranks, batch 1
    (16 dispatch groups of 256 tokens, each on one shard), with the
    expert count ``seq_moe_experts`` picks: every rank holds every weight,
    so the largest count whose 2 copies' reckoned peak fits ``EP_BUDGET``
    (printed first; 3 of 128). First its unsharded run on the card over
    the same first 2 steps of the train-ep schedule; then on the ranks
    those 2 steps and a profiled third. Gates: the step-0 loss within
    5e-3 of the unsharded run's and every step within 2e-2, equal losses
    and bitwise-equal state on both ranks, per rank and step 2 K1, 1 K2
    and 1 K3 call, no plain version. Prints the step median beside the
    unsharded run's, the peak per rank, the idle share and collectives
    by name of the profiled step, and the router logits' gather bytes
    (counted from the shapes).
18d3. **train-sharded qwen2-vl-2b**, **train-sharded whisper-base** —
    the VLM and the encoder-decoder under a sequence group, jobs of the
    shared spawn after the recurrent runs: 2 ranks, seq 4096 = 2 x 2048,
    every published width, bf16, remat full, the first 3 steps of their
    unsharded schedules and a profiled fourth. Every rank holds every
    weight, so qwen2-vl-2b's depth is the deepest whose 2 copies' reckoned
    peak (``train_bytes``, printed first) fits 92 % of the card (batch 1,
    1024 vision slots all on rank 0, the M-RoPE positions sliced on axis
    2), against the unsharded run of that cut; whisper-base runs at full
    size (batch 8, its encoder whole on every rank over all 1500 frames,
    its decoder's self attention sharded) against train whisper-base.
    Gates: every step's loss within 1e-4 of the unsharded run's (bitwise
    printed), equal on both ranks, the loss falling; parameters and
    optimizer state bitwise equal on both ranks; per rank and step 2 K1,
    1 K2 and 1 K3 call a decoder layer through ``sharded_attention`` and
    as many a whisper encoder layer (case (m)'s shapes), no plain
    version. Prints the step median and idle share, the collectives by
    profiler name, the peak per rank and the decoder's halo bytes
    (``ShardedPlan.stats``, counted). Train-kernels case (t-v): shard 1
    of 2 of qwen2-vl-2b's train attention (batch 1 x 12 query heads on
    its 2 KV heads, expanded, hd 128, window 1024 + 4 sinks, (t)'s view
    tables), timed as (t).
18e. **train-dp-check** — data-parallel training (``make_train_step(...,
    data=DataGroup)``), in the shared spawn after 18d2 (18f after it): the
    narrowed f32 smollm of train-check trained 3
    steps on 2 ranks, each on its rows of the global batch (NCCL with one
    card a rank where the machine has the cards, else gloo ranks sharing
    cuda:0), and unsharded on the card from the same parameters and
    batches: losses and parameters within 1e-4; then with
    ``compress_grads`` (the int8 wire with error feedback): the step-0 loss
    the uncompressed one's within 1e-4, ``ef_state`` finite and each rank's
    the residual of its own last wire input within 1e-6. Both: state
    bitwise equal on the ranks (sha256), K1-K3 launched on each.
18f. **train-dp** — smollm-135m at full width and depth, bf16, remat
    full, seq 4096, the global batch 8 split over 2 ranks (4 rows each),
    the train phase's first 4 steps (same seed, weights, batches and
    20-step schedule), the f32 gradients summed by one all_reduce a step.
    Gates: step-0 loss within 1e-3 of the train phase's step 0, every step
    within 1e-2; state bitwise equal on the ranks; per rank and step 60
    K1, 30 K2 and 30 K3 calls (60 kernels), no plain call. Prints the
    bytes a rank receives a step (ring f32 all_reduce against the int8
    wire, counted), the step median beside the train phase's, tokens/s
    over the ranks, the peak per rank, and one more step profiled on rank
    0: device time by kernel, the idle share and the collectives' host
    time by profiler name.
18f'. **train-fsdp-check**, **train-fsdp** — the FSDP fallback
    (``make_train_step(..., data=, fsdp=True)``: each weight that no model
    rule splits held as each rank's slice of its largest dim, gathered a
    layer at a time inside the remat replay, its gradient reduce-scattered
    in f32), in train-dp's 2-rank spawn after its data-parallel run: the
    narrowed f32 smollm of train-dp-check, 3 steps from the same
    parameters and batches (gates: losses within 1e-6 of train-dp-check's,
    gathered parameters within 1e-4, the leaves held whole and the step
    bitwise equal across the ranks, each slice bitwise the rank's shard of
    the gathered leaf, K1-K3 launched); then smollm-135m at full size, the
    train-dp run's first 3 steps (cut from 4 for time), each rank drawing
    only its slices (gates: every loss within 1e-3 of train-dp's, the
    leaves held whole bitwise equal across the ranks, per rank and step 2
    K1, 1 K2 and 1 K3 call an attention layer, no plain version). Prints
    the bytes a rank receives a step (gathers, f32 reduce-scatter, the
    leaves held whole's all_reduce; counted), the state a rank holds, the
    step median and the peak per rank beside train-dp's, and one more step
    profiled on rank 0: idle share and collectives by name.
18g. **train-dp-int8** — the same global batch on 4 ranks (2 rows each)
    with ``compress_grads``: the gradient goes out as int8 values and one
    f32 scale a tensor (one all_gather each), each rank keeps its own
    residual. Gates: step-0 loss within 1e-3 of train-dp's (the loss is
    computed before the reduce), the loss falling, ``ef_state`` finite,
    state bitwise equal on the ranks, the launch counts. Prints as
    train-dp, and the wire's quantize and dequantize-sum kernels' device
    time on rank 0 (CUDA events).
18g'. **train-fsdp-int8-check**, **train-fsdp-int8** — the int8 wire
    under the FSDP fallback, in train-dp-int8's 4-rank spawn after its
    data-parallel run: an FSDP weight's backward keeps the rank's whole
    f32 gradient, quantized whole with the whole residual; one int8
    ``all_to_all`` hands each rank the sum of its slices only. The
    narrowed f32 smollm, 3 steps from the same parameters, beside the
    data-parallel int8 steps of it in the same ranks (gates: losses and
    every rank's slices bitwise the data-parallel int8 run's, the leaves
    held whole and the step bitwise equal across the ranks, K1-K3
    launched); then smollm-135m at full size, train-fsdp's schedule
    (gates: every loss bitwise train-dp-int8's, the launch counts). Prints
    the bytes a rank receives (the int8 ``all_to_all`` against the int8
    ``all_gather``, counted), the whole residual's bytes, the peak per
    rank beside train-fsdp's and train-dp-int8's, rank 0's step median
    and one profiled step's idle share.
18g''. **train-tp-int8-check (data 2, model 2)** — in the same spawn:
    the gemma-like narrowed f32 config of train-tp-check on the int8 wire
    at (data 2, model 2) (each scale group's absmax maxed over the model
    group), against the (data 2) int8 steps of the same config and
    batches. Gates: every loss within 1e-4 (TP reorders the gradients'
    sums by ~1e-7, which moves a value on a rounding boundary by one int8
    step), the model ranks' losses equal, K1-K3 launched. Prints the int8
    values that differ from the data-2 run's slices, per rank and step.
18h. **train-tp-check** — tensor-parallel training (``make_train_step(
    ..., model_group=ModelGroup)``, heads, ffn and vocab split by
    ``dist.sharding.mesh_placements``): six narrowed f32 configs trained
    3 steps on 2 model ranks (NCCL with one card a rank where the machine
    has the cards, else gloo ranks sharing cuda:0; the shared 2-rank
    spawn's, after train-dp, as the model axis of a (1, 2) mesh), each
    from the same
    parameters cut into the ranks' slices, against one rank on the card:
    gemma-like (2 / 2 heads of hd 256, ffn 512, vocab 256: every
    placement split), smollm-like (3 / 1 heads: the attention whole on
    every rank), and train-check's recurrentgemma (d_rnn 256 split: the
    RG-LRU's gate input gathered, its whole gate and conv leaves' shares
    summed), mamba2 (the SSD by heads, its norm's sum over the ranks; no
    attention), qwen2-vl (M-RoPE, the vision merge, 6 query heads on one
    KV head) and whisper (the encoder and the cross attention split).
    Gates: losses and gathered parameters within 1e-4, grad norms within
    1e-5, the leaves a rank holds whole and the optimizer step bitwise
    equal across the ranks (sha256), K1-K3 launched on each (none in
    mamba2), no plain version.
18i. **train-tp** — gemma-7b at every published width (d 3072, 16 heads
    of hd 256, ffn 24576, vocab 256000 tied, softcap 30), bf16, remat
    full, seq 4096, batch 1, on 2 model ranks (the same spawn as the
    check), the depth the deepest whose reckoned peak of one rank
    (``train_bytes_tp``) times the ranks sharing the card fits 92 % of it
    (printed first), the first 4 steps of the gemma train phase's
    schedule; each rank draws its slices layer by layer from the
    single-device draw of the seed (``trainer.init_shards``). Gates:
    every loss within 1e-2 of the unsharded gemma train phase's at the
    same depth (bf16 partials summed in bf16), the loss falling, the
    leaves held whole bitwise equal across the ranks, per rank and step
    2 K1, 1 K2 and 1 K3 call an attention layer, no plain version.
    Prints the placements once, rank 0's step median, tokens/s, the peak
    per rank, one profiled step's idle share and collectives by name, and
    the bytes a rank sends a step (``tp_step_bytes``, counted).
18i'. **train-tp recurrentgemma-9b** — the same for recurrentgemma-9b at
    every published width (d 4096, d_rnn 4096, 16 query heads on one KV
    head of hd 256, window 2048, ffn 12288, vocab 256000 tied), after
    gemma-7b in the same spawn, at the depth of the unsharded
    recurrentgemma train phase (19), which runs before the spawn as its
    reference: the RG-LRU's products split on d_rnn (its f32 gate input
    gathered forward, reduce-scattered backward; ``w_a``, ``w_i``, the
    conv and ``lam`` whole, their gradients' shares summed in one flat
    f32 all_reduce a step), the local attention by heads (its one KV head
    replicated). The same gates and prints; ``tp_step_bytes`` counts the
    gathers, reduce-scatters and the flat sum.
18i''. **train-tp-int8-check**, **train-tp-int8** — the int8 wire under a
    model group of 2 in the same spawn: the gemma-like and the arctic-like
    (expert stacks split over the ranks) narrowed f32 configs, 3 steps on
    the int8 wire against one rank's int8 steps on the card (gates: losses
    and grad norms within 1e-4, K1-K3 launched; prints the int8 values
    that differ from the one-rank run's slices); then gemma-7b at full
    width at train-tp's depth, the first 3 steps of train-tp's schedule
    from the same weights on the int8 wire (gates: losses within 1e-2 of
    train-tp's, which carry int8 noise on the update; equal on the ranks;
    the launch counts). Prints the step median and idle share beside
    train-tp's, the peak per rank and ``tp_step_bytes`` with the wire's
    MAX of the scales.
18j. **train-ep-check** — expert-parallel MoE training (``moe_apply(...,
    model=ModelGroup)``: E / N experts a rank, the router's columns, the
    logits gathered and routed alike on every rank, one ``all_reduce`` of
    the expert rows a layer): serve-check (4)'s narrowed f32 arctic-480b
    and kimi-k2 (128 experts top-2 with the dense residual; 384 top-8 with
    the shared expert and the leading dense layer) trained 3 steps on 2
    model ranks (the train-tp spawn, after train-tp) against one rank on
    the card (``prepare_train_ep``, before the spawn). Gates: losses within
    1e-6, grad norms and aux metrics within 1e-5, gathered parameters
    within 1e-5, every routing call's slot and keep tensors hashed and
    bitwise equal across the ranks, the leaves held whole and the step
    bitwise equal, K1-K3 launched on each rank.
18k. **train-ep** — arctic-480b at every published width (d 7168, 56 / 8
    heads of hd 128, ffn 4864, experts of 4864 top-2, vocab 32000, window
    1024 + 4 sinks), bf16, remat full, seq 4096, batch 1, 1 of 35 layers,
    the expert count the largest multiple of 2 whose reckoned peak
    (``train_bytes_tp``: a rank's parameters and state, its largest leaf's
    update temporaries, its logits' vocab slice and one MoE layer's
    dispatch) for the two ranks sharing the card, and unsharded, fits
    ``EP_BUDGET`` (75 %) of it (printed first; 12 of 128). First the
    unsharded run of that config from the seed, the gemma train phase's
    10-step schedule (its loss must fall); then on the 2 model ranks (the
    train-tp spawn, each rank drawing only its experts) the same 10 steps.
    Gates: the first 4 losses within 1e-2 of the unsharded run's (the
    router saturates from step 4 in both, and the runs part), the mean of
    the last 5 below the first, the leaves held
    whole bitwise equal across the ranks, per rank and step 2 K1, 1 K2 and
    1 K3 call, no plain version. Prints the dropped share of every step
    beside the unsharded run's, rank 0's step median, tokens/s, idle
    share, the peak per rank, the collectives by name and the bytes a rank
    sends a step (``tp_step_bytes``, counted).
18l. **train-ep-uneven-check**, **train-ep-uneven** — an expert count the
    model group does not divide (the train-tp spawn, after train-ep): the
    narrowed f32 arctic-480b of train-ep-check with 3 experts of width 64
    (the 2 ranks split each expert's ffn, the router whole) and of width
    63 (the MoE whole on every rank) trained 3 steps against one rank on
    the card (losses within 1e-4, grad norms and aux metrics within 1e-5,
    gathered parameters within ``EP_UNEVEN_PARAMS_TOL``, whole leaves and
    step bitwise equal); then arctic-480b at every published width, 1
    layer, the largest expert count 2 does not divide that
    ``train_ep_experts`` fits (11: every rank routes all 11, their ffn
    split), the first 3 steps of the train-ep schedule against the
    unsharded run of that cut (within 1e-2), equal losses and whole
    leaves on the ranks, the launch counts; prints the step median and
    the peak per rank. (At 3 ranks arctic splits nothing at full width,
    and 3 whole copies do not fit the card: the 3-rank case runs on the
    CPU, ``tests/test_torch_ep.py``.)
19. **train recurrentgemma-9b** — (run before the train-tp spawn, as
    train-tp recurrentgemma-9b's reference) every published width, the
    depth cut to the deepest multiple of 3 (whole griffin groups) whose
    reckoned peak (``train_bytes``, printed first: RG-LRU and SSD blocks
    and their recomputed f32 scan temporaries counted) fits 92 % of the
    card and whose train-tp reckoning (``train_bytes_tp``, the 2 ranks
    sharing the card) fits too, seq 4096, batch 1, 10 steps, lr 1e-3,
    warmup 3; per step and group K1 2 (remat full replays it), K2 1, K3 2
    (two kernels a call).
20. **train mamba2-370m** — at full width, 12 of its 48 layers, seq
    4096, batch 4, 10 steps, lr 1e-3, warmup 3: no kernel launches; the
    loss falls.
Each phase added for the recurrent and MoE families prints its wall time,
and the script its own before the ``kernels`` line.

The last three lines of standard output are the ``kernels`` JSON line,
the card's name and power limit from ``nvidia-smi``, and the result line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the checkout, it exits nonzero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2}
REPEATS = 10                     # calls a decode case must repeat bitwise
# Decode-only steps [PROFILE_FROM, PROFILE_TO) run under torch.profiler.
# The profiler's hooks slow the host afterwards, so the serve timings are
# taken before PROFILE_FROM and the later steps only finish the run.
PROFILE_FROM, PROFILE_TO = 40, 43
TRAIN_STEPS, TRAIN_BATCH = 20, 8
GEMMA_STEPS, GEMMA_BATCH = 10, 1   # gemma-7b train: depth cut to fit the card
QWEN_STEPS = 4                     # train qwen2-vl-2b: cut from 10 for time
# (recurrentgemma-9b trains the same way, whole griffin groups)
# mamba2-370m train: full width at batch 4, 12 of its 48 layers (depth
# cut to keep the script near 950 s with the sharded and data-parallel
# train phases; its plain recurrent scans are the slowest train step a
# layer)
MAMBA_BATCH, MAMBA_TRAIN_LAYERS = 4, 12
# the MoE family: served at full width, depth cut to fit (serve_depth);
# their names in the kernels line's launch paths
MOE_ARCHS = ("arctic-480b", "kimi-k2-1t-a32b")
MOE_TAGS = {"arctic-480b": "arctic-480b", "kimi-k2-1t-a32b": "kimi-k2"}
# the VLM and the encoder-decoder: full width and depth on one card
FAMILY_ARCHS = ("qwen2-vl-2b", "whisper-base")
FT_TRAIN_AT = 10                   # train-ft: the step checkpointed


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """Mean device time of one call, with L2 flushed before each call (the
    serving decode reads a different layer's slab each launch, so it finds
    L2 cold). The timed calls queue up behind a sleep kernel, so the card
    runs them back to back and the events do not count the host's time to
    issue a call. Slow-to-issue calls (the plain versions, which launch
    many small kernels each) take fewer iterations and a longer sleep; a
    run whose calls outlast the sleep is repeated behind a longer one, and
    calls that wait on the card themselves (a host read inside, or the
    caching allocator freeing blocks, which synchronizes) are timed on the
    host clock. Such a call is known by the sleep ending inside it: the
    call that returns after the sleep has ended took more than half the
    time since the sleep was queued, where a call that never waits issues
    in a small share of it. Then no longer sleep is tried (each retry
    behind the 4x sleep of a plain version cost ~8 s of the card's
    time)."""

    SLEEP_CYCLES = 200_000_000      # ~0.1 s: longer than issuing all calls

    def __init__(self, torch, iters: int = 20):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int = 0, sleep_cycles: int = 0) -> float:
        torch = self.torch
        iters = iters or self.iters
        sleep = sleep_cycles or self.SLEEP_CYCLES
        for _ in range(3):
            fn()
        # calls slower to issue than the sleep lasts are timed again behind
        # a sleep four times as long
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda._sleep(sleep)
            slept = torch.cuda.Event()
            slept.record()
            pairs = []
            waited = False
            queued = time.perf_counter()
            for _ in range(iters):
                self.flush.zero_()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                t0 = time.perf_counter()
                fn()
                e.record()
                pairs.append((s, e))
                t1 = time.perf_counter()
                if slept.query() and t1 - t0 > 0.5 * (t1 - queued):
                    waited = True       # the sleep ended inside this call
                    break
            issued = not waited and not slept.query()
            torch.cuda.synchronize()
            if issued:
                return sum(s.elapsed_time(e) for s, e in pairs) / iters
            if waited:
                break
            sleep *= 4
        # a call that waits on the card itself (a host read inside) cannot
        # queue behind a sleep: its time is the host's, synchronized
        log("[timer] the calls wait on the card (they never queue behind "
            "the sleep): timed on the host clock, synchronized")
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / iters * 1e3


# --------------------------------------------------------------------- #
# the sources the first phases need (K4, K5: the decode and serve phases)
DECODE_SOURCES = ("salo_decode", "salo_paged_decode")


def _log_ptxas(names) -> None:
    from repro_torch.kernels import _build

    for name in names:
        fn = ""
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"[build] {name}: {fn}: {line.strip()}")


def phase_build(wait_all: bool = True):
    """build: one nvcc per CUDA source, all started at once. With
    ``wait_all`` it waits for every one; else for the decode kernels'
    alone (``DECODE_SOURCES``), and the training kernels' builds go on
    beside the phases that need none of them (``finish_build``; a load
    waits for its own build)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    started = _build.start_all()
    names = _build.sources() if wait_all else DECODE_SOURCES
    secs = _build.wait(names)
    log(f"[build] {len(started)} kernel source(s) started at once; "
        f"{'all' if wait_all else 'the decode kernels'} built in "
        f"{time.perf_counter() - t0:.1f} s: {secs}")
    _log_ptxas(names)


def finish_build() -> None:
    """The rest of ``phase_build(wait_all=False)``: wait for the training
    kernels' builds and print their ptxas report."""
    from repro_torch.kernels import _build

    rest = [n for n in _build.sources() if n not in DECODE_SOURCES]
    secs = _build.wait(rest)
    log(f"[build] the training kernels built in {secs} s (nvcc's start to "
        f"its library; 0.0 where a phase's load waited for it)")
    _log_ptxas(rest)


def int8_slab(torch, gen, n_pages, page, Hkv, hd):
    """An int8 slab with per-page scales, written through the engine's
    quant_slab_write (two rounds per slot: scale growth and rescale)."""
    from repro_torch.serve.paged_cache import quant_slab_write

    k8 = torch.zeros((n_pages, page, Hkv, hd), dtype=torch.int8,
                     device="cuda")
    v8 = torch.zeros_like(k8)
    ks = torch.zeros(n_pages, device="cuda")
    vs = torch.zeros_like(ks)
    phys = torch.arange(1, n_pages, device="cuda",
                        dtype=torch.int32).repeat_interleave(page)
    off = torch.arange(page, device="cuda",
                       dtype=torch.int32).repeat(n_pages - 1)
    for gain in (0.5, 1.0):
        rows = torch.randn((2, phys.numel(), Hkv, hd), generator=gen,
                           device="cuda") * gain
        quant_slab_write(k8, v8, ks, vs, phys, off, rows[0], rows[1])
    return k8, v8, ks, vs


def decode_case(torch, gen, *, dtype, B, H, Hkv, hd, page, window, g, dil,
                ts, pad_rows=(), int8=False, shards=1, **_):
    """Random slab/query/page tables/positions on the card for one
    kernel case; positions as the engine keeps them (every position <= t
    written in its ring slot), in the layout of ``shards`` shards.
    Returns (pattern, operands, scales) — scales (k_scale, v_scale) for an
    int8 slab, else (None, None)."""
    import numpy as np

    from repro_torch.core.patterns import causal_sliding_window
    from repro_torch.core.scheduler import PAD_SENTINEL, ring_view_positions
    from repro_torch.serve.paged_cache import layout_for_pattern

    pat = causal_sliding_window(window, n_sinks=g, dilation=dil)
    lay = layout_for_pattern(pat, page, shards=shards)
    npp = lay.pages_per_req
    n_pages = 1 + B * npp
    shape = (n_pages, page, Hkv, hd)
    if int8:
        k, v, ks, vs = int8_slab(torch, gen, n_pages, page, Hkv, hd)
    else:
        k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        ks = vs = None
    q = torch.randn((B, H, 1, hd), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    pt = perm[: B * npp].reshape(B, npp).to(torch.int32).contiguous()
    pos = np.stack([ring_view_positions(t + 1, lay.n_sink, lay.ring_cap, g)
                    for t in ts]).astype(np.int32)
    for r in pad_rows:
        pos[r] = PAD_SENTINEL
    pos_t = torch.from_numpy(pos).cuda()
    t = torch.tensor(ts, dtype=torch.int32, device="cuda")
    return pat, (q, k, v, pt, pos_t, t), (ks, vs)


def check_repeats(torch, fn, first, what):
    """REPEATS more calls of ``fn`` give outputs bitwise equal to
    ``first`` (a tuple of tensors)."""
    for _ in range(REPEATS):
        res = fn()
        res = res if isinstance(res, tuple) else (res,)
        check(all(torch.equal(a, b) for a, b in zip(res, first)),
              f"{what}: a repeated call is not bitwise equal")


def live_mask(torch, pat, pos, t):
    from repro_torch.core.scheduler import (STEP_GLOBAL, STEP_WINDOW,
                                            causal_step_mask)
    return causal_step_mask(pat, t[:, None], pos, STEP_WINDOW | STEP_GLOBAL)


def k4_cases(torch):
    """K4's kernel cases by name: decode_case keyword arguments."""
    serve = dict(B=8, H=9, Hkv=3, hd=64, page=16, window=1024, g=4, dil=1,
                 ts=[5, 300, 700, 1027, 1028, 1500, 2047, 3000])
    return [("a", dict(serve, dtype=torch.bfloat16)),
            ("b", dict(serve, dtype=torch.float32)),
            ("c", dict(B=4, H=2, Hkv=2, hd=128, page=8, window=64, g=4,
                       dil=2, ts=[10, 200, 77, 40], pad_rows=(3,),
                       dtype=torch.float16)),
            # the int8 serve phase's kernel: int8 slab, bf16 compute,
            # page statistics
            ("d", dict(serve, dtype=torch.bfloat16, int8=True,
                       stats=True)),
            # the sequence-parallel partial: f32 (out, m, l) and page
            # statistics, one all-PAD row
            ("e", dict(serve, dtype=torch.float32, state=True, stats=True,
                       pad_rows=(0,))),
            # one request with a long cache: few (request, head) pairs,
            # so the split carries the grid
            ("f", dict(serve, B=1, ts=[3000], dtype=torch.bfloat16)),
            # gemma-7b's decode: 16 heads of hd 256, no GQA
            ("g", dict(serve, H=16, Hkv=16, hd=256, dtype=torch.bfloat16)),
            # arctic-480b's decode: 56 query heads on 8 KV heads of hd 128
            # (rep 7: a full row group of 4 and a partial one of 3)
            ("l", dict(serve, H=56, Hkv=8, hd=128, dtype=torch.bfloat16))]


def phase_kernels(torch, timer, seed):
    """K4 against its plain version in every variant; returns the records
    of the cases by name."""
    import torch.nn.functional as F

    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain,
                                                 split_plan)
    from repro_torch.serve.paged_cache import gather_view

    cases = k4_cases(torch)
    records = {}
    for i, (name, kw) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        pat, ops, (ks, vs) = decode_case(torch, gen, **kw)
        q, k, v, pt, pos, t = ops
        var = dict(pattern=pat, k_scale=ks, v_scale=vs,
                   return_state=kw.get("state", False),
                   return_page_stats=kw.get("stats", False))
        res = salo_paged_decode(*ops, **var)
        ref = salo_paged_decode_plain(*ops, **var)
        torch.cuda.synchronize()
        res = res if isinstance(res, tuple) else (res,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        check_repeats(torch, lambda: salo_paged_decode(*ops, **var), res,
                      f"K4 case {name}")
        mask = live_mask(torch, pat, pos, t)                   # (B, S)
        live_rows = mask.any(dim=1)
        check(bool(live_rows.any()), f"case {name}: no live row")
        check(len(kw.get("pad_rows", ())) == int((~live_rows).sum()),
              f"case {name}: live rows {live_rows.tolist()}")
        dname = str(kw["dtype"]).replace("torch.", "")
        tol = TOL[dname]
        n_row_out = 3 if var["return_state"] else 1
        names = ["out", "m", "l"][:n_row_out]
        errs = {}
        for what, a, b in zip(names, res, ref):
            o, r = a[live_rows].float(), b[live_rows].float()
            check(bool(torch.isfinite(o).all()),
                  f"case {name}: non-finite kernel {what}")
            errs[what] = float((o - r).abs().max())
            check(bool(torch.allclose(o, r, atol=tol, rtol=tol)),
                  f"case {name}: kernel {what} vs plain max abs err "
                  f"{errs[what]} > {tol}")
            if kw.get("pad_rows") and var["return_state"]:
                check(torch.equal(a[~live_rows], b[~live_rows]),
                      f"case {name}: an all-PAD row must give the "
                      f"(0, NEG_INF, 0) identity, {what}")
        if kw.get("pad_rows") and not var["return_state"]:
            check(bool((res[0][~live_rows] == 0).all()),
                  f"case {name}: an all-PAD row must give 0")
        if var["return_page_stats"]:
            pm, rpm = res[-1], ref[-1]
            dead = (pm <= -1e29) | (rpm <= -1e29)
            check(torch.equal(pm[dead], rpm[dead]),
                  f"case {name}: page_m differs where a side is NEG_INF")
            errs["page_m"] = float((pm[~dead] - rpm[~dead]).abs().max())
            check(bool(torch.allclose(pm[~dead], rpm[~dead], atol=tol,
                                      rtol=tol)),
                  f"case {name}: page_m max abs err {errs['page_m']}")
            check(bool(dead.any()) and bool((~dead).any()),
                  f"case {name}: page_m has no dead or no live page")

        # yardstick: SDPA on the pre-gathered (dequantized) view with a
        # precomputed mask
        kr, vr = gather_view(k, v, pt, *((ks, vs, q.dtype) if ks is not None
                                         else ()))
        kr = kr.transpose(1, 2).contiguous()
        vr = vr.transpose(1, 2).contiguous()
        amask = mask[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(q, kr, vr, attn_mask=amask,
                                                  enable_gqa=True)

        kernel_ms = timer(lambda: salo_paged_decode(*ops, **var))
        plain_ms = timer(lambda: salo_paged_decode_plain(*ops, **var))
        library_ms = timer(lib)
        # bound: the bytes the function must move for THIS data (the
        # kernel reads only live slots' K/V rows, and the scales of the
        # pages that hold them) vs its operations
        B, H, _, hd = q.shape
        Hkv, page = k.shape[2], k.shape[1]
        n_split, split_len = split_plan(q.device, B, H, Hkv, pos.shape[1],
                                        page)
        live = int(mask.sum())                      # live (b, slot) pairs
        live_pages = int(mask.reshape(B, -1, page).any(-1).sum())
        item = q.element_size()
        out_item = 4 if var["return_state"] else item
        nbytes = (2 * live * Hkv * hd * k.element_size()   # K and V rows
                  + q.numel() * item + q.numel() * out_item
                  + (pt.numel() + pos.numel() + t.numel()) * 4)
        if ks is not None:
            nbytes += 2 * live_pages * 4                   # their scales
        if var["return_state"]:
            nbytes += 2 * B * H * 4                        # m, l
        if var["return_page_stats"]:
            nbytes += pt.numel() * 4                       # page_m
        ops_ = 4 * live * H * hd                    # QK^T and PV
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / PEAK_OPS[dname] * 1e3
        rec = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=max(errs.values()), errs=errs, bytes=nbytes,
                   live_slots=live, n_split=n_split, split_len=split_len)
        log(f"[kernels] K4 case {name} {dname} "
            f"{'int8 slab ' if ks is not None else ''}"
            f"state={var['return_state']} "
            f"stats={var['return_page_stats']} B={B} H={H} Hkv={Hkv} "
            f"hd={hd} page={page} npp={pt.shape[1]}: "
            + " ".join(f"{a}={b}" for a, b in rec.items()))
        records[name] = rec
    records["s"] = k4_shard_case(torch, timer, seed + len(cases))
    return records


def shard_views(torch, k, v, pt, pos, shards, pps, page):
    """A paged view (slab ``k``/``v``, page tables ``pt`` (B, npp),
    positions ``pos`` (B, npp * page)) split over ``shards`` shards as the
    sequence-parallel engine stripes it: shard r gets its own slab of the
    pages it owns (null page 0 first) and its stripe of the tables and
    positions. Returns [(k_r, v_r, pt_r, pos_r)]."""
    B = pt.shape[0]
    out = []
    for r in range(shards):
        idx = pt[:, r * pps:(r + 1) * pps].reshape(-1).long()
        pt_r = torch.arange(1, 1 + B * pps, dtype=torch.int32,
                            device=pt.device).reshape(B, pps)
        out.append((torch.cat([k[:1], k[idx]]), torch.cat([v[:1], v[idx]]),
                    pt_r, pos[:, r * pps * page:(r + 1) * pps * page]
                    .contiguous()))
    return out


def k4_shard_case(torch, timer, seed, shards=2):
    """K4 case (s): ``return_state`` on one shard's slab, the serve phase's
    shapes at 2 shards (8 rows, 9 query heads on 3 KV heads of hd 64,
    bf16, ``pages_per_shard`` = 33 pages of 16; shard 1's ring has not
    reached its slots on the rows at t = 5 and 300, so they are empty
    there). Checks each shard against the plain version on its live rows
    (``salo_attention.OUT_TOL`` / ``STATS_TOL``), the exact (NEG_INF, 0)
    stats and a zero out on its empty rows, bitwise repeats, and the
    shards' partials merged by ``masked_psum_merge`` (a ``StackedGroup``
    on this card) against unsharded K4 on the same slab content within
    ``OUT_TOL``. Times shard 1's call (the one with empty rows), its plain
    version and SDPA on its gathered view; the bound counts its live
    slots. Returns the record."""
    import torch.nn.functional as F

    from repro_torch.dist.group import StackedGroup
    from repro_torch.dist.sharded_plan import masked_psum_merge
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain,
                                                 split_plan)
    from repro_torch.serve.paged_cache import gather_view, layout_for_pattern

    kw = dict(k4_cases(torch))["a"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # the layout of 2 shards: 65 pages a request padded to 66
    pat, (q, k, v, pt, pos, t), _ = decode_case(torch, gen, **kw,
                                                shards=shards)
    lay = layout_for_pattern(pat, kw["page"], shards=shards)
    pps, page = lay.pages_per_shard, lay.page
    views = shard_views(torch, k, v, pt, pos, shards, pps, page)
    var = dict(pattern=pat, return_state=True)
    dtype = q.dtype
    parts, errs, empty_rows = [], {}, []
    for r, (kr, vr, ptr, posr) in enumerate(views):
        res = salo_paged_decode(q, kr, vr, ptr, posr, t, **var)
        ref = salo_paged_decode_plain(q, kr, vr, ptr, posr, t, **var)
        torch.cuda.synchronize()
        check_repeats(torch, lambda: salo_paged_decode(q, kr, vr, ptr, posr,
                                                       t, **var),
                      res, f"K4 case s shard {r}")
        live = live_mask(torch, pat, posr, t).any(dim=1)
        empty_rows.append(int((~live).sum()))
        for what, a, b, tol in (("out", res[0], ref[0], KA.OUT_TOL[dtype]),
                                ("m", res[1], ref[1], KA.STATS_TOL),
                                ("l", res[2], ref[2], KA.STATS_TOL)):
            o, p_ = a[live], b[live]
            errs[f"{what}{r}"] = float((o - p_).abs().max())
            check(bool(torch.isfinite(a).all()),
                  f"case s shard {r}: non-finite {what}")
            check(bool(torch.allclose(o, p_, atol=tol, rtol=tol)),
                  f"case s shard {r}: {what} vs plain max abs err "
                  f"{errs[f'{what}{r}']} > {tol}")
        check(bool((res[1][~live] == -1e30).all())
              and bool((res[2][~live] == 0).all())
              and bool((res[0][~live] == 0).all()),
              f"case s shard {r}: an empty row must give exactly "
              f"(0, NEG_INF, 0)")
        parts.append(res)
    check(empty_rows[0] == 0 and empty_rows[1] == 2,
          f"case s: empty rows per shard {empty_rows}, want [0, 2]")
    merged = masked_psum_merge(*(torch.stack([p_[i] for p_ in parts])
                                 for i in range(3)),
                               StackedGroup(shards))[0].to(dtype)
    whole = salo_paged_decode(q, k, v, pt, pos, t, pattern=pat)
    torch.cuda.synchronize()
    errs["merged"] = float((merged.float() - whole.float()).abs().max())
    tol = KA.OUT_TOL[dtype]
    check(bool(torch.allclose(merged.float(), whole.float(), atol=tol,
                              rtol=tol)),
          f"case s: merged shards vs unsharded K4 max abs err "
          f"{errs['merged']} > {tol}")

    kr, vr, ptr, posr = views[1]
    mask = live_mask(torch, pat, posr, t)
    gk, gv = gather_view(kr, vr, ptr)
    gk = gk.transpose(1, 2).contiguous()
    gv = gv.transpose(1, 2).contiguous()

    def lib():
        return F.scaled_dot_product_attention(q, gk, gv,
                                              attn_mask=mask[:, None, None],
                                              enable_gqa=True)

    kernel_ms = timer(lambda: salo_paged_decode(q, kr, vr, ptr, posr, t,
                                                **var))
    plain_ms = timer(lambda: salo_paged_decode_plain(q, kr, vr, ptr, posr,
                                                     t, **var))
    library_ms = timer(lib)
    B, H, _, hd = q.shape
    Hkv = k.shape[2]
    live = int(mask.sum())
    nbytes = (2 * live * Hkv * hd * kr.element_size()
              + q.numel() * q.element_size() + q.numel() * 4 + 2 * B * H * 4
              + (ptr.numel() + posr.numel() + t.numel()) * 4)
    ops_ = 4 * live * H * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / PEAK_OPS["bfloat16"] * 1e3
    n_split, split_len = split_plan(q.device, B, H, Hkv, posr.shape[1], page)
    rec = dict(kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=max(errs.values()), errs=errs, bytes=nbytes,
               live_slots=live, n_split=n_split, split_len=split_len)
    whole_split = split_plan(q.device, B, H, Hkv, pos.shape[1], page)
    log(f"[kernels] K4 case s bf16 state=True on shard 1 of {shards} "
        f"(pages_per_shard {pps}, empty rows per shard {empty_rows}; "
        f"unsharded split {whole_split}): "
        + " ".join(f"{a}={b}" for a, b in rec.items()))
    return rec


LOCKSTEP_B, LOCKSTEP_PROMPT, LOCKSTEP_NEW = 8, 1088, 32


# recurrentgemma-9b on the lockstep engine (full width and depth) and its
# K5 case (k): one KV head under 16 query heads of hd 256, window 2048
RG_B, RG_PROMPT, RG_NEW = 8, 256, 32
RG_K5_S = 2304                   # case (k)'s full cache: t = S - 1 > window


def k5_cases(torch):
    """K5's kernel cases by name: (a) the lockstep phase's cache (bf16,
    full cache, slot = position; smollm-135m's 9 query heads on 3 KV heads
    of hd 64), (b) the same in f32, (c) the ring layout (window + sinks
    slots, PAD for unwritten ring slots) with dilation 2, (k)
    recurrentgemma-9b's decode (16 query heads on one KV head of hd 256,
    bf16, full cache of 2304 slots, t past its 2048 window, 4 sinks), (l)
    arctic-480b's decode on the MoE lockstep phases' cache (56 query heads
    on 8 KV heads of hd 128, bf16, 288 slots, t = 287), (m) qwen2-vl-2b's
    (12 query heads on 2 KV heads of hd 128, rep 6: row groups of 4 and
    2, window 1024) and (n) whisper-base's decoder's (8 heads of hd 64, rep
    1, window 512) on the same lockstep cache length."""
    S = LOCKSTEP_PROMPT + LOCKSTEP_NEW
    heads = dict(H=9, Hkv=3, hd=64)
    full = dict(heads, window=1024, g=4, dil=1, S=S, t=S - 1, ring=False)
    return [("a", dict(full, dtype=torch.bfloat16)),
            ("b", dict(full, dtype=torch.float32)),
            ("c", dict(heads, window=512, g=4, dil=2, S=512 + 4, t=3000,
                       ring=True, dtype=torch.bfloat16)),
            ("k", dict(H=16, Hkv=1, hd=256, window=2048, g=4, dil=1,
                       S=RG_K5_S, t=RG_K5_S - 1, ring=False,
                       dtype=torch.bfloat16)),
            ("l", dict(H=56, Hkv=8, hd=128, window=1024, g=4, dil=1,
                       S=RG_PROMPT + RG_NEW, t=RG_PROMPT + RG_NEW - 1,
                       ring=False, dtype=torch.bfloat16)),
            ("m", dict(H=12, Hkv=2, hd=128, window=1024, g=4, dil=1,
                       S=RG_PROMPT + RG_NEW, t=RG_PROMPT + RG_NEW - 1,
                       ring=False, dtype=torch.bfloat16)),
            ("n", dict(H=8, Hkv=8, hd=64, window=512, g=4, dil=1,
                       S=RG_PROMPT + RG_NEW, t=RG_PROMPT + RG_NEW - 1,
                       ring=False, dtype=torch.bfloat16))]


def k5_case(torch, gen, c):
    """Random operands of one K5 case on the card, the caches read through
    the transposed view of a (B, S, Hkv, hd) cache. Returns (pattern, q,
    k, v, positions or None, t)."""
    import numpy as np

    from repro_torch.core.patterns import causal_sliding_window
    from repro_torch.core.scheduler import PAD_SENTINEL

    B, H, Hkv, hd = LOCKSTEP_B, c["H"], c["Hkv"], c["hd"]
    pat = causal_sliding_window(c["window"], n_sinks=c["g"],
                                dilation=c["dil"])
    S, t, dt = c["S"], c["t"], c["dtype"]
    cache = torch.randn((2, B, S, Hkv, hd), generator=gen,
                        device="cuda").to(dt)
    k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
    q = torch.randn((B, H, 1, hd), generator=gen, device="cuda").to(dt)
    positions = None
    if c["ring"]:
        w, g = c["window"], c["g"]
        j = np.arange(S)
        pos = np.where(j < g, j, t - np.mod(t - j, w))
        pos = np.where((j >= g) & (pos < g), PAD_SENTINEL, pos)
        positions = torch.from_numpy(pos.astype(np.int32)).cuda()
    return pat, q, k, v, positions, t


def phase_k5(torch, timer, seed):
    """K5 against its plain version in the cases of ``k5_cases``. Returns
    the records by case."""
    import torch.nn.functional as F

    from repro_torch.kernels.salo_decode import (salo_decode,
                                                 salo_decode_plain,
                                                 split_plan)

    records = {}
    for i, (name, c) in enumerate(k5_cases(torch)):
        gen = torch.Generator(device="cuda").manual_seed(seed + 50 + i)
        pat, q, k, v, positions, t = k5_case(torch, gen, c)
        B, H, _, hd = q.shape
        Hkv, S_, dt = k.shape[1], c["S"], c["dtype"]
        out = salo_decode(q, k, v, positions, t, pattern=pat)
        ref = salo_decode_plain(q, k, v, positions, t, pattern=pat)
        torch.cuda.synchronize()
        check_repeats(torch, lambda: salo_decode(q, k, v, positions, t,
                                                 pattern=pat), (out,),
                      f"K5 case {name}")
        n_split, split_len = split_plan(q.device, B, H, Hkv, S_)
        dname = str(dt).replace("torch.", "")
        tol = TOL[dname]
        check(bool(torch.isfinite(out).all()), f"K5 case {name}: non-finite")
        err = float((out.float() - ref.float()).abs().max())
        check(bool(torch.allclose(out.float(), ref.float(), atol=tol,
                                  rtol=tol)),
              f"K5 case {name}: kernel vs plain max abs err {err} > {tol}")
        pos_k = (torch.arange(S_, dtype=torch.int32, device="cuda")
                 if positions is None else positions)
        mask = live_mask(torch, pat, pos_k[None].expand(B, S_),
                         torch.full((B,), t, dtype=torch.int32,
                                    device="cuda"))
        amask = mask[:, None, None, :]

        def lib():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=amask,
                                                  enable_gqa=True)

        kernel_ms = timer(lambda: salo_decode(q, k, v, positions, t,
                                              pattern=pat))
        # few iterations: a plain call on the strided cache copies it and
        # takes long to issue, and the queue must stay behind the sleep
        plain_ms = timer(lambda: salo_decode_plain(q, k, v, positions, t,
                                                   pattern=pat),
                         iters=2, sleep_cycles=4_000_000_000)
        library_ms = timer(lib)
        live = int(mask.sum())
        item = q.element_size()
        nbytes = (2 * live * Hkv * hd * item + 2 * q.numel() * item
                  + (0 if positions is None else positions.numel() * 4))
        ops_ = 4 * live * H * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops_ / PEAK_OPS[dname] * 1e3
        rec = dict(kernel_ms=kernel_ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   max_abs_err=err, bytes=nbytes, live_slots=live,
                   n_split=n_split, split_len=split_len)
        log(f"[kernels] K5 case {name} {dname} {pat} B={B} H={H} Hkv={Hkv} "
            f"hd={hd} S={S_} t={t} ring={c['ring']}: "
            + " ".join(f"{a}={b}" for a, b in rec.items()))
        records[name] = rec
    return records


def _serve_check_cfg(window):
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import SALOConfig

    return dataclasses.replace(get_smoke("smollm-135m"), d_model=192,
                               n_heads=3, n_kv_heads=1, d_ff=256,
                               salo=SALOConfig(window=window, n_global=2))


def _narrow(arch, **fields):
    """The f32 smoke config of ``arch`` (2 layers, vocab 256, a 16-slot
    window, 32-wide plan blocks) with ``fields`` replaced."""
    import dataclasses

    from repro_torch.configs import get_smoke

    return dataclasses.replace(get_smoke(arch), **fields)


# Narrowed configs of the dense archs for the cuda == cpu checks: widths cut
# so the checks are quick, head dims the kernels take, each arch's own
# features kept (gemma: geglu, logit softcap, tied embeddings, hd 256;
# phi4-mini: GQA 3 at hd 128; granite: GQA 4 at hd 128; longformer:
# bidirectional window, a global token with global rows, gelu, hd 64).
def _check_cfgs():
    return {
        "gemma-7b": _narrow("gemma-7b", d_model=256, n_heads=2,
                            n_kv_heads=2, head_dim=256, d_ff=512),
        "phi4-mini-3.8b": _narrow("phi4-mini-3.8b", d_model=384, n_heads=3,
                                  n_kv_heads=1, d_ff=512),
        "granite-3-8b": _narrow("granite-3-8b", d_model=512, n_heads=4,
                                n_kv_heads=1, d_ff=512),
        "longformer-4k": _narrow("longformer-4k", d_model=128, n_heads=2,
                                 n_kv_heads=2, d_ff=256),
    }


# Narrowed f32 configs of the recurrent archs for the cuda == cpu checks:
# recurrentgemma keeps its one KV head of hd 256 under 2 query heads and
# one griffin group (rec, rec, local attention), its local window cut to 32
# (4 sinks, 32-wide plan blocks) so a 40-token prompt crosses the window
# and the sinks; mamba2 keeps its smoke widths (d 64, SSD chunk 16).
def _recurrent_check_cfgs():
    from repro_torch.configs.base import RecurrentConfig, SALOConfig

    return {
        "recurrentgemma-9b": _narrow(
            "recurrentgemma-9b", d_model=256, n_heads=2, n_kv_heads=1,
            head_dim=256, d_ff=512, recurrent=RecurrentConfig(local_window=32),
            salo=SALOConfig(window=32, n_global=4, block_q=32, block_k=32)),
        "mamba2-370m": _narrow("mamba2-370m"),
    }


# Narrowed f32 configs of the MoE archs for the cuda == cpu checks: every
# MoE field of the published config kept (experts, top-k, the shared
# expert, the leading dense layer, the dense residual, the capacity factor
# and the dispatch groups: the routing is the real one), each arch's
# published rep through an explicit head dim of 128 (arctic 7 query heads
# on one KV head, kimi 8), d 256, the experts' width cut to 64; the smoke
# depth (arctic 2 MoE layers, kimi 1 dense + 2 MoE) and window.
def _moe_check_cfgs():
    import dataclasses

    from repro_torch.configs import get_config

    def narrow(arch, H):
        return _narrow(arch, d_model=256, n_heads=H, n_kv_heads=1,
                       head_dim=128, d_ff=512, moe=dataclasses.replace(
                           get_config(arch).moe, d_ff_expert=64))

    return {"arctic-480b": narrow("arctic-480b", 7),
            "kimi-k2-1t-a32b": narrow("kimi-k2-1t-a32b", 8)}


# Narrowed f32 configs of the last two families for the cuda == cpu checks:
# qwen2-vl keeps hd 128, its rep 6 (6 query heads on one KV head) and its
# M-RoPE sections (16, 24, 24); whisper keeps hd 64, rep 1 and its 1500
# audio frames (the encoder's K1-K3 at n 1500 with 2 global rows); d cut
# to 256 and 128, the smoke depth (2 layers) and window.
def _family_check_cfgs():
    from repro_torch.configs import get_config

    return {
        "qwen2-vl-2b": _narrow("qwen2-vl-2b", d_model=256, n_heads=6,
                               n_kv_heads=1, head_dim=128, d_ff=512,
                               mrope_sections=get_config(
                                   "qwen2-vl-2b").mrope_sections),
        "whisper-base": _narrow("whisper-base", d_model=128, n_heads=2,
                                n_kv_heads=2, d_ff=256,
                                n_audio_frames=get_config(
                                    "whisper-base").n_audio_frames),
    }


def fill_cross_caches(torch, model, params, cache, audio):
    """Whisper's lockstep cross caches from the encoder: ``Model._encode``
    over ``audio`` (B, frames, d) and, per decoder layer, the encoder
    output through that layer's cross-attention ``wk``/``wv``, written
    into ``xk``/``xv`` (the package's ServeEngine leaves them zero, as
    the reference's does). Returns ``cache``."""
    cfg = model.cfg
    with torch.no_grad():
        enc = model._encode(params, {"audio_embeds": audio})
        B, Se, _ = enc.shape
        for i, layer in enumerate(params["seg0_xattn"]):
            for w, key in (("wk", "xk"), ("wv", "xv")):
                cache["seg0_xattn"][key][i].copy_(
                    (enc @ layer["xattn"][w].to(enc.dtype)).reshape(
                        B, Se, cfg.n_kv_heads, cfg.hd))
    return cache


def _with_cross_caches(torch, model, params, seed):
    """For an encoder-decoder ``model``: make its ``init_cache`` fill the
    cross caches (``fill_cross_caches``) from seeded audio frames (one
    draw for the largest batch asked, in the compute dtype, on the
    model's device), so the lockstep engine's cross attention reads real
    keys. A no-op for the other families."""
    from repro_torch.models.layers import dt

    cfg = model.cfg
    if not cfg.encoder_decoder:
        return
    init_cache = model.init_cache

    def filled(batch_size, max_len):
        gen = torch.Generator().manual_seed(seed + 7)
        audio = torch.randn((batch_size, cfg.n_audio_frames, cfg.d_model),
                            generator=gen).to(model.device,
                                              dt(cfg, "compute"))
        return fill_cross_caches(torch, model, params,
                                 init_cache(batch_size, max_len), audio)

    model.init_cache = filled


def lockstep_check(torch, seed):
    """The recurrent archs (``_recurrent_check_cfgs``), the MoE archs
    (``_moe_check_cfgs``) and qwen2-vl and whisper
    (``_family_check_cfgs``; whisper's cross caches filled from its
    encoder over seeded audio frames on each device) at narrowed widths,
    f32, on the lockstep ServeEngine on the card (attention through K5)
    and on the CPU (plain versions), from the same weights and prompts
    (batch 2, prompt 40, 8 new tokens): greedy tokens must be equal; on
    the card K5 launched once per attention layer (a griffin group has
    one) per step and its plain version never ran, on the CPU the
    reverse."""
    import numpy as np

    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    B, P, n_new = 2, 40, 8
    for arch, cfg in {**_recurrent_check_cfgs(), **_moe_check_cfgs(),
                      **_family_check_cfgs()}.items():
        t0 = time.perf_counter()
        params = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        _amplify_residuals(params)        # tokens that use every block
        prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                       (B, P))
        n_attn = _attention_layers(cfg)
        outs = {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, dev)
            p = params if dev == "cpu" else _to(params, dev)
            _with_cross_caches(torch, model, p, seed)
            salo_decode.launches = 0
            salo_decode_plain.calls = 0
            eng = ServeEngine(model, ServeConfig(max_len=P + n_new))
            outs[dev] = eng.generate(p, prompts, n_new).cpu().tolist()
            steps = P + n_new
            want = ((n_attn * steps, 0) if dev == "cuda"
                    else (0, n_attn * steps))
            got = (salo_decode.launches, salo_decode_plain.calls)
            check(got == want, f"lockstep-check {arch} {dev}: (K5 launches, "
                  f"plain calls) {got} != {want}")
        check(outs["cuda"] == outs["cpu"],
              f"lockstep-check {arch}: cuda {outs['cuda']} != cpu "
              f"{outs['cpu']}")
        log(f"[lockstep-check] {arch} d {cfg.d_model} hd {cfg.hd} H "
            f"{cfg.n_heads}/{cfg.n_kv_heads} f32, prompt {P} new {n_new}: "
            f"cuda == cpu greedy tokens ({n_attn} K5 launches a step on the "
            f"card) in {time.perf_counter() - t0:.1f} s: {outs['cuda']}")


def _amplify_residuals(params, gain: float = 6.0) -> None:
    """Scale every residual branch's output projection (``w_out``,
    ``wo``; an encoder's too) in place, so greedy tokens depend on the
    blocks (at the plain init the tied embedding dominates). Whisper's
    cross attention keeps its drawn ``wo``: at random weights it returns
    about the mean of the audio frames' values, which amplified would
    pick every token of a row alone."""
    from repro_torch.tree import tree_flatten_with_path

    for path, leaf in tree_flatten_with_path(params)[0]:
        if path[-1] in ("w_out", "wo") and "xattn" not in path:
            leaf.mul_(gain)


def _attention_layers(cfg) -> int:
    """The self-attention layers of ``cfg``'s program (what K5 serves):
    one per attention block and per whisper decoder block, one per
    griffin group (its local third), none in ssm / rec_mlp segments."""
    from repro_torch.models.transformer import ATTN_KINDS, make_program

    return sum(n for kind, n in make_program(cfg)
               if kind in ATTN_KINDS + ("griffin", "xattn"))


def _train_attention_layers(cfg) -> int:
    """The layers a train step runs K1-K3 in: the program's attention
    layers and an encoder-decoder's encoder layers."""
    return _attention_layers(cfg) + (cfg.n_layers if cfg.encoder_decoder
                                     else 0)


def serve_check(torch, seed):
    """Kernel path (cuda) and plain path (cpu) give the same greedy tokens
    on a small f32 model with hd 64: (1) the fp slab, window 16; (2) the
    int8 slab with page skipping on the workload of the reference's
    ``test_page_skip_engages_at_parity`` (window 64, prompts 24/17/9/30,
    24 new tokens, threshold -3, decay 0.3), where the page counters must
    be equal too and pages really skipped (0 < read < total); then (3)
    gemma-7b (hd 256), phi4-mini and granite (hd 128, GQA 3 and 4) at
    narrowed widths (``_check_cfgs``), and arctic-480b and kimi-k2 (hd
    128, rep 7 and 8, their published routing; ``_moe_check_cfgs``), on
    the fp slab."""
    import numpy as np

    from repro_torch.models.layers import salo_pattern
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
    from repro_torch.serve.paged_cache import layout_for_pattern

    runs = [("fp", _serve_check_cfg(16), (5, 9, 13, 26), 8, {}),
            ("int8 page-sparse", _serve_check_cfg(64), (24, 17, 9, 30), 24,
             dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
                  page_stat_decay=0.3))]
    # the causal dense archs at narrowed widths, fp slab
    checks = {**{a: c for a, c in _check_cfgs().items() if a in SERVE_CHECK},
              **_moe_check_cfgs()}
    runs += [(f"{arch} hd {cfg.hd} H {cfg.n_heads}/{cfg.n_kv_heads}", cfg,
              (5, 9, 13, 26), 8, {}) for arch, cfg in checks.items()]
    for what, cfg, lens, n_new, extra in runs:
        lay = layout_for_pattern(salo_pattern(cfg), 8)
        ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_req, page=8,
                                chunk=8, max_batch=4, **extra)
        cpu_model = build_model(cfg, "cpu")
        params = cpu_model.init(torch.Generator().manual_seed(seed))
        _amplify_residuals(params)        # tokens that use every block
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
        outs, counters = {}, {}
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, dev)
            p = params if dev == "cpu" else _to(params, dev)
            eng = ContinuousEngine(model, ccfg, device=dev)
            rids = [eng.submit(x, n_new) for x in prompts]
            res = eng.run(p)
            outs[dev] = [res[r].tolist() for r in rids]
            counters[dev] = dict(eng.counters)
        check(outs["cuda"] == outs["cpu"],
              f"serve-check {what}: cuda {outs['cuda']} != cpu "
              f"{outs['cpu']}")
        check(counters["cuda"] == counters["cpu"],
              f"serve-check {what}: counters cuda {counters['cuda']} != "
              f"cpu {counters['cpu']}")
        c = counters["cuda"]
        if extra:
            check(0 < c["decode_pages_read"] < c["decode_pages_total"],
                  f"serve-check {what}: no page skipped: {c}")
        log(f"[serve-check] {what}: cuda == cpu greedy tokens and counters "
            f"(decode pages read {c['decode_pages_read']} of "
            f"{c['decode_pages_total']}): {outs['cuda']}")


def _to(tree, dev):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.to(dev), tree)


SERVE_PAGE, SERVE_CHUNK, SERVE_R, SERVE_NEW = 16, 128, 8, 64
SERVE_CHECK = ("gemma-7b", "phi4-mini-3.8b", "granite-3-8b")
TRAIN_CHECK = ("gemma-7b", "longformer-4k")


def _serve_weights(torch, seed, arch="smollm-135m", n_layers=None,
                   device="cuda"):
    """``arch`` at full width and depth (unless ``n_layers`` cuts it) on
    the card (``device``), bf16 weights from ``seed``. Returns (cfg,
    model, params)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, device)
    return cfg, model, model.init(
        torch.Generator(device=device).manual_seed(seed))


def _serve_lens(seed):
    """The serve phases' prompt lengths (600-2000) and the generator that
    then draws their tokens."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [int(x) for x in np.linspace(600, 2000, SERVE_R).round()
            + rng.integers(0, 40, SERVE_R)]
    return [min(n, 2000) for n in lens], rng


def _serve_engine(torch, seed, what, arch="smollm-135m", weights=None,
                  group=None, n_req=SERVE_R, **extra):
    """``arch`` (smollm-135m by default) at full width and depth, bf16,
    random weights from ``seed`` (or ``weights``, ``_serve_weights``'s),
    on the continuous engine with the serve phases' 8 requests submitted
    (prompts over 600-2000 tokens; the first ``n_req`` of them where a
    phase is cut for time): n_pages from ``layout_for_pattern`` (per
    shard under a sequence ``group``, whose rank's device the weights must
    be on), 8 rows. ``extra``: ContinuousConfig fields. Returns (cfg,
    engine, params, the submitted prompts' lengths, rng)."""
    from repro_torch.models.layers import salo_pattern
    from repro_torch.obs import Observability
    from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
    from repro_torch.serve.paged_cache import layout_for_pattern
    from repro_torch.tree import tree_leaves

    cfg, model, params = weights or _serve_weights(torch, seed, arch)
    R = SERVE_R
    S = 1 if group is None else group.size
    lay = layout_for_pattern(salo_pattern(cfg), SERVE_PAGE, shards=S)
    check(S > 1 or lay.pages_per_req == 65,
          f"pages_per_req {lay.pages_per_req}")
    ccfg = ContinuousConfig(n_pages=1 + R * lay.pages_per_shard,
                            page=SERVE_PAGE, chunk=SERVE_CHUNK, max_batch=R,
                            seq_shards=S, **extra)
    eng = ContinuousEngine(model, ccfg, device=model.device,
                           obs=Observability(), group=group)
    n_param = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[{what}] {arch} bf16 {extra}: weights {n_param / 1e6:.1f} MB,"
        f" slab {eng.slab_resident_bytes()} bytes resident "
        f"({eng.slab_resident_bytes() / 1e6:.1f} MB), "
        f"n_pages={ccfg.n_pages}")
    lens, rng = _serve_lens(seed)
    lens = lens[:n_req]
    for n in lens:
        eng.submit(rng.integers(0, cfg.vocab_size, (n,)), SERVE_NEW)

    decode_fn = eng._decode_fn

    def checked_decode(*a, **k):              # finite logits every step
        logits, page_m = decode_fn(*a, **k)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        return logits, page_m

    eng._decode_fn = checked_decode
    return cfg, eng, params, lens, rng


def _check_serve_run(cfg, eng, lens, launches, plain, what):
    """Every request finished with its tokens, the prefill launch count,
    one K4 launch per layer per decode step, no plain call."""
    res = eng.batcher.results()
    c = dict(eng.counters)
    log(f"[{what}] prompts={lens} new={SERVE_NEW} counters={c}")
    check(len(res) == len(lens), f"{len(res)} of {len(lens)} requests "
          f"finished")
    for rid, toks in res.items():
        check(len(toks) == SERVE_NEW, f"request {rid}: {len(toks)} tokens")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"request {rid}: token outside the vocabulary")
    want = sum(math.ceil(n / SERVE_CHUNK) for n in lens)
    check(c["prefill_launches"] == want,
          f"prefill launches {c['prefill_launches']} != {want}")
    check(launches == c["decode_launches"] * cfg.n_layers,
          f"K4 launches {launches} != {c['decode_launches']} x "
          f"{cfg.n_layers}")
    check(launches > 0, "K4 never launched")
    check(plain == 0, f"the plain version ran {plain} times")
    return res, c


def phase_serve(torch, seed, arch="smollm-135m", what="serve",
                profile=(PROFILE_FROM, PROFILE_TO), profile_prefill=True,
                weights=None):
    """``arch`` at full width on the continuous engine (the weights from
    ``seed``, or ``weights``, ``_serve_weights``'s); the decode-only
    steps [profile[0], profile[1]) run under the profiler, and then (when
    ``profile_prefill``) one prefill chunk. Returns the K4 launch count of
    the run, the requests' tokens, the engine counters and the decode
    step median (s)."""
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)

    cfg, eng, params, lens, rng = _serve_engine(torch, seed, what, arch,
                                                weights=weights)
    prof_from, prof_to = profile
    R = SERVE_R
    salo_paged_decode.launches = 0
    salo_paged_decode_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_done = None
    decode_steps = []           # (seconds, cohort) before the profiler
    n_dec = 0                   # decode-only steps so far
    prof, prof_wall, timed = None, 0.0, None
    while True:
        pre, dec = eng.batcher.assemble()
        decode_only = not pre and bool(dec)
        profiled = decode_only and prof_from <= n_dec < prof_to
        if profiled and prof is None:
            timed = (time.perf_counter() - t0, _emitted(eng))
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        ts = time.perf_counter()
        more = eng.step(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        n_dec += decode_only
        if profiled:
            prof_wall += dt
            if n_dec == prof_to:
                prof.stop()
        elif decode_only and prof is None:
            decode_steps.append((dt, len(dec)))
        if prefill_done is None and not any(
                r is not None and r.state in ("waiting", "prefill")
                for r in eng.batcher.rows) and not eng.batcher.queue \
                and eng.counters["prefill_launches"]:
            prefill_done = time.perf_counter() - t0
        if not more:
            break
    check(timed is not None, "the run ended before the profiled steps")
    launches = salo_paged_decode.launches
    plain = salo_paged_decode_plain.calls
    res, counters = _check_serve_run(cfg, eng, lens, launches, plain, what)
    check(len(decode_steps) > 0, "no decode-only step")
    med = sorted(d for d, _ in decode_steps)[len(decode_steps) // 2]
    dec_tps = sum(n for _, n in decode_steps) / sum(d for d, _ in decode_steps)
    log(f"[{what}] prefill {prefill_done:.3f} s (all {R} prompts, "
        f"{sum(lens)} tokens); decode step median {med * 1e3:.3f} ms over "
        f"{len(decode_steps)} decode-only steps ({dec_tps:.1f} tok/s in "
        f"them); {timed[1]} tokens generated in the first {timed[0]:.3f} s "
        f"({timed[1] / timed[0]:.1f} tok/s); K4 launches {launches}")
    check(prof is not None, "no decode-only step was profiled")
    report_profile(prof, prof_wall, prof_to - prof_from, "decode steps")
    if not profile_prefill:
        return launches, res, counters, med

    # After the counts are read: one more request, whose first engine step
    # (one 128-token prefill chunk through all layers) runs under the
    # profiler.
    eng.submit(rng.integers(0, cfg.vocab_size, (2000,)), 1)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    ts = time.perf_counter()
    eng.step(params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - ts
    prof.stop()
    report_profile(prof, dt, 1, "prefill chunk")
    return launches, res, counters, med


def phase_serve_int8(torch, seed):
    """The serve phase's requests and weights on the int8 slab with page
    skipping (threshold -3, decay 0.3). Checks the run like the serve
    phase and the slab's resident bytes; reports the step time and the
    page counters (random weights need not skip pages at full width, so
    that is not gated). Returns the K4 launch count, the tokens and the
    engine counters."""
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)
    from repro_torch.serve.paged_cache import slab_bytes

    cfg, eng, params, lens, _ = _serve_engine(
        torch, seed, "serve-int8", kv_dtype="int8",
        page_sparsity_threshold=-3.0, page_stat_decay=0.3)
    n_layers = sum(n for _, n in eng.model.program)
    want_bytes = slab_bytes(n_layers, eng.ccfg.n_pages, SERVE_PAGE,
                            cfg.n_kv_heads, cfg.hd, 1, with_scales=True)
    fp_bytes = slab_bytes(n_layers, eng.ccfg.n_pages, SERVE_PAGE,
                          cfg.n_kv_heads, cfg.hd, 2)
    check(eng.slab_resident_bytes() == want_bytes,
          f"int8 slab {eng.slab_resident_bytes()} bytes != {want_bytes}")
    salo_paged_decode.launches = 0
    salo_paged_decode_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_done, decode_steps = None, []
    while True:
        pre, dec = eng.batcher.assemble()
        ts = time.perf_counter()
        more = eng.step(params)
        torch.cuda.synchronize()
        if not pre and dec:
            decode_steps.append((time.perf_counter() - ts, len(dec)))
        if prefill_done is None and not any(
                r is not None and r.state in ("waiting", "prefill")
                for r in eng.batcher.rows) and not eng.batcher.queue \
                and eng.counters["prefill_launches"]:
            prefill_done = time.perf_counter() - t0
        if not more:
            break
    wall = time.perf_counter() - t0
    launches = salo_paged_decode.launches
    plain = salo_paged_decode_plain.calls
    res, c = _check_serve_run(cfg, eng, lens, launches, plain, "serve-int8")
    check(len(decode_steps) > 0, "no decode-only step")
    med = sorted(d for d, _ in decode_steps)[len(decode_steps) // 2]
    log(f"[serve-int8] slab {eng.slab_resident_bytes()} bytes resident "
        f"(bf16 slab {fp_bytes}, ratio {fp_bytes / eng.slab_resident_bytes():.3f});"
        f" prefill {prefill_done:.3f} s; decode step median {med * 1e3:.3f} "
        f"ms over {len(decode_steps)} decode-only steps; "
        f"{SERVE_R * SERVE_NEW / wall:.1f} generated tokens/s over the "
        f"phase's {wall:.3f} s; decode pages read "
        f"{c['decode_pages_read']} of {c['decode_pages_total']}, prefill "
        f"{c['prefill_pages_read']} of {c['prefill_pages_total']}; K4 "
        f"launches {launches}")
    return launches, res, c


# ------------------- sequence-parallel serving phases ------------------- #
# serve-sharded-check: serve-check's narrowed f32 model and workloads, the
# window widened where needed so a request's pages stripe over 2 shards
# with no alignment padding (then every counter, page counters included,
# must equal the unsharded engine's): (name, window, prompt lengths, new
# tokens, ContinuousConfig fields)
SHARD_CHECK = (("fp", 24, (5, 9, 13, 26), 8, {}),
               ("int8 page-sparse", 56, (24, 17, 9, 30), 24,
                dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
                     page_stat_decay=0.3)))
SHARD_GATE_AT = 20       # serve-sharded: the decode-only step whose layers
SHARD_PROFILE_AT = 40    # are checked, and the one profiled
SHARD_TIMEOUT_S = 420.0  # run_ranks' deadline for a sharded phase
INT8_SPARSE = dict(kv_dtype="int8", page_sparsity_threshold=-3.0,
                   page_stat_decay=0.3)
# serve-sharded and serve-sharded-int8 serve the first 4 of the 8
# requests (prompts 634 to 1210): their ranks' prefill took 21 and 64 s
# of the script's time, cut to make room for the tensor-parallel train
# phases; serve-sharded-int8 the first 2 (prompts 634 and 825; its 4-rank
# prefill of 4 took 28.5 s), cut to make room for the expert-parallel
# ones, and on 2 shards in serve-sharded's spawn, not 4 in a spawn of its
# own, to make room for the recurrent and family tensor-parallel phases
# (tests/test_torch_dist_serve.py and tools/serve_sharded.py keep 4);
# serve-sharded the first 2 too since, cut for the MoE sequence-parallel
# and uneven expert-parallel train phases
SHARD_REQS = 2
SHARD_INT8_REQS = 2


def _shard_backend(torch, shards):
    """NCCL with one rank per card where the machine has the cards, else
    gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card)."""
    if torch.cuda.device_count() >= shards:
        return "nccl", None
    return "gloo", "cuda:0"


def jobs_rank(group, seed, jobs):
    """One rank of a spawn that runs several phases: each ``(name, (rank
    function, its arguments))`` of ``jobs`` in order, as
    ``fn(group, seed, *args)``, each one's state freed before the next.
    Returns {name: the rank's record} and {name + " wall": its
    seconds}."""
    import torch

    out = {}
    for name, (fn, args) in jobs:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn(group, seed, *args)
        out[f"{name} wall"] = time.perf_counter() - t0
    return out


def spawn_jobs(torch, seed, parts, n=2, timeout_s=1200.0) -> dict:
    """Several phases' ranks in ONE spawn of ``n`` ranks
    (``_shard_backend``; each spawn's ranks take ~15-25 s to start and
    warm up on the card): ``parts`` is ``(name, (job, report, state))``
    for each, the halves a phase's ``*_job`` function returns; the ranks
    run every job in order (``jobs_rank``). Returns {name: (every rank's
    record, rank 0's seconds)}, what each report reads beside its
    state."""
    from repro_torch.dist.group import run_ranks

    backend, device = _shard_backend(torch, n)
    gc.collect()
    torch.cuda.empty_cache()       # the ranks' allocators cannot see it
    t0 = time.perf_counter()
    recs = run_ranks(jobs_rank, n, backend=backend, device=device,
                     timeout_s=timeout_s,
                     args=(seed, [(name, job) for name, (job, _, _)
                                  in parts]))
    log(f"[spawn] {', '.join(name for name, _ in parts)}: {n} ranks on "
        f"backend {backend} ({device or 'one card a rank'}), "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start; on rank "
        f"0: " + ", ".join(f"{name} {recs[0][name + ' wall']:.1f} s"
                           for name, _ in parts))
    return {name: ([r[name] for r in recs], recs[0][name + " wall"])
            for name, _ in parts}


def phase_two_ranks(torch, seed, parts, n=2, timeout_s=1200.0) -> dict:
    """``spawn_jobs``, then each part's report on its records. Returns
    {name: what its report returned}."""
    got = spawn_jobs(torch, seed, parts, n, timeout_s)
    return {name: report(got[name][0], st, got[name][1])
            for name, (_, report, st) in parts}


def _run_alone(torch, seed, n, part, timeout_s):
    """One phase's job on ``n`` ranks in a spawn of its own, and its
    report (``part``: its ``*_job`` function's result)."""
    return phase_two_ranks(torch, seed, [("alone", part)], n,
                           timeout_s)["alone"]


def shard_check_run(torch, seed, window, lens, n_new, extra, device,
                    group=None):
    """One serve-sharded-check run: ``_serve_check_cfg(window)`` (2
    layers, hd 64, f32), residuals amplified, on ``device``, unsharded
    (``group`` None) or as one rank of ``group``: 4 rows, page 8, chunk 8.
    Returns (tokens, counters)."""
    import numpy as np

    from repro_torch.models.layers import salo_pattern
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ContinuousConfig, ContinuousEngine
    from repro_torch.serve.paged_cache import layout_for_pattern

    cfg = _serve_check_cfg(window)
    S = 1 if group is None else group.size
    lay = layout_for_pattern(salo_pattern(cfg), 8, shards=S)
    ccfg = ContinuousConfig(n_pages=1 + 4 * lay.pages_per_shard, page=8,
                            chunk=8, max_batch=4, seq_shards=S, **extra)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    _amplify_residuals(params)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)) for n in lens]
    eng = ContinuousEngine(build_model(cfg, device), ccfg, device=device,
                           group=group)
    rids = [eng.submit(x, n_new) for x in prompts]
    res = eng.run(_to(params, device))
    return [res[r].tolist() for r in rids], dict(eng.counters)


def _merge_check(torch, group, k4, res, q, k_slab, v_slab, pt, pos, t, kw):
    """One layer of a sharded decode step: this rank's K4 partial merged
    across the group against unsharded K4 on the whole logical view (every
    shard's stripe of the pages, dequantized for an int8 slab, and of the
    positions, put together by a sum over the group in which the other
    ranks add zeros). Returns (max abs err, within OUT_TOL)."""
    from repro_torch.dist.sharded_plan import masked_psum_merge
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.serve.paged_cache import gather_view

    merged = masked_psum_merge(*res[:3], group).to(q.dtype)
    R, pps = pt.shape
    page = k_slab.shape[1]
    S, r, dev = group.size, group.index, q.device
    quant = kw.get("k_scale") is not None
    gk, gv = gather_view(k_slab, v_slab, pt,
                         *((kw["k_scale"], kw["v_scale"], q.dtype) if quant
                           else ()))
    sps = pps * page
    full = torch.zeros((2, R, S * sps, *gk.shape[2:]), dtype=q.dtype,
                       device=dev)
    full[0, :, r * sps:(r + 1) * sps] = gk
    full[1, :, r * sps:(r + 1) * sps] = gv
    fpos = torch.zeros((R, S * sps), dtype=torch.float64, device=dev)
    fpos[:, r * sps:(r + 1) * sps] = pos.double()
    group.psum_(full)
    group.psum_(fpos)
    n = R * S * pps
    null = torch.zeros((1, page, *gk.shape[2:]), dtype=q.dtype, device=dev)
    kf = torch.cat([null, full[0].reshape(n, page, *gk.shape[2:])])
    vf = torch.cat([null, full[1].reshape(n, page, *gk.shape[2:])])
    ptf = torch.arange(1, 1 + n, dtype=torch.int32,
                       device=dev).reshape(R, S * pps)
    whole = k4(q, kf, vf, ptf, fpos.to(torch.int32), t,
               pattern=kw["pattern"])
    tol = KA.OUT_TOL[q.dtype]
    err = float((merged.float() - whole.float()).abs().max())
    return err, bool(torch.allclose(merged.float(), whole.float(), atol=tol,
                                    rtol=tol))


# the profiler's own bookkeeping ops, which ``prof.events()`` leaves out
# (``torch.autograd.profiler_util._filter_name``)
_PROFILER_OPS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def _events(prof) -> list:
    """``(name, on the card, us)`` for each event of a stopped
    ``torch.profiler`` run, as ``prof.events()`` reports it: the same
    events (its filter), names (demangled) and times (a device event's
    own time, 0 if async; a host event's span). Read from the raw kineto
    results without building ``prof.events()``'s tree of host events,
    whose Python parse took ~10 s after a profiled train step on the card
    (~80 s a run). Computed once a profile."""
    import torch
    from torch.autograd import DeviceType

    out = getattr(prof, "_smoke_events", None)
    if out is None:
        out = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if name in _PROFILER_OPS or getattr(
                    e, "is_hidden_event", lambda: False)():
                continue
            card = e.device_type() == DeviceType.CUDA
            lag = e.is_async() or e.start_thread_id() != e.end_thread_id()
            out.append((torch._C._demangle(name) if len(name) > 1 else name,
                        card, 0.0 if card and lag else
                        (e.end_ns() - e.start_ns()) / 1e3))
        prof._smoke_events = out
    return out


def _collective_ms(prof, keys=("all_reduce", "allreduce")) -> dict:
    """Host time of the collectives by profiler event name: {name:
    (calls, ms)} for every event whose name holds one of ``keys`` (by
    default "all_reduce" or "allreduce"; the process group's op and its
    backend's span nest, so each name is a view of the same calls; an
    event on the card counts as a call of 0 ms)."""
    out: dict = {}
    for name, card, us in _events(prof):
        if not any(k in name.lower() for k in keys):
            continue
        n, t = out.get(name, (0, 0.0))
        out[name] = (n + 1, t + (0.0 if card else us / 1e3))
    return out


def _serve_sharded(torch, seed, group, what, extra, n_req=SERVE_R):
    """One rank of a full-width serve-sharded run: the serve phase's
    weights and requests on ``ContinuousEngine(seq_shards=S, group=...)``.
    Counts this rank's K4 launches (each must run ``return_state``),
    checks every layer of decode-only step ``SHARD_GATE_AT`` with
    ``_merge_check`` (those launches kept out of the count), times the
    decode-only steps before ``SHARD_PROFILE_AT`` (the checked one left
    out) and the prefill, and profiles step ``SHARD_PROFILE_AT``. Returns
    the rank's record. ``n_req``: the serve phases' first requests
    served."""
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)
    from repro_torch.models import layers as L

    weights = _serve_weights(torch, seed, device=str(group.device))
    cfg, eng, params, lens, _ = _serve_engine(
        torch, seed, f"{what} rank {group.index}", weights=weights,
        group=group, n_req=n_req, **extra)
    real = L.salo_paged_decode
    stats = dict(state_calls=0, check_launches=0, errs=[])
    gate = dict(on=False)

    def counted(q, k_slab, v_slab, pt, pos, t, **kw):
        res = real(q, k_slab, v_slab, pt, pos, t, **kw)
        stats["state_calls"] += bool(kw.get("return_state"))
        if gate["on"]:
            stats["errs"].append(_merge_check(torch, group, real, res, q,
                                              k_slab, v_slab, pt, pos, t,
                                              kw))
            stats["check_launches"] += 1
        return res

    L.salo_paged_decode = counted
    salo_paged_decode.launches = 0
    salo_paged_decode_plain.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill_done, decode_steps, n_dec = None, [], 0
    prof, prof_wall = None, 0.0
    while True:
        pre, dec = eng.batcher.assemble()
        decode_only = not pre and bool(dec)
        gate["on"] = decode_only and n_dec == SHARD_GATE_AT
        profiled = decode_only and n_dec == SHARD_PROFILE_AT
        if profiled:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        ts = time.perf_counter()
        more = eng.step(params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - ts
        if profiled:
            prof.stop()
            prof_wall = dt
        elif decode_only and not gate["on"] and prof is None:
            decode_steps.append(dt)
        gate["on"] = False
        n_dec += decode_only
        if prefill_done is None and not any(
                r is not None and r.state in ("waiting", "prefill")
                for r in eng.batcher.rows) and not eng.batcher.queue \
                and eng.counters["prefill_launches"]:
            prefill_done = time.perf_counter() - t0
        if not more:
            break
    wall = time.perf_counter() - t0
    L.salo_paged_decode = real
    launches = salo_paged_decode.launches - stats["check_launches"]
    res, c = _check_serve_run(cfg, eng, lens, launches,
                              salo_paged_decode_plain.calls,
                              f"{what} rank {group.index}")
    check(stats["state_calls"] == launches,
          f"{what}: {stats['state_calls']} return_state calls of "
          f"{launches} launches")
    check(len(stats["errs"]) == cfg.n_layers,
          f"{what}: {len(stats['errs'])} layers checked")
    check(all(ok for _, ok in stats["errs"]),
          f"{what} rank {group.index}: merged attention vs unsharded K4 "
          f"errs {[e for e, _ in stats['errs']]}")
    check(prof is not None and len(decode_steps) > 0,
          f"{what}: {n_dec} decode-only steps")
    busy_ms = sum(us for _, card, us in _events(prof) if card) / 1e3
    if group.index == 0:
        report_profile(prof, prof_wall, 1, f"{what} decode step (rank 0)")
    return dict(tokens={r: v.tolist() for r, v in res.items()}, counters=c,
                launches=launches, lens=lens,
                step_ms=sorted(decode_steps)[len(decode_steps) // 2] * 1e3,
                n_steps=len(decode_steps), prefill_s=prefill_done,
                wall_s=wall, merge_err=max(e for e, _ in stats["errs"]),
                profiled_ms=prof_wall * 1e3,
                idle=1 - busy_ms / (prof_wall * 1e3),
                collectives=_collective_ms(prof),
                slab_bytes=eng.slab_resident_bytes())


def sharded_rank(group, seed, runs, with_check):
    """A spawned rank of the sequence-parallel phases: serve-sharded-check
    (``with_check``), then each full-width run of ``runs`` (``(what,
    extra, n_req)``: ``_serve_sharded``'s arguments) in turn."""
    import torch

    # what main() sets for itself
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    if with_check:
        out["check"] = [shard_check_run(torch, seed, w, lens, n, ex,
                                        str(group.device), group)
                        for _, w, lens, n, ex in SHARD_CHECK]
    for what, extra, n_req in runs:
        gc.collect()
        torch.cuda.empty_cache()
        out[what] = _serve_sharded(torch, seed, group, what, extra, n_req)
    return out


def phase_serve_sharded(torch, seed, shards, runs, with_check=False):
    """Sequence-parallel serving on the card: ``shards`` ranks through
    ``dist.group.run_ranks`` (NCCL, one card a rank, where the machine has
    the cards; else gloo ranks sharing cuda:0), one spawn for every run.
    With ``with_check`` the ranks first run serve-sharded-check: greedy
    tokens and every counter equal to the unsharded engine's on the card.
    Then each full-width run of ``runs``, ``(what, ref_tokens, extra,
    n_req)`` (``_serve_sharded`` on every rank; ``extra``: the engine's
    slab fields, ``n_req``: the first requests of the 8 served, a cut for
    time): the same tokens and counters on every rank, 30 K4 launches a
    decode step in ``return_state`` mode on each, every layer's merged
    attention within ``OUT_TOL`` of unsharded K4, the first token of each
    request equal to the unsharded phase's (``ref_tokens``); how many of
    the served tokens agree is printed, not gated. Returns {what: (the K4
    launch count over the ranks, rank 0's record)}. A failed rank makes
    ``run_ranks`` raise: nothing here catches it. ``serve_sharded_job``
    and ``report_serve_sharded`` are its two halves, for a spawn shared
    with other phases (``phase_two_ranks``)."""
    return _run_alone(torch, seed, shards, serve_sharded_job(
        torch, seed, shards, runs, with_check), SHARD_TIMEOUT_S)


def serve_sharded_job(torch, seed, shards, runs, with_check=False):
    """The half of ``phase_serve_sharded`` before its ranks: the
    unsharded engine's checks on the card, and the ranks' job
    (``sharded_rank``) with what ``report_serve_sharded`` reads."""
    backend, device = _shard_backend(torch, shards)
    refs = []
    if with_check:
        refs = [shard_check_run(torch, seed, w, lens, n, ex, "cuda")
                for _, w, lens, n, ex in SHARD_CHECK]
    job = (sharded_rank, ([(w, ex, k) for w, _, ex, k in runs],
                          with_check))
    return job, report_serve_sharded, dict(
        shards=shards, runs=runs, refs=refs, backend=backend, device=device,
        with_check=with_check)


def report_serve_sharded(out, st, wall):
    """The half of ``phase_serve_sharded`` after its ranks: ``out`` every
    rank's record, ``st`` what ``serve_sharded_job`` returned beside the
    job."""
    shards, runs, backend = st["shards"], st["runs"], st["backend"]
    log(f"[{'/'.join(w for w, *_ in runs)}] {shards} ranks on backend "
        f"{backend} ({st['device'] or 'one card a rank'}): {wall:.1f} s on "
        f"rank 0")
    if st["with_check"]:
        for i, ((name, w, _, _, ex), (toks, c)) in enumerate(
                zip(SHARD_CHECK, st["refs"])):
            for r, o in enumerate(out):
                sto, sc = o["check"][i]
                check(sto == toks, f"serve-sharded-check {name} rank {r}: "
                      f"tokens {sto} != unsharded {toks}")
                check(sc == c, f"serve-sharded-check {name} rank {r}: "
                      f"counters {sc} != unsharded {c}")
            if ex:
                check(0 < c["decode_pages_read"] < c["decode_pages_total"],
                      f"serve-sharded-check {name}: no page skipped: {c}")
            log(f"[serve-sharded-check] {name} (window {w}) at {shards} "
                f"shards, backend {backend}: tokens and counters equal to "
                f"the unsharded engine's on the card (decode pages read "
                f"{c['decode_pages_read']} of {c['decode_pages_total']}): "
                f"{toks}")
    return {what: _report_serve_sharded([o[what] for o in out], what,
                                        shards, backend, ref_tokens, n_req)
            for what, ref_tokens, _, n_req in runs}


def _report_serve_sharded(recs, what, shards, backend, ref_tokens, n_req):
    """Gate and print one full-width serve-sharded run from every rank's
    record; returns (the K4 launches over the ranks, rank 0's record)."""
    r0 = recs[0]
    for r, rec in enumerate(recs[1:], 1):
        check(rec["tokens"] == r0["tokens"] and
              rec["counters"] == r0["counters"],
              f"{what}: rank {r}'s tokens or counters differ from rank 0's")
    toks = {int(k): v for k, v in r0["tokens"].items()}
    first = sum(int(toks[rid][0] == ref_tokens[rid][0]) for rid in toks)
    check(first == n_req, f"{what}: first tokens equal to the unsharded "
          f"phase's for {first} of {n_req} requests")
    agree = sum(int(a == b) for rid in toks
                for a, b in zip(toks[rid], ref_tokens[rid].tolist()))
    diverge = [next((i for i, (a, b) in enumerate(
        zip(toks[rid], ref_tokens[rid].tolist())) if a != b), None)
        for rid in sorted(toks)]
    launches = sum(rec["launches"] for rec in recs)
    coll = ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in
                     sorted(r0["collectives"].items(), key=lambda x: -x[1][1]))
    log(f"[{what}] {shards} shards, backend {backend}: decode step median "
        f"{r0['step_ms']:.3f} ms over {r0['n_steps']} decode-only steps "
        f"(rank 0); prefill {r0['prefill_s']:.3f} s; run {r0['wall_s']:.3f} "
        f"s; slab {r0['slab_bytes']} bytes a rank; K4 launches a rank "
        f"{[rec['launches'] for rec in recs]} (one a layer a decode step, "
        f"{r0['counters']['decode_launches']} decode steps, return_state); "
        f"merged attention vs "
        f"unsharded K4 max abs err {max(rec['merge_err'] for rec in recs)}; "
        f"first tokens equal to the unsharded phase's {first} of {n_req}; "
        f"tokens equal {agree} of {n_req * SERVE_NEW} (first difference "
        f"per request {diverge}; random weights, not gated); counters "
        f"{r0['counters']}")
    log(f"[{what}] profiled decode step (rank 0): host wall "
        f"{r0['profiled_ms']:.3f} ms, device idle share {r0['idle']:.3f}, "
        f"collectives by name: {coll}")
    return launches, r0


FT_EVERY = 16                     # serve-ft: engine steps between snapshots


def _dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_serve_ft(torch, seed, what, ref_res, ref_c, **extra):
    """The serve phase's weights and requests (``extra``: the int8 phase's
    engine fields) under ``ServeSupervisor``: a fresh engine every boot,
    a snapshot every ``FT_EVERY`` steps into ``build/``, and a
    ``FaultInjector`` crashing two attempts, one while requests still
    prefill (engine step half of the longest prompt's chunks) and one in
    decode (from the uninterrupted run's step count, ``ref_c``). Checks
    the greedy tokens and every engine counter against the uninterrupted
    phase's (``ref_res``, ``ref_c``), 2 restarts with at most
    ``FT_EVERY`` steps lost, every allocator back to n_pages - 1 free, the
    slabs and slot map on the card after each restore, K4 launched and no
    plain call. Prints the snapshot bytes, the median state_dict + save
    and restore times, and the steps lost. Returns the K4 launch count."""
    import shutil

    from repro_torch.ft import FaultInjector, FaultPlan, ServeSupervisor
    from repro_torch.kernels.salo_decode import (salo_paged_decode,
                                                 salo_paged_decode_plain)

    weights = _serve_weights(torch, seed)
    n_steps = ref_c["engine_steps"]
    marks = {"t": 0.0, "boots": 0}
    snap_ms, restore_ms = [], []

    def make_engine():
        eng = _serve_engine(torch, seed, what, weights=weights, **extra)[1]
        marks["boots"] += 1
        state_dict, load = eng.state_dict, eng.load_state

        def timed_state_dict():
            marks["t"] = time.perf_counter()
            return state_dict()

        def checked_load(tree):     # after state_dict (the like) and read
            load(tree)
            torch.cuda.synchronize()
            restore_ms.append((time.perf_counter() - marks["t"]) * 1e3)
            check(all(a.is_cuda for s_ in eng.slabs.values()
                      for a in s_.tensors()) and eng.slot_pos.is_cuda,
                  f"[{what}] a restored tensor left the card")

        eng.state_dict, eng.load_state = timed_state_dict, checked_load
        return eng

    # crash attempts: engine step p (prefill: no snapshot yet, so a
    # restart from scratch), then engine step d in decode, FT_EVERY
    # stepping not landing on a snapshot (attempt p + 1 + d)
    n_prefill = max(math.ceil(n / SERVE_CHUNK) for n in _serve_lens(seed)[0])
    p = n_prefill // 2
    d = FT_EVERY * ((n_prefill + n_steps) // (2 * FT_EVERY)) + 9
    check(0 < p < n_prefill < d < n_steps - 1,
          f"[{what}] no crash plan: prefill {n_prefill}, steps {n_steps}")
    ckdir = ROOT / "build" / f"ft_{what}"
    shutil.rmtree(ckdir, ignore_errors=True)
    sup = ServeSupervisor(
        make_engine, weights[2], str(ckdir), checkpoint_every=FT_EVERY,
        keep=2, injector=FaultInjector(FaultPlan(
            crash_steps=frozenset({p, p + 1 + d}))))
    save = sup.manager.save

    def timed_save(tree, step):
        save(tree, step)
        snap_ms.append((time.perf_counter() - marks["t"]) * 1e3)
        marks["bytes"] = _dir_bytes(ckdir / f"step_{step:08d}")

    sup.manager.save = timed_save
    try:
        salo_paged_decode.launches = 0
        salo_paged_decode_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng, hist = sup.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = salo_paged_decode.launches
        plain = salo_paged_decode_plain.calls
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    res = eng.batcher.results()
    c = dict(eng.counters)
    check(sorted(res) == sorted(ref_res), f"[{what}] requests {sorted(res)}")
    for rid, toks in ref_res.items():
        check(len(res[rid]) == len(toks) and bool((res[rid] == toks).all()),
              f"[{what}] request {rid}: tokens differ from the "
              f"uninterrupted run")
    check(c == ref_c, f"[{what}] counters {c} != uninterrupted {ref_c}")
    check(hist["restarts"] == 2 and hist["max_step_loss"] <= FT_EVERY,
          f"[{what}] history {hist}")
    check(len(restore_ms) >= 1, f"[{what}] no restore ran")
    check(all(a.n_free == eng.ccfg.n_pages - 1
              for a in eng.batcher.allocs), f"[{what}] pages leaked")
    n_layers = sum(n for _, n in eng.model.program)
    check(launches >= ref_c["decode_launches"] * n_layers and plain == 0,
          f"[{what}] K4 launches {launches}, plain {plain}")
    med = sorted(snap_ms)[len(snap_ms) // 2]
    rmed = sorted(restore_ms)[len(restore_ms) // 2]
    log(f"[{what}] crashes at attempts {p} (prefill, engine step {p}) and "
        f"{p + 1 + d} (decode, engine step {d}); {marks['boots']} boots, "
        f"{len(restore_ms)} restore(s), steps lost {hist['steps_lost']} (max "
        f"{hist['max_step_loss']}), {hist['steps_run']} steps run for "
        f"{n_steps}; tokens and counters equal to the uninterrupted run's")
    log(f"[{what}] snapshot {marks['bytes']} bytes on disk; state_dict + "
        f"save median {med:.3f} ms over {len(snap_ms)} snapshots "
        f"({[round(x, 3) for x in snap_ms]}); restore median {rmed:.3f} ms "
        f"over {len(restore_ms)} ({[round(x, 3) for x in restore_ms]}); "
        f"phase {wall:.3f} s; K4 launches {launches}")
    return launches


def phase_lockstep(torch, seed, arch="smollm-135m", B=LOCKSTEP_B,
                   P=LOCKSTEP_PROMPT, n_new=LOCKSTEP_NEW, weights=None):
    """``arch`` at full width and depth (or ``weights``,
    ``_serve_weights``', whose depth may be cut), bf16, on the lockstep
    ServeEngine: batch ``B``, a ``P``-token prompt prefilled token by
    token, ``n_new`` new tokens. Checks finite logits every step, one K5
    launch per attention layer per decode step (smollm-135m: 30;
    recurrentgemma-9b: 12, one a griffin group; mamba2-370m: none) and no
    plain call; prints the step times, tokens/s and peak memory. An
    encoder-decoder (whisper-base) first fills its cross caches from its
    encoder over seeded audio frames (``_with_cross_caches``): one K1
    launch per encoder layer, and no K2/K3 (the training kernels' counts,
    ``_counters``, hold them after the phase). Returns the K5 launch
    count and the generation step median (s)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.salo_decode import salo_decode, salo_decode_plain
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.tree import tree_leaves

    tag = "lockstep" if arch == "smollm-135m" else f"lockstep {arch}"
    t_phase = time.perf_counter()
    if weights is None:
        cfg = get_config(arch)
        model = build_model(cfg, "cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    else:
        cfg, model, params = weights
    n_attn = _attention_layers(cfg)
    if arch == "smollm-135m":     # the window and the sinks both bite
        check(P > cfg.salo.window, f"prompt {P} within the window")
    eng = ServeEngine(model, ServeConfig(max_len=P + n_new))
    _with_cross_caches(torch, model, params, seed)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                   (B, P))
    decode_step = model.decode_step
    times = []

    def timed_step(*a, **k):                  # finite logits every step
        ts = time.perf_counter()
        logits, cache = decode_step(*a, **k)
        check(bool(torch.isfinite(logits).all()), "non-finite logits")
        times.append(time.perf_counter() - ts)
        return logits, cache

    model.decode_step = timed_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    salo_decode.launches = 0
    salo_decode_plain.calls = 0
    _counters(reset=True)
    t0 = time.perf_counter()
    toks = eng.generate(params, prompts, n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = salo_decode.launches, salo_decode_plain.calls
    train_k, train_plain = _counters()
    enc = cfg.n_layers if cfg.encoder_decoder else 0
    check(train_k == {"K1": enc, "K2": 0, "K3": 0} and train_plain == 0,
          f"training kernels {train_k} (plain {train_plain}), want K1 = "
          f"{enc} (the encoder's layers) and nothing else")
    peak = torch.cuda.max_memory_allocated()
    steps = len(times)
    check(steps == P + n_new, f"{steps} decode steps, want {P + n_new}")
    check(launches == steps * n_attn,
          f"K5 launches {launches} != {steps} x {n_attn}")
    check(plain == 0, f"the plain version ran {plain} times")
    check(tuple(toks.shape) == (B, n_new), f"tokens {tuple(toks.shape)}")
    med = sorted(times)[steps // 2]
    gen_med = sorted(times[P:])[n_new // 2]
    gen_s = sum(times[P:])
    n_param = sum(t.numel() for t in tree_leaves(params))
    log(f"[{tag}] {arch} bf16 ({n_param / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers) B={B} "
        f"prompt={P} new={n_new}: "
        f"{steps} decode steps in {wall:.3f} s; step median {med * 1e3:.3f} "
        f"ms (prefill and generation), generation step median "
        f"{gen_med * 1e3:.3f} ms, {B * n_new / gen_s:.1f} generated "
        f"tokens/s in the generation steps, {B * (P + n_new) / wall:.1f} "
        f"tokens/s through the whole run; peak memory {peak / 2**30:.3f} "
        f"GiB; K5 launches {launches} ({n_attn} a step)"
        + (f", K1 launches {enc} (the encoder over {cfg.n_audio_frames} "
           f"seeded audio frames a row, filling the cross caches)"
           if enc else "")
        + f"; first tokens {toks[:2, :8].tolist()}")
    del model.decode_step
    model.__dict__.pop("init_cache", None)
    if arch != "smollm-135m":
        log(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f} s")
    return launches, gen_med


def profile_lockstep(torch, seed, arch, B, P):
    """One lockstep decode step of ``arch`` (full width and depth, bf16,
    random weights from ``seed``) at position ``P`` on zeroed caches (the
    shapes and the work of the lockstep phase's first generation step)
    under the profiler: device time by kernel name and the idle share.
    Runs after the serve phases, whose timings the profiler's hooks would
    slow."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    cfg = get_config(arch)
    model = build_model(cfg, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    cache = model.init_cache(B, P + 1)
    tok = {"tokens": torch.zeros((B, 1), dtype=torch.long, device="cuda")}
    for _ in range(2):                                   # warm up
        model.decode_step(params, cache, tok, P)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    ts = time.perf_counter()
    model.decode_step(params, cache, tok, P)
    torch.cuda.synchronize()
    dt = time.perf_counter() - ts
    prof.stop()
    report_profile(prof, dt, 1, f"{arch} lockstep decode step at t={P}")
    log(f"[lockstep {arch}] profiled step phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")


# ----------------------------- training ------------------------------ #
# Kernel cases of the training kernels (K1 forward, K2 dQ, K3 dK/dV), each
# on the working-space tensors and plan tables the op hands them:
# (a) the train phase's attention: smollm-135m's pattern, B*H = 8 x 9 flat
#     heads, n 4096, hd 64, block 256, bf16; (b) the same in f32; (c) ViL
#     2-D multi-band with a global token, block_q != block_k, hd 128, f16,
#     padded rows; (d) causal dilated window with sinks (reordered; the
#     global tile's transposed row splits in pack_rows), block 32, f32;
#     (e) case (a) in f16, where small ds meet f16's subnormal range;
# (f) gemma-7b's attention: its pattern, batch 2 x 16 heads, n 4096, hd 256,
#     block 256, bf16 (the column split over blocks); (g) the same in f32
#     (the staged hd chunks on the CUDA cores); (h) longformer-4k's:
#     bidirectional window 512, one global token with global rows, batch
#     8 x 12 heads, hd 64, bf16; (i), (j) the paper's ViL stages 1 and 2
#     (grids 56 x 56 and 28 x 28, window 15 x 15, one global token, 3 and 6
#     heads of hd 64), bf16; (k) recurrentgemma-9b's local attention: its
#     one KV head copied to 16 query heads by the GQA expand (B*H = 16),
#     n 4096, hd 256, window 2048, 4 sinks, block 256, bf16; (l) kimi-k2's
#     attention: 64 query heads (8 KV heads copied 8 times by the GQA
#     expand), batch 1, n 4096, hd 128, window 1024, 4 sinks, block 256,
#     bf16; (m) whisper-base's encoder attention: bidirectional window 512
#     with 4 global tokens (global rows too), batch 8 x 8 heads, n 1500
#     (the audio frames, padded to 1536), hd 64, block 256, bf16.
TRAIN_CASES = {
    "a": dict(pat=("csw", 1024, 4, 1), n=4096, bh=72, hd=64, bq=256, bk=256,
              dtype="bfloat16"),
    "b": dict(pat=("csw", 1024, 4, 1), n=4096, bh=72, hd=64, bq=256, bk=256,
              dtype="float32"),
    "c": dict(pat=("vil", (32, 32), (7, 7), 1), n=1025, bh=4, hd=128,
              bq=128, bk=64, dtype="float16"),
    "d": dict(pat=("csw", 64, 4, 2), n=2048, bh=4, hd=64, bq=32, bk=32,
              dtype="float32"),
    "e": dict(pat=("csw", 1024, 4, 1), n=4096, bh=72, hd=64, bq=256, bk=256,
              dtype="float16"),
    "f": dict(pat=("csw", 1024, 4, 1), n=4096, bh=32, hd=256, bq=256,
              bk=256, dtype="bfloat16"),
    "g": dict(pat=("csw", 1024, 4, 1), n=4096, bh=32, hd=256, bq=256,
              bk=256, dtype="float32"),
    "h": dict(pat=("lf", 512, 1), n=4096, bh=96, hd=64, bq=256, bk=256,
              dtype="bfloat16"),
    "i": dict(pat=("vil", (56, 56), (15, 15), 1), n=3137, bh=3, hd=64,
              bq=128, bk=128, dtype="bfloat16"),
    "j": dict(pat=("vil", (28, 28), (15, 15), 1), n=785, bh=6, hd=64,
              bq=128, bk=128, dtype="bfloat16"),
    "k": dict(pat=("csw", 2048, 4, 1), n=4096, bh=16, hd=256, bq=256,
              bk=256, dtype="bfloat16"),
    "l": dict(pat=("csw", 1024, 4, 1), n=4096, bh=64, hd=128, bq=256,
              bk=256, dtype="bfloat16"),
    "m": dict(pat=("lf", 512, 4), n=1500, bh=64, hd=64, bq=256, bk=256,
              dtype="bfloat16"),
    # one rank's heads of gemma-7b's train attention at 2 model ranks:
    # batch 1 x 8 of the 16 heads
    "tp": dict(pat=("csw", 1024, 4, 1), n=4096, bh=8, hd=256, bq=256,
               bk=256, dtype="bfloat16"),
    # one rank's heads of arctic-480b's train attention at 2 model ranks:
    # batch 1 x 28 of the 56 query heads (on 4 of the 8 KV heads)
    "ep": dict(pat=("csw", 1024, 4, 1), n=4096, bh=28, hd=128, bq=256,
               bk=256, dtype="bfloat16"),
    # one model rank of 2 of recurrentgemma-9b's local attention: batch 1 x
    # 8 of its 16 query heads on its one KV head, what each rank of
    # train-tp recurrentgemma-9b launches
    "k-tp": dict(pat=("csw", 2048, 4, 1), n=4096, bh=8, hd=256, bq=256,
                 bk=256, dtype="bfloat16"),
}
K1, K2, K3 = ("salo_table_attention", "salo_table_backward_dq",
              "salo_table_backward_dkv")
# the cases whose kernels are timed (the ViL stages: K1 only)
TIMED = {"a": (K1, K2, K3), "b": (K1, K2, K3), "f": (K1, K2, K3),
         "g": (K1, K2, K3), "h": (K1, K2, K3), "i": (K1,), "j": (K1,),
         "k": (K1, K2, K3), "l": (K1, K2, K3), "m": (K1, K2, K3),
         "tp": (K1, K2, K3), "ep": (K1, K2, K3), "k-tp": (K1, K2, K3)}
# Tolerances (abs and rel). The forward's out and row stats within
# salo_attention.OUT_TOL and STATS_TOL (f32 1e-5; 16-bit out 8e-3, two bf16
# ulps at |out| near 0.5, as the kernel rounds p relative to a 64-key
# sub-tile's running max; m, l 1e-5 in every case). Kernel and plain
# version use the same f32 arithmetic in another order: f32 gradients 1e-4
# (three products deep). 16-bit dq 2e-2: it is returned in the 16-bit type;
# beyond that it must equal the plain f32 dq rounded to its type on all but
# salo_backward.DQ_OFF_SHARE of its elements. dk/dv (f32 outputs) within
# salo_backward.DKV_TOL (16-bit: 1e-3 bf16, 1e-4 f16): the backward kernels
# split every f32 operand into 16-bit hi + lo on the tensor cores, which
# keeps them within ~1e-5 of f32 arithmetic, where one 16-bit rounding of
# dout, p and ds would miss both (tests/test_torch_backward_numerics.py).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-2}
# a train step's dout relative to unit scale (the gradient of a mean over
# ~3e4 tokens): below f16's normal range
SMALL_DOUT = 2.0 ** -20


def _case_pattern(spec):
    from repro_torch.core import patterns as P
    if spec[0] == "csw":
        _, w, g, dil = spec
        return P.causal_sliding_window(w, n_sinks=g, dilation=dil)
    if spec[0] == "lf":
        _, w, g = spec
        return P.longformer(w, n_global=g)
    _, grid, win, g = spec
    return P.vil(grid, win, n_global=g)


def _attended_pairs(torch, sched, pos_q, pos_k, kvb, flags) -> int:
    """Pairs the step tables' masks admit: the work these inputs need."""
    total = 0
    for s in range(kvb.shape[1]):
        pk = pos_k.index_select(0, kvb[:, s])
        fl = flags[:, s]
        total += int(sched.step_mask(pos_q[:, :, None], pk[:, None, :],
                                     fl[:, None, None]).sum())
    return total


def _live_tiles(torch, sched, pos_q, pos_k, kvb, flags) -> int:
    """Key tiles of the step tables in which some pair survives the mask:
    the K/V tiles these inputs need read (a tile whose every pair is
    masked, like a dilated plan's odd-offset halo, adds nothing to the
    output)."""
    live = set()
    for s in range(kvb.shape[1]):
        pk = pos_k.index_select(0, kvb[:, s])
        hit = sched.step_mask(pos_q[:, :, None], pk[:, None, :],
                              flags[:, s, None, None]).flatten(1).any(1)
        live.update(kvb[:, s][hit].tolist())
    return len(live)


def _executed_pairs(sched, pos_q, pos_k, kvb, flags, rows: int) -> int:
    """Pairs of the (rows x 64-key) sub-tiles of the step tables in which
    any pair survives: what K1 executes for one head (a 32-key tile is one
    sub-tile of 32 keys)."""
    nq, bq = pos_q.shape
    bk = pos_k.shape[1]
    ks = min(64, bk)
    total = 0
    for s in range(kvb.shape[1]):
        pk = pos_k.index_select(0, kvb[:, s])
        live = sched.step_mask(pos_q[:, :, None], pk[:, None, :],
                               flags[:, s, None, None])
        live = live.reshape(nq, bq // rows, rows, bk // ks, ks)
        total += int(live.any(dim=4).any(dim=2).sum()) * rows * ks
    return total


def _k12_io(BH, n_pad, D, item, tables, pairs, dtype):
    """(bytes moved, [(operations, peak for their type)]) of K1 and K2 on
    step tables whose masks admit ``pairs`` pairs: each input read once,
    each output written once. Both forward products take 16-bit operands
    (p is rounded to V's type): 4 x hd flops per pair. dQ with 16-bit
    inputs: each product once at the 16-bit tensor rate, 6 x hd per pair
    (q.k^T, dout.v^T, ds.k); with f32 inputs all but q.k^T at the f32
    rate."""
    qkv = 3 * BH * n_pad * D * item
    stats = 3 * BH * n_pad * 4
    pk16, pk32 = PEAK_OPS[dtype], PEAK_OPS["float32"]
    dq_ops = ([(2 * D * pairs, pk16), (4 * D * pairs, pk32)]
              if dtype == "float32" else [(6 * D * pairs, pk16)])
    return {
        K1: (qkv + BH * n_pad * D * item + 2 * BH * n_pad * 4 + tables,
             [(4 * D * pairs, pk16)]),
        K2: (qkv + BH * n_pad * D * 4 + stats + BH * n_pad * D * item
             + tables, dq_ops)}


def _bound(nbytes, parts):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(o / peak for o, peak in parts) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_train_kernels(torch, timer, seed):
    """K1, K2, K3 against their plain versions; returns the timed cases'
    records {case: {kernel: record}}."""
    import torch.nn.functional as F

    from repro_torch.core.blockwise import plan_tables
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    out_records = {}
    for ci, (name, c) in enumerate(TRAIN_CASES.items()):
        dtype = getattr(torch, c["dtype"])
        pat = _case_pattern(c["pat"])
        sched = schedule(pat, c["n"])
        plan = sched.plan(c["bq"], c["bk"])
        pk_plan = plan.transposed_packed()
        t = plan_tables(plan, torch.device("cuda", 0))
        BH, D, n_pad = c["bh"], c["hd"], plan.n_pad
        gen = torch.Generator(device="cuda").manual_seed(seed + 100 + ci)
        q, k, v = (torch.randn((BH, n_pad, D), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        dout = torch.randn((BH, n_pad, D), generator=gen, device="cuda")
        pos_q = t.pos.reshape(plan.nq, plan.block_q)
        pos_k = t.pos.reshape(plan.nkb, plan.block_k)
        scale = D ** -0.5
        fwd_args = (q, k, v, pos_q, pos_k, t.kv_blocks, t.flags)
        kw = dict(sched=sched, scale=scale)
        out, m, l = KA.salo_table_attention(*fwd_args, **kw)
        ro, rm, rl = KA.salo_table_attention_plain(*fwd_args, **kw)
        delta = (dout * ro.float()).sum(-1)
        bwd_in = (dout, delta, rm, rl, q, k, v, pos_q, pos_k)
        dq = KB.salo_table_backward_dq(*bwd_in, t.kv_blocks, t.flags, **kw)
        rdq = KB.salo_table_backward_dq_plain(*bwd_in, t.kv_blocks, t.flags,
                                              **kw)
        dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
        dk, dv = KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw)
        dk2, dv2 = KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw)
        rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd_in, *dkv_t, **kw)
        torch.cuda.synchronize()

        tol, gtol = KA.OUT_TOL[dtype], GRAD_TOL[c["dtype"]]
        ktol, stol = KB.DKV_TOL[dtype], KA.STATS_TOL
        errs = {}
        for what, a, b, tl in (("out", out, ro, tol), ("m", m, rm, stol),
                               ("l", l, rl, stol), ("dq", dq, rdq, gtol),
                               ("dk", dk, rdk, ktol), ("dv", dv, rdv, ktol)):
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"case {name}: non-finite "
                  f"kernel {what}")
            errs[what] = float((a - b).abs().max())
            check(bool(torch.allclose(a, b, atol=tl, rtol=tl)),
                  f"case {name}: kernel {what} vs plain max abs err "
                  f"{errs[what]} > {tl}")
        check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
              f"case {name}: dK/dV differ between two runs on one input")
        if dtype != torch.float32:
            errs["dq_off_share"] = KB.dq_off_share(dq, rdq)
            check(errs["dq_off_share"] <= KB.DQ_OFF_SHARE,
                  f"case {name}: kernel dq differs from the plain f32 dq "
                  f"rounded to {dtype} on {errs['dq_off_share']} of its "
                  f"elements > {KB.DQ_OFF_SHARE}")
            # dout at a train step's scale, compared relative to it
            sin = (dout * SMALL_DOUT, delta * SMALL_DOUT, *bwd_in[2:])
            sdq = KB.salo_table_backward_dq(*sin, t.kv_blocks, t.flags, **kw)
            srdq = KB.salo_table_backward_dq_plain(*sin, t.kv_blocks,
                                                   t.flags, **kw)
            sdk, sdv = KB.salo_table_backward_dkv(*sin, *dkv_t, **kw)
            srdk, srdv = KB.salo_table_backward_dkv_plain(*sin, *dkv_t, **kw)
            for what, a, b in (("dk", sdk, srdk), ("dv", sdv, srdv)):
                a, b = a / SMALL_DOUT, b / SMALL_DOUT
                errs[f"small_{what}"] = float((a - b).abs().max())
                check(bool(torch.allclose(a, b, atol=ktol, rtol=ktol)),
                      f"case {name}: dout x {SMALL_DOUT}: kernel {what} vs "
                      f"plain max abs err {errs[f'small_{what}']} (relative "
                      f"to the scale) > {ktol}")
            errs["small_dq_off_share"] = KB.dq_off_share(sdq, srdq)
            check(errs["small_dq_off_share"] <= KB.DQ_OFF_SHARE,
                  f"case {name}: dout x {SMALL_DOUT}: dq off share "
                  f"{errs['small_dq_off_share']} > {KB.DQ_OFF_SHARE}")
        pad = t.pos >= sched.n                      # padding rows
        if bool(pad.any()):
            check(bool((m[:, pad] == -1e30).all() and (l[:, pad] == 0).all()
                       and (out[:, pad] == 0).all()),
                  f"case {name}: padded rows must give (0, NEG_INF, 0)")
        n_split = pk_plan.n_rows - len(set(pk_plan.row_tile.tolist()))
        pairs = BH * _attended_pairs(torch, sched, pos_q, pos_k, t.kv_blocks,
                                     t.flags)
        log(f"[train-kernels] case {name} {c['dtype']} {pat} n={c['n']} "
            f"n_pad={n_pad} B*H={BH} hd={D} bq={c['bq']} bk={c['bk']}: "
            f"steps={plan.max_steps} tiles={int(plan.num_steps.sum())} "
            f"packed rows={pk_plan.n_rows} (split {n_split}) "
            f"pairs={pairs} max abs err {errs}; dK/dV bitwise equal over "
            f"two runs")
        if c["pat"][0] == "csw" and c["pat"][3] > 1:
            check(n_split > 0, f"case {name}: no transposed row split")
        if name not in TIMED:
            continue

        item = q.element_size()
        qkv = 3 * BH * n_pad * D * item
        stats = 3 * BH * n_pad * 4
        tables = 4 * (t.pos.numel() + t.kv_blocks.numel() + t.flags.numel())
        ttables = 4 * (t.pos.numel() + sum(x.numel() for x in dkv_t))
        # (bytes moved, [(operations, peak for their type), ...]); K1 and
        # K2 as _k12_io. dK/dV with 16-bit inputs: each product once at the
        # 16-bit tensor rate, 8 x hd flops per pair (q.k^T, dout.v^T,
        # p^T.dout, ds^T.q); with f32 inputs every product but q.k^T at
        # the f32 peak.
        pk16, pk32 = PEAK_OPS[c["dtype"]], PEAK_OPS["float32"]
        if c["dtype"] == "float32":
            dkv_ops = [(2 * D * pairs, pk16), (6 * D * pairs, pk32)]
        else:
            dkv_ops = [(8 * D * pairs, pk16)]
        io = {**_k12_io(BH, n_pad, D, item, tables, pairs, c["dtype"]),
              K3: (qkv + BH * n_pad * D * 4 + stats + 2 * BH * n_pad * D * 4
                   + ttables, dkv_ops)}
        # what the kernels run: K1 4 x hd flops per pair of every sub-tile
        # it executes (16-bit: 16-row x 64-key warp sub-tiles, f32: 64 x 64
        # block sub-tiles); K2/K3 with 16-bit inputs the hi/lo split's
        # tensor-core flops (10 and 16 x hd per pair), with f32 each product.
        # At hd 256 the 16-bit kernels split the accumulated columns over
        # nz = 2 blocks, each of which runs the products before them (K1's
        # scores, 2 x hd; K2/K3's scores and dp, 6 x hd) over the full hd.
        split = c["dtype"] != "float32"
        nz = max(1, D // 128) if split else 1
        exec_pairs = BH * _executed_pairs(sched, pos_q, pos_k, t.kv_blocks,
                                          t.flags, 16 if split else 64)
        run_ops = {K1: (2 * nz + 2) * D * exec_pairs,
                   K2: (6 * nz + 4 if split else 6) * D * pairs,
                   K3: (6 * nz + 10 if split else 8) * D * pairs}
        calls = {
            "salo_table_attention": (
                lambda: KA.salo_table_attention(*fwd_args, **kw),
                lambda: KA.salo_table_attention_plain(*fwd_args, **kw)),
            "salo_table_backward_dq": (
                lambda: KB.salo_table_backward_dq(*bwd_in, t.kv_blocks,
                                                  t.flags, **kw),
                lambda: KB.salo_table_backward_dq_plain(
                    *bwd_in, t.kv_blocks, t.flags, **kw)),
            "salo_table_backward_dkv": (
                lambda: KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw),
                lambda: KB.salo_table_backward_dkv_plain(*bwd_in, *dkv_t,
                                                         **kw)),
        }
        # yardstick: SDPA with the dense boolean mask (working order is the
        # original order here: no dilation), and that call's backward for
        # K2 and K3 together; padding rows (n_pad > n) attend to themselves
        mask = torch.eye(n_pad, dtype=torch.bool, device="cuda")
        mask[:c["n"], :c["n"]] = torch.from_numpy(pat.mask(c["n"])).cuda()
        qs, kss, vs = (x[None].detach().requires_grad_() for x in (q, k, v))

        def lib_fwd():
            return F.scaled_dot_product_attention(qs, kss, vs,
                                                  attn_mask=mask)

        lib_out = lib_fwd()
        g_lib = dout[None].to(dtype)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (qs, kss, vs), g_lib,
                                       retain_graph=True)

        lib_ms = {"salo_table_attention": timer(lib_fwd)}
        if K2 in TIMED[name]:
            lib_ms["backward"] = timer(lib_bwd)
        del lib_out
        recs = {}
        for kname, (kfn, pfn) in calls.items():
            if kname not in TIMED[name]:
                continue
            nbytes, parts = io[kname]
            bound_ms, bound_by = _bound(nbytes, parts)
            ops = sum(o for o, _ in parts)
            err = (errs["out"] if kname == "salo_table_attention" else
                   errs["dq"] if kname == "salo_table_backward_dq" else
                   max(errs["dk"], errs["dv"]))
            kernel_ms = timer(kfn)
            recs[kname] = dict(
                kernel_ms=kernel_ms,
                # few iterations: a plain call queues hundreds of launches,
                # and the queue must not fill up behind the sleep kernel
                plain_ms=timer(pfn, iters=2, sleep_cycles=4_000_000_000),
                library_ms=lib_ms[K1 if kname == K1 else "backward"],
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=err, bytes=nbytes, ops=ops,
                run_ops=run_ops[kname],
                run_tflops=run_ops[kname] / kernel_ms / 1e9,
                run_ops_bound_ms=run_ops[kname] / pk16 * 1e3)
            log(f"[train-kernels] case {name} {kname}: "
                + " ".join(f"{a}={b}" for a, b in recs[kname].items()))
        out_records[name] = recs
    for case in SHARD_CASES:
        out_records[case] = train_kernels_shard(torch, timer, seed, case)
    return out_records


# K1-K3 case (t): one sequence shard's view, shard 1 of 2 at smollm-135m's
# train shapes (8 x 9 flat heads, n 4096, hd 64, window 1024 + 4 sinks,
# 128-blocks as the sharded op picks them): q on the shard's 16 local
# blocks, K/V on its view of 16 local tiles, 8 halo tiles from shard 0
# (distance -1), 1 halo slot at distance +1 and 1 global tile; bf16. The
# +1 slot exists because the band walk of shard 0's last query block
# lists the first tile of shard 1 (causally masked whole, as in the
# reference's plan); on shard 1 it is padding, which no table reads.
def phase_analysis(torch) -> dict:
    """analysis: the launch contract of ``repro_torch.analysis
    .launch_lint`` with CUDA tensors, so the counts are of real kernel
    launches: for every registry target (``analysis.registry
    .plan_targets``; a block below the kernels' smallest raised to it,
    head dim 64, bf16) one forward of ``kernels.ops.salo_attention``
    books ``LAUNCH_CONTRACT["forward"]`` launches and launches K1 once,
    one forward + backward books ``LAUNCH_CONTRACT["grad"]`` and launches
    K1, K2 once and K3's two kernels. Fails on any finding. Returns the
    launches by kernel."""
    from repro_torch.analysis import launch_lint as LL
    from repro_torch.analysis import render
    from repro_torch.analysis.registry import plan_targets
    from repro_torch.kernels.salo_attention import BLOCKS

    t0 = time.perf_counter()
    findings, total, shown = [], {"K1": 0, "K2": 0, "K3": 0}, []
    for t in plan_targets():
        bq, bk = max(t.block_q, min(BLOCKS)), max(t.block_k, min(BLOCKS))
        c = LL.count_launches(t.pattern, t.n, bq, bk, "cuda",
                              torch.bfloat16, d=64)
        findings += LL.check_launch_contract(
            t.pattern, t.n, bq, bk, f"kernels.ops[{t.name}]", "cuda",
            counts=c)
        for k, a, b in zip(("K1", "K2", "K3"), c["forward_kernels"],
                           c["grad_kernels"]):
            total[k] += a + b
        shown.append(f"{t.name} (n {t.n}, blocks {bq}/{bk}): forward "
                     f"{c['forward']} booked {c['forward_kernels']}, grad "
                     f"{c['grad']} booked {c['grad_kernels']}")
    check(not findings, f"analysis: the launch contract fails:\n"
          f"{render(findings)}")
    log(f"[analysis] launch contract held with CUDA tensors, launches "
        f"booked in the registry and (K1, K2, K3) kernel launches: "
        f"{'; '.join(shown)}; {time.perf_counter() - t0:.1f} s")
    phase_smem(torch)
    return total


def phase_smem(torch) -> None:
    """analysis, the shared-memory budget: for every instantiation of the
    CUDA sources (``analysis.smem_budget.instantiations``: K1-K3 by dtype,
    head dim and warps, the owner sum, K4/K5 by dtype, cache type and head
    dim) the bytes its ``.cu`` file exports (the launchers' dynamic sizes;
    the decode kernels' and the owner sum's static bytes as compiled, read
    with ``cudaFuncGetAttributes``) equal the Python mirror's; the card's
    opt-in per-block limit is at least the one the budget holds launches
    to; and the budget finds no launch over its limit for any registry
    target or decode instantiation. Fails on any difference."""
    from repro_torch.analysis import render
    from repro_torch.analysis import smem_budget as SB
    from repro_torch.analysis.registry import plan_targets

    t0 = time.perf_counter()
    props = torch.cuda.get_device_properties(0)
    optin = getattr(props, "shared_memory_per_block_optin", None)
    check(optin is None or optin >= SB.OPTIN_LIMIT,
          f"analysis: the card's opt-in shared memory a block {optin} is "
          f"below the budget's {SB.OPTIN_LIMIT}")
    inst = SB.instantiations()
    got = {x.name(): SB.exported(x) for x in inst}
    bad = [f"{x.name()}: exported {got[x.name()]}, mirror {x.total}"
           for x in inst if got[x.name()] != x.total]
    check(not bad, "analysis: the .cu files' shared memory differs from "
          "analysis/smem_budget.py's mirror: " + "; ".join(bad))
    findings, _ = SB.check_budget(plan_targets(), with_max_n=False)
    check(not findings, f"analysis: shared-memory budget:\n"
          f"{render(findings)}")
    big = max(inst, key=lambda x: x.total if x.opt_in else 0)
    log(f"[analysis] shared memory: the .cu exports equal the mirror for "
        f"all {len(inst)} instantiations (largest dynamic {big.name()} "
        f"{big.total} bytes of the card's {optin} opt-in; decode static "
        f"{min(x.total for x in inst if x.kernel in ('K4', 'K5'))}-"
        f"{max(x.total for x in inst if x.kernel in ('K4', 'K5'))} bytes; "
        f"the owner sum's static {got['K3-owner-sum[float32, hd 64]']}); no "
        f"launch of the {len(plan_targets())} registry targets at hd 64, "
        f"128, 256 in f32, bf16, f16 over its limit; "
        f"{time.perf_counter() - t0:.1f} s")


# K1-K3 case (t-k): shard 1 of 2 of recurrentgemma-9b's train attention
# under a sequence group (batch 1 x 16 query heads expanded from its one
# KV head, hd 256, window 2048 + 4 sinks, 128-blocks): the window spans the
# whole previous shard, so the view holds 16 local tiles, 15 halo tiles
# from shard 0 (distance -1), the +1 slot and 1 global tile; bf16, the
# column split of hd 256. Case (t-v): the same shard of qwen2-vl-2b's
# train attention (batch 1 x 12 query heads expanded from its 2 KV heads,
# hd 128, window 1024 + 4 sinks: (t)'s view of 16 local, 8 + 1 halo and 1
# global tiles). Case (t-d): shard 1 of 2 of smollm-135m's train attention
# at dilation 2 (train-sharded smollm-135m dilation 2: 8 x 9 flat heads, hd
# 64, window 1024 + 4 sinks, 128-blocks): its working slice is residue
# class 1 (2048 rows, 16 query blocks) against a view of 16 local tiles, 8
# halo tiles from shard 0 (residue class 0's tail: every pair masked, each
# offset odd) and 2 global tiles (the dilated sinks in working slots 0, 1,
# 2048 and 2049)
SHARD_CASES = {
    "t": dict(pat=("csw", 1024, 4, 1), n=4096, shards=2, shard=1, bh=72,
              hd=64, blk=128, dtype="bfloat16", view=(16, (8, 1), 1)),
    "t-k": dict(pat=("csw", 2048, 4, 1), n=4096, shards=2, shard=1, bh=16,
                hd=256, blk=128, dtype="bfloat16", view=(16, (15, 1), 1)),
    "t-v": dict(pat=("csw", 1024, 4, 1), n=4096, shards=2, shard=1, bh=12,
                hd=128, blk=128, dtype="bfloat16", view=(16, (8, 1), 1)),
    "t-d": dict(pat=("csw", 1024, 4, 2), n=4096, shards=2, shard=1, bh=72,
                hd=64, blk=128, dtype="bfloat16", view=(16, (8,), 2)),
}


def _view_mask(torch, sched, pos_q, pos_k, kvb, flags):
    """The dense (n_q, n_kv) mask that step tables imply over a view: the
    pairs K1 attends."""
    nq, bq = pos_q.shape
    nkb, bk = pos_k.shape
    mask = torch.zeros((nq, bq, nkb, bk), dtype=torch.bool,
                       device=pos_q.device)
    rows = torch.arange(nq, device=pos_q.device)
    for s in range(kvb.shape[1]):
        tile = kvb[:, s].long()
        live = sched.step_mask(pos_q[:, :, None],
                               pos_k.index_select(0, kvb[:, s])[:, None, :],
                               flags[:, s, None, None])
        mask[rows, :, tile, :] |= live
    return mask.reshape(nq * bq, nkb * bk)


def train_kernels_shard(torch, timer, seed, case="t"):
    """Case ``case`` of ``SHARD_CASES``, (t), (t-k), (t-v) or (t-d): K1,
    K2 and K3 on one shard's view tables (``dist.sharded_plan
    .shard_plan``), held against their plain versions within the
    train-kernels tolerances,
    dK/dV bitwise over two calls, timed beside the bound, the plain
    versions and SDPA with the mask the view tables imply. Returns
    {kernel: record}."""
    import torch.nn.functional as F

    from repro_torch.core.scheduler import schedule
    from repro_torch.dist.sharded_plan import shard_plan, shard_tables
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    c = SHARD_CASES[case]
    dtype = getattr(torch, c["dtype"])
    sched = schedule(_case_pattern(c["pat"]), c["n"])
    S, r, blk = c["shards"], c["shard"], c["blk"]
    sp = shard_plan(sched.plan(blk, blk, S * blk), S)
    check((sp.nkb_l, sp.halo_counts, sp.n_gt) == c["view"],
          f"case {case}: view {sp.nkb_l} local + {sp.halo_counts} halo + "
          f"{sp.n_gt} global tiles, expected {c['view']}")
    t = shard_tables(sp, torch.device("cuda", 0))
    pos_q, pos_k, kvb, flg = t.pos_q[r], t.pos_k[r], t.tables[r], t.flags[r]
    dkv_t = (t.row_tile[r], t.q_blocks[r], t.pk_flags[r])
    BH, D = c["bh"], c["hd"]
    nQ, nK = sp.nq_l * blk, sp.view_tiles * blk
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)
    q = torch.randn((BH, nQ, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((BH, nK, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    dout = torch.randn((BH, nQ, D), generator=gen, device="cuda")
    kw = dict(sched=sched, scale=D ** -0.5)
    fwd_args = (q, k, v, pos_q, pos_k, kvb, flg)
    out, m, l = KA.salo_table_attention(*fwd_args, **kw)
    ro, rm, rl = KA.salo_table_attention_plain(*fwd_args, **kw)
    delta = (dout * ro.float()).sum(-1)
    bwd_in = (dout, delta, rm, rl, q, k, v, pos_q, pos_k)
    dq = KB.salo_table_backward_dq(*bwd_in, kvb, flg, **kw)
    rdq = KB.salo_table_backward_dq_plain(*bwd_in, kvb, flg, **kw)
    dk, dv = KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw)
    dk2, dv2 = KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw)
    rdk, rdv = KB.salo_table_backward_dkv_plain(*bwd_in, *dkv_t, **kw)
    torch.cuda.synchronize()
    ktol = KB.DKV_TOL[dtype]
    errs = {}
    for what, a, b, tl in (("out", out, ro, KA.OUT_TOL[dtype]),
                           ("m", m, rm, KA.STATS_TOL),
                           ("l", l, rl, KA.STATS_TOL),
                           ("dq", dq, rdq, GRAD_TOL[c["dtype"]]),
                           ("dk", dk, rdk, ktol), ("dv", dv, rdv, ktol)):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"case {case}: non-finite {what}")
        errs[what] = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, atol=tl, rtol=tl)),
              f"case {case}: kernel {what} vs plain max abs err {errs[what]} "
              f"> {tl}")
    errs["dq_off_share"] = KB.dq_off_share(dq, rdq)
    check(errs["dq_off_share"] <= KB.DQ_OFF_SHARE,
          f"case {case}: dq off share {errs['dq_off_share']}")
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
          f"case {case}: dK/dV differ between two runs on one input")
    pairs = BH * _attended_pairs(torch, sched, pos_q, pos_k, kvb, flg)
    live = _live_tiles(torch, sched, pos_q, pos_k, kvb, flg)
    log(f"[train-kernels] case {case} {c['dtype']} shard {r} of {S}, "
        f"{sched.pattern} n={c['n']}: q {nQ} rows, view {nK} keys "
        f"({sp.nkb_l} local + {sum(sp.halo_counts)} halo + {sp.n_gt} global "
        f"tiles of {blk}), B*H={BH} hd={D}: steps={kvb.shape[1]} "
        f"packed rows={dkv_t[0].numel()} pairs={pairs} live view tiles="
        f"{live} of {sp.view_tiles} max abs err {errs}; "
        f"dK/dV bitwise equal over two runs")

    # bytes: each input read once, each output written once, K and V read
    # only in the view tiles some pair attends (K3 writes the whole view's
    # dK/dV); operations as _k12_io and the K3 count of
    # phase_train_kernels, at the bf16 rate
    item, pk16 = q.element_size(), PEAK_OPS[c["dtype"]]
    qb, kvb_bytes = BH * nQ * D * item, 2 * BH * live * blk * D * item
    stats = 3 * BH * nQ * 4
    tables = 4 * (pos_q.numel() + pos_k.numel() + kvb.numel() + flg.numel())
    ttables = 4 * (pos_q.numel() + pos_k.numel()
                   + sum(x.numel() for x in dkv_t))
    io = {K1: (qb + kvb_bytes + qb + 2 * BH * nQ * 4 + tables,
               [(4 * D * pairs, pk16)]),
          K2: (qb + kvb_bytes + BH * nQ * D * 4 + stats + qb + tables,
               [(6 * D * pairs, pk16)]),
          K3: (qb + kvb_bytes + BH * nQ * D * 4 + stats
               + 2 * BH * nK * D * 4 + ttables, [(8 * D * pairs, pk16)])}
    calls = {
        K1: (lambda: KA.salo_table_attention(*fwd_args, **kw),
             lambda: KA.salo_table_attention_plain(*fwd_args, **kw)),
        K2: (lambda: KB.salo_table_backward_dq(*bwd_in, kvb, flg, **kw),
             lambda: KB.salo_table_backward_dq_plain(*bwd_in, kvb, flg,
                                                     **kw)),
        K3: (lambda: KB.salo_table_backward_dkv(*bwd_in, *dkv_t, **kw),
             lambda: KB.salo_table_backward_dkv_plain(*bwd_in, *dkv_t,
                                                      **kw))}
    mask = _view_mask(torch, sched, pos_q, pos_k, kvb, flg)
    qs, kss, vs = (x[None].detach().requires_grad_() for x in (q, k, v))

    def lib_fwd():
        return F.scaled_dot_product_attention(qs, kss, vs, attn_mask=mask)

    lib_out = lib_fwd()
    g_lib = dout[None].to(dtype)
    lib_ms = {K1: timer(lib_fwd), "backward": timer(
        lambda: torch.autograd.grad(lib_out, (qs, kss, vs), g_lib,
                                    retain_graph=True))}
    del lib_out
    recs = {}
    for name, (kfn, pfn) in calls.items():
        nbytes, parts = io[name]
        bound_ms, bound_by = _bound(nbytes, parts)
        recs[name] = dict(
            kernel_ms=timer(kfn),
            plain_ms=timer(pfn, iters=2, sleep_cycles=4_000_000_000),
            library_ms=lib_ms[K1 if name == K1 else "backward"],
            bound_ms=bound_ms, bound_by=bound_by,
            max_abs_err=(errs["out"] if name == K1 else errs["dq"]
                         if name == K2 else max(errs["dk"], errs["dv"])),
            bytes=nbytes, ops=sum(o for o, _ in parts))
        log(f"[train-kernels] case {case} {name}: "
            + " ".join(f"{a}={b}" for a, b in recs[name].items()))
    return recs


# --------------------------------------------------------------------- #
# Runtime plans: the dynamic path (hybrid_attention(plan="dynamic")), on
# device-built step tables. smollm-135m's and longformer-4k's attention at
# full width (8 x 9 query heads on 3 KV heads; 8 x 12 heads), n 4096, hd
# 64, block 256, bf16; keep 4 of smollm's 7 steps (61 of 96 executed),
# full keep, and keep 4 of longformer's 5 (62 of 74).
DYN_CASES = {
    "smollm-135m": dict(pat=("csw", 1024, 4, 1), B=8, H=9, Hkv=3, n=4096,
                        hd=64, blk=256, keeps=(4, 7)),
    "longformer-4k": dict(pat=("lf", 512, 1), B=8, H=12, Hkv=12, n=4096,
                          hd=64, blk=256, keeps=(4,)),
}
# the dynamic-check cases: narrowed f32, run on the card and on the CPU
DYN_CHECK = {
    "causal_sinks": dict(pat=("csw", 100, 4, 1), B=2, H=4, Hkv=2, n=512,
                         hd=64, blk=64),
    "longformer": dict(pat=("lf", 48, 2), B=2, H=3, Hkv=3, n=333, hd=64,
                       blk=32),
    "dilated_sinks": dict(pat=("csw", 24, 3, 2), B=2, H=2, Hkv=1, n=200,
                          hd=128, blk=32),
}


def _issue_ms(torch, fn, n: int = 5) -> float:
    """The host's time to issue one call of ``fn`` (mean of ``n``, after a
    warm-up), without waiting for the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return dt


def _dyn_inputs(torch, c, dtype, gen, device="cuda"):
    shp_q = (c["B"], c["H"], c["n"], c["hd"])
    shp_kv = (c["B"], c["Hkv"], c["n"], c["hd"])
    return [torch.randn(s, generator=gen, device=device).to(dtype)
            for s in (shp_q, shp_kv, shp_kv, shp_q)]


def _flat(torch, q, k):
    """hybrid_attention's flat (B*H, n, D) q and GQA-expanded k."""
    B, H, n, D = q.shape
    rep = H // k.shape[1]
    kf = k[:, :, None].expand(B, k.shape[1], rep, n, D).reshape(B * H, n, D)
    return q.reshape(B * H, n, D), kf


def _dyn_grad(torch, pat, c, q, k, v, cot, plan="dynamic", keep=None):
    """One fwd + bwd of hybrid_attention; returns (out, dq, dk, dv)."""
    from repro_torch.core.attention import hybrid_attention

    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    kw = dict(dynamic_keep=keep) if plan == "dynamic" else {}
    out = hybrid_attention(*xs, pat, block_q=c["blk"], block_k=c["blk"],
                           plan=plan, **kw)
    return (out.detach(), *torch.autograd.grad(out, xs, cot))


def phase_dynamic(torch, timer, seed):
    """The dynamic path on the card: each fwd + bwd must launch K1 once
    and K2 once, K3 never, no plain version; at full keep the device
    tables equal the static plan's and out / dQ the static path's; at
    small keep K1 and K2 on the device tables match their plain versions
    on the same tables; the scatter dK/dV repeats bitwise. Returns the
    path's launch counts and K1/K2 records of smollm-135m at keep 4."""
    import torch.nn.functional as F

    from repro_torch.core import dynamic as DY
    from repro_torch.core.blockwise import (plan_tables,
                                            table_dkv_scatter_scan,
                                            working_stream)
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    dtype = torch.bfloat16
    total = {"K1": 0, "K2": 0, "K3": 0}
    records = {}
    for ci, (arch, c) in enumerate(DYN_CASES.items()):
        pat = _case_pattern(c["pat"])
        gen = torch.Generator(device="cuda").manual_seed(seed + 300 + ci)
        q, k, v, cot = _dyn_inputs(torch, c, dtype, gen)
        qf, kf = _flat(torch, q, k)
        BH, D, blk = c["B"] * c["H"], c["hd"], c["blk"]
        for keep in c["keeps"]:
            # the main path: counts set to 0 just before, read just after
            _counters(reset=True)
            res = _dyn_grad(torch, pat, c, q, k, v, cot, keep=keep)
            torch.cuda.synchronize()
            launches, plain = _counters()
            check(launches == {"K1": 1, "K2": 1, "K3": 0} and plain == 0,
                  f"[dynamic] {arch} keep {keep}: launches {launches}, "
                  f"plain {plain}; want K1 1, K2 1, K3 0, plain 0")
            for key in total:
                total[key] += launches[key]
            check(all(bool(torch.isfinite(x.float()).all()) for x in res),
                  f"[dynamic] {arch} keep {keep}: non-finite out or grads")

            cfg = DY.DynamicConfig(keep=keep)
            plan, kvt, flg, _ = DY.dynamic_tables(qf, kf, pat, cfg,
                                                  block_q=blk, block_k=blk)
            sched = plan.sched
            t = plan_tables(plan, q.device)
            pos_q = t.pos.reshape(plan.nq, blk)
            pos_k = t.pos.reshape(plan.nkb, blk)
            total_steps, kept = DY._kept_steps(plan.flags, keep)
            check(int((flg != 0).sum()) == kept,
                  f"[dynamic] {arch} keep {keep}: {int((flg != 0).sum())} "
                  f"steps kept, want {kept}")
            scale = D ** -0.5
            kw = dict(sched=sched, scale=scale)
            vf = v[:, :, None].expand(c["B"], c["Hkv"], c["H"] // c["Hkv"],
                                      c["n"], D).reshape(BH, c["n"], D)
            qw, kw_, vw = (working_stream(x, sched, plan).contiguous()
                           for x in (qf, kf, vf))
            dout = working_stream(cot.reshape(BH, c["n"], D), sched,
                                  plan).float().contiguous()
            fwd = (qw, kw_, vw, pos_q, pos_k, kvt, flg)
            out_w, m, l = KA.salo_table_attention(*fwd, **kw)
            delta = (dout * out_w.float()).sum(-1)
            bwd = (dout, delta, m, l, qw, kw_, vw, pos_q, pos_k)
            sc1 = table_dkv_scatter_scan(*bwd, kvt, flg, sched, scale)
            sc2 = table_dkv_scatter_scan(*bwd, kvt, flg, sched, scale)
            check(torch.equal(sc1[0], sc2[0]) and torch.equal(sc1[1], sc2[1]),
                  f"[dynamic] {arch} keep {keep}: the scatter dK/dV differs "
                  f"between two calls")
            errs = {}
            if keep >= plan.max_steps:
                check(torch.equal(kvt, t.kv_blocks)
                      and torch.equal(flg, t.flags),
                      f"[dynamic] {arch} full keep: the device tables differ "
                      f"from the static plan's")
                st = _dyn_grad(torch, pat, c, q, k, v, cot, plan="static")
                bitwise = {w: torch.equal(a, b) for w, a, b in
                           zip(("out", "dq", "dk", "dv"), res, st)}
                for w, a, b, tl in (("out", res[0], st[0], KA.OUT_TOL[dtype]),
                                    ("dq", res[1], st[1], GRAD_TOL["bfloat16"])):
                    errs[w] = float((a.float() - b.float()).abs().max())
                    check(bool(torch.allclose(a.float(), b.float(), atol=tl,
                                              rtol=tl)),
                          f"[dynamic] {arch} full keep: {w} vs the static "
                          f"path max abs err {errs[w]} > {tl}")
                dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
                dk3, dv3 = KB.salo_table_backward_dkv(*bwd, *dkv_t, **kw)
                ktol = KB.DKV_TOL[dtype]
                for w, a, b in (("dk", sc1[0], dk3), ("dv", sc1[1], dv3)):
                    errs[w] = float((a - b).abs().max())
                    check(bool(torch.allclose(a, b, atol=ktol, rtol=ktol)),
                          f"[dynamic] {arch} full keep: scatter {w} vs K3 "
                          f"max abs err {errs[w]} > {ktol}")
                log(f"[dynamic] {arch} full keep {keep}: device tables equal "
                    f"the static plan's; vs the static path: bitwise "
                    f"{bitwise}, max abs err {errs} (scatter dK/dV vs K3 "
                    f"on the packed tables)")
            else:
                ro, rm, rl = KA.salo_table_attention_plain(*fwd, **kw)
                dq = KB.salo_table_backward_dq(*bwd, kvt, flg, **kw)
                rdq = KB.salo_table_backward_dq_plain(*bwd, kvt, flg, **kw)
                for w, a, b, tl in (("out", out_w, ro, KA.OUT_TOL[dtype]),
                                    ("m", m, rm, KA.STATS_TOL),
                                    ("l", l, rl, KA.STATS_TOL),
                                    ("dq", dq, rdq, GRAD_TOL["bfloat16"])):
                    errs[w] = float((a.float() - b.float()).abs().max())
                    check(bool(torch.allclose(a.float(), b.float(), atol=tl,
                                              rtol=tl)),
                          f"[dynamic] {arch} keep {keep}: kernel {w} vs plain "
                          f"on the device tables max abs err {errs[w]} > {tl}")
                errs["dq_off_share"] = KB.dq_off_share(dq, rdq)
                check(errs["dq_off_share"] <= KB.DQ_OFF_SHARE,
                      f"[dynamic] {arch} keep {keep}: dq off share "
                      f"{errs['dq_off_share']} > {KB.DQ_OFF_SHARE}")
                rows_moved = int((kvt != t.kv_blocks[:, :keep]).any(1).sum())
                log(f"[dynamic] {arch} keep {keep}: K1, K2 on the device "
                    f"tables vs their plain versions max abs err {errs}; "
                    f"{rows_moved} of {plan.nq} rows differ from the static "
                    f"table's first {keep} steps")
            log(f"[dynamic] {arch} keep {keep}: tables {tuple(kvt.shape)} "
                f"(static {tuple(t.kv_blocks.shape)}), executed steps "
                f"{kept} of {total_steps} (ratio {kept / total_steps}); "
                f"launches {launches}; scatter dK/dV bitwise equal over two "
                f"calls")
            if arch != "smollm-135m" or keep >= plan.max_steps:
                continue

            # times on the card: selection, K1 and K2 on the device
            # tables, the scatter twin against K3, the op fwd + bwd
            # dynamic against static
            window = DY._resolve_window(cfg, blk, blk)
            dkv_t = (t.row_tile, t.q_blocks, t.pk_flags)
            tms_fns = {
                "select_ms": lambda: DY._selected(qw, kw_, plan, cfg, window,
                                                  keep, scale),
                "scatter_dkv_ms": lambda: table_dkv_scatter_scan(
                    *bwd, kvt, flg, sched, scale),
                "k3_static_ms": lambda: KB.salo_table_backward_dkv(
                    *bwd, *dkv_t, **kw),
                "dynamic_fwd_bwd_ms": lambda: _dyn_grad(
                    torch, pat, c, q, k, v, cot, keep=keep),
                "static_fwd_bwd_ms": lambda: _dyn_grad(
                    torch, pat, c, q, k, v, cot, plan="static"),
            }
            tms = {name: timer(fn, iters=20 if name in ("select_ms",
                                                         "k3_static_ms")
                               else 5)
                   for name, fn in tms_fns.items()}
            # the host's time to issue a call (no wait on the card): the
            # selection is ~30 small launches
            issue = {name: _issue_ms(torch, fn) for name, fn in (
                ("select", tms_fns["select_ms"]),
                ("scatter_dkv", tms_fns["scatter_dkv_ms"]),
                ("dynamic_fwd_bwd", tms_fns["dynamic_fwd_bwd_ms"]),
                ("static_fwd_bwd", tms_fns["static_fwd_bwd_ms"]))}
            # no host read on the call path: ATen's synchronizing ops raise
            # under the sync debug mode (which does not see every sync)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                tms_fns["dynamic_fwd_bwd_ms"]()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            log(f"[dynamic] {arch} keep {keep}: fwd + bwd ran under "
                f"torch.cuda.set_sync_debug_mode('error') with no "
                f"synchronizing op; host issue ms a call {issue}")
            item = q.element_size()
            tables = 4 * (t.pos.numel() + kvt.numel() + flg.numel())
            pairs = BH * _attended_pairs(torch, sched, pos_q, pos_k, kvt,
                                         flg)
            io = _k12_io(BH, plan.n_pad, D, item, tables, pairs, "bfloat16")
            # yardstick: SDPA with the dense mask the selection implies
            sel = torch.zeros((plan.nq, plan.nkb + 1), dtype=torch.bool,
                              device="cuda")
            sel.scatter_(1, torch.where(flg != 0, kvt, plan.nkb).long(),
                         True)
            sel = sel[:, :plan.nkb]
            mask = torch.from_numpy(pat.mask(c["n"])).cuda() & \
                sel.repeat_interleave(blk, 0).repeat_interleave(blk, 1)
            qs, kss, vs = (x[None].detach().requires_grad_()
                           for x in (qw, kw_, vw))
            lib_out = F.scaled_dot_product_attention(qs, kss, vs,
                                                     attn_mask=mask)
            lib = {K1: timer(lambda: F.scaled_dot_product_attention(
                       qs, kss, vs, attn_mask=mask)),
                   K2: timer(lambda: torch.autograd.grad(
                       lib_out, (qs, kss, vs), dout[None].to(dtype),
                       retain_graph=True))}
            del lib_out
            calls = {
                K1: (lambda: KA.salo_table_attention(*fwd, **kw),
                     lambda: KA.salo_table_attention_plain(*fwd, **kw),
                     errs["out"]),
                K2: (lambda: KB.salo_table_backward_dq(*bwd, kvt, flg, **kw),
                     lambda: KB.salo_table_backward_dq_plain(*bwd, kvt, flg,
                                                             **kw),
                     errs["dq"])}
            for kname, (kfn, pfn, err) in calls.items():
                bound_ms, bound_by = _bound(*io[kname])
                records[kname] = dict(
                    kernel_ms=timer(kfn),
                    plain_ms=timer(pfn, iters=2, sleep_cycles=4_000_000_000),
                    library_ms=lib[kname], bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err, pairs=pairs)
                log(f"[dynamic] {arch} keep {keep} {kname}: "
                    + " ".join(f"{a}={b}" for a, b in records[kname].items()))
            log(f"[dynamic] {arch} keep {keep} times (ms): "
                + " ".join(f"{a}={b}" for a, b in tms.items())
                + f"; scatter / K3 {tms['scatter_dkv_ms'] / tms['k3_static_ms']}"
                + f"; dynamic / static fwd+bwd "
                f"{tms['dynamic_fwd_bwd_ms'] / tms['static_fwd_bwd_ms']}; "
                f"executed-tile ratio {kept / total_steps}")
    log(f"[dynamic] launches on the dynamic path {total}")
    return total, records


def dynamic_check(torch, seed):
    """Narrowed f32 cases on the card and on the CPU from the same tensors:
    the device-built tables equal, out and the three gradients within
    1e-4. Then smollm-135m's bf16 case at full width: how many table rows
    differ between the card and the CPU (near-ties may flip; not gated)."""
    from repro_torch.core import dynamic as DY
    from repro_torch.core.scheduler import schedule

    for ci, (name, c) in enumerate(DYN_CHECK.items()):
        pat = _case_pattern(c["pat"])
        gen = torch.Generator().manual_seed(seed + 400 + ci)
        xs = _dyn_inputs(torch, c, torch.float32, gen, device="cpu")
        qf, kf = _flat(torch, xs[0], xs[1])
        sched_plan = schedule(pat, c["n"]).plan(c["blk"], c["blk"])
        need = int(DY.plan_always_keep(sched_plan, c["blk"]).sum(-1).max())
        # below max_steps (a real selection), at or above the always-kept
        keep = max(need, min(need + 1, sched_plan.max_steps - 1))
        check(keep < sched_plan.max_steps, f"[dynamic-check] {name}: keep "
              f"{keep} leaves nothing to select of {sched_plan.max_steps}")
        cfg = DY.DynamicConfig(keep=keep)
        tabs, res = {}, {}
        for dev in ("cuda", "cpu"):
            _, kvt, flg, _ = DY.dynamic_tables(qf.to(dev), kf.to(dev), pat,
                                               cfg, block_q=c["blk"],
                                               block_k=c["blk"])
            tabs[dev] = (kvt.cpu(), flg.cpu())
            res[dev] = [x.cpu() for x in _dyn_grad(
                torch, pat, c, *(x.to(dev) for x in xs), keep=keep)]
        check(all(torch.equal(a, b) for a, b in zip(tabs["cuda"],
                                                      tabs["cpu"])),
              f"[dynamic-check] {name}: tables differ between cuda and cpu")
        errs = [float((a - b).abs().max()) for a, b in zip(res["cuda"],
                                                            res["cpu"])]
        check(all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                  for a, b in zip(res["cuda"], res["cpu"])),
              f"[dynamic-check] {name}: cuda vs cpu (out, dq, dk, dv) max "
              f"abs err {errs} > 1e-4")
        log(f"[dynamic-check] {name} f32 keep {keep} of "
            f"{sched_plan.max_steps}: tables equal on cuda and cpu; (out, "
            f"dq, dk, dv) max abs err {errs}")
    c = DYN_CASES["smollm-135m"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 300)
    q, k, _, _ = _dyn_inputs(torch, c, torch.bfloat16, gen)
    qf, kf = _flat(torch, q, k)
    keep = c["keeps"][0]
    cfg = DY.DynamicConfig(keep=keep)
    got = [DY.dynamic_tables(x, y, _case_pattern(c["pat"]), cfg,
                             block_q=c["blk"], block_k=c["blk"])[1:3]
           for x, y in ((qf, kf), (qf.cpu(), kf.cpu()))]
    rows = int(((got[0][0].cpu() != got[1][0]) |
                (got[0][1].cpu() != got[1][1])).any(1).sum())
    log(f"[dynamic-check] smollm-135m bf16 keep {keep} at full width: "
        f"{rows} of {got[1][0].shape[0]} table rows differ between cuda and "
        f"cpu (not gated)")


def _train_cfg(smoke: bool):
    import dataclasses

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.configs.base import SALOConfig

    if smoke:
        return dataclasses.replace(
            get_smoke("smollm-135m"), d_model=192, n_heads=3, n_kv_heads=1,
            d_ff=256, salo=SALOConfig(window=16, n_global=2, block_q=32,
                                      block_k=32))
    return get_config("smollm-135m")


def _trainer(cfg, dev, params, *, seq, batch, steps, lr, warmup, seed,
             group=None, data=None, compress=False, model_group=None,
             fsdp=False):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.optim.schedule import Schedule
    from repro_torch.train.trainer import TrainConfig, make_train_step

    model = build_model(cfg, dev)
    tcfg = TrainConfig(optimizer=adamw.AdamWConfig(lr=lr),
                       schedule=Schedule(warmup_steps=warmup,
                                         total_steps=steps),
                       compress_grads=compress)
    ds = SyntheticLM(cfg, DataConfig(seq, batch, seed=seed))
    return (make_train_step(model, tcfg, group=group, data=data,
                            model_group=model_group, fsdp=fsdp),
            adamw.init(tcfg.optimizer, params), ds)


def _counters(reset: bool = False):
    """The training kernels' launch counts and their plain versions' call
    counts (all set to 0 first when ``reset``)."""
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels import salo_backward as KB

    fns = {"K1": KA.salo_table_attention, "K2": KB.salo_table_backward_dq,
           "K3": KB.salo_table_backward_dkv}
    plains = (KA.salo_table_attention_plain, KB.salo_table_backward_dq_plain,
              KB.salo_table_backward_dkv_plain)
    if reset:
        for f in fns.values():
            f.launches = 0
        for f in plains:
            f.calls = 0
    return ({k: f.launches for k, f in fns.items()},
            sum(f.calls for f in plains))


# the MoE aux metrics a train step reports (models/moe.py)
AUX = ("load_balance", "router_z", "dropped_frac")


def train_check(torch, seed, cfg=None, what="smollm-135m hd 64"):
    """The same small f32 model (2 layers; by default smollm's at hd 64)
    trained 3 steps on the card (kernels) and on the CPU (plain versions)
    from the same parameters and batches: losses and grad norms (and an
    MoE model's three aux metrics) agree within 1e-4 (f32, summation order
    only). A program without attention layers (mamba2) must launch no
    kernel and call no plain version. Returns the card's launch counts."""
    from repro_torch.models.model import build_model

    cfg = cfg if cfg is not None else _train_cfg(smoke=True)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    hist = {}
    for dev in ("cuda", "cpu"):
        p = params if dev == "cpu" else _to(params, dev)
        step, opt, ds = _trainer(cfg, dev, p, seq=128, batch=2, steps=3,
                                 lr=3e-3, warmup=1, seed=seed)
        _counters(reset=True)
        hist[dev] = []
        for i in range(3):
            p, opt, met, _ = step(p, opt, ds.batch(i))
            hist[dev].append(tuple(float(met[k]) for k in (
                "loss", "grad_norm", *(a for a in AUX if a in met))))
        launches, plain = _counters()
        if dev == "cuda":
            card = launches
        if not _attention_layers(cfg):
            check(plain == 0 and max(launches.values()) == 0,
                  f"train-check {dev}: launches {launches}, plain {plain} "
                  f"in a program without attention")
        elif dev == "cuda":
            check(plain == 0 and min(launches.values()) > 0,
                  f"train-check cuda: launches {launches}, plain {plain}")
        else:
            check(plain > 0 and max(launches.values()) == 0,
                  f"train-check cpu: launches {launches}, plain {plain}")
    for hc, hp in zip(hist["cuda"], hist["cpu"]):
        check(all(math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-4)
                  for a, b in zip(hc, hp)),
              f"train-check {what}: cuda {hist['cuda']} != cpu "
              f"{hist['cpu']}")
    names = ("loss", "grad norm") + tuple(a for a in AUX if cfg.moe)
    log(f"[train-check] {what}: cuda == cpu within 1e-4, "
        f"({', '.join(names)}) per step: cuda {hist['cuda']} cpu "
        f"{hist['cpu']}")
    return card


def _block_params(cfg, kind: str) -> int:
    """Parameters of one segment element of ``kind`` (``models/
    transformer.py``'s block_init): an attention block (q, k, v, o
    projections), an RG-LRU block (w_in, w_gate_branch, w_out: 3 d dr;
    w_a, w_i: 2 dr^2; the conv W dr; lam dr), an SSD block (w_in, w_out,
    the conv over d_inner + 2N channels, A_log, D, dt_bias, norm_scale),
    each with its MLP and RMS norms; a griffin group is two RG-LRU blocks
    and one attention block; an MoE block (``models/moe.py``) is an
    attention block with the router (d E), the expert stacks and the
    shared experts in place of its MLP (arctic's keeps the MLP beside
    them); a whisper decoder block (``xattn``) is an attention block with
    a second attention (cross) and its norm."""
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    mults = 3 if cfg.act in ("swiglu", "geglu") else 2
    mlp = mults * d * cfg.d_ff
    if kind in ("attn_mlp", "attn_mlp_local"):
        return d * hd * (2 * H + 2 * Hkv) + mlp + 2 * d
    if kind == "xattn":
        return 2 * d * hd * (2 * H + 2 * Hkv) + mlp + 3 * d
    if kind in ("attn_moe", "attn_moe_dense"):
        m = cfg.moe
        moe = d * m.n_experts + mults * d * m.d_ff_expert * (
            m.n_experts + m.n_shared_experts)
        return (d * hd * (2 * H + 2 * Hkv) + moe + 2 * d
                + (mlp if kind == "attn_moe_dense" else 0))
    if kind == "rec_mlp":
        dr = cfg.recurrent.d_rnn or d
        W = cfg.recurrent.conv_width
        return 3 * d * dr + 2 * dr * dr + W * dr + dr + mlp + 2 * d
    if kind == "ssm":
        s = cfg.ssm
        d_inner = s.expand * d
        Hs = d_inner // s.head_dim
        return (d * (2 * d_inner + 2 * s.d_state + Hs) + d_inner * d
                + s.conv_width * (d_inner + 2 * s.d_state) + 3 * Hs
                + d_inner + d)
    if kind == "griffin":
        return (2 * _block_params(cfg, "rec_mlp")
                + _block_params(cfg, "attn_mlp_local"))
    raise ValueError(f"train_bytes does not reckon block kind {kind!r}")


def _recompute_bytes(cfg, kind: str, seq: int, batch: int) -> int:
    """The f32 temporaries one segment element holds in its backward
    (under remat its forward runs again there, saving them) beyond the
    projections: an RG-LRU block's scan keeps each of its ceil(log2 T)
    passes' (a, b) pair and ~10 gate and product tensors, f32 over (tokens,
    d_rnn); a griffin group's two RG-LRU blocks are recomputed together;
    an SSD block keeps ~4 chunk-quadratic f32 tensors (tokens x chunk x
    heads) and ~8 f32 (tokens, d_inner) ones; a whisper decoder block's
    dense cross attention its f32 probabilities over the audio frames,
    their gradient and the scores' (3 x (batch, H, seq, frames))."""
    tokens = seq * batch
    if kind == "xattn":
        return 3 * 4 * tokens * cfg.n_heads * cfg.n_audio_frames
    if kind == "rec_mlp":
        dr = cfg.recurrent.d_rnn or cfg.d_model
        return (2 * math.ceil(math.log2(seq)) + 10) * 4 * dr * tokens
    if kind == "griffin":
        return 2 * _recompute_bytes(cfg, "rec_mlp", seq, batch)
    if kind == "ssm":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        Hs = d_inner // s.head_dim
        return (4 * s.chunk * Hs + 8 * d_inner) * 4 * tokens
    return 0


def train_bytes(cfg, seq: int, batch: int) -> dict:
    """The device bytes a train step of ``cfg`` needs at its peak, reckoned
    from the shapes (bf16 parameters; see ``optim/adamw.py`` and
    ``train/trainer.py``). Resident are the parameters (2 B each) and
    AdamW's f32 moments (4 + 4). The update holds, besides, the step's f32
    gradients and their clipped copy (4 + 4), and adds the new f32
    parameters and moments leaf by leaf (4 + 4 + 4), then the new bf16
    parameters (2): 32 B a parameter at its end. A leaf's own f32
    temporaries (~5 x 4 B each) come on top while it is updated; the
    embedding, the largest, is the first leaf, so they meet only the 18 B
    a parameter held when the update starts; an MoE program's largest
    leaf may be an expert stack (E x d x d_ff_expert), whose temporaries
    are counted instead where it is the larger. The loss holds the f32
    logits, their soft-capped and log-softmax copies and their gradient
    (4 x 4 B a logit), beside what the forward saved for the backward:
    under remat "full" each segment element's input (d values a token an
    element: a layer, or a whole griffin group), under "dots" (attention
    programs only) the projections' outputs too (q, k, v, o, the MLP's up
    (and gate) and down products; ``models/transformer.py``), all in
    bf16; and the largest element's recomputed f32 temporaries
    (``_recompute_bytes``: the RG-LRU scan's, the SSD's, the cross
    attention's). An encoder-decoder adds its encoder (``n_layers``
    attention blocks and a norm; each layer's input over the audio frames
    saved too) and the f32 audio frames; a VLM its vision projection (d
    x d) and the f32 vision embeddings with their bf16 projection."""
    from repro_torch.models.transformer import ATTN_KINDS, make_program

    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    gated = cfg.act in ("swiglu", "geglu")
    program = make_program(cfg)
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    enc = (cfg.n_layers * _block_params(cfg, "attn_mlp") + d
           if cfg.encoder_decoder else 0)
    params = embed + sum(n * _block_params(cfg, kind)
                         for kind, n in program) + d + enc
    params += d * d if cfg.n_vision_tokens else 0
    largest = embed
    if cfg.moe is not None:
        largest = max(largest, cfg.moe.n_experts * d * cfg.moe.d_ff_expert)
    update = max(32 * params, 18 * params + 20 * largest)
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"train_bytes reckons remat full and dots, got "
                         f"{cfg.remat!r}")
    if cfg.remat == "dots" and any(k not in ATTN_KINDS for k, _ in program):
        raise ValueError("train_bytes reckons remat dots for attention "
                         "programs only")
    proj = hd * (H + 2 * Hkv) + d + (2 if gated else 1) * cfg.d_ff + d
    per_token = d + (proj if cfg.remat == "dots" else 0)
    elements = sum(n for _, n in program)
    saved = 2 * per_token * seq * batch * elements
    extras = 6 * seq * batch * d if cfg.n_vision_tokens else 0
    if cfg.encoder_decoder:
        frames = cfg.n_audio_frames * batch
        saved += 2 * d * frames * (cfg.n_layers + 1)
        extras += 4 * d * frames
    recompute = max(_recompute_bytes(cfg, kind, seq, batch)
                    for kind, _ in program)
    loss = 16 * seq * batch * cfg.vocab_size + 10 * params + saved \
        + recompute + extras
    per_layer = _block_params(cfg, program[0][0])
    return dict(params=params, per_layer=per_layer, embedding=embed,
                resident=10 * params, update_peak=update, loss_peak=loss,
                saved=saved, saved_per_token_layer=per_token,
                recompute=recompute, extras=extras, peak=max(update, loss))


def _fit_depth(full, seq: int, batch: int, budget: float) -> int:
    """The deepest ``full`` (a multiple of 3 for hybrid programs) whose
    reckoned train-step peak fits ``budget`` bytes; 0 if none does."""
    import dataclasses

    unit = 3 if full.family == "hybrid" else 1
    depth = 0
    for n in range(unit, full.n_layers + 1, unit):
        if train_bytes(dataclasses.replace(full, n_layers=n), seq,
                       batch)["peak"] > budget:
            break
        depth = n
    return depth


def train_shape(torch, arch: str, seq: int, batches=(8, 4, 2, 1)):
    """(batch, depth) for a train phase of ``arch``: the largest of
    ``batches`` at which the full depth's reckoned peak (``train_bytes``)
    fits 92 % of the card, else batch 1 at ``train_depth``. Prints the
    reckoning of the pick (``train_depth``'s line)."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    budget = 0.92 * torch.cuda.get_device_properties(0).total_memory
    batch = next((b for b in batches
                  if _fit_depth(full, seq, b, budget) == full.n_layers), 1)
    return batch, train_depth(torch, arch, seq, batch)


def train_depth(torch, arch: str, seq: int, batch: int) -> int:
    """The deepest ``arch`` (every published width kept) whose reckoned
    train-step peak (``train_bytes``) fits in 92 % of the card's memory;
    a multiple of 3 for hybrid programs (whole griffin groups)."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    unit = 3 if full.family == "hybrid" else 1
    budget = 0.92 * torch.cuda.get_device_properties(0).total_memory
    depth = _fit_depth(full, seq, batch, budget)
    check(depth > 0, f"no {unit} layer(s) of {arch} fit the card")
    b = train_bytes(dataclasses.replace(full, n_layers=depth), seq, batch)
    nxt = train_bytes(dataclasses.replace(full, n_layers=depth + unit), seq,
                      batch)
    log(f"[train {arch}] reckoned bytes at seq {seq} batch {batch}: "
        f"embedding {b['embedding'] / 1e6:.1f}M params "
        f"({'tied' if full.tie_embeddings else 'untied'}), "
        f"{b['per_layer'] / 1e6:.1f}M a segment element; {depth} of "
        f"{full.n_layers} layers fit {budget / 1e9:.2f} GB (92 % of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}): "
        f"{b['params'] / 1e6:.1f}M params, resident {b['resident'] / 1e9:.2f}"
        f" GB, update peak {b['update_peak'] / 1e9:.2f} GB, loss peak "
        f"{b['loss_peak'] / 1e9:.2f} GB (f32 logits "
        f"{seq * batch * full.vocab_size * 4 / 1e9:.2f} GB, recomputed "
        f"f32 temporaries {b['recompute'] / 1e9:.2f} GB); "
        f"{depth + unit} layers would peak at {nxt['peak'] / 1e9:.2f} GB")
    return depth


def serve_bytes(cfg) -> dict:
    """The device bytes the MoE serve and lockstep phases of ``cfg`` need
    at their peak, reckoned from the shapes: the weights (bf16, the
    routers f32), the continuous engine's bf16 slab (the serve traffic's
    n_pages of page 16) and the lockstep caches (batch 8, 288 slots), the
    largest call's MoE dispatch temporaries (a 128-token prefill chunk:
    the (E·G·C, d) dispatch buffer and the experts' output, their three
    (E·G·C, f) products, and the (T·k, d) copies of the tokens and their
    contributions; ``models/moe.py``), and the logits of the widest step
    (8 rows, bf16 and their f32 copy)."""
    from repro_torch.models.layers import salo_pattern
    from repro_torch.models.moe import capacity, n_groups
    from repro_torch.models.transformer import MOE_KINDS, make_program
    from repro_torch.serve.paged_cache import layout_for_pattern

    d, m = cfg.d_model, cfg.moe
    program = make_program(cfg)
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    params = embed + sum(n * _block_params(cfg, kind)
                         for kind, n in program) + d
    router = sum(n * d * m.n_experts for kind, n in program
                 if kind in MOE_KINDS)
    weights = 2 * params + 2 * router
    layers = sum(n for _, n in program)
    kv_row = 2 * cfg.n_kv_heads * cfg.hd * 2            # K and V, bf16
    lay = layout_for_pattern(salo_pattern(cfg), SERVE_PAGE)
    slab = layers * (1 + SERVE_R * lay.pages_per_req) * SERVE_PAGE * kv_row
    caches = layers * RG_B * (RG_PROMPT + RG_NEW) * kv_row
    T = SERVE_CHUNK
    G = n_groups(cfg, T)
    slots = m.n_experts * G * capacity(cfg, T // G)
    dispatch = 2 * (2 * slots * d + 3 * slots * m.d_ff_expert
                    + 2 * T * m.top_k * d)
    logits = SERVE_R * cfg.vocab_size * (2 + 4)
    return dict(params=params, weights=weights, slab=slab, caches=caches,
                dispatch=dispatch, dispatch_slots=slots, logits=logits,
                peak=weights + slab + caches + dispatch + logits)


def serve_depth(torch, arch: str) -> int:
    """The deepest ``arch`` (every published width kept, at least one MoE
    layer) whose reckoned serving peak (``serve_bytes``) fits in 92 % of
    the card's memory; prints the reckoning."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    budget = 0.92 * torch.cuda.get_device_properties(0).total_memory
    depth = 0
    for n in range(full.moe.first_k_dense + 1, full.n_layers + 1):
        if serve_bytes(dataclasses.replace(full, n_layers=n))["peak"] \
                > budget:
            break
        depth = n
    check(depth > 0, f"no MoE layer of {arch} fits the card")
    b = serve_bytes(dataclasses.replace(full, n_layers=depth))
    nxt = serve_bytes(dataclasses.replace(full, n_layers=depth + 1))
    log(f"[serve {arch}] reckoned bytes: {depth} of {full.n_layers} layers "
        f"fit {budget / 1e9:.2f} GB (92 % of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}): "
        f"{b['params'] / 1e9:.3f}G params, weights {b['weights'] / 1e9:.2f} "
        f"GB, slab {b['slab'] / 1e9:.3f} GB, lockstep caches "
        f"{b['caches'] / 1e9:.3f} GB, dispatch temporaries "
        f"{b['dispatch'] / 1e9:.3f} GB ({b['dispatch_slots']} expert slots "
        f"at a {SERVE_CHUNK}-token chunk), logits {b['logits'] / 1e9:.3f} "
        f"GB: peak {b['peak'] / 1e9:.2f} GB; {depth + 1} layers would peak "
        f"at {nxt['peak'] / 1e9:.2f} GB")
    return depth


def moe_breakdown(torch, timer, weights, k4_ms: float, k5_ms: float,
                  serve_ms: float, lockstep_ms: float) -> dict:
    """The MoE decode step split into its parts: one MoE layer's
    ``moe_apply`` on a decode step's 8 rows, timed as K1's cases are (L2
    flushed), against its expert products alone (``_expert_ffn`` on the
    step's (E, G·C, d) buffer) and its shared expert; the rest of the
    call is routing and dispatch. With the measured decode step medians
    (``serve_ms``, ``lockstep_ms``) and one K4 / K5 launch of case (l)
    (``k4_ms``, ``k5_ms``), per step: the layers' expert products,
    dispatch, attention kernels, and what is left (projections, norms,
    the LM head, the host). One ``moe_apply`` runs first under
    ``torch.cuda.set_sync_debug_mode("error")``: no host read on the call
    path. Prints and returns them (ms)."""
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import dt, mlp_apply
    from repro_torch.models.transformer import MOE_KINDS

    cfg, model, params = weights
    m = cfg.moe
    key, kind = next((f"seg{i}_{k}", k)
                     for i, (k, _) in enumerate(model.program)
                     if k in MOE_KINDS)
    p = params[key][0]["moe"]
    n_moe = sum(n for k, n in model.program if k in MOE_KINDS)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((SERVE_R, 1, cfg.d_model), generator=gen,
                    device="cuda").to(dt(cfg, "compute"))
    G = MOE.n_groups(cfg, SERVE_R)
    C = MOE.capacity(cfg, SERVE_R // G)
    buf = torch.randn((m.n_experts, G * C, cfg.d_model), generator=gen,
                      device="cuda").to(x.dtype)
    with torch.no_grad():
        # no host read on the call path (the sync debug mode raises on
        # ATen's synchronizing ops), so the calls queue behind the timer
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            MOE.moe_apply(p, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        # few iterations: a call issues ~60 small kernels, and the queue
        # must stay behind the sleep kernel
        moe_ms = timer(lambda: MOE.moe_apply(p, x, cfg), iters=4,
                       sleep_cycles=2_000_000_000)
        expert_ms = timer(lambda: MOE._expert_ffn(p, buf, cfg))
        shared_ms = (timer(lambda: mlp_apply(p["shared"], x, cfg))
                     if m.n_shared_experts else 0.0)
    expert_bytes = sum(p[w].numel() * p[w].element_size()
                       for w in ("w_in", "w_gate", "w_out") if w in p)
    layers = sum(n for _, n in model.program)
    rec = dict(moe_ms=moe_ms, expert_ms=expert_ms, shared_ms=shared_ms,
               dispatch_ms=moe_ms - expert_ms - shared_ms,
               expert_bound_ms=expert_bytes / HBM_BYTES_PER_S * 1e3,
               expert_bytes=expert_bytes, slots=G * C, moe_layers=n_moe)
    for what, step_ms, attn_ms in (("serve", serve_ms, k4_ms),
                                   ("lockstep", lockstep_ms, k5_ms)):
        parts = {"experts": n_moe * expert_ms,
                 "shared expert": n_moe * shared_ms,
                 "routing and dispatch": n_moe * rec["dispatch_ms"],
                 "attention kernel": layers * attn_ms}
        parts["rest"] = step_ms - sum(parts.values())
        rec[what] = parts
        log(f"[moe {cfg.name}] {what} decode step {step_ms:.3f} ms: "
            + ", ".join(f"{a} {b:.3f} ms" for a, b in parts.items())
            + f" ({n_moe} MoE layers, {layers} attention layers)")
    log(f"[moe {cfg.name}] one MoE layer ({kind}) on {SERVE_R} rows: "
        + " ".join(f"{a}={b}" for a, b in rec.items()
                   if a not in ("serve", "lockstep")))
    return rec


def phase_moe(torch, timer, seed, arch, k4_ms, k5_ms) -> dict:
    """lockstep <arch> and serve <arch>: every published width, the depth
    from ``serve_depth``, bf16 weights from ``seed`` initialised once on
    the card; the lockstep phase's traffic (batch 8, prompt 256, 32 new;
    one K5 launch a layer a step), then the serve phase's on the
    continuous engine (one K4 launch a layer a decode step, one decode
    step profiled), then ``moe_breakdown``. Returns the K4 and K5 launch
    counts."""
    t_phase = time.perf_counter()
    depth = serve_depth(torch, arch)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    weights = _serve_weights(torch, seed, arch, depth)
    torch.cuda.synchronize()
    log(f"[serve {arch}] {depth} layers' weights drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    k5, lock_med = phase_lockstep(torch, seed, arch, RG_B, RG_PROMPT,
                                  RG_NEW, weights=weights)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    k4, _, _, serve_med = phase_serve(torch, seed, arch, f"serve {arch}",
                                      (40, 41), False, weights=weights)
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve {arch}] peak memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    moe_breakdown(torch, timer, weights, k4_ms, k5_ms, serve_med * 1e3,
                  lock_med * 1e3)
    del weights
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve {arch}] phase wall {time.perf_counter() - t_phase:.1f} s")
    return k4, k5


DOTS_STEPS = 5                   # train-dots: the train phase's first steps


def dots_reckoning(seq: int, batch: int) -> None:
    """train-dots, printed before it runs: what remat "dots" saves beyond
    "full" for smollm-135m (``train_bytes``)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("smollm-135m")
    full = train_bytes(cfg, seq, batch)
    dots = train_bytes(dataclasses.replace(cfg, remat="dots"), seq, batch)
    log(f"[train-dots] reckoned at seq {seq} batch {batch}: remat dots "
        f"saves {dots['saved_per_token_layer']} bf16 values a token a layer "
        f"(full: {full['saved_per_token_layer']}, the layer input), "
        f"{dots['saved'] / 1e9:.3f} GB over {seq * batch} tokens x "
        f"{cfg.n_layers} layers against {full['saved'] / 1e9:.3f} GB: "
        f"+{(dots['saved'] - full['saved']) / 2**30:.3f} GiB on remat "
        f"full's peak; reckoned loss peak {dots['loss_peak'] / 1e9:.3f} GB "
        f"(full {full['loss_peak'] / 1e9:.3f})")


def phase_train(torch, seed, arch="smollm-135m", n_layers=None,
                steps=TRAIN_STEPS, batch=TRAIN_BATCH, lr=3e-3, warmup=10,
                ft_save_at=None, remat="full", ref=None, cfg=None,
                run=None):
    """``arch`` at full width (and depth unless ``n_layers`` cuts it),
    bf16, remat ``remat``, trained on the card at seq 4096. With
    ``ft_save_at``, {"params", "opt"} after that many steps go to
    ``build/`` through an async ``CheckpointManager``, with a clone kept
    on the card; the steps that overlap the background write are printed
    and left out of the median. With ``ref`` (the stats an earlier run of
    the same seed returned), only ``len(ref["losses"])`` steps of the
    ``steps``-step schedule run, their losses must equal ``ref``'s within
    1e-4 instead of falling. Returns the launch counts of the run,
    what ``phase_train_ft`` needs (None without ``ft_save_at``) and the
    run's stats (losses, median step ms, peak bytes, an MoE program's
    dropped share per step). ``cfg``: the
    config to run in place of ``arch``'s published one (train-ep's cut
    expert count). ``run``: only the first ``run`` steps of the schedule
    (a split phase's reference), whose loss is not held to fall."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch) if cfg is None else cfg
    check(cfg.remat == "full", f"config {cfg}")
    cfg = dataclasses.replace(cfg, remat=remat)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    tag = "train" if arch == "smollm-135m" else f"train {arch}"
    if remat != "full":
        tag = f"train-{remat}"
    t_phase = time.perf_counter()
    run = run or (steps if ref is None else len(ref["losses"]))
    seq = 4096
    params = build_model(cfg, "cuda").init(
        torch.Generator(device="cuda").manual_seed(seed))
    step, opt, ds = _trainer(cfg, "cuda", params, seq=seq, batch=batch,
                             steps=steps, lr=lr, warmup=warmup, seed=seed)
    n_param = sum(t.numel() for t in tree_leaves(params))
    log(f"[{tag}] {arch} bf16 remat={remat}: {n_param / 1e6:.1f}M params, "
        f"{cfg.n_layers} layers, seq {seq} batch {batch} steps {run} of a "
        f"{steps}-step schedule, lr {lr} warmup {warmup}")
    # cyclic garbage of earlier phases must not count in this one's peak
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log(f"[{tag}] allocated before the first step "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB (parameters, "
        f"optimizer state and whatever earlier phases still hold)")
    _counters(reset=True)
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    losses, norms, times, overlapped, ft = [], [], [], [], None
    draws, dropped = [], []
    for i in range(run):
        if ft is not None and ft["mgr"].writing():
            overlapped.append(i)
        # the batch is drawn on the host before the step's clock starts
        td = time.perf_counter()
        batch_np = ds.batch(i)
        draws.append(time.perf_counter() - td)
        t0 = time.perf_counter()
        params, opt, met, _ = step(params, opt, batch_np)
        loss = float(met["loss"])                   # syncs the card
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(float(met["grad_norm"]))
        if "dropped_frac" in met:
            dropped.append(float(met["dropped_frac"]))
        log(f"[{tag}] step {i:3d} loss {loss:.4f} grad norm "
            f"{norms[-1]:.4f}" + (f" dropped {dropped[-1]:.4f}" if dropped
                                  else "") + f" {times[-1] * 1e3:.1f} ms"
            + (" (overlaps the checkpoint write)" if overlapped
               and overlapped[-1] == i else ""))
        if i + 1 == ft_save_at:
            ft = _ft_save(torch, params, opt, i + 1)
    launches, plain = _counters()
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    if ref is None and run == steps:
        check(sum(losses[-5:]) / 5 < losses[0],
              f"the loss did not fall: {losses}")
    elif ref is not None:
        want_l = ref["losses"][:run]
        check(all(math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-4)
                  for a, b in zip(losses, want_l)),
              f"[{tag}] losses {losses} != remat full's {want_l} (1e-4)")
        log(f"[{tag}] losses equal remat full's first {run} within 1e-4 "
            f"(bitwise: {losses == want_l}): {losses} vs {want_l}")
    # remat full and dots replay the attention forward in the backward
    replay = 1 + (cfg.remat != "none")
    # K3 is two kernels per call: the row walk and the owner-tile sum; one
    # call of each per attention layer (a griffin group has one; whisper's
    # encoder layers count too)
    n_attn = _train_attention_layers(cfg)
    want = {"K1": replay * n_attn * run, "K2": n_attn * run,
            "K3": 2 * n_attn * run}
    check(launches == want, f"launches {launches} != {want}")
    check(plain == 0, f"the plain versions ran {plain} times")
    timed = [t for i, t in enumerate(times) if i and i not in overlapped]
    med = sorted(timed)[len(timed) // 2]
    if overlapped:
        log(f"[{tag}] steps {overlapped} overlapped the background "
            f"checkpoint write: left out of the median "
            f"({[round(times[i] * 1e3, 3) for i in overlapped]} ms)")
    log(f"[{tag}] step median {med * 1e3:.3f} ms over steps 1..{run - 1} "
        f"({batch * seq / med:.1f} tokens/s); first step "
        f"{times[0] * 1e3:.3f} ms; peak memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated); launches {launches} "
        f"({ {k: v // run for k, v in launches.items()} } a step); the "
        f"batch drawn on the host before each step's clock: median "
        f"{sorted(draws)[run // 2] * 1e3:.3f} ms; caching-allocator "
        f"retries (cached blocks freed, the device synchronized) "
        f"{retries} over the {run} steps")
    stats = dict(losses=losses, median_ms=med * 1e3, peak=peak,
                 dropped=dropped)
    if ref is not None:
        log(f"[{tag}] step median {med * 1e3:.3f} ms against remat full's "
            f"{ref['median_ms']:.3f}; peak {peak / 2**30:.3f} GiB against "
            f"{ref['peak'] / 2**30:.3f} GiB (remat full's includes "
            f"train-ft's clone)")

    # After the counts are read: one more step under the profiler.
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    batch_np = ds.batch(run)
    torch.cuda.synchronize()
    prof.start()
    ts = time.perf_counter()
    params, opt, met, _ = step(params, opt, batch_np)
    float(met["loss"])
    dt = time.perf_counter() - ts
    prof.stop()
    by_name = report_profile(prof, dt, 1, "train step")
    # the training kernels' device time per step; K3 is its row walk and
    # its owner-tile sum
    parts = {"K1": ("table_attention_mma_kernel", "table_attention_kernel"),
             "K2": ("dq_mma_kernel", "dq_kernel"),
             "K3": ("dkv_mma_kernel", "dkv_kernel", "owner_sum_kernel")}
    per = {key: sum(t for name, (_, t) in by_name.items()
                    if any(f"::{k}<" in name or f"::{k}(" in name
                           for k in keys)) / 1e3
           for key, keys in parts.items()}
    log(f"[profile] train kernels per step: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in per.items())
        + f"; K2 + K3 {per['K2'] + per['K3']:.3f} ms")
    log(f"[{tag}] phase wall {time.perf_counter() - t_phase:.1f} s")
    if ft is not None:
        ft.update(cfg=cfg, step_fn=step, ds=ds,
                  ref={i: (losses[i], norms[i]) for i in range(ft_save_at,
                                                              steps)})
    return launches, ft, stats


def _ft_save(torch, params, opt, at: int) -> dict:
    """train-ft, first half: {"params", "opt"} at step ``at`` through an
    async CheckpointManager under ``build/`` (the device-to-host copy on
    this thread, the write in the background), and a clone on the card."""
    import shutil

    from repro_torch.ft import CheckpointManager
    from repro_torch.tree import tree_flatten_with_path, tree_unflatten

    ckdir = ROOT / "build" / "ft_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = CheckpointManager(str(ckdir), keep=1, async_write=True)
    state = {"params": params, "opt": opt}
    flat, treedef = tree_flatten_with_path(state)
    clone = tree_unflatten(treedef, [x.clone() if torch.is_tensor(x) else x
                                     for _, x in flat])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(state, at)
    snap_ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(x.numel() * x.element_size() for _, x in flat
                 if torch.is_tensor(x))
    log(f"[train-ft] checkpoint of step {at} handed to the background "
        f"writer: synchronous snapshot (device to host) {snap_ms:.3f} ms; "
        f"the clone kept on the card adds {nbytes} bytes to the phase's "
        f"peak memory")
    return dict(mgr=mgr, dir=ckdir, at=at, clone=clone, snapshot_ms=snap_ms)


def phase_train_ft(torch, seed, ft) -> dict:
    """train-ft, second half: the checkpoint restored into a freshly
    initialised state must equal the clone bit for bit (every parameter,
    m, v, and the step as an int, each on the card in its dtype); steps
    ``at`` and ``at + 1`` replayed from it must give the train phase's
    losses and grad norms bit for bit. Removes the checkpoint. Returns the
    replay's launch counts."""
    import shutil

    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_flatten_with_path

    mgr, at, cfg = ft["mgr"], ft["at"], ft["cfg"]
    try:
        mgr.wait()
        nbytes = _dir_bytes(ft["dir"])
        params0 = build_model(cfg, "cuda").init(
            torch.Generator(device="cuda").manual_seed(seed + 1))
        like = {"params": params0,
                "opt": adamw.init(adamw.AdamWConfig(), params0)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step_at = mgr.restore_latest(like)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    finally:
        shutil.rmtree(ft["dir"], ignore_errors=True)
    check(step_at == at, f"[train-ft] restored step {step_at}, want {at}")
    got, want = (tree_flatten_with_path(t)[0] for t in (state, ft["clone"]))
    check([p for p, _ in got] == [p for p, _ in want],
          "[train-ft] restored tree differs in structure")
    for (path, a), (_, b) in zip(got, want):
        if torch.is_tensor(b):
            check(a.is_cuda and a.dtype == b.dtype and torch.equal(a, b),
                  f"[train-ft] {'::'.join(path)} not bit-equal on the card")
        else:
            check(type(a) is int and a == b == at,
                  f"[train-ft] {'::'.join(path)}: {a!r} != {b!r}")
    params, opt = state["params"], state["opt"]
    del like, params0
    _counters(reset=True)
    replay = {}
    for i in (at, at + 1):
        params, opt, met, _ = ft["step_fn"](params, opt, ft["ds"].batch(i))
        replay[i] = (float(met["loss"]), float(met["grad_norm"]))
    launches, plain = _counters()
    check(plain == 0 and min(launches.values()) > 0,
          f"[train-ft] launches {launches}, plain {plain}")
    for i, got_i in replay.items():
        check(got_i == ft["ref"][i],
              f"[train-ft] step {i} replayed (loss, grad norm) {got_i} != "
              f"the train phase's {ft['ref'][i]}")
    log(f"[train-ft] checkpoint {nbytes} bytes on disk; synchronous "
        f"snapshot {ft['snapshot_ms']:.3f} ms, background write "
        f"{mgr.write_s:.3f} s, restore {restore_ms:.3f} ms; restored state "
        f"bit-equal to the clone (step {step_at}); steps {at}, {at + 1} "
        f"replayed bit-equal: {replay}; launches {launches}")
    return launches


# --------------------------------------------------------------------- #
# Sequence-parallel training (dist/sharded_plan.py): S ranks through
# dist.group.run_ranks, each holding one contiguous slice of every
# sequence; the halo exchange feeds K1-K3 on each shard's view tables.
TRAIN_SHARDS = 2
# train-sharded smollm-135m and longformer-4k: the train phase's first 2
# and 3 steps (cut for time from 3 and 4 with the MoE phases; ROADMAP
# item 1 undoes it)
SHARDED_STEPS = {"smollm-135m": 2, "longformer-4k": 3}
# the one-layer gate's pattern per arch: the model's own (None), or the
# paper's bidirectional Longformer layer with its global row (the
# longformer-4k LM trains on its causal form, as the reference's does)
SHARDED_GATE = {"smollm-135m": None, "longformer-4k": ("lf", 512, 1)}
TRAIN_SHARD_TIMEOUT_S = 600.0
# train-sharded smollm-135m dilation 2: the reordered schedule (the working
# stream's stride exchange across shards) at smollm-135m's full size, the
# dilation of its SALOConfig raised (no published config sets one), its
# steps SHARDED_STEPS["smollm-135m"], held to an unsharded run of the same
# config and steps on the card
SHARDED_DILATION = 2
# the collectives of a sharded train step by profiler name: the point-to-
# point halo sends and receives and the all_reduces
P2P_KEYS = ("all_reduce", "allreduce", "send", "recv")
# the stride exchange's all_to_alls, and every collective the profiler
# names (the process group's ops and each backend's spans)
A2A_KEYS = ("all_to_all", "alltoall")
COLLECTIVE_KEYS = ("c10d::", "gloo:", "nccl:")
# train-sharded-moe: the first steps of EP_SCHED's schedule it runs
# against the unsharded run of its cut, and its collectives by profiler
# name (the halo's, the all_reduces and the router logits' all_gathers)
SEQ_MOE_STEPS = 2
SEQ_MOE_KEYS = P2P_KEYS + ("all_gather", "allgather")


def _digest(torch, *trees) -> str:
    """sha256 of every leaf's bytes, in tree order: equal digests on two
    ranks mean bitwise-equal state."""
    import hashlib

    from repro_torch.tree import tree_leaves

    h = hashlib.sha256()
    for tree in trees:
        for x in tree_leaves(tree):
            h.update(x.detach().contiguous().reshape(-1).view(torch.uint8)
                     .cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_prelude(torch) -> None:
    """What main() sets for itself, in a spawned rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _seq_moe_check_cfg():
    """train-sharded-check's MoE config: the narrowed f32 kimi-k2 of the
    MoE checks (384 experts top-8, the shared expert, the leading dense
    layer) with 2 dispatch groups, so at seq 128, batch 2 on 2 shards
    each group is one sequence split over both shards."""
    import dataclasses

    cfg = _moe_check_cfgs()["kimi-k2-1t-a32b"]
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=2))


def sharded_check_rank(group, seed, cfg, params, keys=("loss",)):
    """A rank of train-sharded-check: ``cfg`` trained 3 steps under the
    group from ``params`` (seq 128, batch 2, as train_check). Returns the
    metrics ``keys`` of each step, the rank's launch counts and the digest
    of its parameters and optimizer state."""
    import torch

    _rank_prelude(torch)
    dev = str(group.device)
    p = _to(params, dev)
    step, opt, ds = _trainer(cfg, dev, p, seq=128, batch=2, steps=3,
                             lr=3e-3, warmup=1, seed=seed, group=group)
    _counters(reset=True)
    hist = []
    for i in range(3):
        p, opt, met, _ = step(p, opt, ds.batch(i))
        hist.append(tuple(float(met[k]) for k in keys))
    launches, plain = _counters()
    return dict(hist=hist, launches=launches, plain=plain,
                digest=_digest(torch, p, opt.m, opt.v))


def _sharded_check_inputs(torch, seed) -> dict:
    """train-sharded-check's configs, their parameters (on the CPU, from
    ``seed``), the metrics each step keeps and the unsharded runs they are
    held to: the narrowed f32 smollm (train_check's) and longformer (hd
    64) unsharded on the card, the MoE config of ``_seq_moe_check_cfg``
    unsharded on the CPU (the plain versions: cuda == cpu), and the
    recurrent checks of ``_recurrent_check_cfgs`` (recurrentgemma's one
    griffin group at hd 256, window 32; mamba2 at smoke widths, chunk 16)
    unsharded on both, their losses and grad norms kept, and the narrowed
    smollm at dilation 2 (a reordered schedule: the stride exchange,
    each rank's working slice one residue class of 64 slots with a halo
    tile and a global tile) unsharded on both. {name: (cfg, params, keys,
    {where: reference steps})}."""
    from repro_torch.configs import with_dilation
    from repro_torch.models.model import build_model

    rec = _recurrent_check_cfgs()
    out = {}
    for name, cfg, devs in (
            ("smollm-135m", _train_cfg(smoke=True), ("cuda",)),
            ("longformer-4k", _check_cfgs()["longformer-4k"], ("cuda",)),
            ("kimi-k2-1t-a32b", _seq_moe_check_cfg(), ("cpu",)),
            *((arch, cfg, ("cuda", "cpu")) for arch, cfg in rec.items()),
            (f"smollm-135m-dilation-{SHARDED_DILATION}",
             with_dilation(_train_cfg(smoke=True), SHARDED_DILATION),
             ("cuda", "cpu"))):
        keys = ("loss",) + (AUX if cfg.moe is not None else ()) \
            + (("grad_norm",) if cfg.recurrent or cfg.ssm else ())
        params = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        refs = {}
        for dev in devs:
            p = _to(params, dev)
            step, opt, ds = _trainer(cfg, dev, p, seq=128, batch=2, steps=3,
                                     lr=3e-3, warmup=1, seed=seed)
            refs[dev] = []
            for i in range(3):
                p, opt, met, _ = step(p, opt, ds.batch(i))
                refs[dev].append(tuple(float(met[k]) for k in keys))
        out[name] = (cfg, params, keys, refs)
    return out


def sharded_checks_rank(group, seed, checks):
    """A rank of train-sharded-check: ``sharded_check_rank`` for each of
    ``checks`` ({name: (cfg, params, keys)}). Returns {name: its
    record}."""
    return {name: sharded_check_rank(group, seed, cfg, params, keys)
            for name, (cfg, params, keys) in checks.items()}


def sharded_check_job(torch, seed):
    """train-sharded-check's half before its ranks: the unsharded runs
    (``_sharded_check_inputs``) and the ranks' job
    (``sharded_checks_rank``), with what ``report_sharded_checks``
    reads."""
    checks = _sharded_check_inputs(torch, seed)
    backend, device = _shard_backend(torch, TRAIN_SHARDS)
    return ((sharded_checks_rank, ({name: c[:3]
                                    for name, c in checks.items()},)),
            report_sharded_checks,
            dict(checks=checks, backend=backend, device=device))


def _close(got, want, tol) -> bool:
    """Every metric of every step of ``got`` within ``tol`` (abs and rel)
    of ``want``'s."""
    return all(math.isclose(a, b, rel_tol=tol, abs_tol=tol)
               for h, w in zip(got, want) for a, b in zip(h, w))


def report_sharded_checks(recs, st, wall) -> dict:
    """Gate and print train-sharded-check: every rank's losses (and an
    MoE config's aux metrics, a recurrent config's grad norms) within
    1e-4 of each unsharded run's (a recurrent config's on the card and on
    the CPU, which agree within 1e-4 too), parameters and optimizer state
    bitwise equal across the ranks, K1-K3 launched on every rank of a
    program with attention (none in mamba2's) and no plain version.
    Returns {path: launches summed over the ranks}."""
    backend, device = st["backend"], st["device"]
    out = {}
    for name, (cfg, _, keys, refs) in st["checks"].items():
        res = [r[name] for r in recs]
        if len(refs) > 1:
            check(_close(refs["cuda"], refs["cpu"], 1e-4),
                  f"train-sharded-check {name}: unsharded cuda "
                  f"{refs['cuda']} != cpu {refs['cpu']} (1e-4)")
        attn = _attention_layers(cfg) > 0
        for r, rec in enumerate(res):
            for dev, ref in refs.items():
                check(_close(rec["hist"], ref, 1e-4),
                      f"train-sharded-check {name} rank {r}: {keys} "
                      f"{rec['hist']} != unsharded {ref} on the {dev} "
                      f"(1e-4)")
            check(rec["plain"] == 0 and (
                min(rec["launches"].values()) > 0 if attn
                else max(rec["launches"].values()) == 0),
                  f"train-sharded-check {name} rank {r}: launches "
                  f"{rec['launches']}, plain {rec['plain']}")
        check(len({rec["digest"] for rec in res}) == 1,
              f"train-sharded-check {name}: parameters or optimizer state "
              f"differ across the ranks")
        extra = "" if cfg.moe is None else (
            f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
            f"{cfg.moe.dispatch_groups} dispatch groups of 128 tokens, "
            f"each split over the {TRAIN_SHARDS} shards")
        unsharded = "; ".join(f"on the {dev} {ref}"
                              for dev, ref in refs.items())
        log(f"[train-sharded-check] {name} d {cfg.d_model} hd {cfg.hd} "
            f"f32{extra}, {TRAIN_SHARDS} ranks on backend {backend} "
            f"({device or 'one card a rank'}): {keys} per step "
            f"{res[0]['hist']} vs unsharded {unsharded} (within 1e-4); "
            f"state bitwise equal across the ranks; launches a rank "
            f"{res[0]['launches']}")
        out[f"train-sharded-check-{name}"] = {
            k: sum(rec["launches"][k] for rec in res) for k in ("K1", "K2",
                                                               "K3")}
    log(f"[train-sharded-check] {wall:.1f} s on rank 0")
    return out


def _layer_gate(torch, group, cfg, seed, spec=None):
    """One layer's attention at the train shapes (8 x H flat heads, n 4096,
    bf16): ``sharded_attention`` forward and backward on this rank's
    slice — the exchange and K1-K3 on the view — against unsharded
    ``salo_attention`` on the whole sequence, this rank's slice of out and
    of dq/dk/dv within ``OUT_TOL`` / ``GRAD_TOL``. ``spec``: a
    ``_case_pattern`` spec, else the model's pattern. Returns (errs, ok)."""
    from repro_torch.dist.sharded_plan import sharded_attention
    from repro_torch.kernels import salo_attention as KA
    from repro_torch.kernels.ops import salo_attention
    from repro_torch.models.layers import salo_pattern

    dev = group.device
    pat = salo_pattern(cfg) if spec is None else _case_pattern(spec)
    BH, N, D = TRAIN_BATCH * cfg.n_heads, 4096, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(seed + 400)
    full = [torch.randn((BH, N, D), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(4)]
    n = N // group.size
    sl = slice(group.index * n, (group.index + 1) * n)
    bq, bk = cfg.salo.block_q, cfg.salo.block_k
    q, k, v = (x[:, sl].contiguous().requires_grad_() for x in full[:3])
    out = sharded_attention(q, k, v, pat, group, block_q=bq, block_k=bk)
    grads = torch.autograd.grad(out, (q, k, v), full[3][:, sl].contiguous())
    qf, kf, vf = (x.detach().requires_grad_() for x in full[:3])
    ref = salo_attention(qf, kf, vf, pat, bq, bk)
    rgrads = torch.autograd.grad(ref, (qf, kf, vf), full[3])
    tol, gtol = KA.OUT_TOL[torch.bfloat16], GRAD_TOL["bfloat16"]
    errs, ok = {}, True
    for what, a, b, tl in (("out", out, ref[:, sl], tol),
                           *((f"d{w}", g, rg[:, sl], gtol) for w, g, rg in
                             zip("qkv", grads, rgrads))):
        a, b = a.detach().float(), b.detach().float()
        errs[what] = float((a - b).abs().max())
        ok = ok and bool(torch.isfinite(a).all()) and bool(
            torch.allclose(a, b, atol=tl, rtol=tl))
    return errs, ok


def _sharded_tag(arch: str, dilation: int = 1) -> str:
    if dilation > 1:
        return f"train-sharded {arch} dilation {dilation}"
    return "train-sharded" + ("" if arch == "smollm-135m" else f" {arch}")


def train_sharded_rank(group, seed, arch, steps, dilation=1):
    """A spawned rank of a full-size train-sharded phase: the one-layer
    gate, then ``arch`` at full width and depth (its attention at
    ``dilation``), bf16, remat full, seq 4096, global batch
    ``TRAIN_BATCH``, ``steps`` steps of the train phase's schedule (20
    steps, lr 3e-3, warmup 10) from the same seed, then one more step,
    profiled on rank 0 (every collective by profiler name). Returns the
    rank's record."""
    import torch

    from repro_torch.configs import get_config, with_dilation
    from repro_torch.models.model import build_model

    _rank_prelude(torch)
    tag = _sharded_tag(arch, dilation)
    dev = str(group.device)
    cfg = with_dilation(get_config(arch), dilation)
    gate_errs, gate_ok = _layer_gate(torch, group, cfg, seed,
                                     SHARDED_GATE[arch])
    torch.cuda.empty_cache()
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=TRAIN_BATCH,
                             steps=TRAIN_STEPS, lr=3e-3, warmup=10,
                             seed=seed, group=group)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, times = [], []
    for i in range(steps):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, _ = step(params, opt, batch)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        if group.index == 0:
            log(f"[{tag}] rank 0 step {i} loss {losses[-1]:.4f} grad norm "
                f"{float(met['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms")
    launches, plain = _counters()
    peak = torch.cuda.max_memory_allocated()
    rec = dict(losses=losses, times=times, launches=launches, plain=plain,
               peak=peak, gate_errs=gate_errs, gate_ok=gate_ok,
               digest=_digest(torch, params, opt.m, opt.v))
    batch = ds.batch(steps)
    torch.cuda.synchronize()
    prof = None
    if group.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    params, opt, met, _ = step(params, opt, batch)
    float(met["loss"])
    dt = time.perf_counter() - ts
    if prof is not None:
        prof.stop()
        by_name = report_profile(prof, dt, 1, f"{tag} step (rank 0)")
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(profiled_ms=dt * 1e3, idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, COLLECTIVE_KEYS))
    return rec


def seq_train_rank(group, seed, run):
    """A rank of a sequence-parallel train run at full width with its
    depth cut (every rank holds every weight): ``run["cfg"]``, bf16,
    remat full, this rank's slice of every sequence at seq 4096, the
    batch and schedule of ``run["sched"]`` ``(batch, steps, lr,
    warmup)``, its first ``run["steps"]`` steps from the seed, then one
    more step, profiled on rank 0 (collectives by the profiler names
    ``run["keys"]``). train-sharded-moe (arctic-480b at the cut expert
    count) and train-sharded mamba2-370m. Returns the rank's record."""
    import torch

    from repro_torch.models.model import build_model

    _rank_prelude(torch)
    dev = str(group.device)
    cfg, tag = run["cfg"], run["tag"]
    batch_n, sched_steps, lr, warmup = run["sched"]
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=batch_n,
                             steps=sched_steps, lr=lr, warmup=warmup,
                             seed=seed, group=group)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, dropped, times = [], [], []
    for i in range(run["steps"]):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, _ = step(params, opt, batch)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        if "dropped_frac" in met:
            dropped.append(float(met["dropped_frac"]))
        if group.index == 0:
            log(f"[{tag}] rank 0 step {i} loss {losses[-1]:.4f} grad norm "
                f"{float(met['grad_norm']):.4f}" + (
                    f" dropped {dropped[-1]:.4f}" if dropped else "")
                + f" {times[-1] * 1e3:.1f} ms")
    launches, plain = _counters()
    rec = dict(losses=losses, dropped=dropped, times=times,
               launches=launches, plain=plain,
               peak=torch.cuda.max_memory_allocated(),
               digest=_digest(torch, params, opt.m, opt.v))
    batch = ds.batch(run["steps"])
    torch.cuda.synchronize()
    prof = None
    if group.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    params, opt, met, _ = step(params, opt, batch)
    float(met["loss"])
    dt = time.perf_counter() - ts
    if prof is not None:
        prof.stop()
        by_name = report_profile(prof, dt, 1, f"{tag} {cfg.name} step "
                                 f"(rank 0)")
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(profiled_ms=dt * 1e3, idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, run["keys"]))
    return rec


def _log_sharded_stats(arch, dilation=1) -> None:
    """``ShardedPlan.stats`` of ``arch``'s attention (at ``dilation``) and
    of its one-layer gate's at n 4096 over ``TRAIN_SHARDS``: the
    exchange's bytes against an all-gather's, as counted; on a reordered
    schedule also the stride exchange's (``seq_stride_bytes``)."""
    from repro_torch.configs import get_config, with_dilation
    from repro_torch.core.scheduler import build_plan, schedule
    from repro_torch.dist.sharded_plan import _auto_block, shard_plan
    from repro_torch.models.layers import salo_pattern

    tag = _sharded_tag(arch, dilation)
    S = TRAIN_SHARDS
    cfg = with_dilation(get_config(arch), dilation)
    for what, pat in (("model", salo_pattern(cfg)),
                      ("gate", salo_pattern(cfg) if SHARDED_GATE[arch] is None
                       else _case_pattern(SHARDED_GATE[arch]))):
        sched = schedule(pat, 4096)
        b = _auto_block(sched.n_work, S, cfg.salo.block_q)
        sp = shard_plan(build_plan(sched, b, b, S * b), S)
        st = sp.stats(cfg.hd)
        heads = TRAIN_BATCH * cfg.n_heads
        log(f"[{tag}] ShardedPlan.stats({cfg.hd}) of the {what}'s attention "
            f"{pat} at n 4096, {S} shards, blocks {b}: view {sp.nkb_l} "
            f"local + {sp.halo_counts} halo (distances {sp.halo_dists}) + "
            f"{sp.n_gt} global tiles; per flat head and layer {st}; per "
            f"layer over {heads} flat heads: exchange "
            f"{st['exchange_bytes'] * heads} bytes vs all-gather "
            f"{st['allgather_bytes'] * heads} (counted, not timed)")
    if dilation > 1:
        sb = seq_stride_bytes(cfg, TRAIN_BATCH)
        log(f"[{tag}] the stride exchange (the working stream across "
            f"{S} shards, bf16): a rank sends {sb['tensor']} bytes of each "
            f"exchanged tensor to the other ranks; per layer forward "
            f"{sb['forward']} (q, k, v, out), backward {sb['backward']} "
            f"(dout, dq, dk, dv), remat full's replay {sb['replay']}; "
            f"{sb['step']} bytes a step a rank over {cfg.n_layers} layers "
            f"(counted from the shapes, not timed)")


def seq_stride_bytes(cfg, batch: int, n: int = TRAIN_SHARDS,
                     seq: int = 4096) -> dict:
    """The bytes a rank sends the other ranks through the stride exchange
    of ``cfg``'s attention at ``seq`` (``dist.sharded_plan
    .stride_exchange``'s counts, rank 0; bf16 over ``batch`` x n_heads
    flat heads of hd): one tensor, a layer forward (4 tensors), backward
    (4) and remat full's replay (4), and a step."""
    from repro_torch.core.scheduler import build_plan, schedule
    from repro_torch.dist.sharded_plan import _auto_block, stride_exchange
    from repro_torch.models.layers import salo_pattern

    sched = schedule(salo_pattern(cfg), seq)
    b = _auto_block(sched.n_work, n, cfg.salo.block_q)
    ex = stride_exchange(build_plan(sched, b, b, n * b), n)
    rows = int(ex.counts[0].sum() - ex.counts[0, 0])
    tensor = rows * batch * cfg.n_heads * cfg.hd * 2
    layer = dict(forward=4 * tensor, backward=4 * tensor,
                 replay=4 * tensor * (cfg.remat != "none"))
    return dict(tensor=tensor, **layer,
                step=sum(layer.values()) * cfg.n_layers)


def train_sharded_job(torch, seed, arch, ref, dilation=1):
    """One train-sharded run's half before its ranks: ``arch``'s
    ``ShardedPlan.stats`` (at ``dilation``) and the ranks' job
    (``train_sharded_rank``), with what ``report_train_sharded`` reads
    (``ref``: the unsharded train phase's stats, of the same config)."""
    _log_sharded_stats(arch, dilation)
    backend, device = _shard_backend(torch, TRAIN_SHARDS)
    return ((train_sharded_rank, (arch, SHARDED_STEPS[arch], dilation)),
            report_train_sharded,
            dict(arch=arch, ref=ref, backend=backend, device=device,
                 dilation=dilation))


def report_train_sharded(recs, st, wall) -> dict:
    """Gate and print one train-sharded run (``train_sharded_rank``'s
    records). ``st["ref"]``: the unsharded train phase's stats (same
    seed, weights, batches and schedule). Gates: every rank's one-layer gate;
    the step-0 loss within 5e-3 of the unsharded phase's step 0 and every
    step within 2e-2 of it, the loss falling; equal losses and bitwise-
    equal parameters and optimizer state on every rank; per rank and step
    2 K1 (the forward and remat full's replay), 1 K2 and 1 K3 call (2
    kernels) an attention layer, no plain version; rank 0's profiled step
    ran no collective but the all_reduces, the halo's sends and receives
    and, on a reordered schedule (``st["dilation"]`` > 1), exactly
    ``launch_lint.stride_exchanges`` all_to_alls an attention layer (none
    otherwise), counted by the process group's op name. Returns {path:
    the launches summed over the ranks}."""
    from repro_torch.analysis.launch_lint import stride_exchanges
    from repro_torch.configs import get_config, with_dilation

    arch, ref, dil = st["arch"], st["ref"], st["dilation"]
    backend, device = st["backend"], st["device"]
    tag = _sharded_tag(arch, dil)
    S = TRAIN_SHARDS
    cfg = with_dilation(get_config(arch), dil)
    steps = len(recs[0]["losses"])
    want_l = ref["losses"][:steps]
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * steps, "K2": n_attn * steps,
            "K3": 2 * n_attn * steps}
    r0 = recs[0]
    for r, rec in enumerate(recs):
        check(rec["gate_ok"], f"{tag} rank {r}: one layer's sharded "
              f"attention vs unsharded salo_attention: errs "
              f"{rec['gate_errs']} (OUT_TOL / GRAD_TOL bf16)")
        check(rec["losses"] == r0["losses"],
              f"{tag}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{tag} rank {r}: launches {rec['launches']} != {want}, "
              f"plain {rec['plain']}")
    losses = r0["losses"]
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(abs(losses[0] - want_l[0]) <= 5e-3,
          f"{tag}: step-0 loss {losses[0]} vs unsharded {want_l[0]} (5e-3)")
    check(all(abs(a - b) <= 2e-2 for a, b in zip(losses, want_l)),
          f"{tag}: losses {losses} vs unsharded {want_l} (2e-2)")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    check(len({rec["digest"] for rec in recs}) == 1,
          f"{tag}: parameters or optimizer state differ across the ranks")
    stray = [n for n in r0["collectives"]
             if not any(k in n.lower() for k in P2P_KEYS + A2A_KEYS)]
    check(not stray, f"{tag}: the profiled step ran collectives beyond the "
          f"halo's, the sums and the stride exchange: {stray}")
    a2a = sum(c for n, (c, _) in r0["collectives"].items()
              if n.startswith("c10d::") and any(k in n.lower()
                                                for k in A2A_KEYS))
    want_a2a = stride_exchanges(cfg) * n_attn if dil > 1 else 0
    check(a2a == want_a2a, f"{tag}: the profiled step ran {a2a} "
          f"all_to_alls, expected {want_a2a} ({n_attn} attention layers)")
    med = sorted(r0["times"][1:])[(steps - 1) // 2] * 1e3
    coll = ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    log(f"[{tag}] {arch} bf16 remat full, {S} ranks on backend {backend} "
        f"({device or 'one card a rank'}), seq 4096 = {S} x {4096 // S}, "
        f"global batch {TRAIN_BATCH}, {steps} steps of a {TRAIN_STEPS}-step "
        f"schedule: {wall:.1f} s on rank 0; one-layer gate errs "
        f"{[rec['gate_errs'] for rec in recs]}; losses {losses} vs "
        f"unsharded {want_l} (max diff "
        f"{max(abs(a - b) for a, b in zip(losses, want_l))}); state "
        f"bitwise equal across the ranks; launches a rank {r0['launches']}")
    log(f"[{tag}] step median {med:.3f} ms over steps 1..{steps - 1} "
        f"(rank 0; unsharded {ref['median_ms']:.3f} ms); peak per rank "
        f"{[round(rec['peak'] / 2**30, 3) for rec in recs]} GiB "
        f"(unsharded {ref['peak'] / 2**30:.3f} GiB); profiled step (rank "
        f"0): host wall {r0['profiled_ms']:.3f} ms, device idle share "
        f"{r0['idle']:.3f}, collectives by name (host time): {coll}")
    if dil > 1:
        sb = seq_stride_bytes(cfg, TRAIN_BATCH)
        log(f"[{tag}] stride exchange: {a2a} all_to_alls in the profiled "
            f"step ({stride_exchanges(cfg)} a layer), {sb['step']} bytes a "
            f"rank sends the other rank a step (counted from the shapes)")
    return {tag.replace(" ", "-"): {k: sum(rec["launches"][k] for rec in recs)
                                    for k in ("K1", "K2", "K3")}}


def seq_moe_experts(torch, arch: str, n: int = TRAIN_SHARDS) -> int:
    """train-sharded-moe's expert count: every rank of a sequence group
    holds every weight, so the largest count (at least top-k, at most the
    published one) whose reckoned peak (``train_bytes`` at the rank's
    4096 / n tokens, ``EP_DEPTH`` layers), times the ``n`` ranks sharing
    the card, fits ``EP_BUDGET`` of it, and whose unsharded run (the
    phase's reference) fits it too. Prints the reckoning."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    total = torch.cuda.get_device_properties(0).total_memory
    budget = EP_BUDGET * total
    batch_n = EP_SCHED[0]

    def peaks(E):
        cfg = _ep_cfg(arch, E)
        return (n * train_bytes(cfg, 4096 // n, batch_n)["peak"],
                train_bytes(cfg, 4096, batch_n)["peak"])
    pick = 0
    for E in range(full.moe.top_k, full.moe.n_experts + 1):
        if max(peaks(E)) > budget:
            break
        pick = E
    check(pick > 0, f"no expert count of {arch} fits {n} whole copies on "
          f"the card")
    got, one = peaks(pick)
    log(f"[train-sharded-moe {arch}] reckoned: every rank of a sequence "
        f"group of {n} holds every weight, so {pick} of "
        f"{full.moe.n_experts} experts fit {budget / 1e9:.2f} GB "
        f"({EP_BUDGET:.0%} of {total / 1e9:.2f}): {n} ranks at "
        f"{4096 // n} tokens each peak at {got / 1e9:.2f} GB, the unsharded "
        f"run at {one / 1e9:.2f} GB; {pick + 1} experts would take "
        f"{max(peaks(pick + 1)) / 1e9:.2f} GB; {EP_DEPTH[arch]} of "
        f"{full.n_layers} layers")
    return pick


def seq_moe_inputs(torch, seed, arch="arctic-480b") -> dict:
    """What train-sharded-moe compares with, run here first: ``arch`` at
    every published width, ``EP_DEPTH`` layers and the expert count
    ``seq_moe_experts`` picks, unsharded on the card over the phase's
    first ``SEQ_MOE_STEPS`` steps of ``EP_SCHED``'s schedule from the
    same seed (``phase_train``: the launch counts). Returns the phase's
    plan."""
    E = seq_moe_experts(torch, arch)
    cfg = _ep_cfg(arch, E)
    batch_n, sched_steps, lr, warmup = EP_SCHED
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train-sharded-moe {arch}] the unsharded reference: {E} experts, "
        f"{cfg.n_layers} layer(s), seq 4096 batch {batch_n}, the phase's "
        f"seed, schedule and steps")
    ref_launches, _, ref = phase_train(
        torch, seed, arch, cfg=cfg, steps=sched_steps, batch=batch_n, lr=lr,
        warmup=warmup, run=SEQ_MOE_STEPS)
    return dict(arch=arch, cfg=cfg, ref=ref, ref_launches=ref_launches,
                rank_args=dict(cfg=cfg, sched=EP_SCHED, steps=SEQ_MOE_STEPS,
                               tag="train-sharded-moe", keys=SEQ_MOE_KEYS))


def seq_moe_job(torch, seed, moe):
    """train-sharded-moe's half before its ranks: the ranks' job
    (``seq_train_rank``) with what ``report_seq_moe`` reads (``moe``:
    ``seq_moe_inputs``'s plan)."""
    backend, device = _shard_backend(torch, TRAIN_SHARDS)
    return ((seq_train_rank, (moe["rank_args"],)), report_seq_moe,
            dict(moe=moe, backend=backend, device=device))


def report_seq_moe(recs, st, wall) -> dict:
    """Gate and print train-sharded-moe (``seq_train_rank``'s records)
    against the unsharded run of the same cut: the step-0 loss within
    5e-3 and every step within 2e-2 (train-sharded's limits), equal
    losses and bitwise-equal parameters and optimizer state on every
    rank, per rank and step 2 K1, 1 K2 and 1 K3 call an attention layer,
    no plain version. Prints rank 0's step median and idle share, the
    peak per rank, the collectives by profiler name and the router
    logits' gather bytes, counted from the shapes. Returns {path: the
    launches summed over the ranks}."""
    from repro_torch.models import moe as M
    from repro_torch.models.transformer import MOE_KINDS, make_program

    moe, backend, device = st["moe"], st["backend"], st["device"]
    tag = "train-sharded-moe"
    cfg, ref, S = moe["cfg"], moe["ref"], TRAIN_SHARDS
    r0 = recs[0]
    losses = r0["losses"]
    steps = len(losses)
    want_l = ref["losses"][:steps]
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * steps, "K2": n_attn * steps,
            "K3": 2 * n_attn * steps}
    for r, rec in enumerate(recs):
        check(rec["losses"] == losses,
              f"{tag}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{tag} rank {r}: launches {rec['launches']} != {want}, "
              f"plain {rec['plain']}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(abs(losses[0] - want_l[0]) <= 5e-3,
          f"{tag}: step-0 loss {losses[0]} vs unsharded {want_l[0]} (5e-3)")
    check(all(abs(a - b) <= 2e-2 for a, b in zip(losses, want_l)),
          f"{tag}: losses {losses} vs unsharded {want_l} (2e-2)")
    check(len({rec["digest"] for rec in recs}) == 1,
          f"{tag}: parameters or optimizer state differ across the ranks")
    batch_n = EP_SCHED[0]
    T = 4096 * batch_n
    E = cfg.moe.n_experts
    G = M.n_groups(cfg, T)
    layers = sum(k for kind, k in make_program(cfg) if kind in MOE_KINDS)
    # each MoE layer gathers the (T / S, E) f32 logits of every rank, in
    # its forward and again in remat full's replay
    gather = (S - 1) * (T // S) * E * 4
    layout = ("some split over the shards" if batch_n * S > G
              else "each on one shard")
    med = sorted(r0["times"][1:])[(steps - 1) // 2] * 1e3
    coll = ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    log(f"[{tag}] {moe['arch']} bf16 remat full, every published width, "
        f"{cfg.n_layers} layer(s), {E} experts top-{cfg.moe.top_k} (every "
        f"rank holds all), {S} ranks on backend {backend} "
        f"({device or 'one card a rank'}), seq 4096 = {S} x {4096 // S}, "
        f"batch {batch_n}: {G} dispatch groups of {T // G} tokens, "
        f"{layout}; "
        f"{steps} steps of a {EP_SCHED[1]}-step schedule: "
        f"{wall:.1f} s on rank 0; losses {losses} vs unsharded "
        f"{want_l} (max diff {max(abs(a - b) for a, b in zip(losses, want_l))}"
        f"); dropped share per step {r0['dropped']} (unsharded "
        f"{ref['dropped'][:steps]}); state bitwise equal across the ranks; "
        f"launches a rank {r0['launches']}")
    log(f"[{tag}] step median {med:.3f} ms over steps 1..{steps - 1} (rank "
        f"0; unsharded {ref['median_ms']:.3f} ms); peak per rank "
        f"{[round(rec['peak'] / 2**30, 3) for rec in recs]} GiB (unsharded "
        f"{ref['peak'] / 2**30:.3f} GiB); profiled step (rank 0): host wall "
        f"{r0['profiled_ms']:.3f} ms, device idle share {r0['idle']:.3f}, "
        f"collectives by name (host time): {coll}")
    log(f"[{tag}] the router logits' all_gather: a rank receives {gather} "
        f"bytes a layer ({S - 1} x {T // S} tokens x {E} f32 logits), "
        f"{2 * layers * gather} a step over its {layers} MoE layer(s) (the "
        f"forward and remat full's replay; counted, not timed)")
    return {tag: {k: sum(rec["launches"][k] for rec in recs)
                  for k in ("K1", "K2", "K3")}}


# train-sharded mamba2-370m and recurrentgemma-9b: the unsharded phases'
# first steps they run (their schedules are TP_SCHED's), recurrentgemma's
# depth (one griffin group) and their collectives by profiler name (the
# halos' sends and receives, the carries' all_gathers and their
# backward's reduce_scatters, the gradients' all_reduce)
SEQ_REC_STEPS = 2
SEQ_REC_KEYS = SEQ_MOE_KEYS + ("reduce_scatter", "reducescatter")
SEQ_RG_DEPTH = 3
# train-sharded recurrentgemma-9b's forward-and-backward form: the fixed
# random projections a gradient leaf is digested into, and the bound on
# each leaf's relative gradient error estimated from them: 3x the largest
# a probe on the card read (9.9e-3, bf16; PERF.md §6), as four
# projections estimate it to within about a third
SEQ_RG_PROJ = 4
SEQ_RG_GRAD_TOL = 3e-2


def seq_carry_bytes(cfg, batch: int, n: int) -> dict:
    """What a rank sends and receives a recurrent layer under a sequence
    group of ``n``, counted from the shapes: the conv halo it sends
    (``batch`` x (W - 1) rows of the conv's channels in bf16: ``d_rnn``
    for the RG-LRU, d_inner + 2N for the SSD) and the carries it receives
    in the gather (the n - 1 other shards' f32 decay product and end
    state: 2 x ``batch`` x ``d_rnn``, or ``batch`` x H x (1 + N P) for the
    SSD). Each crosses again in remat full's replay, and its gradient
    back (the reverse ``ppermute``, the ``reduce_scatter``)."""
    if cfg.ssm is not None:
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = d_inner // s.head_dim
        halo = batch * (s.conv_width - 1) * (d_inner + 2 * s.d_state) * 2
        carry = batch * H * (1 + s.d_state * s.head_dim) * 4
    else:
        dr = cfg.recurrent.d_rnn or cfg.d_model
        halo = batch * (cfg.recurrent.conv_width - 1) * dr * 2
        carry = 2 * batch * dr * 4
    return dict(halo=halo, carry=(n - 1) * carry)


def seq_rg_whole_steps(torch, n: int = TRAIN_SHARDS) -> bool:
    """Whether train-sharded recurrentgemma-9b runs whole train steps.
    Every rank of a sequence group holds every weight, so it does where
    the ranks that share a card (all ``n`` under gloo on cuda:0, one a
    card under NCCL) fit ``train_bytes``' peak at the rank's 4096 / n
    tokens in 92 % of it; else the split forward and backward with the
    gradients' one ``all_reduce``, no update: 10 B a parameter (the bf16
    weights, their f32 gradients and the all_reduce's flat f32 buffer)
    and the rank's f32 logits (16 B a logit). Prints the reckoning."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config("recurrentgemma-9b")
    cfg = dataclasses.replace(full, n_layers=SEQ_RG_DEPTH)
    share = n if _shard_backend(torch, n)[1] is not None else 1
    total = torch.cuda.get_device_properties(0).total_memory
    budget = 0.92 * total
    tb = train_bytes(cfg, 4096 // n, 1)
    step = share * tb["peak"]
    fwd_bwd = share * (10 * tb["params"] + 16 * (4096 // n) * cfg.vocab_size)
    whole = step <= budget
    check(whole or fwd_bwd <= budget,
          f"train-sharded recurrentgemma-9b: {share} ranks on a card need "
          f"{fwd_bwd / 1e9:.2f} GB for the forward and backward alone")
    log(f"[train-sharded recurrentgemma-9b] reckoned: {SEQ_RG_DEPTH} of "
        f"{full.n_layers} layers (one griffin group) at every published "
        f"width, {tb['params'] / 1e6:.1f}M params (the tied embedding "
        f"{tb['embedding'] / 1e6:.1f}M), held whole by every rank of a "
        f"sequence group of {n}, {share} rank(s) a card: whole train steps "
        f"peak at {step / 1e9:.2f} GB (32 B a parameter), the forward and "
        f"backward with the gradients' all_reduce at {fwd_bwd / 1e9:.2f} "
        f"GB, against {budget / 1e9:.2f} GB (92 % of {total / 1e9:.2f}): "
        + ("whole train steps" if whole else
           "the forward and backward, no AdamW update"))
    return whole


def _grad_digest(torch, grads) -> list:
    """Each gradient leaf's f32 norm and its dot products with
    ``SEQ_RG_PROJ`` fixed N(0, 1) vectors, drawn leaf by leaf from a seed
    in chunks of 2^26 values (the same on every process and device):
    what the host keeps of recurrentgemma-9b's 1.7G-value gradient to
    hold two runs' gradients against each other."""
    out = []
    for i, g in enumerate(grads):
        flat = g.reshape(-1)
        gen = torch.Generator(device=flat.device).manual_seed(7919 + i)
        proj = torch.zeros(SEQ_RG_PROJ, dtype=torch.float64,
                           device=flat.device)
        for lo in range(0, flat.numel(), 1 << 26):
            part = flat[lo:lo + (1 << 26)].float()
            r = torch.randn((SEQ_RG_PROJ, part.numel()), generator=gen,
                            device=flat.device)
            proj += (r @ part).double()
        out.append((float(flat.float().norm()), proj.tolist()))
    return out


def _grad_errors(got, want) -> list:
    """Per leaf, the relative error of ``got``'s gradient against
    ``want``'s (``_grad_digest``s): the projections' root mean square
    difference over ``want``'s norm (an estimate of |g - g_ref| /
    |g_ref|, each projection of g - g_ref having that variance), and the
    norms' relative difference."""
    out = []
    for (n_g, p_g), (n_w, p_w) in zip(got, want):
        rms = math.sqrt(sum((a - b) ** 2 for a, b in zip(p_g, p_w))
                        / len(p_w))
        out.append((rms / max(n_w, 1e-30), abs(n_g - n_w) / max(n_w, 1e-30)))
    return out


def _rg_batch(torch, cfg, seed, dev):
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    ds = SyntheticLM(cfg, DataConfig(4096, 1, seed=seed))
    return {k: torch.as_tensor(v).to(dev) for k, v in ds.batch(0).items()}


def seq_rg_reference(torch, seed, cfg, dev="cuda") -> dict:
    """train-sharded recurrentgemma-9b's reference in its forward-and-
    backward form: the unsharded loss and gradients on the card from the
    seed's weights and first batch (seq 4096, batch 1, bf16, remat full).
    Keeps on the host the loss, the K1-K3 launches and the gradients'
    ``_grad_digest``."""
    from repro_torch.models.model import build_model
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  tree_map)

    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    names = ["/".join(p) for p, _ in tree_flatten_with_path(params)[0]]
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    _counters(reset=True)
    t0 = time.perf_counter()
    loss, _ = model.loss(leaves, _rg_batch(torch, cfg, seed, dev))
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    loss = float(loss)
    dt = time.perf_counter() - t0
    launches, plain = _counters()
    check(plain == 0, f"train-sharded recurrentgemma-9b reference: plain "
          f"{plain}")
    digest = _grad_digest(torch, grads)
    log(f"[train-sharded recurrentgemma-9b] the unsharded reference: loss "
        f"{loss:.6f}, forward and backward {dt * 1e3:.3f} ms, launches "
        f"{launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB")
    return dict(loss=loss, digest=digest, launches=launches, names=names)


def seq_rg_rank(group, seed, cfg):
    """train-sharded recurrentgemma-9b on one rank in its forward-and-
    backward form: the seed's weights (every rank holds all) and first
    batch, this rank's half of the sequence, the loss under the group,
    its gradients cast to f32 and summed over the group in the trainer's
    one flat ``all_reduce`` (``_psum_flat_``), no update; profiled on rank
    0. Returns the loss, the gradients' digests, the launches, the peak
    and rank 0's profile numbers."""
    import torch

    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import _psum_flat_, _seq_slice
    from repro_torch.tree import tree_leaves, tree_map

    _rank_prelude(torch)
    dev = str(group.device)
    model = build_model(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    batch = _seq_slice(_rg_batch(torch, cfg, seed, dev), group)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    prof = None
    if group.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model.loss(leaves, batch, group=group)
    grads = iter(g.float() for g in torch.autograd.grad(
        loss, tree_leaves(leaves)))
    grads = _psum_flat_(tree_map(lambda _: next(grads), params), group)
    total = float(metrics["loss"])
    dt = time.perf_counter() - ts
    launches, plain = _counters()
    rec = dict(loss=total, launches=launches, plain=plain, ms=dt * 1e3)
    if prof is not None:
        prof.stop()
        by_name = report_profile(prof, dt, 1, "train-sharded "
                                 "recurrentgemma-9b forward and backward "
                                 "(rank 0)")
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, SEQ_REC_KEYS))
    rec.update(peak=torch.cuda.max_memory_allocated(),
               grads=_grad_digest(torch, tree_leaves(grads)),
               digest=_digest(torch, grads))
    return rec


def seq_rec_inputs(torch, seed, arch, ref=None) -> dict:
    """What a recurrent train-sharded run compares with, and its form:
    mamba2-370m (``MAMBA_TRAIN_LAYERS`` layers) takes whole train steps
    against ``ref``, the unsharded mamba2 phase's stats (same seed and
    schedule); recurrentgemma-9b (one griffin group) takes whole steps
    where ``seq_rg_whole_steps`` finds they fit, against the unsharded
    phase of its cut run here, else the forward and backward against
    ``seq_rg_reference``. Returns the run's plan."""
    import dataclasses

    from repro_torch.configs import get_config

    depth = MAMBA_TRAIN_LAYERS if arch == "mamba2-370m" else SEQ_RG_DEPTH
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    sched = TP_SCHED[arch]
    plan = dict(arch=arch, cfg=cfg, whole=True, ref=ref, ref_launches=None,
                rank_args=dict(cfg=cfg, sched=sched, steps=SEQ_REC_STEPS,
                               tag=f"train-sharded {arch}",
                               keys=SEQ_REC_KEYS))
    if arch == "mamba2-370m":
        return plan
    gc.collect()
    torch.cuda.empty_cache()
    if seq_rg_whole_steps(torch):
        batch_n, steps, lr, warmup = sched
        plan["ref_launches"], _, plan["ref"] = phase_train(
            torch, seed, arch, cfg=cfg, steps=steps, batch=batch_n, lr=lr,
            warmup=warmup, run=SEQ_REC_STEPS)
    else:
        plan.update(whole=False, ref=seq_rg_reference(torch, seed, cfg))
        plan["ref_launches"] = plan["ref"]["launches"]
    torch.cuda.empty_cache()
    return plan


def seq_rec_job(torch, seed, rec):
    """A recurrent train-sharded run's half before its ranks: the ranks'
    job (``seq_train_rank`` for whole steps, ``seq_rg_rank`` for the
    forward and backward) with what ``report_seq_rec`` reads (``rec``:
    ``seq_rec_inputs``'s plan)."""
    backend, device = _shard_backend(torch, TRAIN_SHARDS)
    job = (seq_train_rank, (rec["rank_args"],)) if rec["whole"] \
        else (seq_rg_rank, (rec["cfg"],))
    return (job, report_seq_rec, dict(rec=rec, backend=backend,
                                      device=device))


def report_seq_rec(recs, st, wall) -> dict:
    """Gate and print a recurrent train-sharded run against its unsharded
    reference: the loss of every step (whole steps) or of the forward
    (forward and backward) within 1e-2 of it (train-tp's convention for
    a split bf16 run), equal on every rank; in the forward-and-backward
    form every gradient leaf's relative error (``_grad_errors``) within
    ``SEQ_RG_GRAD_TOL``; the parameters and optimizer state (or the
    summed gradients) bitwise equal on every rank; per rank 2 K1, 1 K2
    and 1 K3 call (2 kernels) an attention layer a step, none in mamba2,
    no plain version. Prints rank 0's step time and idle share, the
    collectives by profiler name, the halo and carry bytes a layer
    (counted) and the peak per rank. Returns {path: the launches summed
    over the ranks}."""
    from repro_torch.configs import get_config
    from repro_torch.models.rglru import _d_rnn

    rec, backend, device = st["rec"], st["backend"], st["device"]
    arch, cfg, ref = rec["arch"], rec["cfg"], rec["ref"]
    tag = f"train-sharded {arch}"
    S = TRAIN_SHARDS
    r0 = recs[0]
    batch_n = rec["rank_args"]["sched"][0]
    n_attn = _train_attention_layers(cfg)
    steps = len(r0["losses"]) if rec["whole"] else 1
    want = {"K1": 2 * n_attn * steps, "K2": n_attn * steps,
            "K3": 2 * n_attn * steps}
    for r, got in enumerate(recs):
        check(got["launches"] == want and got["plain"] == 0,
              f"{tag} rank {r}: launches {got['launches']} != {want}, "
              f"plain {got['plain']}")
    check(len({got["digest"] for got in recs}) == 1,
          f"{tag}: the state differs across the ranks")
    if rec["whole"]:
        losses, want_l = r0["losses"], ref["losses"][:steps]
        check(all(got["losses"] == losses for got in recs),
              f"{tag}: the ranks' losses differ: "
              f"{[got['losses'] for got in recs]}")
        check(all(math.isfinite(x) for x in losses),
              f"{tag}: losses {losses}")
        diff = max(abs(a - b) for a, b in zip(losses, want_l))
        check(diff <= 1e-2, f"{tag}: losses {losses} vs unsharded {want_l} "
              f"(1e-2)")
        med = sorted(r0["times"][1:])[(steps - 1) // 2] * 1e3
        what = (f"{steps} steps of a {rec['rank_args']['sched'][1]}-step "
                f"schedule: losses {losses} vs unsharded {want_l} (max diff "
                f"{diff}); parameters and optimizer state bitwise equal "
                f"across the ranks")
        timing = (f"step median {med:.3f} ms over steps 1..{steps - 1} "
                  f"(rank 0; unsharded {ref['median_ms']:.3f} ms); "
                  f"profiled step: host wall {r0['profiled_ms']:.3f} ms")
    else:
        check(all(got["loss"] == r0["loss"] for got in recs),
              f"{tag}: the ranks' losses differ")
        diff = abs(r0["loss"] - ref["loss"])
        check(math.isfinite(r0["loss"]) and diff <= 1e-2,
              f"{tag}: loss {r0['loss']} vs unsharded {ref['loss']} (1e-2)")
        errs = _grad_errors(r0["grads"], ref["digest"])
        order = sorted(range(len(errs)), key=lambda i: -errs[i][0])
        top = ", ".join(f"{ref['names'][i]} {errs[i][0]:.3e} (norm "
                        f"{ref['digest'][i][0]:.4e})" for i in order[:6])
        check(all(e <= SEQ_RG_GRAD_TOL for e, _ in errs),
              f"{tag}: gradient leaf {ref['names'][order[0]]} relative "
              f"error {errs[order[0]][0]} > {SEQ_RG_GRAD_TOL}; the largest "
              f"{top}")
        what = (f"the forward and backward (no update): loss "
                f"{r0['loss']} vs unsharded {ref['loss']} (diff {diff}); "
                f"gradients summed over the ranks bitwise equal on every "
                f"rank, per leaf relative error (from {SEQ_RG_PROJ} "
                f"projections; limit {SEQ_RG_GRAD_TOL}) largest {top}; "
                f"the norms' largest relative difference "
                f"{max(n for _, n in errs):.3e}, over {len(errs)} leaves")
        timing = (f"forward and backward with the all_reduce "
                  f"{r0['ms']:.3f} ms (rank 0, profiled)")
    cb = seq_carry_bytes(cfg, batch_n, S)
    width = (f"d_rnn {_d_rnn(cfg)}" if cfg.recurrent is not None
             else f"d_inner {cfg.ssm.expand * cfg.d_model}, N "
             f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}")
    coll = ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    log(f"[{tag}] bf16 remat full, every published width ({width}), "
        f"{cfg.n_layers} of {get_config(arch).n_layers} layers, {S} ranks "
        f"on backend {backend} "
        f"({device or 'one card a rank'}), seq 4096 = {S} x {4096 // S}, "
        f"batch {batch_n}: {wall:.1f} s on rank 0; {what}; launches a "
        f"rank {r0['launches']}")
    log(f"[{tag}] {timing}, device idle share {r0['idle']:.3f}; peak per "
        f"rank {[round(got['peak'] / 2**30, 3) for got in recs]} GiB; "
        f"collectives by name (host time): {coll}")
    log(f"[{tag}] a recurrent layer: the conv halo a rank sends "
        f"{cb['halo']} bytes, the carries it receives {cb['carry']} bytes "
        f"(f32), each again in remat full's replay and back in the "
        f"backward (counted, not timed)")
    return {tag.replace(" ", "-"): {k: sum(got["launches"][k]
                                           for got in recs)
                                    for k in ("K1", "K2", "K3")}}


# train-sharded qwen2-vl-2b and whisper-base, the VLM and the encoder-
# decoder under a sequence group: the first steps of their references'
# schedules they run (a schedule's step 0 has lr 0, so the third step is
# the first after an update), each schedule (qwen2-vl-2b's cut reference
# at batch 1; whisper-base's the unsharded train phase's) and the bound
# on their losses against the unsharded ones
SEQ_FAM_STEPS = 3
SEQ_FAM_SCHED = {"qwen2-vl-2b": (GEMMA_BATCH, QWEN_STEPS, 1e-3, 3),
                 "whisper-base": (TRAIN_BATCH, GEMMA_STEPS, 1e-3, 3)}
SEQ_FAM_TOL = 1e-4


def seq_fam_depth(torch, arch: str, n: int = TRAIN_SHARDS) -> int:
    """The depth of a family's train-sharded run: every rank of a
    sequence group holds every weight, so the deepest ``arch`` (every
    published width kept) whose ``train_bytes`` peak at the rank's 4096 /
    n tokens, times the ranks that share a card (all ``n`` under gloo on
    cuda:0, one under NCCL), fits 92 % of the card. Prints the
    reckoning."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    batch = SEQ_FAM_SCHED[arch][0]
    share = n if _shard_backend(torch, n)[1] is not None else 1
    total = torch.cuda.get_device_properties(0).total_memory
    budget = 0.92 * total
    depth = _fit_depth(full, 4096 // n, batch, budget / share)
    check(depth > 0, f"train-sharded {arch}: no layer's {share} copies fit")
    tb = train_bytes(dataclasses.replace(full, n_layers=depth), 4096 // n,
                     batch)
    more = "" if depth == full.n_layers else (
        f"; {depth + 1} layers would peak at "
        f"{share * train_bytes(dataclasses.replace(full, n_layers=depth + 1), 4096 // n, batch)['peak'] / 1e9:.2f} GB")
    log(f"[train-sharded {arch}] reckoned: {depth} of {full.n_layers} layers "
        f"at every published width, {tb['params'] / 1e6:.1f}M params, held "
        f"whole by every rank of a sequence group of {n}, {share} rank(s) a "
        f"card, batch {batch}: whole train steps peak at "
        f"{share * tb['peak'] / 1e9:.2f} GB against {budget / 1e9:.2f} GB "
        f"(92 % of {total / 1e9:.2f}){more}")
    return depth


def seq_fam_inputs(torch, seed, arch, ref=None) -> dict:
    """What a family's train-sharded run compares with: ``arch`` at
    ``seq_fam_depth``'s depth and the schedule of ``SEQ_FAM_SCHED``,
    against ``ref`` (the unsharded train phase's stats, same seed,
    weights, batches and schedule) where that depth is the full one, else
    against the unsharded run of its cut, run here over the same first
    ``SEQ_FAM_STEPS`` steps. Returns the run's plan."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=seq_fam_depth(torch, arch))
    sched = SEQ_FAM_SCHED[arch]
    plan = dict(arch=arch, cfg=cfg, ref=ref, ref_launches=None,
                rank_args=dict(cfg=cfg, sched=sched, steps=SEQ_FAM_STEPS,
                               tag=f"train-sharded {arch}", keys=P2P_KEYS))
    if ref is None or cfg.n_layers != full.n_layers:
        gc.collect()
        torch.cuda.empty_cache()
        batch_n, steps, lr, warmup = sched
        plan["ref_launches"], _, plan["ref"] = phase_train(
            torch, seed, arch, cfg=cfg, steps=steps, batch=batch_n, lr=lr,
            warmup=warmup, run=SEQ_FAM_STEPS)
        torch.cuda.empty_cache()
    return plan


def seq_fam_job(torch, seed, fam):
    """A family's train-sharded run's half before its ranks: the ranks'
    job (``seq_train_rank``) with what ``report_seq_fam`` reads (``fam``:
    ``seq_fam_inputs``' plan)."""
    backend, device = _shard_backend(torch, TRAIN_SHARDS)
    return ((seq_train_rank, (fam["rank_args"],)), report_seq_fam,
            dict(fam=fam, backend=backend, device=device))


def seq_halo_bytes(cfg, batch: int, n: int = TRAIN_SHARDS) -> dict:
    """``ShardedPlan.stats`` of ``cfg``'s decoder attention at n 4096 over
    ``n`` shards, at the blocks the sharded op picks, and what a rank
    sends a layer over its ``batch`` x H flat heads (K and V in bf16;
    counted, not timed): {"plan": the stats, "blocks", "view": (local,
    halo, global tiles), "heads", "exchange", "allgather"}."""
    from repro_torch.core.scheduler import build_plan, schedule
    from repro_torch.dist.sharded_plan import _auto_block, shard_plan
    from repro_torch.models.layers import salo_pattern

    sched = schedule(salo_pattern(cfg), 4096)
    b = _auto_block(sched.n_work, n, cfg.salo.block_q)
    sp = shard_plan(build_plan(sched, b, b, n * b), n)
    st = sp.stats(cfg.hd)
    heads = batch * cfg.n_heads
    return dict(plan=st, blocks=b, view=(sp.nkb_l, sp.halo_counts, sp.n_gt),
                heads=heads, exchange=st["exchange_bytes"] * heads,
                allgather=st["allgather_bytes"] * heads)


def report_seq_fam(recs, st, wall) -> dict:
    """Gate and print a family's train-sharded run against its unsharded
    reference: every step's loss within ``SEQ_FAM_TOL`` of it (and
    whether bitwise), equal on every rank, the loss falling; parameters
    and optimizer state bitwise equal on every rank; per rank and step 2
    K1, 1 K2 and 1 K3 call (2 kernels) a decoder layer, through
    ``sharded_attention``, and as many again a layer of whisper's encoder,
    whole on every rank (case (m)'s shapes); no plain version. Prints
    rank 0's step median and idle share, the collectives by profiler
    name, the peak per rank and the halo bytes (``ShardedPlan.stats``,
    counted). Returns {path: the launches summed over the ranks}."""
    from repro_torch.configs import get_config

    fam, backend, device = st["fam"], st["backend"], st["device"]
    arch, cfg, ref = fam["arch"], fam["cfg"], fam["ref"]
    tag = f"train-sharded {arch}"
    S = TRAIN_SHARDS
    r0 = recs[0]
    losses = r0["losses"]
    steps = len(losses)
    want_l = ref["losses"][:steps]
    batch_n, sched_steps = fam["rank_args"]["sched"][:2]
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * steps, "K2": n_attn * steps,
            "K3": 2 * n_attn * steps}
    for r, rec in enumerate(recs):
        check(rec["losses"] == losses,
              f"{tag}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{tag} rank {r}: launches {rec['launches']} != {want}, "
              f"plain {rec['plain']}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    diff = max(abs(a - b) for a, b in zip(losses, want_l))
    check(diff <= SEQ_FAM_TOL, f"{tag}: losses {losses} vs unsharded "
          f"{want_l} (max diff {diff} > {SEQ_FAM_TOL})")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall: {losses}")
    check(len({rec["digest"] for rec in recs}) == 1,
          f"{tag}: parameters or optimizer state differ across the ranks")
    med = sorted(r0["times"][1:])[(steps - 1) // 2] * 1e3
    coll = ", ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    hb = seq_halo_bytes(cfg, batch_n)
    dec = _attention_layers(cfg)
    enc = (f"; its encoder's {cfg.n_layers} layers whole on every rank "
           f"({cfg.n_audio_frames} frames, no collective)"
           if cfg.encoder_decoder else "")
    log(f"[{tag}] bf16 remat full, every published width, {cfg.n_layers} "
        f"of {get_config(arch).n_layers} layers, {S} ranks on backend "
        f"{backend} ({device or 'one card a rank'}), seq 4096 = {S} x "
        f"{4096 // S}, batch {batch_n}{enc}: {wall:.1f} s on rank 0; "
        f"{steps} steps of a {sched_steps}-step schedule: losses {losses} vs "
        f"unsharded {want_l} (max diff {diff}; "
        f"{'bitwise equal' if losses == want_l else 'not bitwise'}); state "
        f"bitwise equal across the ranks; launches a rank {r0['launches']} "
        f"({dec} decoder layers through sharded_attention"
        + (f", {cfg.n_layers} encoder layers whole" if cfg.encoder_decoder
           else "") + ")")
    log(f"[{tag}] step median {med:.3f} ms over steps 1..{steps - 1} (rank "
        f"0; unsharded {ref['median_ms']:.3f} ms); peak per rank "
        f"{[round(rec['peak'] / 2**30, 3) for rec in recs]} GiB (unsharded "
        f"{ref['peak'] / 2**30:.3f} GiB); profiled step (rank 0): host wall "
        f"{r0['profiled_ms']:.3f} ms, device idle share {r0['idle']:.3f}, "
        f"collectives by name (host time): {coll}")
    log(f"[{tag}] ShardedPlan.stats({cfg.hd}) of the decoder's attention at "
        f"n 4096, {S} shards, blocks {hb['blocks']}: view {hb['view'][0]} "
        f"local + {hb['view'][1]} halo + {hb['view'][2]} global tiles; per "
        f"flat head and layer {hb['plan']}; a rank sends a layer over "
        f"{hb['heads']} flat heads {hb['exchange']} bytes (all-gather "
        f"{hb['allgather']}), again in remat full's replay and back in the "
        f"backward (counted, not timed)")
    return {tag.replace(" ", "-"): {k: sum(rec["launches"][k] for rec in recs)
                                    for k in ("K1", "K2", "K3")}}


def train_sharded_parts(torch, seed, runs, moe=None, with_check=True,
                        recs=(), fams=()):
    """The sequence-parallel training phases as parts of a spawn
    (``phase_two_ranks``, ``spawn_jobs``), each its own job and report:
    train-sharded-check (``with_check``; ``sharded_check_job``),
    train-sharded for each ``(arch, ref, dilation)`` of ``runs`` at full
    width and depth (``train_sharded_job``; ``ref`` the unsharded train
    phase's stats of that config), train-sharded-moe (``moe``:
    ``seq_moe_inputs``'s plan; ``seq_moe_job``), the recurrent runs
    (``recs``: ``seq_rec_inputs``' plans; ``seq_rec_job``) and the VLM
    and encoder-decoder runs (``fams``: ``seq_fam_inputs``' plans;
    ``seq_fam_job``)."""
    parts = [("train-sharded-check", sharded_check_job(torch, seed))
             ] if with_check else []
    parts += [(f"train-sharded {arch}" + (f" dilation {dil}" if dil > 1
                                          else ""),
               train_sharded_job(torch, seed, arch, ref, dil))
              for arch, ref, dil in runs]
    if moe is not None:
        parts.append(("train-sharded-moe", seq_moe_job(torch, seed, moe)))
    parts += [(f"train-sharded {rec['arch']}", seq_rec_job(torch, seed, rec))
              for rec in recs]
    parts += [(f"train-sharded {fam['arch']}", seq_fam_job(torch, seed, fam))
              for fam in fams]
    return parts


def phase_train_sharded(torch, seed, runs, moe=None, with_check=True,
                        recs=(), fams=()):
    """``train_sharded_parts`` in one spawn of ``TRAIN_SHARDS`` ranks.
    Returns {path: launches summed over the ranks}."""
    out = {}
    for launches in phase_two_ranks(
            torch, seed, train_sharded_parts(torch, seed, runs, moe,
                                             with_check, recs, fams),
            TRAIN_SHARDS, TRAIN_SHARD_TIMEOUT_S).values():
        out.update(launches)
    return out


# train-dp phases: the train phase's first steps (cut to 4 for time with
# the tensor-parallel phases)
DP_STEPS = 4
# phase -> (ranks, compress_grads); the global batch is TRAIN_BATCH
DP_PHASES = {"train-dp": (2, False), "train-dp-int8": (4, True)}
# the collectives of a data-parallel step by profiler name
DP_KEYS = ("all_reduce", "allreduce", "all_gather", "allgather")


def _flat_cpu(torch, tree):
    from repro_torch.tree import tree_leaves
    return torch.cat([x.detach().float().reshape(-1).cpu()
                      for x in tree_leaves(tree)])


def dp_check_rank(group, seed, cfg, params):
    """A spawned rank of train-dp-check: ``cfg`` trained 3 steps on this
    rank's rows of the global batch (seq 128, batch 2, as train_check),
    uncompressed, then again from ``params`` with ``compress_grads``,
    where the wire's last input x = g + ef is kept: the residual the step
    returns must be x - dq(q8(x)) computed on this rank alone
    (``compression.compress_decompress``). Returns both runs' losses,
    launch counts, final parameters and state digest."""
    import torch

    from repro_torch.dist import compression
    from repro_torch.dist.group import DataGroup
    from repro_torch.tree import tree_leaves, tree_map

    _rank_prelude(torch)
    data = DataGroup.of(group)
    dev = str(group.device)
    out = {}
    for compress in (False, True):
        p = _to(params, dev)
        step, opt, ds = _trainer(cfg, dev, p, seq=128, batch=2, steps=3,
                                 lr=3e-3, warmup=1, seed=seed, data=data,
                                 compress=compress)
        seen, real = [], compression.compressed_psum_with_residual

        def spy(x, g, *rest):
            seen.append(x)
            return real(x, g, *rest)

        compression.compressed_psum_with_residual = spy
        _counters(reset=True)
        losses, ef = [], None
        for i in range(3):
            p, opt, met, ef = step(p, opt, ds.batch(i), ef)
            losses.append(float(met["loss"]))
        compression.compressed_psum_with_residual = real
        launches, plain = _counters()
        rec = dict(losses=losses, launches=launches, plain=plain,
                   params=_flat_cpu(torch, p),
                   digest=_digest(torch, p, opt.m, opt.v))
        if compress:
            want = compression.compress_decompress(
                tree_map(torch.clone, seen[-1]))[1]
            got = tree_leaves(ef)
            rec.update(ef_finite=all(bool(torch.isfinite(e).all())
                                     for e in got),
                       ef_err=max(float((a - b).abs().max()) for a, b in
                                  zip(got, tree_leaves(want))),
                       wire_calls=len(seen))
        out[compress] = rec
    return out


def train_dp_check(torch, seed):
    """train-dp-check: the narrowed f32 smollm of train_check trained 3
    steps on 2 data-parallel ranks (``_shard_backend``: gloo ranks sharing
    cuda:0 on one card) and unsharded on the card from the same
    parameters and global batches. Uncompressed: losses and parameters
    within 1e-4 of the unsharded run's. With ``compress_grads``: the
    step-0 loss the uncompressed one's within 1e-4 (it is computed before
    the reduce), ``ef_state`` finite and each rank's the residual of its
    own wire input within 1e-6. Both: the state bitwise equal across the
    ranks, K1-K3 launched and no plain version. Returns ({path: launches
    summed over the ranks}, the uncompressed run's rank records: what
    train-fsdp-check is held to). ``dp_check_job`` and
    ``report_dp_check`` are its two halves, for a spawn shared with other
    phases (``phase_two_ranks``)."""
    return _run_alone(torch, seed, 2, dp_check_job(torch, seed),
                      TRAIN_SHARD_TIMEOUT_S)


def dp_check_job(torch, seed):
    """The half of ``train_dp_check`` before its ranks: the unsharded run
    on the card and the ranks' job (``dp_check_rank``)."""
    from repro_torch.models.model import build_model

    n = 2
    backend, device = _shard_backend(torch, n)
    cfg = _train_cfg(smoke=True)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(seed))
    p = _to(params, "cuda")
    step, opt, ds = _trainer(cfg, "cuda", p, seq=128, batch=2, steps=3,
                             lr=3e-3, warmup=1, seed=seed)
    ref = []
    for i in range(3):
        p, opt, met, _ = step(p, opt, ds.batch(i))
        ref.append(float(met["loss"]))
    return (dp_check_rank, (cfg, params)), report_dp_check, dict(
        n=n, cfg=cfg, ref=ref, ref_p=_flat_cpu(torch, p), backend=backend,
        device=device)


def report_dp_check(res, st, wall):
    """The half of ``train_dp_check`` after its ranks."""
    n, cfg, ref, ref_p = st["n"], st["cfg"], st["ref"], st["ref_p"]
    backend, device = st["backend"], st["device"]
    out = {}
    for compress, what in ((False, "train-dp-check"),
                           (True, "train-dp-check-int8")):
        recs = [r[compress] for r in res]
        for r, rec in enumerate(recs):
            check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
                  f"{what} rank {r}: launches {rec['launches']}, plain "
                  f"{rec['plain']}")
            if not compress:
                perr = float((rec["params"] - ref_p).abs().max())
                check(all(math.isclose(a, b, rel_tol=1e-4, abs_tol=1e-4)
                          for a, b in zip(rec["losses"], ref)) and
                      perr <= 1e-4,
                      f"{what} rank {r}: losses {rec['losses']} vs "
                      f"unsharded {ref}, parameters off by {perr} (1e-4)")
            else:
                check(abs(rec["losses"][0] - ref[0]) <= 1e-4,
                      f"{what} rank {r}: step-0 loss {rec['losses'][0]} "
                      f"vs {ref[0]} (1e-4)")
                check(rec["ef_finite"] and rec["ef_err"] <= 1e-6
                      and rec["wire_calls"] == 3,
                      f"{what} rank {r}: ef finite {rec['ef_finite']}, "
                      f"off its own residual by {rec['ef_err']}, "
                      f"{rec['wire_calls']} wire calls")
        check(len({rec["digest"] for rec in recs}) == 1,
              f"{what}: parameters or optimizer state differ across the "
              f"ranks")
        extra = ("" if not compress else
                 f"; ef_state finite, off each rank's own residual by "
                 f"{[rec['ef_err'] for rec in recs]}")
        log(f"[{what}] smollm d {cfg.d_model} hd {cfg.hd} f32, {n} ranks on "
            f"backend {backend} ({device or 'one card a rank'}), global "
            f"batch 2: losses {recs[0]['losses']} vs unsharded {ref}; "
            f"parameters off by "
            f"{float((recs[0]['params'] - ref_p).abs().max())}; state "
            f"bitwise equal across the ranks{extra}; launches a rank "
            f"{recs[0]['launches']}")
        out[what] = {k: sum(rec["launches"][k] for rec in recs)
                     for k in ("K1", "K2", "K3")}
    log(f"[train-dp-check] {wall:.1f} s on rank 0")
    return out, [r[False] for r in res]


def _wire_kernels_ms(torch, grads, n: int) -> dict:
    """Device time (CUDA events, 5 runs after a warm-up) of the
    compressed wire's own kernels on ``grads``: the flat quantization of
    every tensor, and the dequantize-and-sum of ``n`` gathered parts (the
    gather itself left out: the parts are this rank's, repeated)."""
    from repro_torch.dist import compression as CP
    from repro_torch.tree import tree_leaves

    class _Local:                   # n parts, no collective
        size = n

        @staticmethod
        def all_gather(t):
            return t.expand(n, *t.shape)

    leaves = tree_leaves(grads)
    ids, n_groups = CP.scale_groups(grads)
    gid = torch.tensor(ids, device=leaves[0].device)
    sizes = CP._sizes(leaves)

    def quantize():
        return CP._q8_flat(leaves, gid, n_groups)

    _, q, scales, _ = quantize()
    out = {}
    for what, fn in (("quantize", quantize),
                     ("dequantize_sum", lambda: CP._gathered_sum(
                         _Local, q, scales, gid, sizes))):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[what] = start.elapsed_time(end) / 5
    return out


def train_dp_rank(group, seed, steps, compress, arch="smollm-135m",
                  fsdp=None, tp=None):
    """A spawned rank of a full-size train-dp phase: ``arch`` at full
    width and depth, bf16, remat full, seq 4096, this rank's rows of the
    global batch ``TRAIN_BATCH``, ``steps`` steps of the train phase's
    schedule (20 steps, lr 3e-3, warmup 10) from the same seed, then one
    more step, profiled on rank 0, where the wire's quantize and sum
    kernels are then timed on that step's gradient shapes. ``fsdp`` (a
    dict with the check's ``cfg``, None to leave it out, its ``params``
    and train-fsdp's ``steps``): then, in the same spawn, train-fsdp-check
    (``fsdp_check_run``) and train-fsdp
    (``fsdp_full_run``) from the same seed and batches, under
    ``rec["fsdp_check"]`` and ``rec["fsdp"]``; with ``compress`` they are
    train-fsdp-int8-check (beside the data-parallel int8 check it is held
    to, ``dp_int8_check_run``) and train-fsdp-int8. ``tp`` (a dict with a
    narrowed config's ``cfg`` and ``params``, or None): then
    train-tp-int8-check at (data 2, model 2) on these ranks
    (``tp_int8_check_run``), under ``rec["tp_int8_check"]``. Returns the
    rank's record."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import compression
    from repro_torch.dist.group import DataGroup
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves

    _rank_prelude(torch)
    data = DataGroup.of(group)
    dev = str(group.device)
    cfg = get_config(arch)
    params = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(seed))
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=TRAIN_BATCH,
                             steps=TRAIN_STEPS, lr=3e-3, warmup=10,
                             seed=seed, data=data, compress=compress)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, times, ef = [], [], None
    for i in range(steps):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, ef = step(params, opt, batch, ef)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        if data.index == 0:
            log(f"[train-dp{'-int8' if compress else ''} {arch} x{data.size}"
                f"] rank 0 step {i} loss {losses[-1]:.4f} grad norm "
                f"{float(met['grad_norm']):.4f} {times[-1] * 1e3:.1f} ms")
    launches, plain = _counters()
    peak = torch.cuda.max_memory_allocated()
    rec = dict(losses=losses, times=times, launches=launches, plain=plain,
               peak=peak, digest=_digest(torch, params, opt.m, opt.v),
               ef_finite=ef is None or all(bool(torch.isfinite(e).all())
                                           for e in tree_leaves(ef)),
               grad_size=(sum(x.numel() for x in tree_leaves(params)),
                          compression.scale_groups(params)[1]))
    batch = ds.batch(steps)
    torch.cuda.synchronize()
    if data.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    params, opt, met, ef = step(params, opt, batch, ef)
    float(met["loss"])
    dt = time.perf_counter() - ts
    if data.index == 0:
        prof.stop()
        what = (f"train-dp{'-int8' if compress else ''} {arch} "
                f"x{data.size} step (rank 0)")
        by_name = report_profile(prof, dt, 1, what)
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(profiled_ms=dt * 1e3, idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, DP_KEYS))
        if compress:
            rec["wire_ms"] = _wire_kernels_ms(torch, ef, data.size)
    if fsdp is not None:
        del params, opt, step, met, ef, batch
        gc.collect()
        torch.cuda.empty_cache()
        if fsdp["cfg"] is not None:
            rec["fsdp_check"] = fsdp_check_run(torch, data, dev, seed,
                                               fsdp["cfg"], fsdp["params"],
                                               compress)
            if compress:
                rec["fsdp_check_dp"] = dp_int8_check_run(
                    torch, data, dev, seed, fsdp["cfg"], fsdp["params"])
            gc.collect()
            torch.cuda.empty_cache()
        rec["fsdp"] = fsdp_full_run(torch, data, dev, seed, fsdp["steps"],
                                    arch, compress)
    if tp is not None:
        gc.collect()
        torch.cuda.empty_cache()
        rec["tp_int8_check"] = tp_int8_check_run(torch, group, dev, seed,
                                                 tp["cfg"], tp["params"])
    return rec


# the collectives of an FSDP step by profiler name
FSDP_KEYS = DP_KEYS + ("reduce_scatter", "reducescatter", "all_to_all",
                       "alltoall")
# train-fsdp: train-dp's first steps, 2 timed and the profiled third
# (3 of its 4, cut for time)
FSDP_STEPS = 2


def fsdp_inputs(torch, seed, dp_check, steps=FSDP_STEPS) -> dict:
    """What the FSDP phases take into the train-dp spawn: the narrowed
    f32 smollm of train-dp-check and its parameters from ``seed`` (on the
    CPU), ``dp_check`` (train-dp-check's uncompressed rank records) and
    train-fsdp's ``steps``."""
    from repro_torch.models.model import build_model

    cfg = _train_cfg(smoke=True)
    return {"cfg": cfg, "dp_check": dp_check, "steps": steps,
            "params": build_model(cfg, "cpu").init(
                torch.Generator().manual_seed(seed))}


def fsdp_step_bytes(whole, dims, n: int) -> dict:
    """The bytes a rank receives in one FSDP step over ``n`` ranks,
    counted from the placements (ring collectives; not timed): ``gather``,
    the ``all_gather``s of the split weights in their stored type, a
    layer's twice under remat full (the forward and the backward's
    replay: a leaf under a segment, the encoder's too) and the others (the
    embedding, the head) once;
    ``reduce_scatter``, the split weights' f32 gradients once;
    ``all_reduce``, the f32 gradients of the leaves held whole, twice.
    ``whole``: the whole leaves (``Model.param_shapes``)."""
    from repro_torch.tree import tree_flatten_with_path, tree_leaves, tree_map

    flat, _ = tree_flatten_with_path(whole)
    share = (n - 1) / n
    out = {"gather": 0.0, "reduce_scatter": 0.0, "all_reduce": 0.0}
    for (path, x), s in zip(flat, tree_leaves(tree_map(lambda _, s: s,
                                                       whole, dims))):
        if s.data is None:
            out["all_reduce"] += 2 * share * x.numel() * 4
            continue
        times = 2 if any(p.startswith("seg") for p in path) else 1
        out["gather"] += times * share * x.numel() * x.element_size()
        out["reduce_scatter"] += share * x.numel() * 4
    return {k: int(v) for k, v in out.items()}


def fsdp_check_run(torch, data, dev, seed, cfg, params, compress=False):
    """train-fsdp-check on one rank of the train-dp spawn: ``cfg`` (the
    narrowed f32 smollm of ``dp_check_rank``) trained 3 steps under the
    FSDP fallback from ``params`` cut into this rank's slices, on its rows
    of the same global batches (seq 128, batch 2, or one row a rank on
    more ranks); on the int8 wire with
    ``compress`` (train-fsdp-int8-check). Returns the losses, the launch
    counts, the gathered parameters, this rank's slices, the digest of the
    leaves held whole and the step, and whether each split leaf is bitwise
    this rank's ``shard`` of the gathered one."""
    from repro_torch.dist.group import Mesh2D
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import (gather_params, shard_params,
                                           train_placements)
    from repro_torch.tree import tree_leaves, tree_map

    dims = train_placements(build_model(cfg, dev), data=data, fsdp=True)
    mesh = Mesh2D(data, None)
    p = shard_params(_to(params, dev), dims, mesh)
    step, opt, ds = _trainer(cfg, dev, p, seq=128,
                             batch=max(2, data.size), steps=3, lr=3e-3,
                             warmup=1, seed=seed, data=data, fsdp=True,
                             compress=compress)
    _counters(reset=True)
    losses, ef = [], None
    for i in range(3):
        p, opt, met, ef = step(p, opt, ds.batch(i), ef)
        losses.append(float(met["loss"]))
    launches, plain = _counters()
    whole = gather_params(p, dims, mesh)
    sliced = all(tree_leaves(tree_map(
        lambda x, w, s: s.data is None or torch.equal(x, data.shard(w,
                                                                 s.data)),
        p, whole, dims)))
    return dict(losses=losses, launches=launches, plain=plain,
                params=_flat_cpu(torch, whole), sliced=sliced,
                slices=_flat_cpu(torch, p),
                digest=_whole_digest(torch, p, opt, dims),
                n_split=sum(not s.whole for s in tree_leaves(dims)),
                n_leaves=len(tree_leaves(p)))


def dp_int8_check_run(torch, data, dev, seed, cfg, params):
    """train-fsdp-int8-check's reference on one rank of the same spawn:
    ``cfg`` trained 3 steps data-parallel on the int8 wire from the whole
    ``params``, on the same rows and batches as ``fsdp_check_run``.
    Returns the losses and this rank's FSDP slices of the final
    parameters."""
    from repro_torch.dist.group import Mesh2D
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import shard_params, train_placements

    dims = train_placements(build_model(cfg, dev), data=data, fsdp=True)
    p = _to(params, dev)
    step, opt, ds = _trainer(cfg, dev, p, seq=128,
                             batch=max(2, data.size), steps=3, lr=3e-3,
                             warmup=1, seed=seed, data=data, compress=True)
    losses, ef = [], None
    for i in range(3):
        p, opt, met, ef = step(p, opt, ds.batch(i), ef)
        losses.append(float(met["loss"]))
    return dict(losses=losses, slices=_flat_cpu(
        torch, shard_params(p, dims, Mesh2D(data, None))))


def tp_int8_check_run(torch, world, dev, seed, cfg, params):
    """train-tp-int8-check at (data 2, model 2) on one rank of a 4-rank
    spawn (``mesh_groups(world, 2)``): ``cfg`` trained 3 steps on the
    int8 wire from ``params`` cut into this rank's model slices, and the
    same 3 steps over the data group alone from the whole ``params`` (the
    data-2 int8 run it is held to). Returns both runs' losses, the int8
    values of each step that differ between this rank's and its slices of
    the data-2 run's (``_int8_flips``), and the split run's launches."""
    from repro_torch.dist.group import Mesh2D, mesh_groups
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.train.trainer import shard_params
    from repro_torch.tree import tree_leaves, tree_map

    mesh = mesh_groups(world, 2)
    full = _to(params, dev)
    pl = mesh_placements(full, cfg, model=2)
    q_tp, q_dp = [], []
    _counters(reset=True)
    hist_tp, _, _ = _check_steps(
        cfg, dev, shard_params(full, pl, Mesh2D(None, mesh.model)), seed,
        ("loss",), mesh.model, compress=True, data=mesh.data, qs=q_tp)
    launches, plain = _counters()
    hist_dp, _, _ = _check_steps(cfg, dev, full, seed, ("loss",),
                                 compress=True, data=mesh.data, qs=q_dp)
    shapes = [tuple(x.shape) for x in tree_leaves(full)]
    dims = tree_leaves(tree_map(lambda _, s: s.model, full, pl))
    return dict(hist=hist_tp, ref=hist_dp, launches=launches, plain=plain,
                flips=_int8_flips(q_dp, q_tp, shapes, dims,
                                  mesh.model.index, 2),
                values=[q.numel() for q in q_tp],
                index=(mesh.data.index, mesh.model.index))


def fsdp_full_run(torch, data, dev, seed, steps, arch, compress=False):
    """train-fsdp on one rank of the train-dp spawn: ``arch`` at full
    width and depth, bf16, remat full, seq 4096, the train-dp run's
    schedule and batches, under the FSDP fallback: the rank draws its
    slices layer by layer from the seed's single-device draw
    (``trainer.init_shards``), ``steps`` timed steps, then one more,
    profiled on rank 0, whose loss and launches count with theirs; on the
    int8 wire with ``compress`` (train-fsdp-int8, in train-dp-int8's
    spawn). Returns the rank's record (as ``train_dp_rank``'s, with the
    bytes a rank receives a step and the state a rank holds)."""
    from repro_torch.configs import get_config
    from repro_torch.dist import compression
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import init_shards, train_placements
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_config(arch)
    model = build_model(cfg, dev)
    whole = model.param_shapes()
    dims = train_placements(model, data=data, fsdp=True)
    params = init_shards(model, torch.Generator(device=dev).manual_seed(seed),
                         None, data, fsdp=True)
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=TRAIN_BATCH,
                             steps=TRAIN_STEPS, lr=3e-3, warmup=10,
                             seed=seed, data=data, fsdp=True,
                             compress=compress)
    tag = "train-fsdp" + ("-int8" if compress else "")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, times, ef = [], [], None
    for i in range(steps):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, ef = step(params, opt, batch, ef)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        if data.index == 0:
            log(f"[{tag} {arch} x{data.size}] rank 0 step {i} loss "
                f"{losses[-1]:.4f} grad norm {float(met['grad_norm']):.4f} "
                f"{times[-1] * 1e3:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    batch = ds.batch(steps)
    torch.cuda.synchronize()
    if data.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    params, opt, met, ef = step(params, opt, batch, ef)
    losses.append(float(met["loss"]))
    dt = time.perf_counter() - ts
    launches, plain = _counters()
    state = sum(x.numel() * x.element_size() for t in (params, opt.m, opt.v)
                for x in tree_leaves(t))
    split = sum(x.numel() for x in tree_leaves(tree_map(
        lambda x, s: x if s.data is not None else None, whole, dims))
        if x is not None)
    rec = dict(losses=losses, times=times, launches=launches, plain=plain,
               peak=peak, state_bytes=state,
               digest=_whole_digest(torch, params, opt, dims),
               bytes=fsdp_step_bytes(whole, dims, data.size),
               wire=(sum(x.numel() for x in tree_leaves(whole)),
                     compression.scale_groups(whole)[1], split),
               ef_bytes=0 if ef is None else sum(
                   x.numel() * x.element_size() for x in tree_leaves(ef)))
    if data.index == 0:
        prof.stop()
        by_name = report_profile(prof, dt, 1, f"{tag} {arch} "
                                 f"x{data.size} step (rank 0)")
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(profiled_ms=dt * 1e3, idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, FSDP_KEYS))
    return rec


def _report_fsdp_check(chk, dp_check, what) -> dict:
    """train-fsdp-check's gates and print (``report_train_fsdp``); returns
    its launches summed over the ranks."""
    n = len(chk)
    ref_l, ref_p = dp_check[0]["losses"], dp_check[0]["params"]
    for r, rec in enumerate(chk):
        perr = float((rec["params"] - ref_p).abs().max())
        lerr = max(abs(a - b) for a, b in zip(rec["losses"], ref_l))
        check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
              f"{what}-check rank {r}: launches {rec['launches']}, plain "
              f"{rec['plain']}")
        check(lerr <= 1e-6 and perr <= 1e-4,
              f"{what}-check rank {r}: losses {rec['losses']} vs "
              f"train-dp-check's {ref_l} (1e-6), parameters off by {perr} "
              f"(1e-4)")
        check(rec["sliced"], f"{what}-check rank {r}: a split leaf is not "
              f"the rank's slice of the gathered leaf")
    check(len({rec["digest"] for rec in chk}) == 1,
          f"{what}-check: the leaves held whole or the step differ across "
          f"the ranks")
    log(f"[{what}-check] narrowed smollm f32, {n} ranks, {chk[0]['n_split']}"
        f" of {chk[0]['n_leaves']} leaves split over the data group: "
        f"losses {chk[0]['losses']} vs train-dp-check's {ref_l} (max diff "
        f"{max(abs(a - b) for a, b in zip(chk[0]['losses'], ref_l))}); "
        f"gathered parameters off by "
        f"{float((chk[0]['params'] - ref_p).abs().max())}; leaves held whole"
        f" and the step bitwise equal across the ranks; each slice bitwise "
        f"the rank's shard of the gathered leaf; launches a rank "
        f"{chk[0]['launches']}")
    return {k: sum(rec["launches"][k] for rec in chk)
            for k in ("K1", "K2", "K3")}


def _report_fsdp_int8_check(recs, what) -> dict:
    """train-fsdp-int8-check's gates and print: on every rank the losses
    and this rank's slices of the parameters bitwise the data-parallel
    int8 check's (``dp_int8_check_run``, the same spawn), the leaves held
    whole and the step bitwise equal across the ranks, each split leaf
    bitwise the rank's slice of the gathered one, K1-K3 launched and no
    plain version. Returns its launches summed over the ranks."""
    chk = [r["fsdp_check"] for r in recs]
    for r, (rec, ref) in enumerate(zip(chk, (r["fsdp_check_dp"]
                                             for r in recs))):
        check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
              f"{what}-check rank {r}: launches {rec['launches']}, plain "
              f"{rec['plain']}")
        check(rec["losses"] == ref["losses"],
              f"{what}-check rank {r}: losses {rec['losses']} vs the "
              f"data-parallel int8 check's {ref['losses']} (bitwise)")
        check(bool((rec["slices"] == ref["slices"]).all()),
              f"{what}-check rank {r}: its slices differ from the data-"
              f"parallel int8 check's (max "
              f"{float((rec['slices'] - ref['slices']).abs().max())})")
        check(rec["sliced"], f"{what}-check rank {r}: a split leaf is not "
              f"the rank's slice of the gathered leaf")
    check(len({rec["digest"] for rec in chk}) == 1,
          f"{what}-check: the leaves held whole or the step differ across "
          f"the ranks")
    log(f"[{what}-check] narrowed smollm f32, {len(chk)} ranks, "
        f"{chk[0]['n_split']} of {chk[0]['n_leaves']} leaves split over the "
        f"data group, int8 wire: losses {chk[0]['losses']} bitwise the "
        f"data-parallel int8 check's on every rank; every rank's slices "
        f"bitwise its slices of that run's parameters; leaves held whole "
        f"and the step bitwise equal across the ranks; launches a rank "
        f"{chk[0]['launches']}")
    return {k: sum(rec["launches"][k] for rec in chk)
            for k in ("K1", "K2", "K3")}


# the peak per rank of the train-dp spawns' phases, by phase (printed
# beside each other)
PEAKS = {}


def report_train_fsdp(torch, recs, dp_check, what="train-fsdp",
                      arch="smollm-135m", compress=False) -> dict:
    """The gates and prints of train-fsdp-check and train-fsdp, from the
    train-dp spawn's records (``recs``: every rank's, with the train-dp
    run's beside) and ``dp_check`` (train-dp-check's uncompressed rank
    records). train-fsdp-check: losses within 1e-6 of train-dp-check's,
    gathered parameters within 1e-4, the leaves held whole and the step
    bitwise equal across the ranks, each split leaf bitwise the rank's
    slice of the gathered one, K1-K3 launched and no plain version.
    train-fsdp: every step's loss within 1e-3 of train-dp's, equal losses
    and leaves held whole on every rank, per rank and step 2 K1, 1 K2 and
    1 K3 call (2 kernels) an attention layer, no plain version. Prints the
    bytes a rank receives a step (counted), the step median and the peak
    per rank beside train-dp's, and rank 0's profiled step. With
    ``compress`` (train-fsdp-int8-check and train-fsdp-int8, in
    train-dp-int8's spawn): the check by ``_report_fsdp_int8_check``, and
    every loss bitwise train-dp-int8's; the bytes of the int8
    ``all_to_all`` beside the int8 ``all_gather``, and the peak per rank
    beside train-fsdp's and train-dp-int8's. Returns {path: launches
    summed over the ranks}."""
    from repro_torch.configs import get_config
    from repro_torch.dist import compression

    n = len(recs)
    out = {}
    if "fsdp_check" in recs[0]:
        out[f"{what}-check"] = (
            _report_fsdp_int8_check(recs, what) if compress else
            _report_fsdp_check([r["fsdp_check"] for r in recs], dp_check,
                               what))
    fs = [r["fsdp"] for r in recs]
    steps = len(fs[0]["losses"])
    n_attn = _train_attention_layers(get_config(arch))
    want = {"K1": 2 * n_attn * steps, "K2": n_attn * steps,
            "K3": 2 * n_attn * steps}
    r0, dp0 = fs[0], recs[0]
    for r, rec in enumerate(fs):
        check(rec["losses"] == r0["losses"],
              f"{what}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{what} rank {r}: launches {rec['launches']} != {want}, "
              f"plain {rec['plain']}")
    check(len({rec["digest"] for rec in fs}) == 1,
          f"{what}: the leaves held whole or the step differ across the "
          f"ranks")
    diff = [abs(a - b) for a, b in zip(r0["losses"], dp0["losses"])]
    dp_l = dp0["losses"][:steps]
    dp_what = "train-dp-int8" if compress else "train-dp"
    check(all(math.isfinite(x) for x in r0["losses"]) and (
        r0["losses"] == dp_l if compress else max(diff) <= 1e-3),
        f"{what}: losses {r0['losses']} vs {dp_what}'s {dp_l} "
        f"({'bitwise' if compress else '1e-3'})")
    PEAKS[what] = [rec["peak"] for rec in fs]
    PEAKS[dp_what] = [rec["peak"] for rec in recs]
    med = statistics.median(r0["times"][1:]) * 1e3
    dp_med = statistics.median(dp0["times"][1:]) * 1e3
    coll = ", ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    b = r0["bytes"]
    n_val = dp0["grad_size"][0]
    log(f"[{what}] {arch} bf16 remat full, {n} ranks, global batch "
        f"{TRAIN_BATCH} = {n} x {TRAIN_BATCH // n} at seq 4096, the weights "
        f"no model rule splits held as each rank's slice of their largest "
        f"dim{', int8 wire (compress_grads)' if compress else ''}, {steps} "
        f"steps of {dp_what}'s schedule (the last profiled): losses "
        f"{r0['losses']} vs {dp_what}'s {dp_l} (max diff {max(diff)}); "
        f"leaves held whole bitwise equal across the ranks; launches a rank "
        f"{r0['launches']}")
    if compress:
        nv, ng, split = r0["wire"]
        wb = compression.wire_bytes(nv, ng, n, split_values=split)
        log(f"[{what}] a rank receives a step (counted, not timed): gathers "
            f"of the split weights {b['gather']} bytes, the int8 all_to_all"
            f" of its slices of the {split} split values and the {nv - split}"
            f" whole ones, with the f32 scales, {wb['int8_all_to_all']} "
            f"bytes, against train-dp-int8's int8 all_gather "
            f"{wb['int8_gather']} and a ring f32 all_reduce "
            f"{wb['f32_ring_all_reduce']}; parameters and AdamW moments a "
            f"rank {r0['state_bytes']} bytes, the whole f32 residual "
            f"{r0['ef_bytes']} bytes")
    else:
        log(f"[{what}] a rank receives a step (counted, not timed): gathers "
            f"{b['gather']} bytes, f32 reduce_scatter {b['reduce_scatter']}"
            f", f32 all_reduce of the leaves held whole {b['all_reduce']}: "
            f"{sum(b.values())} in all, against train-dp's f32 all_reduce "
            f"{int(2 * (n - 1) / n * n_val * 4)}; parameters and AdamW "
            f"moments a rank {r0['state_bytes']} bytes")
    gib = {k: [round(x / 2**30, 3) for x in v] for k, v in PEAKS.items()}
    peers = ", ".join(f"{k} {v} GiB" for k, v in gib.items() if k != what)
    log(f"[{what}] step median {med:.3f} ms over steps "
        f"1..{len(r0['times']) - 1} "
        f"(rank 0; {dp_what} {dp_med:.3f} ms over 1..{DP_STEPS - 1}); peak "
        f"per rank {gib[what]} GiB ({peers}); profiled "
        f"step (rank 0): host wall {r0['profiled_ms']:.3f} ms, device idle "
        f"share {r0['idle']:.3f}, collectives by name (host time): {coll}")
    out[what] = {k: sum(rec["launches"][k] for rec in fs)
                 for k in ("K1", "K2", "K3")}
    return out


def report_tp_int8_dp(recs, what="train-tp-int8-check") -> dict:
    """train-tp-int8-check at (data 2, model 2), from the 4-rank spawn's
    records (``tp_int8_check_run``): on every rank each step's loss
    within 1e-4 of the data-2 int8 run's (TP reorders the gradients' sums
    by ~1e-7, which can move a value on a rounding boundary by one int8
    step), the int8 values that differ from the data-2 run's slices
    within ``_check_flips``' shares, the model ranks' losses equal, K1-K3
    launched and no plain version; prints the int8 values that differ a
    step. Returns its launches summed over the ranks."""
    rs = [r["tp_int8_check"] for r in recs]
    for r, rec in enumerate(rs):
        diff = max(abs(a[0] - b[0]) for a, b in zip(rec["hist"], rec["ref"]))
        check(diff <= 1e-4, f"{what} (data 2, model 2) rank {r}: losses "
              f"{rec['hist']} vs the data-2 int8 run's {rec['ref']} (1e-4)")
        check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
              f"{what} rank {r}: launches {rec['launches']}, plain "
              f"{rec['plain']}")
        _check_flips(f"{what} (data 2, model 2) rank {r}", rec["flips"],
                     rec["values"])
    for d in (0, 1):
        pair = [rec["hist"] for rec in rs if rec["index"][0] == d]
        check(pair[0] == pair[1], f"{what}: the model ranks of data rank "
              f"{d} disagree: {pair}")
    log(f"[{what}] (data 2, model 2) narrowed gemma f32 on the int8 wire "
        f"(scales maxed over the model group), 3 steps: losses "
        f"{[h[0] for h in rs[0]['hist']]} vs the data-2 int8 run's "
        f"{[h[0] for h in rs[0]['ref']]} (max diff "
        f"{max(abs(a[0] - b[0]) for rec in rs for a, b in zip(rec['hist'], rec['ref']))}"
        f"); int8 values differing from the data-2 run's slices, per rank "
        f"and step: {[rec['flips'] for rec in rs]} of "
        f"{rs[0]['values']}; launches a rank {rs[0]['launches']}")
    return {k: sum(rec["launches"][k] for rec in rs)
            for k in ("K1", "K2", "K3")}


def tp_int8_inputs(torch, seed) -> dict:
    """What train-tp-int8-check at (data 2, model 2) takes into
    train-dp-int8's spawn: the gemma-like narrowed f32 config of
    ``_tp_check_cfgs`` and its parameters from ``seed`` (on the CPU)."""
    from repro_torch.models.model import build_model

    cfg = _tp_check_cfgs()["gemma-7b"]
    return {"cfg": cfg, "params": build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(seed))}


def phase_train_dp(torch, seed, what, ref, ref_dp=None, arch="smollm-135m",
                   n=None, compress=None, fsdp=None, tp=None):
    """train-dp and train-dp-int8: ``DP_PHASES[what]`` ranks
    (``_shard_backend``; or ``n`` ranks, ``compress``) train ``arch`` at
    full width and depth on the train phase's global batch, split by rows
    (``train_dp_rank``). ``ref``: the unsharded train phase's stats (same
    seed, weights, batches and schedule); ``ref_dp``: the uncompressed
    run's losses, for a compressed one.
    Gates: uncompressed, the step-0 loss within 1e-3 of the unsharded
    phase's and every step within 1e-2; compressed, the step-0 loss
    within 1e-3 of train-dp's (it is computed before the reduce) and the
    loss falling, ``ef_state`` finite; both: equal losses and bitwise-
    equal parameters and optimizer state on every rank, per rank and step
    2 K1, 1 K2 and 1 K3 call (2 kernels) an attention layer, no plain
    version. Prints the bytes a rank receives a step (counted), the step
    median beside the unsharded phase's, the peak per rank, the profiled
    step's idle share and collectives (rank 0), and for the int8 wire its
    quantize and sum kernels' device time. ``fsdp`` (a dict with the
    check's ``cfg``, ``params`` and ``dp_check``, train-dp-check's
    records): the same spawn then runs train-fsdp-check and train-fsdp
    (``report_train_fsdp``; train-fsdp-int8-check and train-fsdp-int8
    in a compressed phase). ``tp`` (``tp_int8_inputs``; 4 ranks): then
    train-tp-int8-check at (data 2, model 2) in the same spawn
    (``report_tp_int8_dp``). Returns (the launches summed over the ranks,
    rank 0's losses, the FSDP and TP phases' launches by path or {}).
    ``train_dp_job`` and ``report_train_dp`` are its two halves, for a
    spawn shared with other phases (``phase_two_ranks``)."""
    if n is None:
        n, compress = DP_PHASES[what]
    return _run_alone(torch, seed, n, train_dp_job(
        torch, seed, what, ref, ref_dp, arch, n, compress, fsdp, tp),
        TRAIN_SHARD_TIMEOUT_S)


def train_dp_job(torch, seed, what, ref, ref_dp=None, arch="smollm-135m",
                 n=None, compress=None, fsdp=None, tp=None):
    """The half of ``phase_train_dp`` before its ranks: the ranks' job
    (``train_dp_rank``) with what ``report_train_dp`` reads."""
    if n is None:
        n, compress = DP_PHASES[what]
    backend, device = _shard_backend(torch, n)
    job = (train_dp_rank, (DP_STEPS, compress, arch,
                           None if fsdp is None else
                           {k: fsdp[k] for k in ("cfg", "params", "steps")},
                           tp))
    return job, report_train_dp, dict(
        what=what, ref=ref, ref_dp=ref_dp, arch=arch, n=n, compress=compress,
        fsdp=fsdp, tp=tp, backend=backend, device=device)


def report_train_dp(recs, st, wall, dp_check=None):
    """The half of ``phase_train_dp`` after its ranks. ``dp_check``:
    train-dp-check's uncompressed rank records, where they came from the
    same spawn (else ``st["fsdp"]["dp_check"]``)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import compression

    what, ref, ref_dp, arch = st["what"], st["ref"], st["ref_dp"], st["arch"]
    n, compress, fsdp, tp = st["n"], st["compress"], st["fsdp"], st["tp"]
    backend, device = st["backend"], st["device"]
    cfg = get_config(arch)
    want_l = ref["losses"][:DP_STEPS]
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * DP_STEPS, "K2": n_attn * DP_STEPS,
            "K3": 2 * n_attn * DP_STEPS}
    r0 = recs[0]
    for r, rec in enumerate(recs):
        check(rec["losses"] == r0["losses"],
              f"{what}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{what} rank {r}: launches {rec['launches']} != {want}, "
              f"plain {rec['plain']}")
        check(rec["ef_finite"], f"{what} rank {r}: ef_state not finite")
    losses = r0["losses"]
    check(all(math.isfinite(x) for x in losses), f"{what}: losses {losses}")
    check(len({rec["digest"] for rec in recs}) == 1,
          f"{what}: parameters or optimizer state differ across the ranks")
    if not compress:
        check(abs(losses[0] - want_l[0]) <= 1e-3,
              f"{what}: step-0 loss {losses[0]} vs unsharded {want_l[0]} "
              f"(1e-3)")
        check(all(abs(a - b) <= 1e-2 for a, b in zip(losses, want_l)),
              f"{what}: losses {losses} vs unsharded {want_l} (1e-2)")
    else:
        check(abs(losses[0] - ref_dp[0]) <= 1e-3,
              f"{what}: step-0 loss {losses[0]} vs train-dp's {ref_dp[0]} "
              f"(1e-3)")
        check(losses[-1] < losses[0], f"{what}: the loss did not fall: "
              f"{losses}")
    med = sorted(r0["times"][1:])[(DP_STEPS - 1) // 2] * 1e3
    coll = ", ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    n_val, n_tensors = r0["grad_size"]
    wb = compression.wire_bytes(n_val, n_tensors, n)
    log(f"[{what}] the gradient: {n_val} f32 values in {n_tensors} tensors "
        f"(the reference's stacked leaves); a rank receives a step "
        f"{wb['f32_ring_all_reduce']} bytes on a ring f32 all_reduce and "
        f"{wb['int8_gather']} on the int8 wire (int8 values + f32 scales of "
        f"the {n - 1} other ranks; counted, not timed); this phase runs "
        f"the {'int8 wire' if compress else 'f32 all_reduce'}")
    log(f"[{what}] {arch} bf16 remat full, {n} ranks on backend "
        f"{backend} ({device or 'one card a rank'}), global batch "
        f"{TRAIN_BATCH} = {n} x {TRAIN_BATCH // n} at seq 4096, "
        f"{'int8 wire (compress_grads)' if compress else 'f32 all_reduce'},"
        f" {DP_STEPS} steps of a {TRAIN_STEPS}-step schedule: {wall:.1f} s "
        f"on rank 0; losses {losses} vs unsharded {want_l} "
        f"(max diff {max(abs(a - b) for a, b in zip(losses, want_l))}); "
        f"state bitwise equal across the ranks; launches a rank "
        f"{r0['launches']}")
    log(f"[{what}] step median {med:.3f} ms over steps 1..{DP_STEPS - 1} "
        f"(rank 0; unsharded {ref['median_ms']:.3f} ms; "
        f"{TRAIN_BATCH * 4096 / med * 1e3:.1f} tokens/s over the ranks); "
        f"peak per rank {[round(rec['peak'] / 2**30, 3) for rec in recs]} "
        f"GiB (unsharded {ref['peak'] / 2**30:.3f} GiB); profiled step "
        f"(rank 0): host wall {r0['profiled_ms']:.3f} ms, device idle share "
        f"{r0['idle']:.3f}, collectives by name (host time): {coll}")
    if compress:
        log(f"[{what}] the wire's own kernels on rank 0 (CUDA events, "
            f"device time): quantize {r0['wire_ms']['quantize']:.3f} ms, "
            f"dequantize and sum of {n} parts "
            f"{r0['wire_ms']['dequantize_sum']:.3f} ms a step")
    if fsdp is not None and dp_check is None:
        dp_check = fsdp["dp_check"]
    extra = {} if fsdp is None else report_train_fsdp(
        torch, recs, dp_check, what.replace("train-dp",
                                                    "train-fsdp"), arch,
        compress)
    if tp is not None:
        extra["train-tp-int8-check-data2-model2"] = report_tp_int8_dp(recs)
    return ({k: sum(rec["launches"][k] for rec in recs)
             for k in ("K1", "K2", "K3")}, losses, extra)


TP_RANKS = 2             # train-tp phases: the model group's ranks
# train-tp: the unsharded train phase's first steps, compared with it
TP_STEPS = 4
# the collectives of a tensor-parallel step by profiler name
TP_KEYS = ("all_reduce", "allreduce", "all_gather", "allgather",
           "reduce_scatter", "reducescatter")


def _tp_shares(cfg, n: int) -> dict:
    """One rank's share of a program's parameters under a model group of
    ``n`` (``dist.sharding.mesh_placements``: each leaf split on its own
    width): its embedding rows (and LM head's), its slice of each layer
    (the query and output projections by heads, the KV projections by KV
    heads, a dense or shared MLP by ffn, an MoE layer's expert stacks and
    router columns by experts, ``moe.expert_span``, or where the group
    does not divide the experts every expert with its ffn split where the
    group divides it, the router whole; an RG-LRU block's
    ``w_in``/``w_gate_branch``/``w_out`` by ``d_rnn`` with its gates
    ``w_a``, ``w_i`` (d_rnn^2 each), conv and ``lam`` whole; an SSD
    block's ``w_in`` and ``w_out`` by their widths with its conv and
    per-head leaves whole; a whisper decoder block's two attentions; the
    norms whole), an encoder's layers, a VLM's whole vision projection
    and its vocab rows. Also its experts a layer and the leaf whose update
    temporaries ``train_bytes`` counts: the embedding, or one expert stack
    where that is the larger."""
    from repro_torch.dist.sharding import split_axes
    from repro_torch.models.transformer import make_program

    s = split_axes(cfg, n)
    d, hd = cfg.d_model, cfg.hd

    def part(count, axis="ffn"):
        """``count`` on this rank: a head, KV head, vocab or expert count
        split where ``cell_rules`` splits it; an ffn width where ``n``
        divides it."""
        ok = count % n == 0 if axis == "ffn" else axis in s
        return count // n if ok else count

    vocab = part(cfg.vocab_size, "vocab")
    embed = vocab * d * (1 if cfg.tie_embeddings else 2)
    mults = 3 if cfg.act in ("swiglu", "geglu") else 2
    proj = (2 * d * hd * part(cfg.n_heads, "heads")
            + 2 * d * hd * part(cfg.n_kv_heads, "kv_heads"))
    attn = proj + 2 * d
    mlp = mults * d * part(cfg.d_ff)
    layer = {"attn_mlp": attn + mlp, "attn_mlp_local": attn + mlp,
             "xattn": 2 * proj + 3 * d + mlp}
    experts = stack = expert_ffn = 0
    if cfg.moe is not None:
        f = cfg.moe.d_ff_expert
        experts = part(cfg.moe.n_experts, "experts")
        # a group that does not divide the experts splits their ffn where
        # it divides it (moe.expert_split)
        expert_ffn = f if "experts" in s else part(f)
        stack = experts * d * expert_ffn
        moe = (d * experts + mults * stack
               + mults * d * part(f * cfg.moe.n_shared_experts))
        layer.update(attn_moe=attn + moe, attn_moe_dense=attn + mlp + moe)
    if cfg.recurrent is not None:
        dr = cfg.recurrent.d_rnn or d
        rec = (3 * d * part(dr) + 2 * dr * dr
               + (cfg.recurrent.conv_width + 1) * dr)
        layer["rec_mlp"] = rec + mlp + 2 * d
        layer["griffin"] = 2 * layer["rec_mlp"] + attn + mlp
    if cfg.ssm is not None:
        sc = cfg.ssm
        di = sc.expand * d
        Hs = di // sc.head_dim
        layer["ssm"] = (d * part(2 * di + 2 * sc.d_state + Hs)
                        + part(di) * d + sc.conv_width * (di + 2 * sc.d_state)
                        + 3 * Hs + di + d)
    program = make_program(cfg)
    extra = (cfg.n_layers * (attn + mlp) + d if cfg.encoder_decoder else 0) \
        + (d * d if cfg.n_vision_tokens else 0)
    return dict(embedding=embed, per_layer=layer[program[-1][0]],
                vocab=vocab, experts=experts, expert_ffn=expert_ffn,
                largest=max(embed, stack),
                params=embed + sum(k * layer[kind] for kind, k in program)
                + d + extra)


def train_bytes_tp(cfg, seq: int, batch: int, n: int) -> dict:
    """``train_bytes`` for one rank of a model group of ``n``: the same
    reckoning on the rank's parameters (``_tp_shares``), the update's
    temporaries of its largest leaf and its vocab slice of the f32
    logits; on an MoE program also one MoE layer's dispatch in its
    backward: the bf16 buffer, expert products and output rows of its
    E / n experts' slots and the (T·k, d) rows before and after the sum,
    each with its gradient. The activations a layer saves are whole on
    every rank."""
    whole = train_bytes(cfg, seq, batch)
    sh = _tp_shares(cfg, n)
    params = sh["params"]
    T = seq * batch
    dispatch = 0
    if cfg.moe is not None:
        from repro_torch.models.moe import capacity, n_groups

        m = cfg.moe
        G = n_groups(cfg, T)
        slots = sh["experts"] * G * capacity(cfg, T // G)
        dispatch = 2 * 2 * (slots * (2 * cfg.d_model + 3 * sh["expert_ffn"])
                            + 2 * T * m.top_k * cfg.d_model)
    update = max(32 * params, 18 * params + 20 * sh["largest"])
    loss = (16 * T * sh["vocab"] + 10 * params + whole["saved"]
            + whole["recompute"] + whole["extras"] + dispatch)
    return dict(params=params, per_layer=sh["per_layer"],
                experts=sh["experts"], embedding=sh["embedding"],
                largest=sh["largest"], resident=10 * params,
                update_peak=update, loss_peak=loss, saved=whole["saved"],
                dispatch=dispatch, peak=max(update, loss))


def train_tp_depth(torch, arch: str, seq: int, batch: int, n: int,
                   share: bool = True) -> int:
    """The deepest ``arch`` (every published width kept; whole griffin
    groups for a hybrid program) whose reckoned train-step peak of one
    rank of a model group of ``n`` (``train_bytes_tp``), times the ``n``
    ranks that share the card (``share``; else one rank a card), fits in
    92 % of a card's memory. Prints the reckoning."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    unit = 3 if full.family == "hybrid" else 1
    total = torch.cuda.get_device_properties(0).total_memory
    budget = 0.92 * total
    k = n if share else 1
    depth = 0
    for layers in range(unit, full.n_layers + 1, unit):
        b = train_bytes_tp(dataclasses.replace(full, n_layers=layers), seq,
                           batch, n)
        if k * b["peak"] > budget:
            break
        depth = layers
    check(depth > 0, f"no {unit} layer(s) of {arch} fit the card at {n} "
          f"ranks")
    b = train_bytes_tp(dataclasses.replace(full, n_layers=depth), seq,
                       batch, n)
    nxt = train_bytes_tp(dataclasses.replace(full, n_layers=depth + unit),
                         seq, batch, n)
    log(f"[train-tp {arch}] reckoned bytes a rank at {n} model ranks, seq "
        f"{seq} batch {batch}: embedding {b['embedding'] / 1e6:.1f}M params "
        f"a rank, {b['per_layer'] / 1e6:.1f}M a layer; {depth} of "
        f"{full.n_layers} layers fit {budget / 1e9:.2f} GB (92 % of "
        f"{total / 1e9:.2f}) with {k} rank(s) on a card: "
        f"{b['params'] / 1e6:.1f}M params a rank, resident "
        f"{b['resident'] / 1e9:.2f} GB, update peak "
        f"{b['update_peak'] / 1e9:.2f} GB, loss peak "
        f"{b['loss_peak'] / 1e9:.2f} GB a rank (x {k}: "
        f"{k * b['peak'] / 1e9:.2f} GB)" + (
            f"; {depth + unit} layers would peak at "
            f"{k * nxt['peak'] / 1e9:.2f} GB" if depth < full.n_layers
            else ""))
    return depth


def tp_step_bytes(cfg, seq: int, batch: int, n: int,
                  scale_groups: int = 0) -> dict:
    """The collectives of one train step (remat full: a layer, or a
    griffin group, one checkpointed unit) of one rank of a model group of
    ``n``, counted from the shapes. Where the group splits the heads,
    each attention sums its (batch, seq, d) output over the group forward
    and again in the remat replay, and its input's gradient backward (3
    all_reduces); where it splits a dense or shared MLP's ffn, the MLP
    sums its output forward and its input's gradient backward, and in the
    replay too unless it ends its unit (the replay stops at the unit's
    last saved tensor; torch's checkpoint stops early); an MoE layer sums
    its input's gradient backward (1), gathers its f32 router logits (T,
    E) forward and in the replay (2 all_gathers) and sums its (T·k, d)
    expert rows forward and in the replay (2). Replicated ``wk``/``wv``
    under split heads sum their gradients. An RG-LRU block whose
    ``d_rnn`` splits sums its input's gradient (1) and its output forward
    and in the replay (2), gathers its f32 (T, d_rnn) gate input forward
    and in the replay (2 all_gathers) and reduce-scatters that gradient
    (1). An SSD block gathers its (T, 2 d_inner + 2N + H) projection
    where ``w_in`` splits (2; its gradient reduce-scattered where
    ``w_out`` splits too), sums its input's gradient (1), its norm's f32
    (T, 1) sum of squares where it runs by heads (3: forward, replay,
    backward) and its output where ``w_out`` splits (1: it ends its
    layer). Whisper's cross attention sums x's and the encoder output's
    (batch, frames, d) gradients (2) and its output (2: forward and
    replay), and its encoder's layers count as attention blocks over the
    frames. A split vocabulary sums the embedding lookup forward and the
    head's input gradient backward, and the loss runs three (batch, seq)
    f32 collectives (max, sum of exp, gold logit); the whole leaves a rank
    uses only its part of (``Split.model_sum``) sum their f32 gradients
    in one all_reduce; the clip sums one f32; on the int8 wire
    (``scale_groups`` > 0) the scales' absmax is maxed over the group in
    one all_reduce of ``scale_groups`` f32. Returns the calls and
    payload bytes of each kind and the bytes a rank sends on a ring
    (all_reduce 2 (n - 1) / n of the payload, all_gather and
    reduce_scatter (n - 1) / n of the whole tensor)."""
    import torch

    from repro_torch.dist.sharding import split_axes
    from repro_torch.models.transformer import MOE_KINDS, make_program

    m = cfg.moe
    s = split_axes(cfg, n)
    cb = torch.finfo(getattr(torch, cfg.compute_dtype)).bits // 8
    w = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    d, T = cfg.d_model, seq * batch
    act = T * d * cb
    calls = {"all_reduce": [0, 0], "all_gather": [0, 0],
             "reduce_scatter": [0, 0]}

    def add(kind, times, payload):
        calls[kind][0] += times
        calls[kind][1] += times * payload

    def attention(k, a=act):
        if "heads" in s:
            add("all_reduce", 3 * k, a)
            if "kv_heads" not in s:
                add("all_reduce", 2 * k, d * cfg.n_kv_heads * cfg.hd * w)

    def mlp(k, last=True, width=cfg.d_ff, a=act):
        if n > 1 and width and width % n == 0:
            add("all_reduce", (2 if last else 3) * k, a)

    summed = 0                      # the model_sum leaves' f32 values
    for kind, k in make_program(cfg):
        if kind in ("attn_mlp", "attn_mlp_local", "griffin"):
            attention(k)
            mlp(k)
        if kind in MOE_KINDS:
            attention(k)
            add("all_reduce", k, act)
            add("all_reduce", 2 * k, T * m.top_k * d * cb)
            add("all_gather", 2 * k, T * m.n_experts * 4)
            if kind == "attn_moe_dense":
                mlp(k)
            elif m.n_shared_experts:
                mlp(k, width=m.d_ff_expert * m.n_shared_experts)
        if kind in ("rec_mlp", "griffin"):
            reps = k * (2 if kind == "griffin" else 1)
            dr = cfg.recurrent.d_rnn or d
            if dr % n == 0 and n > 1:
                add("all_reduce", 3 * reps, act)
                add("all_gather", 2 * reps, T * dr * 4)
                add("reduce_scatter", reps, T * dr * 4)
                summed += reps * (2 * dr * dr
                                  + (cfg.recurrent.conv_width + 1) * dr)
            mlp(reps, last=kind == "rec_mlp")
        if kind == "ssm":
            sc = cfg.ssm
            di = sc.expand * d
            Hs = di // sc.head_dim
            wide = 2 * di + 2 * sc.d_state + Hs
            cut_in = n > 1 and wide % n == 0
            cut_out = n > 1 and di % n == 0
            if cut_in or cut_out:
                add("all_reduce", k, act)
            if cut_in:
                add("all_gather", 2 * k, T * wide * cb)
            if cut_in and cut_out:
                add("reduce_scatter", k, T * wide * cb)
            if cut_out:
                add("all_reduce", k, act)
                if Hs % n == 0:
                    add("all_reduce", 3 * k, T * 4)
                summed += k * (sc.conv_width * (di + 2 * sc.d_state)
                               + 3 * Hs + di + (0 if cut_in else d * wide))
        if kind == "xattn":
            attention(k)
            if "heads" in s:
                add("all_reduce", 3 * k, act)
                add("all_reduce", k, batch * cfg.n_audio_frames * d * cb)
                if "kv_heads" not in s:
                    add("all_reduce", 2 * k,
                        d * cfg.n_kv_heads * cfg.hd * w)
            mlp(k)
    if cfg.encoder_decoder:
        frames = batch * cfg.n_audio_frames * d * cb
        attention(cfg.n_layers, frames)
        mlp(cfg.n_layers, a=frames)
    if "vocab" in s:
        add("all_reduce", 5, 0)
        calls["all_reduce"][1] += 2 * act + 3 * T * 4
    if summed:
        add("all_reduce", 1, 4 * summed)
    add("all_reduce", 1, 4)
    if scale_groups:
        add("all_reduce", 1, 4 * scale_groups)
    (red, red_b), (gat, gat_b), (rs, rs_b) = (
        calls[k] for k in ("all_reduce", "all_gather", "reduce_scatter"))
    return dict(all_reduces=red, all_reduce_payload=red_b, all_gathers=gat,
                all_gather_payload=gat_b, reduce_scatters=rs,
                reduce_scatter_payload=rs_b, model_sum_bytes=4 * summed,
                ring_sent=int(2 * (n - 1) / n * red_b
                              + (n - 1) / n * (gat_b + rs_b)))


def _step_bytes_line(sb) -> str:
    """``tp_step_bytes``' count as a log line's words."""
    return (f"a rank's collectives a step (counted from the shapes): "
            f"{sb['all_reduces']} all_reduces of {sb['all_reduce_payload']} "
            f"bytes (of them one of the whole leaves' summed f32 gradients, "
            f"{sb['model_sum_bytes']} bytes), {sb['all_gathers']} "
            f"all_gathers of {sb['all_gather_payload']} bytes, "
            f"{sb['reduce_scatters']} reduce_scatters of "
            f"{sb['reduce_scatter_payload']} bytes, {sb['ring_sent']} bytes "
            f"sent on a ring")


def _tp_check_cfgs():
    """train-tp-check's narrowed f32 configs at 2 ranks: gemma-like (2 / 2
    heads of hd 256, ffn 512, vocab 256: every placement split),
    smollm-like (3 / 1 heads: the attention whole on every rank; ffn and
    vocab split), and the train-checks' recurrentgemma (d_rnn 256 split,
    its gates' input gathered; 2 query heads on one KV head), mamba2 (the
    SSD by heads: w_in 296 and w_out 128 split, no attention), qwen2-vl
    (M-RoPE and the vision merge; 6 query heads on one KV head) and
    whisper (the encoder and the cross attention split)."""
    return {"gemma-7b": _check_cfgs()["gemma-7b"],
            "smollm-135m": _train_cfg(smoke=True),
            **_recurrent_check_cfgs(), **_family_check_cfgs()}


def _whole_digest(torch, params, opt, placements):
    """sha256 of the leaves a rank holds whole (parameters and moments of
    the leaves ``placements``, a ``Split`` tree, keeps whole; matched by
    key) and of the optimizer's step."""
    from repro_torch.tree import tree_leaves, tree_map

    held = tree_leaves(tree_map(lambda _, s: s.whole, params, placements))
    whole = [x for t in (params, opt.m, opt.v)
             for x, h in zip(tree_leaves(t), held) if h]
    return _digest(torch, whole) + f":{opt.step}"


def _check_steps(cfg, dev, p, seed, keys, model_group=None,
                 compress=False, data=None, qs=None):
    """The 3 steps of a split-training check (seq 128, batch 2, lr 3e-3,
    warmup 1, as train_check) from ``p`` on ``dev``, one rank or this
    rank of ``model_group`` (and of ``data``), on the int8 wire with
    ``compress``: the metrics ``keys`` of each step, the final parameters
    and optimizer state. ``qs``: a list that gets each step's int8 values
    (``_Int8Tap``)."""
    step, opt, ds = _trainer(cfg, dev, p, seq=128, batch=2, steps=3,
                             lr=3e-3, warmup=1, seed=seed,
                             model_group=model_group, compress=compress,
                             data=data)
    hist, ef = [], None
    for i in range(3):
        with _Int8Tap(qs):
            p, opt, met, ef = step(p, opt, ds.batch(i), ef)
        hist.append(tuple(float(met[k]) for k in keys))
    return hist, p, opt


class _Int8Tap:
    """Within the block, every int8 value the compressed wire quantizes
    (``compression._quantize``) is kept; at its end ``qs`` (a list, or
    None to keep nothing) gets them end to end, one flat CPU int8 tensor:
    what a rank put on the wire in one step."""

    def __init__(self, qs):
        self.qs, self.parts = qs, []

    def __enter__(self):
        from repro_torch.dist import compression as CP
        self.real = CP._quantize
        if self.qs is not None:
            def tap(x, s):
                q = self.real(x, s)
                self.parts.append(q.reshape(-1).cpu())
                return q
            CP._quantize = tap
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import compression as CP
        CP._quantize = self.real
        if self.qs is not None and exc[0] is None:
            import torch
            self.qs.append(torch.cat(self.parts))
        return False


# the int8 values a rank of a split run may put on the wire differently
# from its slices of the one-rank run's, as a share of its values: at
# step 0 (the same parameters; only the gradients' summation order
# differs) and at every step (the earlier flips move the parameters).
# Correct runs on the H100 flipped at most 1.3e-5 at step 0 and 6.6e-4
# at step 2; a rank that quantized with its own slice's absmax would move
# most of its nonzero values.
FLIPS_STEP0 = 1e-4
FLIPS_ANY = 2e-3


def _check_flips(what, flips, values) -> None:
    """Fails unless each step's ``flips`` of a rank's ``values`` int8
    values stay within ``FLIPS_STEP0`` (step 0) and ``FLIPS_ANY``."""
    check(flips[0] <= FLIPS_STEP0 * values[0]
          and all(f <= FLIPS_ANY * v for f, v in zip(flips, values)),
          f"{what}: int8 values differing from the reference's slices a "
          f"step {flips} of {values} (at most {FLIPS_STEP0} of them at "
          f"step 0, {FLIPS_ANY} at any)")


def _int8_flips(ref, got, shapes, dims, index, n) -> list:
    """Per step, how many of this rank's int8 values (``got``: one flat
    tensor a step) differ from its slices of the whole run's (``ref``:
    the whole leaves end to end, ``shapes`` their shapes in leaf order,
    ``dims`` each leaf's split dim over the ``n`` model ranks or None):
    values on a rounding boundary that a reordered sum moved by one int8
    step."""
    import math

    import torch

    out = []
    for r, g in zip(ref, got):
        parts, off = [], 0
        for sh, d in zip(shapes, dims):
            k = math.prod(sh)
            leaf = r[off: off + k].view(sh)
            off += k
            parts.append((leaf if d is None else
                          leaf.chunk(n, d)[index]).reshape(-1))
        want = torch.cat(parts)
        if want.numel() != g.numel():
            raise RuntimeError(f"the int8 values of a step: {g.numel()} on "
                               f"the rank, {want.numel()} in its slices")
        out.append(int((want != g).sum()))
    return out


# a train-tp phase's schedule per arch: (batch, schedule steps, lr,
# warmup), the unsharded train phase's
TP_SCHED = {"gemma-7b": (GEMMA_BATCH, GEMMA_STEPS, 1e-3, 3),
            "recurrentgemma-9b": (GEMMA_BATCH, GEMMA_STEPS, 1e-3, 3),
            "mamba2-370m": (MAMBA_BATCH, GEMMA_STEPS, 1e-3, 3)}
TP_SCHED_DEFAULT = (TRAIN_BATCH, TRAIN_STEPS, 3e-3, 10)


def _tp_main_run(mg, seed, arch, depth, n_steps, compress=False):
    """One train-tp run of ``arch`` on this rank of ``mg``: full width at
    ``depth`` layers, bf16, remat full, seq 4096, ``n_steps`` steps of the
    arch's train phase's schedule (``TP_SCHED``), this rank's slices drawn
    layer by layer from the single-device draw of ``seed``
    (``trainer.init_shards``), then one more step, profiled on rank 0; on
    the int8 wire with ``compress`` (train-tp-int8). Returns the rank's
    record."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist import compression
    from repro_torch.dist.sharding import describe, mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import init_shards

    dev = str(mg.device)
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    batch_n, sched_steps, lr, warmup = TP_SCHED.get(arch, TP_SCHED_DEFAULT)
    torch.cuda.empty_cache()
    params = init_shards(build_model(cfg, dev),
                         torch.Generator(device=dev).manual_seed(seed), mg)
    pl = mesh_placements(params, cfg, model=mg.size)
    tag = "train-tp-int8" if compress else "train-tp"
    if mg.index == 0 and not compress:
        log(f"[train-tp] {arch} placements over {mg.size} ranks: "
            f"{describe(params, pl)}")
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=batch_n,
                             steps=sched_steps, lr=lr, warmup=warmup,
                             seed=seed, model_group=mg, compress=compress)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, times, ef = [], [], None
    for i in range(n_steps):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, ef = step(params, opt, batch, ef)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        if mg.index == 0:
            log(f"[{tag}] {arch} rank 0 step {i} loss {losses[-1]:.4f} "
                f"grad norm {float(met['grad_norm']):.4f} "
                f"{times[-1] * 1e3:.1f} ms")
    launches, plain = _counters()
    rec = dict(losses=losses, times=times, launches=launches, plain=plain,
               peak=torch.cuda.max_memory_allocated(),
               whole=_whole_digest(torch, params, opt, pl),
               n_groups=compression.scale_groups(params)[1])
    batch = ds.batch(n_steps)
    torch.cuda.synchronize()
    if mg.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    params, opt, met, ef = step(params, opt, batch, ef)
    float(met["loss"])
    dt = time.perf_counter() - ts
    if mg.index == 0:
        prof.stop()
        by_name = report_profile(prof, dt, 1, f"{tag} {arch} step "
                                 f"(rank 0)")
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(profiled_ms=dt * 1e3, idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, TP_KEYS))
    return rec


def _tp_int8_check_cfgs():
    """train-tp-int8-check's narrowed f32 configs at (model 2): the
    gemma-like one of ``_tp_check_cfgs`` and the arctic-like MoE check
    config (expert stacks split over the ranks, so their scale groups
    span them)."""
    return {"gemma-7b": _tp_check_cfgs()["gemma-7b"],
            "arctic-480b": _moe_check_cfgs()["arctic-480b"]}


def train_tp_rank(mesh, seed, check_params, runs, ep=None, int8=None,
                  epu=None):
    """A spawned rank of the tensor-parallel phases. train-tp-check: each
    ``_tp_check_cfgs`` config trained 3 steps (seq 128, batch 2, as
    train_check) from ``check_params`` cut to this rank's slices. Then
    each ``(arch, depth, n_steps)`` of ``runs`` (``_tp_main_run``: train-tp
    gemma-7b, train-tp recurrentgemma-9b), each run's state freed before
    the next. With ``int8`` (``{"checks": {arch: whole parameters},
    "run": (arch, depth, n_steps)}``): train-tp-int8-check, each
    ``_tp_int8_check_cfgs`` config's 3 steps on the int8 wire (the int8
    values of each step kept, under "int8 <arch>"), and train-tp-int8,
    the run on the int8 wire (``_tp_main_run``, under "main-int8
    <arch>"). Then, with ``ep`` (the ranks' arguments of
    ``prepare_train_ep``), the expert-parallel phases in the same ranks
    (``train_ep_rank``, its records under "ep"), and with ``epu``
    (``prepare_train_ep_uneven``'s) the uneven ones
    (``train_ep_uneven_rank``, under "ep-uneven"). Returns the rank's
    records."""
    import torch

    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.train.trainer import gather_params, shard_params

    _rank_prelude(torch)
    mg = mesh.model
    on = Mesh2D(None, mg)       # the model axis alone
    dev = str(mg.device)
    out = {}
    for check_arch, cfg in _tp_check_cfgs().items():
        if check_arch not in check_params:
            continue
        full = _to(check_params[check_arch], dev)
        pl = mesh_placements(full, cfg, model=mg.size)
        _counters(reset=True)
        hist, p, opt = _check_steps(cfg, dev, shard_params(full, pl, on),
                                    seed, ("loss", "grad_norm"), mg)
        launches, plain = _counters()
        out[check_arch] = dict(
            hist=hist, launches=launches, plain=plain,
            params=_flat_cpu(torch, gather_params(p, pl, on)),
            whole=_whole_digest(torch, p, opt, pl))
        del full, p, opt
    for check_arch, cfg in _tp_int8_check_cfgs().items():
        if int8 is None or check_arch not in int8["checks"]:
            continue
        full = _to(int8["checks"][check_arch], dev)
        pl = mesh_placements(full, cfg, model=mg.size)
        qs = []
        _counters(reset=True)
        hist, _, _ = _check_steps(cfg, dev, shard_params(full, pl, on),
                                  seed, ("loss", "grad_norm"), mg,
                                  compress=True, qs=qs)
        launches, plain = _counters()
        out[f"int8 {check_arch}"] = dict(hist=hist, q=qs, launches=launches,
                                         plain=plain)
        del full
    for arch, depth, n_steps in runs:
        gc.collect()
        out[f"main {arch}"] = _tp_main_run(mg, seed, arch, depth, n_steps)
    if int8 is not None and int8["run"] is not None:
        gc.collect()
        torch.cuda.empty_cache()
        arch, depth, n_steps = int8["run"]
        out[f"main-int8 {arch}"] = _tp_main_run(mg, seed, arch, depth,
                                                n_steps, compress=True)
    if ep is not None:
        gc.collect()
        torch.cuda.empty_cache()
        out["ep"] = train_ep_rank(mesh, seed, ep)
    if epu is not None:
        gc.collect()
        torch.cuda.empty_cache()
        out["ep-uneven"] = train_ep_uneven_rank(mesh, seed, epu)
    return out


def _tp_plan(torch, seed, arch, ref, ref_depth, n, share, depth=None):
    """(depth, the unsharded reference's stats or None, steps) of a
    train-tp run of ``arch`` on ``n`` model ranks: ``depth``, or the one
    ``train_tp_depth`` picks; where it is not ``ref_depth`` (the depth of
    the unsharded phase ``ref``) and fits one card unsharded, the
    unsharded phase runs here at that depth; with a reference the run
    takes ``TP_STEPS`` steps, else the whole schedule."""
    from repro_torch.configs import get_config

    batch_n, sched_steps, lr, warmup = TP_SCHED.get(arch, TP_SCHED_DEFAULT)
    if depth is None:
        depth = train_tp_depth(torch, arch, 4096, batch_n, n, share=share)
    if depth != ref_depth:
        ref = None
        fits = _fit_depth(get_config(arch), 4096, batch_n, 0.92 * torch.cuda
                          .get_device_properties(0).total_memory)
        if depth <= fits:
            torch.cuda.empty_cache()
            _, _, ref = phase_train(
                torch, seed, arch, n_layers=depth, steps=sched_steps,
                batch=batch_n, lr=lr, warmup=warmup)
    return depth, ref, TP_STEPS if ref is not None else sched_steps


def _report_train_tp(rec_list, arch, depth, n_steps, ref, n, backend,
                     device, wall) -> dict:
    """Gate and print one train-tp run from every rank's record
    (``_tp_main_run``'s). Returns its launches summed over the ranks."""
    import dataclasses

    from repro_torch.configs import get_config

    batch_n, sched_steps, _, _ = TP_SCHED.get(arch, TP_SCHED_DEFAULT)
    tag = "train-tp" + ("" if arch == "gemma-7b" else f" {arch}") + (
        "" if n == TP_RANKS else f" x{n}")
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    rs = rec_list
    r0 = rs[0]
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * n_steps, "K2": n_attn * n_steps,
            "K3": 2 * n_attn * n_steps}
    for r, rec in enumerate(rs):
        check(rec["losses"] == r0["losses"],
              f"{tag}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{tag} rank {r}: launches {rec['launches']} != {want}, "
              f"plain {rec['plain']}")
    losses = r0["losses"]
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(len({rec["whole"] for rec in rs}) == 1,
          f"{tag}: the leaves held whole or the step differ across the ranks")
    if ref is not None:
        check(losses[-1] < losses[0],
              f"{tag}: the loss did not fall: {losses}")
        want_l = ref["losses"][:TP_STEPS]
        check(all(abs(a - b) <= 1e-2 for a, b in zip(losses, want_l)),
              f"{tag}: losses {losses} vs unsharded {want_l} (1e-2)")
        vs = (f"vs unsharded {want_l} (max diff "
              f"{max(abs(a - b) for a, b in zip(losses, want_l))})")
        unsh = (f"unsharded {ref['median_ms']:.3f} ms; peak "
                f"{ref['peak'] / 2**30:.3f} GiB")
    else:
        check(sum(losses[-5:]) / 5 < losses[0],
              f"{tag}: the loss did not fall: {losses}")
        vs = (f"(no unsharded reference: {depth} layers of {arch} do not "
              f"fit one card)")
        unsh = "no unsharded run"
    med = sorted(r0["times"][1:])[(n_steps - 1) // 2] * 1e3
    coll = ", ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    sb = tp_step_bytes(cfg, 4096, batch_n, n)
    log(f"[{tag}] {arch} bf16 remat full, {depth} of {full.n_layers} layers,"
        f" {n} model ranks on backend {backend} "
        f"({device or 'one card a rank'}), seq 4096 batch {batch_n}, "
        f"{n_steps} steps of a {sched_steps}-step schedule: {wall:.1f} s "
        f"on rank 0 with every tensor-parallel phase; losses {losses} "
        f"{vs}; whole leaves and step bitwise equal across the ranks; "
        f"launches a rank {r0['launches']}")
    log(f"[{tag}] step median {med:.3f} ms over steps 1..{n_steps - 1} "
        f"(rank 0; {unsh}); {batch_n * 4096 / med * 1e3:.1f} tokens/s; peak "
        f"per rank {[round(rec['peak'] / 2**30, 3) for rec in rs]} GiB; "
        f"profiled step (rank 0): host wall {r0['profiled_ms']:.3f} ms, "
        f"device idle share {r0['idle']:.3f}, collectives by name (host "
        f"time): {coll}")
    log(f"[{tag}] {_step_bytes_line(sb)}")
    return {tag.replace(" ", "-"): {k: sum(rec["launches"][k] for rec in rs)
                                    for k in ("K1", "K2", "K3")}}


# train-tp-int8: the arch run on the int8 wire in train-tp's spawn, at
# its train-tp run's depth, and the steps (the first of train-tp's)
TP_INT8 = ("gemma-7b", 3)


def _report_tp_int8_checks(recs, refs, n, backend, device) -> dict:
    """train-tp-int8-check at (model ``n``), from every rank's records
    against the one-rank compressed steps (``refs``: arch -> (hist, the
    int8 values of each step, the whole leaves' shapes, their split dims
    over the model group)): each step's loss within 1e-4 and grad norm
    within 1e-4, the int8 values each rank's differ from its slices of
    the one-rank run's within ``_check_flips``' shares (printed), K1-K3
    launched on each rank (none in a program without attention) and no
    plain version. Returns {path: launches}."""
    out = {}
    for carch, (want_h, want_q, shapes, dims) in refs.items():
        what = f"train-tp-int8-check {carch}"
        rs = [r[f"int8 {carch}"] for r in recs]
        flips = [_int8_flips(want_q, rec["q"], shapes, dims, r, n)
                 for r, rec in enumerate(rs)]
        for r, rec in enumerate(rs):
            check(all(abs(a[0] - b[0]) <= 1e-4 and abs(a[1] - b[1]) <= 1e-4
                      for a, b in zip(rec["hist"], want_h)),
                  f"{what} rank {r}: (loss, grad norm) {rec['hist']} vs one "
                  f"rank's int8 steps {want_h} (1e-4)")
            check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
                  f"{what} rank {r}: launches {rec['launches']}, plain "
                  f"{rec['plain']}")
            _check_flips(f"{what} rank {r}", flips[r],
                         [q.numel() for q in rec["q"]])
        log(f"[{what}] (model {n}) f32 on the int8 wire (scales maxed over "
            f"the model group), {n} ranks on backend {backend} "
            f"({device or 'one card a rank'}): (loss, grad norm) "
            f"{rs[0]['hist']} vs one rank's int8 steps {want_h} (max loss "
            f"diff {max(abs(a[0] - b[0]) for rec in rs for a, b in zip(rec['hist'], want_h))}"
            f"); int8 values differing from the one-rank run's slices, per "
            f"rank and step: {flips} of {[q.numel() for q in rs[0]['q']]}; "
            f"launches a rank {rs[0]['launches']}")
        out[f"train-tp-int8-check-{carch}"] = {
            k: sum(rec["launches"][k] for rec in rs) for k in ("K1", "K2",
                                                               "K3")}
    return out


def _report_train_tp_int8(rs, tp_rs, arch, depth, n, backend, device):
    """train-tp-int8 from every rank's record (``_tp_main_run`` with
    ``compress``) against the same spawn's train-tp run of ``arch``
    (``tp_rs``): every loss within 1e-2 of train-tp's (the int8 wire's
    noise on the update), equal on the ranks, the whole leaves and the
    step bitwise equal across them, per rank and step 2 K1, 1 K2 and 1 K3
    call an attention layer, no plain version. Prints the step median
    and idle share beside train-tp's and the collectives counted with
    the wire's MAX of the scales. Returns {path: launches}."""
    import dataclasses

    from repro_torch.configs import get_config

    batch_n = TP_SCHED.get(arch, TP_SCHED_DEFAULT)[0]
    cfg = dataclasses.replace(get_config(arch), n_layers=depth)
    r0, t0 = rs[0], tp_rs[0]
    n_steps = len(r0["times"])
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * n_steps, "K2": n_attn * n_steps,
            "K3": 2 * n_attn * n_steps}
    for r, rec in enumerate(rs):
        check(rec["losses"] == r0["losses"],
              f"train-tp-int8: rank {r}'s losses {rec['losses']} != rank "
              f"0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"train-tp-int8 rank {r}: launches {rec['launches']} != "
              f"{want}, plain {rec['plain']}")
    check(len({rec["whole"] for rec in rs}) == 1,
          "train-tp-int8: the leaves held whole or the step differ across "
          "the ranks")
    want_l = t0["losses"][:n_steps]
    diff = max(abs(a - b) for a, b in zip(r0["losses"], want_l))
    check(all(math.isfinite(x) for x in r0["losses"]) and diff <= 1e-2,
          f"train-tp-int8: losses {r0['losses']} vs train-tp's {want_l} "
          f"(1e-2)")
    med = sorted(r0["times"][1:])[(n_steps - 1) // 2] * 1e3
    tp_med = sorted(t0["times"][1:n_steps])[(n_steps - 1) // 2] * 1e3
    sb = tp_step_bytes(cfg, 4096, batch_n, n, scale_groups=r0["n_groups"])
    log(f"[train-tp-int8] {arch} bf16 remat full, {depth} layers, {n} "
        f"model ranks on backend {backend} ({device or 'one card a rank'}),"
        f" int8 wire (compress_grads; one scale a stacked tensor, maxed "
        f"over the model group), the first {n_steps} steps of train-tp's "
        f"schedule from the same weights: losses {r0['losses']} vs "
        f"train-tp's {want_l} (max diff {diff}); whole leaves and step "
        f"bitwise equal across the ranks; launches a rank {r0['launches']}")
    log(f"[train-tp-int8] step median {med:.3f} ms over steps 1..{n_steps - 1}"
        f" (rank 0; train-tp {tp_med:.3f} ms over the same steps); peak per "
        f"rank {[round(rec['peak'] / 2**30, 3) for rec in rs]} GiB "
        f"(train-tp {[round(rec['peak'] / 2**30, 3) for rec in tp_rs]} "
        f"GiB); profiled step (rank 0): host wall {r0['profiled_ms']:.3f} "
        f"ms, device idle share {r0['idle']:.3f} (train-tp "
        f"{t0['idle']:.3f})")
    log(f"[train-tp-int8] {_step_bytes_line(sb)} (with the int8 wire's MAX "
        f"of {r0['n_groups']} f32 scales over the model group)")
    return {"train-tp-int8": {k: sum(rec["launches"][k] for rec in rs)
                              for k in ("K1", "K2", "K3")}}


def phase_train_tp(torch, seed, runs=(("gemma-7b", None, None, None),),
                   n=TP_RANKS, with_check=True, ep=None, int8=TP_INT8,
                   epu=None):
    """train-tp-check and one train-tp run for each ``(arch, ref,
    ref_depth, depth)`` of ``runs`` on ``n`` model ranks
    (``_shard_backend``; one spawn runs them all: ``train_tp_rank``), and
    with ``ep`` (``prepare_train_ep``'s plan for as many ranks)
    train-ep-check and train-ep in the same spawn after them
    (``report_train_ep``); with ``epu`` (``prepare_train_ep_uneven``'s)
    train-ep-uneven-check and train-ep-uneven after those
    (``report_train_ep_uneven``).

    train-tp-check (``with_check``), against the port's one-rank step on
    the card from the same parameters and batches: losses and gathered
    parameters within 1e-4, grad norms within 1e-5, the leaves a rank
    holds whole and the optimizer step bitwise equal across the ranks,
    K1-K3 launched on each rank and no plain version (none launched in a
    program without attention).

    train-tp ``arch`` at ``depth`` (or the depth ``train_tp_depth`` picks),
    against the unsharded train phase of ``arch`` (``ref``, run at
    ``ref_depth`` layers; where the depth differs and fits one card
    unsharded, the unsharded steps run here: ``_tp_plan``): its first
    ``TP_STEPS`` steps, every loss within 1e-2 (bf16 partials summed in
    bf16) and the loss falling. Where the depth does not fit one card
    there is no unsharded reference: the whole schedule runs, gated as an
    unsharded train phase is (the mean of the last 5 losses below the
    first). Both: the leaves a rank holds whole bitwise equal across the
    ranks, per rank and step 2 K1, 1 K2 and 1 K3 call an attention layer,
    no plain version. Prints rank 0's step median, tokens/s, idle share,
    the peak per rank, the collectives by profiler name and the bytes a
    rank sends a step (``tp_step_bytes``).

    ``int8`` (``(arch, steps)`` or None; ``arch`` among ``runs``):
    train-tp-int8-check (``with_check``; ``_report_tp_int8_checks``,
    against the one-rank int8 steps run here first) and train-tp-int8,
    ``arch``'s first
    ``steps`` steps on the int8 wire at its train-tp run's depth
    (``_report_train_tp_int8``), in the same spawn. Returns {path:
    launches summed over the ranks}. ``train_tp_job`` and
    ``report_train_tp_phases`` are its two halves, for a spawn shared with
    other phases (``phase_two_ranks``: its ranks are then the model axis
    of a (1, n) mesh, ``train_tp_group_rank``)."""
    return _run_alone(torch, seed, n, train_tp_job(
        torch, seed, runs, n, with_check, ep, int8, epu),
        TRAIN_SHARD_TIMEOUT_S)


def train_tp_group_rank(group, seed, *args):
    """``train_tp_rank`` on the ranks of a shared spawn: its group as the
    model axis of a (1, n) mesh."""
    from repro_torch.dist.group import Mesh2D, ModelGroup

    mg = ModelGroup(group.pg, group.index, group.size, group.device,
                    group.backend)
    return train_tp_rank(Mesh2D(None, mg), seed, *args)


def train_tp_job(torch, seed, runs=(("gemma-7b", None, None, None),),
                 n=TP_RANKS, with_check=True, ep=None, int8=TP_INT8,
                 epu=None):
    """The half of ``phase_train_tp`` before its ranks: the one-rank
    checks, any unsharded reference, and the ranks' job
    (``train_tp_group_rank``) with what ``report_train_tp_phases``
    reads."""
    from repro_torch.dist.sharding import mesh_placements
    from repro_torch.models.model import build_model
    from repro_torch.tree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    backend, device = _shard_backend(torch, n)
    check_params, check_ref = {}, {}
    for carch, cfg in (_tp_check_cfgs().items() if with_check else ()):
        check_params[carch] = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        hist, p, _ = _check_steps(cfg, "cuda", _to(check_params[carch],
                                                   "cuda"), seed,
                                  ("loss", "grad_norm"))
        check_ref[carch] = (hist, _flat_cpu(torch, p))
    int8_params, int8_ref = {}, {}
    for carch, cfg in (_tp_int8_check_cfgs().items() if int8 and with_check
                       else ()):
        int8_params[carch] = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        qs = []
        hist, _, _ = _check_steps(cfg, "cuda", _to(int8_params[carch],
                                                   "cuda"), seed,
                                  ("loss", "grad_norm"), compress=True,
                                  qs=qs)
        full = int8_params[carch]
        pl = mesh_placements(full, cfg, model=n)
        int8_ref[carch] = (hist, qs, [tuple(x.shape)
                                      for x in tree_leaves(full)],
                           tree_leaves(tree_map(lambda _, s: s.model, full,
                                                pl)))
    plans = [(arch, *_tp_plan(torch, seed, arch, ref, ref_depth, n,
                              device is not None, depth))
             for arch, ref, ref_depth, depth in runs]
    int8_run = None
    if int8:
        int8_run = (int8[0], next(d for a, d, _, _ in plans
                                  if a == int8[0]), int8[1])
    log(f"[train-tp] before the spawn (the one-rank checks and any "
        f"unsharded reference): {time.perf_counter() - t_phase:.1f} s")
    for plan in (ep, epu):
        if plan is not None:
            check(plan["n"] == n, f"train-ep's {plan['n']} ranks in "
                  f"train-tp's {n}")
    job = (train_tp_group_rank, (
        check_params, [(a, d, k) for a, d, _, k in plans],
        None if ep is None else ep["rank_args"],
        None if not int8 else {"checks": int8_params, "run": int8_run},
        None if epu is None else epu["rank_args"]))
    return job, report_train_tp_phases, dict(
        n=n, backend=backend, device=device, check_ref=check_ref,
        plans=plans, int8=int8, int8_ref=int8_ref, int8_run=int8_run, ep=ep,
        epu=epu, t_phase=t_phase)


def report_train_tp_phases(recs, st, wall) -> dict:
    """The half of ``phase_train_tp`` after its ranks."""
    import torch

    n, backend, device = st["n"], st["backend"], st["device"]
    check_ref, plans, int8 = st["check_ref"], st["plans"], st["int8"]
    int8_ref, int8_run = st["int8_ref"], st["int8_run"]
    ep, epu, t_phase = st["ep"], st["epu"], st["t_phase"]
    out = {}
    for carch, cfg in _tp_check_cfgs().items():
        if carch not in check_ref:
            continue
        what = f"train-tp-check {carch}"
        want_h, want_p = check_ref[carch]
        rs = [r[carch] for r in recs]
        attends = _train_attention_layers(cfg) > 0
        for r, rec in enumerate(rs):
            perr = float((rec["params"] - want_p).abs().max())
            check(all(abs(a[0] - b[0]) <= 1e-4 and abs(a[1] - b[1]) <= 1e-5
                      for a, b in zip(rec["hist"], want_h)) and perr <= 1e-4,
                  f"{what} rank {r}: (loss, grad norm) {rec['hist']} vs one "
                  f"rank's {want_h} (1e-4, 1e-5); parameters off by {perr} "
                  f"(1e-4)")
            check(rec["plain"] == 0 and (
                min(rec["launches"].values()) > 0 if attends
                else max(rec["launches"].values()) == 0),
                f"{what} rank {r}: launches {rec['launches']}, plain "
                f"{rec['plain']}")
        check(len({rec["whole"] for rec in rs}) == 1,
              f"{what}: the leaves held whole or the step differ across the "
              f"ranks")
        log(f"[{what}] d {cfg.d_model} H {cfg.n_heads}/{cfg.n_kv_heads} hd "
            f"{cfg.hd} ffn {cfg.d_ff} vocab {cfg.vocab_size} f32, {n} ranks "
            f"on backend {backend} ({device or 'one card a rank'}): (loss, "
            f"grad norm) {rs[0]['hist']} vs one rank {want_h}; gathered "
            f"parameters off by "
            f"{max(float((rec['params'] - want_p).abs().max()) for rec in rs)}"
            f"; whole leaves and step bitwise equal across the ranks; "
            f"launches a rank {rs[0]['launches']}")
        out[f"train-tp-check-{carch}"] = {
            k: sum(rec["launches"][k] for rec in rs) for k in ("K1", "K2",
                                                               "K3")}
    for arch, depth, ref, n_steps in plans:
        out.update(_report_train_tp([r[f"main {arch}"] for r in recs], arch,
                                    depth, n_steps, ref, n, backend, device,
                                    wall))
    if int8:
        out.update(_report_tp_int8_checks(recs, int8_ref, n, backend,
                                          device))
        arch = int8_run[0]
        out.update(_report_train_tp_int8(
            [r[f"main-int8 {arch}"] for r in recs],
            [r[f"main {arch}"] for r in recs], arch, int8_run[1], n,
            backend, device))
    if ep is not None:
        out.update(report_train_ep(torch, [r["ep"] for r in recs], ep))
    if epu is not None:
        out.update(report_train_ep_uneven([r["ep-uneven"] for r in recs],
                                          epu))
    log(f"[train-tp] phase {time.perf_counter() - t_phase:.1f} s ({wall:.1f} "
        f"s of it on rank 0)")
    return out


EP_RANKS = 2             # train-ep phases: the model group's ranks
EP_ARCH = "arctic-480b"  # train-ep: the arch trained at every published width
# train-ep: the layers kept (arctic: one MoE layer of 35; kimi: its leading
# dense layer and one MoE layer of 60)
EP_DEPTH = {"arctic-480b": 1, "kimi-k2-1t-a32b": 2}
# train-ep: the share of the card the reckoning may fill with the ranks'
# parameters, state and activations. The rest is for what it does not
# count: each process's CUDA context, gloo's buffers, the allocator's slack
EP_BUDGET = 0.75
# a train-ep phase's schedule: (batch, schedule steps, lr, warmup), the
# gemma-7b train phase's
EP_SCHED = (GEMMA_BATCH, GEMMA_STEPS, 1e-3, 3)
# train-ep-check: the limit of its gathered parameters against one rank's,
# by model ranks (1e-4 beyond 2). f32 rounding moves them that far: on the
# CPU (tools/ep_rounding.py) the one-rank step with its sums reordered
# reads up to 9.5e-6, 2 and 4 model ranks up to 3.5e-5, and a planted
# wrong gradient 9.3e-3; on the card 2 ranks read 9.4e-6, 4 NCCL ranks
# 1.25e-5
EP_CHECK_PARAMS_TOL = {2: 1e-5}


def _ep_cfg(arch: str, experts: int):
    """``arch`` at every published width, ``EP_DEPTH`` layers and
    ``experts`` experts."""
    import dataclasses

    from repro_torch.configs import get_config

    full = get_config(arch)
    return dataclasses.replace(full, n_layers=EP_DEPTH[arch],
                               moe=dataclasses.replace(full.moe,
                                                       n_experts=experts))


def train_ep_experts(torch, arch: str, seq: int, batch: int, n: int,
                     share: bool = True, experts=None,
                     uneven: bool = False) -> int:
    """The expert count of a train-ep phase of ``arch`` (every published
    width, ``EP_DEPTH`` layers): the largest multiple of ``n`` (with
    ``uneven``, the largest count of at least top-k that ``n`` does not
    divide) up to the published count whose reckoned peak of one rank
    (``train_bytes_tp``), times the ``n`` ranks that share the card
    (``share``; else one rank a card), fits ``EP_BUDGET`` of it, and where
    the ranks share one card whose unsharded config fits it too (the
    phase's reference). The expert count is cut as the depth is: to what
    the reckoning fits. ``experts``: take that count instead (it must
    fit). Prints the reckoning."""
    from repro_torch.configs import get_config

    full = get_config(arch)
    total = torch.cuda.get_device_properties(0).total_memory
    budget = EP_BUDGET * total
    k = n if share else 1

    def fits(E):
        ok = k * train_bytes_tp(_ep_cfg(arch, E), seq, batch, n)["peak"] \
            <= budget
        return ok and (not share or train_bytes(_ep_cfg(arch, E), seq,
                                                batch)["peak"] <= budget)
    counts = [E for E in range(full.moe.top_k, full.moe.n_experts + 1)
              if (E % n != 0) == uneven]
    pick = 0
    for E in counts:
        if not fits(E):
            break
        pick = E
    if experts is not None:
        check((experts % n != 0) == uneven and fits(experts),
              f"train-ep {arch}: {experts} experts over {n} ranks do not fit "
              f"{budget / 1e9:.2f} GB (the reckoning's pick: {pick})")
        pick = experts
    check(pick > 0, f"no expert count of {arch} fits the card at {n} ranks")
    b = train_bytes_tp(_ep_cfg(arch, pick), seq, batch, n)
    one = train_bytes(_ep_cfg(arch, pick), seq, batch)
    after = next((E for E in counts if E > pick), pick + n)
    nxt = train_bytes_tp(_ep_cfg(arch, after), seq, batch, n)
    log(f"[train-ep {arch}] reckoned bytes a rank at {n} model ranks, "
        f"{EP_DEPTH[arch]} of {full.n_layers} layers, seq {seq} batch "
        f"{batch}: {pick} of {full.moe.n_experts} experts fit "
        f"{budget / 1e9:.2f} GB ({EP_BUDGET:.0%} of {total / 1e9:.2f}) "
        f"with {k} rank(s) on a card: {b['experts']} experts a rank, "
        f"{b['params'] / 1e6:.1f}M params a rank (its largest leaf "
        f"{b['largest'] / 1e6:.1f}M), resident {b['resident'] / 1e9:.2f} "
        f"GB, update peak {b['update_peak'] / 1e9:.2f} GB, loss peak "
        f"{b['loss_peak'] / 1e9:.2f} GB (the dispatch "
        f"{b['dispatch'] / 1e9:.2f} GB) a rank (x {k}: "
        f"{k * b['peak'] / 1e9:.2f} GB); unsharded {one['params'] / 1e6:.1f}"
        f"M params, peak {one['peak'] / 1e9:.2f} GB; {after} experts "
        f"would peak at {k * nxt['peak'] / 1e9:.2f} GB")
    return pick


def train_ep_rank(mesh, seed, ep):
    """The expert-parallel phases on one rank of a model group (spawned:
    alone by ``phase_train_ep``, or at the end of ``train_tp_rank``).
    train-ep-check: each ``_moe_check_cfgs`` config in ``ep["check_params"]``
    trained 3 steps (seq 128, batch 2, as train_check) from those
    parameters cut to this rank's slices, ``moe._slots`` wrapped to hash
    every slot and keep tensor it returns. Then train-ep: ``ep["cfg"]``
    (every published width, the cut depth and expert count), bf16, remat
    full, seq 4096, batch 1, ``ep["n_steps"]`` steps of ``EP_SCHED``, this
    rank's slices and experts drawn from the single-device draw of
    ``seed`` (``trainer.init_shards``), then one more step, profiled on
    rank 0. Returns the rank's records."""
    import hashlib

    import torch

    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import describe, mesh_placements
    from repro_torch.models import moe as M
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import (gather_params, init_shards,
                                           shard_params)

    t_ep = time.perf_counter()
    _rank_prelude(torch)
    mg = mesh.model
    on = Mesh2D(None, mg)       # the model axis alone
    dev = str(mg.device)
    out = {}
    hashes = []
    plain_slots = M._slots

    def hashed_slots(probs, k, C):
        res = plain_slots(probs, k, C)
        hashes.append(_digest(torch, *res[1:]))
        return res

    M._slots = hashed_slots
    try:
        for arch, cfg in _moe_check_cfgs().items():
            if arch not in ep["check_params"]:
                continue
            full = _to(ep["check_params"][arch], dev)
            pl = mesh_placements(full, cfg, model=mg.size)
            _counters(reset=True)
            hashes.clear()
            hist, p, opt = _check_steps(cfg, dev, shard_params(full, pl, on),
                                        seed, ("loss", "grad_norm", *AUX), mg)
            launches, plain = _counters()
            out[f"check-{arch}"] = dict(
                hist=hist, launches=launches, plain=plain,
                params=_flat_cpu(torch, gather_params(p, pl, on)),
                whole=_whole_digest(torch, p, opt, pl), slot_calls=len(hashes),
                slots=hashlib.sha256("".join(hashes).encode()).hexdigest())
    finally:
        M._slots = plain_slots
    cfg = ep["cfg"]
    batch_n, sched_steps, lr, warmup = EP_SCHED
    gc.collect()
    torch.cuda.empty_cache()
    params = init_shards(build_model(cfg, dev),
                         torch.Generator(device=dev).manual_seed(seed), mg)
    pl = mesh_placements(params, cfg, model=mg.size)
    if mg.index == 0:
        log(f"[train-ep] {cfg.name} placements over {mg.size} ranks: "
            f"{describe(params, pl)}")
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=batch_n,
                             steps=sched_steps, lr=lr, warmup=warmup,
                             seed=seed, model_group=mg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, dropped, times = [], [], []
    for i in range(ep["n_steps"]):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, _ = step(params, opt, batch)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        dropped.append(float(met["dropped_frac"]))
        if mg.index == 0:
            log(f"[train-ep] rank 0 step {i} loss {losses[-1]:.4f} grad "
                f"norm {float(met['grad_norm']):.4f} dropped "
                f"{dropped[-1]:.4f} {times[-1] * 1e3:.1f} ms")
    launches, plain = _counters()
    rec = dict(losses=losses, dropped=dropped, times=times,
               launches=launches, plain=plain,
               peak=torch.cuda.max_memory_allocated(),
               whole=_whole_digest(torch, params, opt, pl))
    batch = ds.batch(ep["n_steps"])
    torch.cuda.synchronize()
    if mg.index == 0:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    ts = time.perf_counter()
    params, opt, met, _ = step(params, opt, batch)
    float(met["loss"])
    dt = time.perf_counter() - ts
    if mg.index == 0:
        prof.stop()
        by_name = report_profile(prof, dt, 1, f"train-ep {cfg.name} step "
                                 f"(rank 0)")
        busy_ms = sum(t for _, t in by_name.values()) / 1e3
        rec.update(profiled_ms=dt * 1e3, idle=1 - busy_ms / (dt * 1e3),
                   collectives=_collective_ms(prof, TP_KEYS))
    rec["wall"] = time.perf_counter() - t_ep
    out["main"] = rec
    return out


def prepare_train_ep(torch, seed, n=EP_RANKS, arch=EP_ARCH, experts=None,
                     with_check=True) -> dict:
    """What the train-ep phases of ``arch`` on ``n`` model ranks compare
    with, run here first on the card: each ``_moe_check_cfgs`` config
    trained 3 steps on one rank (``with_check``), and where the ranks
    share the card, ``arch`` unsharded at the train-ep config (every
    published width, ``EP_DEPTH`` layers, the expert count
    ``train_ep_experts`` picks, or ``experts``) from the same seed, the
    whole ``EP_SCHED`` schedule (``phase_train``: the loss falls, the
    launch counts). Returns the phases' plan: the config, the ranks'
    arguments and the references."""
    from repro_torch.models.model import build_model

    backend, device = _shard_backend(torch, n)
    check_params, check_ref = {}, {}
    for carch, cfg in (_moe_check_cfgs().items() if with_check else ()):
        check_params[carch] = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        hist, p, _ = _check_steps(cfg, "cuda", _to(check_params[carch],
                                                   "cuda"), seed,
                                  ("loss", "grad_norm", *AUX))
        check_ref[carch] = (hist, _flat_cpu(torch, p))
    batch_n, sched_steps, lr, warmup = EP_SCHED
    E = train_ep_experts(torch, arch, 4096, batch_n, n,
                         share=device is not None, experts=experts)
    cfg = _ep_cfg(arch, E)
    ref, ref_launches = None, None
    if device is not None:       # the ranks share this card: so does this
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[train-ep {arch}] the unsharded reference: {E} experts, "
            f"{cfg.n_layers} layer(s), the train-ep phase's seed and "
            f"schedule")
        ref_launches, _, ref = phase_train(
            torch, seed, arch, cfg=cfg, steps=sched_steps, batch=batch_n,
            lr=lr, warmup=warmup)
    return dict(arch=arch, n=n, backend=backend, device=device, cfg=cfg,
                check_ref=check_ref, ref=ref, ref_launches=ref_launches,
                rank_args=dict(check_params=check_params, cfg=cfg,
                               n_steps=sched_steps))


def report_train_ep(torch, recs, ep, wall=None) -> dict:
    """Gate and print the train-ep phases from every rank's records
    (``train_ep_rank``'s).

    train-ep-check, against the one-rank steps of ``prepare_train_ep``:
    losses within 1e-6 (abs and rel), the grad norms and aux metrics
    within 1e-5, gathered parameters within ``EP_CHECK_PARAMS_TOL`` (1e-5
    at 2 ranks, 1e-4 at more), the slot and keep
    tensors of every routing call bitwise equal across the ranks (one
    hash of their hashes), the leaves a rank holds whole and the step
    bitwise equal across the ranks, K1-K3 launched on each rank, no plain
    version.

    train-ep: every rank's losses equal, the leaves held whole bitwise
    equal across the ranks, per rank and step 2 K1, 1 K2 and 1 K3 call an
    attention layer, no plain version; against the unsharded reference
    (where one ran, its loss falling over the whole schedule) the same
    steps, the first ``TP_STEPS`` losses within 1e-2 (bf16 partials
    summed in bf16, as train-tp's) and the mean of the last 5 below the
    first; without one, that mean alone. Prints the
    dropped share of every step (and the reference's), rank 0's step
    median, tokens/s and idle share, the peak per rank, the collectives by
    profiler name and ``tp_step_bytes``. Returns {path: launches summed
    over the ranks}."""
    arch, n, cfg = ep["arch"], ep["n"], ep["cfg"]
    where = f"{n} ranks on backend {ep['backend']} " \
        f"({ep['device'] or 'one card a rank'})"
    out = {}
    for carch, (want_h, want_p) in ep["check_ref"].items():
        what = f"train-ep-check {carch}"
        rs = [r[f"check-{carch}"] for r in recs]
        ccfg = _moe_check_cfgs()[carch]
        perr = max(float((rec["params"] - want_p).abs().max()) for rec in rs)
        ptol = EP_CHECK_PARAMS_TOL.get(n, 1e-4)
        lmax = max(abs(a[0] - b[0]) for rec in rs
                   for a, b in zip(rec["hist"], want_h))
        for r, rec in enumerate(rs):
            lerr = max(abs(a[0] - b[0]) for a, b in zip(rec["hist"], want_h))
            rest = max(abs(x - y) for a, b in zip(rec["hist"], want_h)
                       for x, y in zip(a[1:], b[1:]))
            check(all(math.isclose(a[0], b[0], rel_tol=1e-6, abs_tol=1e-6)
                      for a, b in zip(rec["hist"], want_h)) and rest <= 1e-5
                  and float((rec["params"] - want_p).abs().max()) <= ptol,
                  f"{what} rank {r}: (loss, grad norm, aux) {rec['hist']} vs "
                  f"one rank's {want_h} (loss 1e-6, the rest 1e-5; off by "
                  f"{lerr}, {rest}); parameters off by {perr} ({ptol})")
            check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
                  f"{what} rank {r}: launches {rec['launches']}, plain "
                  f"{rec['plain']}")
            check(rec["slot_calls"] > 0, f"{what}: no routing call hashed")
        check(len({rec["slots"] for rec in rs}) == 1,
              f"{what}: the slot and keep tensors differ across the ranks")
        check(len({rec["whole"] for rec in rs}) == 1,
              f"{what}: the leaves held whole or the step differ across the "
              f"ranks")
        log(f"[{what}] d {ccfg.d_model} H {ccfg.n_heads}/{ccfg.n_kv_heads} hd "
            f"{ccfg.hd}, {ccfg.moe.n_experts} experts top-{ccfg.moe.top_k} "
            f"({ccfg.moe.n_experts // n} a rank), f32, {where}: (loss, grad "
            f"norm, lb, z, dropped) {rs[0]['hist']} vs one rank {want_h}; "
            f"loss off by at most {lmax}, gathered parameters by {perr} "
            f"(limit {ptol}); {rs[0]['slot_calls']} routing calls a rank, "
            f"their slots bitwise equal across the ranks; "
            f"whole leaves and step bitwise equal; launches a rank "
            f"{rs[0]['launches']}")
        out[f"train-ep-check-{MOE_TAGS[carch]}"] = {
            k: sum(rec["launches"][k] for rec in rs) for k in ("K1", "K2",
                                                               "K3")}
    tag = "train-ep" + ("" if arch == EP_ARCH else f" {arch}") + (
        "" if n == EP_RANKS else f" x{n}")
    rs = [r["main"] for r in recs]
    r0 = rs[0]
    n_steps = len(r0["losses"])
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * n_steps, "K2": n_attn * n_steps,
            "K3": 2 * n_attn * n_steps}
    for r, rec in enumerate(rs):
        check(rec["losses"] == r0["losses"],
              f"{tag}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{tag} rank {r}: launches {rec['launches']} != {want}, plain "
              f"{rec['plain']}")
    losses = r0["losses"]
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(len({rec["whole"] for rec in rs}) == 1,
          f"{tag}: the leaves held whole or the step differ across the ranks")
    ref = ep["ref"]
    if ref is not None:
        # the first step at the full lr (step 3) spikes the loss and the
        # router then saturates (dropped share ~0.4 at step 4, ~0.78 from
        # step 6), on one rank as on two; from there a saturated router's
        # near-tied choices follow the rounding of the split attention's
        # bf16 partial sums, and the runs part: the unsharded run against
        # itself with its ffn sums reordered parts as far (2.0e-3 over
        # steps 0-3, 0.24 after: tools/ep_rounding.py --card). The first
        # TP_STEPS are held to the unsharded run's within 1e-2, as
        # train-tp's are; the whole run must fall, as the unsharded one
        # does (phase_train)
        want_l = ref["losses"]
        diff = [abs(a - b) for a, b in zip(losses, want_l)]
        check(len(losses) == len(want_l)
              and max(diff[:TP_STEPS]) <= 1e-2
              and sum(losses[-5:]) / 5 < losses[0],
              f"{tag}: losses {losses} vs unsharded {want_l} (the first "
              f"{TP_STEPS} within 1e-2; the mean of the last 5 below the "
              f"first); dropped share per step {r0['dropped']} vs unsharded "
              f"{ref['dropped']}")
        vs = (f"vs unsharded {want_l} (max diff {max(diff[:TP_STEPS])} "
              f"over steps 0..{TP_STEPS - 1}, {max(diff[TP_STEPS:])} after);"
              f" unsharded dropped share per step {ref['dropped']}")
        unsh = (f"unsharded {ref['median_ms']:.3f} ms; peak "
                f"{ref['peak'] / 2**30:.3f} GiB")
    else:
        check(sum(losses[-5:]) / 5 < losses[0],
              f"{tag}: the loss did not fall: {losses}")
        vs = f"(no unsharded reference: {cfg.moe.n_experts} experts over " \
            f"{n} cards)"
        unsh = "no unsharded run"
    batch_n = EP_SCHED[0]
    med = sorted(r0["times"][1:])[(n_steps - 1) // 2] * 1e3
    coll = ", ".join(f"{k} x{c} {ms:.3f} ms" for k, (c, ms) in
                     sorted(r0["collectives"].items(),
                            key=lambda x: -x[1][1]))
    sb = tp_step_bytes(cfg, 4096, batch_n, n)
    log(f"[{tag}] {arch} bf16 remat full, every published width, "
        f"{cfg.n_layers} layer(s), {cfg.moe.n_experts} experts "
        f"({cfg.moe.n_experts // n} a rank) top-{cfg.moe.top_k}, {where}, "
        f"seq 4096 batch {batch_n}, {n_steps} steps of a {EP_SCHED[1]}-step "
        f"schedule: {r0['wall']:.1f} s on rank 0"
        + ("" if wall is None else f" ({wall:.1f} s with the ranks' start)")
        + f"; losses {losses} {vs}; dropped share per step {r0['dropped']}; "
        f"whole leaves and step bitwise equal across the ranks; launches a "
        f"rank {r0['launches']}")
    log(f"[{tag}] step median {med:.3f} ms over steps 1..{n_steps - 1} "
        f"(rank 0; {unsh}); {batch_n * 4096 / med * 1e3:.1f} tokens/s; peak "
        f"per rank {[round(rec['peak'] / 2**30, 3) for rec in rs]} GiB; "
        f"profiled step (rank 0): host wall {r0['profiled_ms']:.3f} ms, "
        f"device idle share {r0['idle']:.3f}, collectives by name (host "
        f"time): {coll}")
    log(f"[{tag}] {_step_bytes_line(sb)}")
    out[tag.replace(" ", "-")] = {k: sum(rec["launches"][k] for rec in rs)
                                  for k in ("K1", "K2", "K3")}
    return out


def phase_train_ep(torch, seed, ep) -> dict:
    """train-ep-check and train-ep in a spawn of their own (``ep`` from
    ``prepare_train_ep``): ``train_ep_rank`` on ``ep["n"]`` model ranks,
    then ``report_train_ep``."""
    from repro_torch.dist.group import run_ranks

    gc.collect()
    torch.cuda.empty_cache()       # the ranks' allocators cannot see it
    t0 = time.perf_counter()
    recs = run_ranks(train_ep_rank, ep["n"], backend=ep["backend"],
                     device=ep["device"], timeout_s=TRAIN_SHARD_TIMEOUT_S,
                     model=ep["n"], args=(seed, ep["rank_args"]))
    return report_train_ep(torch, recs, ep, time.perf_counter() - t0)


# train-ep-uneven: an expert count the model group does not divide, at
# every published width: arctic-480b, EP_DEPTH layers and the largest
# count EP_RANKS does not divide that train_ep_experts fits (the stacks
# split over their ffn, the router whole, every rank routing all the
# experts), its first EP_UNEVEN_STEPS steps of EP_SCHED's schedule
# against the unsharded run of the same cut. At 3 ranks arctic splits
# nothing (56 heads, 8 KV heads, ffn 4864 and vocab 32000 are not
# multiples of 3), so three whole copies share the card: 85.4 GB reckoned
# for even 2 experts, more than the card holds; the phase runs EP_RANKS
# ranks, and the whole branch runs in its check (and at 3 ranks in the
# CPU tests)
EP_UNEVEN_STEPS = 3
# train-ep-uneven-check: the limit of the gathered parameters against one
# rank's, by branch. The ffn split sums each expert row's halves, so its
# gradients differ in the last bits and AdamW moves an entry whose
# gradient is at the rounding floor by up to the learning rate (on the
# CPU, tests/test_torch_ep.py: 7.9e-4 on one of 16384 entries); the whole
# branch runs one device's arithmetic
EP_UNEVEN_PARAMS_TOL = {"ffn": 1e-3, "whole": 1e-4}


def _ep_uneven_check_cfgs():
    """train-ep-uneven-check's configs: train-ep-check's narrowed f32
    arctic-480b (d 256, 7 query heads on one KV head of hd 128) with 3
    experts, of width 64 (the ``EP_RANKS`` ranks split their ffn) and of
    width 63 (they split nothing of the MoE: the whole branch)."""
    import dataclasses

    base = _moe_check_cfgs()["arctic-480b"]
    return {branch: dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=3, d_ff_expert=f))
        for branch, f in (("ffn", 64), ("whole", 63))}


def prepare_train_ep_uneven(torch, seed, n=EP_RANKS, arch=EP_ARCH) -> dict:
    """What the train-ep-uneven phases on ``n`` model ranks compare with,
    run here first on the card: each ``_ep_uneven_check_cfgs`` config
    trained 3 steps on one rank, and where the ranks share the card,
    ``arch`` unsharded at the phase's cut (every published width,
    ``EP_DEPTH`` layers, the largest expert count ``n`` does not divide
    that ``train_ep_experts`` fits) over the phase's first
    ``EP_UNEVEN_STEPS`` steps of ``EP_SCHED``'s schedule from the same
    seed (``phase_train``: the launch counts; over the whole schedule its
    router collapses, as train-ep's does at 2 ranks, and its loss need
    not fall). Returns the phases' plan."""
    from repro_torch.models.model import build_model

    backend, device = _shard_backend(torch, n)
    check_params, check_ref = {}, {}
    for branch, cfg in _ep_uneven_check_cfgs().items():
        check_params[branch] = build_model(cfg, "cpu").init(
            torch.Generator().manual_seed(seed))
        hist, p, _ = _check_steps(cfg, "cuda", _to(check_params[branch],
                                                   "cuda"), seed,
                                  ("loss", "grad_norm", *AUX))
        check_ref[branch] = (hist, _flat_cpu(torch, p))
    batch_n, sched_steps, lr, warmup = EP_SCHED
    E = train_ep_experts(torch, arch, 4096, batch_n, n,
                         share=device is not None, uneven=True)
    cfg = _ep_cfg(arch, E)
    ref, ref_launches = None, None
    if device is not None:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[train-ep-uneven {arch}] the unsharded reference: {E} "
            f"experts, {cfg.n_layers} layer(s), the phase's seed, schedule "
            f"and steps")
        ref_launches, _, ref = phase_train(
            torch, seed, arch, cfg=cfg, steps=sched_steps, batch=batch_n,
            lr=lr, warmup=warmup, run=EP_UNEVEN_STEPS)
    return dict(arch=arch, n=n, backend=backend, device=device, cfg=cfg,
                check_ref=check_ref, ref=ref, ref_launches=ref_launches,
                rank_args=dict(check_params=check_params, cfg=cfg))


def train_ep_uneven_rank(mesh, seed, epu):
    """The uneven expert-parallel phases on one rank of a model group (at
    the end of ``train_tp_rank``). train-ep-uneven-check: each
    ``_ep_uneven_check_cfgs`` config trained 3 steps (seq 128, batch 2,
    as train_check) from ``epu["check_params"]`` cut to this rank's
    slices. Then train-ep-uneven: ``epu["cfg"]``, bf16, remat full, seq
    4096, the first ``EP_UNEVEN_STEPS`` steps of ``EP_SCHED``, this rank's
    slices drawn from the single-device draw of ``seed``
    (``trainer.init_shards``: every expert, each stack's ffn columns).
    Returns the rank's records."""
    import torch

    from repro_torch.dist.group import Mesh2D
    from repro_torch.dist.sharding import describe, mesh_placements
    from repro_torch.models import moe as M
    from repro_torch.models.model import build_model
    from repro_torch.train.trainer import (gather_params, init_shards,
                                           shard_params)

    t_ep = time.perf_counter()
    _rank_prelude(torch)
    mg = mesh.model
    on = Mesh2D(None, mg)
    dev = str(mg.device)
    out = {}
    for branch, cfg in _ep_uneven_check_cfgs().items():
        full = _to(epu["check_params"][branch], dev)
        pl = mesh_placements(full, cfg, model=mg.size)
        _counters(reset=True)
        hist, p, opt = _check_steps(cfg, dev, shard_params(full, pl, on),
                                    seed, ("loss", "grad_norm", *AUX), mg)
        launches, plain = _counters()
        out[f"check-{branch}"] = dict(
            hist=hist, launches=launches, plain=plain,
            split=M.expert_split(cfg, mg.size),
            params=_flat_cpu(torch, gather_params(p, pl, on)),
            whole=_whole_digest(torch, p, opt, pl))
        del full, p, opt
    cfg = epu["cfg"]
    batch_n, sched_steps, lr, warmup = EP_SCHED
    gc.collect()
    torch.cuda.empty_cache()
    params = init_shards(build_model(cfg, dev),
                         torch.Generator(device=dev).manual_seed(seed), mg)
    pl = mesh_placements(params, cfg, model=mg.size)
    if mg.index == 0:
        log(f"[train-ep-uneven] {cfg.name} with {cfg.moe.n_experts} experts, "
            f"placements over {mg.size} ranks: {describe(params, pl)}")
    step, opt, ds = _trainer(cfg, dev, params, seq=4096, batch=batch_n,
                             steps=sched_steps, lr=lr, warmup=warmup,
                             seed=seed, model_group=mg)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _counters(reset=True)
    losses, dropped, times = [], [], []
    for i in range(EP_UNEVEN_STEPS):
        batch = ds.batch(i)
        t0 = time.perf_counter()
        params, opt, met, _ = step(params, opt, batch)
        losses.append(float(met["loss"]))         # syncs the card
        times.append(time.perf_counter() - t0)
        dropped.append(float(met["dropped_frac"]))
        if mg.index == 0:
            log(f"[train-ep-uneven] rank 0 step {i} loss {losses[-1]:.4f} "
                f"grad norm {float(met['grad_norm']):.4f} dropped "
                f"{dropped[-1]:.4f} {times[-1] * 1e3:.1f} ms")
    launches, plain = _counters()
    out["main"] = dict(losses=losses, dropped=dropped, times=times,
                       launches=launches, plain=plain,
                       split=M.expert_split(cfg, mg.size),
                       peak=torch.cuda.max_memory_allocated(),
                       whole=_whole_digest(torch, params, opt, pl),
                       wall=time.perf_counter() - t_ep)
    return out


def report_train_ep_uneven(recs, epu) -> dict:
    """Gate and print the uneven expert-parallel phases from every rank's
    records (``train_ep_uneven_rank``'s).

    train-ep-uneven-check, against the one-rank steps of
    ``prepare_train_ep_uneven``: each config took its branch (``ffn``,
    ``whole``), losses within 1e-4, the grad norms and aux metrics within
    1e-5, gathered parameters within ``EP_UNEVEN_PARAMS_TOL``, the leaves
    a rank holds whole and the step bitwise equal across the ranks, K1-K3
    launched on each rank, no plain version.

    train-ep-uneven: the stacks split over ffn; every rank's losses
    equal, the leaves held whole bitwise equal across the ranks, per rank
    and step 2 K1, 1 K2 and 1 K3 call an attention layer, no plain
    version; against the unsharded run of the same cut (where one ran)
    every step within 1e-2 (train-ep's limit). Prints rank 0's step
    median and the peak per rank. Returns {path: launches summed over the
    ranks}."""
    arch, n, cfg = epu["arch"], epu["n"], epu["cfg"]
    where = f"{n} ranks on backend {epu['backend']} " \
        f"({epu['device'] or 'one card a rank'})"
    out = {}
    for branch, (want_h, want_p) in epu["check_ref"].items():
        what = f"train-ep-uneven-check {branch}"
        rs = [r[f"check-{branch}"] for r in recs]
        ccfg = _ep_uneven_check_cfgs()[branch]
        ptol = EP_UNEVEN_PARAMS_TOL[branch]
        perr = max(float((rec["params"] - want_p).abs().max()) for rec in rs)
        for r, rec in enumerate(rs):
            check(rec["split"] == (None if branch == "whole" else branch),
                  f"{what}: the experts split over {rec['split']}")
            lerr = max(abs(a[0] - b[0]) for a, b in zip(rec["hist"], want_h))
            rest = max(abs(x - y) for a, b in zip(rec["hist"], want_h)
                       for x, y in zip(a[1:], b[1:]))
            check(lerr <= 1e-4 and rest <= 1e-5
                  and float((rec["params"] - want_p).abs().max()) <= ptol,
                  f"{what} rank {r}: (loss, grad norm, aux) {rec['hist']} vs "
                  f"one rank's {want_h} (loss 1e-4, the rest 1e-5; off by "
                  f"{lerr}, {rest}); parameters off by {perr} ({ptol})")
            check(rec["plain"] == 0 and min(rec["launches"].values()) > 0,
                  f"{what} rank {r}: launches {rec['launches']}, plain "
                  f"{rec['plain']}")
        check(len({rec["whole"] for rec in rs}) == 1,
              f"{what}: the leaves held whole or the step differ across the "
              f"ranks")
        log(f"[{what}] d {ccfg.d_model} H {ccfg.n_heads}/{ccfg.n_kv_heads} "
            f"hd {ccfg.hd}, {ccfg.moe.n_experts} experts of width "
            f"{ccfg.moe.d_ff_expert} top-{ccfg.moe.top_k} (split over "
            f"{rs[0]['split'] or 'nothing'}), f32, {where}: (loss, grad "
            f"norm, lb, z, dropped) {rs[0]['hist']} vs one rank {want_h}; "
            f"gathered parameters off by {perr} (limit {ptol}); whole leaves "
            f"and step bitwise equal; launches a rank {rs[0]['launches']}")
        out[f"train-ep-uneven-check-{branch}"] = {
            k: sum(rec["launches"][k] for rec in rs) for k in ("K1", "K2",
                                                               "K3")}
    tag = "train-ep-uneven"
    rs = [r["main"] for r in recs]
    r0 = rs[0]
    losses = r0["losses"]
    n_steps = len(losses)
    n_attn = _train_attention_layers(cfg)
    want = {"K1": 2 * n_attn * n_steps, "K2": n_attn * n_steps,
            "K3": 2 * n_attn * n_steps}
    for r, rec in enumerate(rs):
        check(rec["split"] == "ffn", f"{tag}: the experts split over "
              f"{rec['split']}, not their ffn")
        check(rec["losses"] == losses,
              f"{tag}: rank {r}'s losses {rec['losses']} != rank 0's")
        check(rec["launches"] == want and rec["plain"] == 0,
              f"{tag} rank {r}: launches {rec['launches']} != {want}, plain "
              f"{rec['plain']}")
    check(all(math.isfinite(x) for x in losses), f"{tag}: losses {losses}")
    check(len({rec["whole"] for rec in rs}) == 1,
          f"{tag}: the leaves held whole or the step differ across the ranks")
    ref = epu["ref"]
    vs, unsh = "(no unsharded reference)", "no unsharded run"
    if ref is not None:
        want_l = ref["losses"][:n_steps]
        diff = max(abs(a - b) for a, b in zip(losses, want_l))
        check(diff <= 1e-2, f"{tag}: losses {losses} vs unsharded {want_l} "
              f"(1e-2)")
        vs = f"vs unsharded {want_l} (max diff {diff})"
        unsh = (f"unsharded {ref['median_ms']:.3f} ms; peak "
                f"{ref['peak'] / 2**30:.3f} GiB")
    med = sorted(r0["times"][1:])[(n_steps - 1) // 2] * 1e3
    log(f"[{tag}] {arch} bf16 remat full, every published width, "
        f"{cfg.n_layers} layer(s), {cfg.moe.n_experts} experts on every rank "
        f"(their ffn {cfg.moe.d_ff_expert} split {n} ways, the router whole) "
        f"top-{cfg.moe.top_k}, {where}, seq 4096 batch {EP_SCHED[0]}, "
        f"{n_steps} steps of a {EP_SCHED[1]}-step schedule: {r0['wall']:.1f} "
        f"s on rank 0 with its check; losses {losses} {vs}; dropped share "
        f"per step {r0['dropped']}; whole leaves and step bitwise equal "
        f"across the ranks; launches a rank {r0['launches']}")
    log(f"[{tag}] step median {med:.3f} ms over steps 1..{n_steps - 1} "
        f"(rank 0; {unsh}); peak per rank "
        f"{[round(rec['peak'] / 2**30, 3) for rec in rs]} GiB")
    out[tag] = {k: sum(rec["launches"][k] for rec in rs)
                for k in ("K1", "K2", "K3")}
    return out


def report_profile(prof, wall_s: float, n_steps: int, what: str) -> dict:
    """Device time by kernel name over the profiled engine steps, and the
    device's idle share (1 - kernel time / host wall time of the steps;
    the profiler's own host overhead inflates the wall time, so this share
    is an upper bound). Returns {name: (launches, device us)}."""
    by_name: dict = {}
    for name, card, us in _events(prof):
        if not card:
            continue
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    busy_ms = sum(t for _, t in by_name.values()) / 1e3
    if not by_name:
        log("[profile] the profiler recorded no device events")
        return by_name
    log(f"[profile] {n_steps} {what}: host wall {wall_s * 1e3:.3f} ms, "
        f"device kernel time {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / (wall_s * 1e3):.3f}, "
        f"{sum(n for n, _ in by_name.values()) / n_steps:.0f} kernels/step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, t) in top:
        log(f"[profile]   {t / 1e3 / n_steps:8.3f} ms/step "
            f"{n / n_steps:6.1f} launches/step  {name[:90]}")
    return by_name


def _emitted(eng) -> int:
    """Tokens generated so far by every request of the engine."""
    reqs = list(eng.batcher.finished.values()) + [
        r for r in eng.batcher.rows if r is not None]
    return sum(len(r.out) for r in reqs)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import os

    # gemma-7b's train step allocates and frees f32 temporaries of its
    # 786M-parameter embedding: without growable segments the cached
    # blocks fragment (23.6 GiB reserved but unusable at an OOM, on the
    # H100)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")

    # the decode phases run while the training kernels still compile
    phase_build(wait_all=False)
    timer = Timer(torch)
    k4 = phase_kernels(torch, timer, args.seed)
    k5 = phase_k5(torch, timer, args.seed)
    serve_check(torch, args.seed)
    lockstep_check(torch, args.seed)
    # the lockstep and int8 serve phases run before the profiled serve
    # phase: the profiler's hooks slow the host afterwards
    launches_k5, _ = phase_lockstep(torch, args.seed)
    launches_rg, _ = phase_lockstep(torch, args.seed, "recurrentgemma-9b",
                                    RG_B, RG_PROMPT, RG_NEW)
    torch.cuda.empty_cache()
    phase_lockstep(torch, args.seed, "mamba2-370m", RG_B, RG_PROMPT,
                   RG_NEW)
    torch.cuda.empty_cache()
    launches_int8, int8_tokens, int8_c = phase_serve_int8(torch, args.seed)
    launches, bf16_tokens, bf16_c, _ = phase_serve(torch, args.seed)
    agree = sum(int((int8_tokens[r] == bf16_tokens[r]).sum())
                for r in bf16_tokens)
    first = sum(int(int8_tokens[r][0] == bf16_tokens[r][0])
                for r in bf16_tokens)
    log(f"[serve-int8] tokens equal to the bf16 slab's run: {agree} of "
        f"{SERVE_R * SERVE_NEW} (first tokens {first} of {SERVE_R}; random "
        f"weights, not gated)")
    # gemma-7b at full width and depth on the continuous engine, one
    # profiled decode step
    # kill and resume: the serve phases' runs under the supervisor, two
    # injected crashes each
    launches_ft = phase_serve_ft(torch, args.seed, "serve-ft", bf16_tokens,
                                 bf16_c)
    launches_ft8 = phase_serve_ft(
        torch, args.seed, "serve-ft-int8", int8_tokens, int8_c,
        kv_dtype="int8", page_sparsity_threshold=-3.0, page_stat_decay=0.3)
    launches_gemma, _, _, _ = phase_serve(torch, args.seed, "gemma-7b",
                                          "serve gemma-7b", (40, 41), False)
    torch.cuda.empty_cache()
    for arch in ("recurrentgemma-9b", "mamba2-370m"):
        profile_lockstep(torch, args.seed, arch, RG_B, RG_PROMPT)
        torch.cuda.empty_cache()
    # the MoE family at full width, depth cut to fit: one set of weights
    # for its lockstep and serve phases
    moe_k4, moe_k5 = {}, {}
    for arch in MOE_ARCHS:
        moe_k4[arch], moe_k5[arch] = phase_moe(
            torch, timer, args.seed, arch, k4["l"]["kernel_ms"],
            k5["l"]["kernel_ms"])
    # qwen2-vl-2b (M-RoPE text decode) and whisper-base (its cross caches
    # filled from the encoder through K1) at full width and depth
    fam_k5, fam_k1 = {}, {}
    for arch in FAMILY_ARCHS:
        fam_k5[arch], _ = phase_lockstep(torch, args.seed, arch, RG_B,
                                         RG_PROMPT, RG_NEW)
        fam_k1[arch] = _counters()[0]
        torch.cuda.empty_cache()
    finish_build()
    trec = phase_train_kernels(torch, timer, args.seed)
    tl = {"lockstep-whisper-base": fam_k1["whisper-base"],
          "analysis": phase_analysis(torch)}
    tl["dynamic"], drec = phase_dynamic(torch, timer, args.seed)
    dynamic_check(torch, args.seed)
    torch.cuda.empty_cache()
    train_check(torch, args.seed)
    for arch, cfg in _check_cfgs().items():
        if arch in TRAIN_CHECK:
            train_check(torch, args.seed, cfg, f"{arch} hd {cfg.hd}")
    for arch, cfg in _recurrent_check_cfgs().items():
        train_check(torch, args.seed, cfg, f"{arch} d {cfg.d_model}")
    for arch, cfg in _moe_check_cfgs().items():
        tl[f"train-check-{MOE_TAGS[arch]}"] = train_check(
            torch, args.seed, cfg, f"{arch} hd {cfg.hd} H "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.moe.n_experts} experts "
            f"top-{cfg.moe.top_k}")
    for arch, cfg in _family_check_cfgs().items():
        tl[f"train-check-{arch}"] = train_check(
            torch, args.seed, cfg, f"{arch} d {cfg.d_model} hd {cfg.hd} H "
            f"{cfg.n_heads}/{cfg.n_kv_heads}")
    torch.cuda.empty_cache()
    batch, depth = train_shape(torch, "qwen2-vl-2b", 4096)
    tl["train-qwen2-vl-2b"], _, _ = phase_train(
        torch, args.seed, "qwen2-vl-2b", n_layers=depth, steps=QWEN_STEPS,
        batch=batch, lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    tl["train-whisper-base"], _, whisper_stats = phase_train(
        torch, args.seed, "whisper-base", steps=GEMMA_STEPS,
        batch=TRAIN_BATCH, lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    tl["smollm-135m"], ft, full = phase_train(torch, args.seed,
                                              ft_save_at=FT_TRAIN_AT)
    tl["train-ft"] = phase_train_ft(torch, args.seed, ft)
    del ft
    torch.cuda.empty_cache()
    dots_reckoning(4096, TRAIN_BATCH)
    tl["train-dots"], _, _ = phase_train(
        torch, args.seed, remat="dots",
        ref={**full, "losses": full["losses"][:DOTS_STEPS]})
    torch.cuda.empty_cache()
    gemma_depth = train_depth(torch, "gemma-7b", 4096, GEMMA_BATCH)
    tl["gemma-7b"], _, gemma_stats = phase_train(
        torch, args.seed, "gemma-7b", n_layers=gemma_depth,
        steps=GEMMA_STEPS, batch=GEMMA_BATCH, lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    tl["longformer-4k"], _, lf_stats = phase_train(torch, args.seed,
                                                   "longformer-4k")
    torch.cuda.empty_cache()
    # smollm-135m at dilation 2, unsharded: the first steps of the train
    # phase's schedule, the losses train-sharded's dilated run is held to
    from repro_torch.configs import with_dilation
    d2_arch = f"smollm-135m dilation {SHARDED_DILATION}"
    tl[f"train-{d2_arch.replace(' ', '-')}"], _, d2_stats = phase_train(
        torch, args.seed, d2_arch, run=SHARDED_STEPS["smollm-135m"],
        cfg=with_dilation(_train_cfg(smoke=False), SHARDED_DILATION))
    torch.cuda.empty_cache()
    # recurrentgemma-9b at full width, at the depth both one card and the
    # train-tp ranks sharing it hold: the unsharded phase, train-tp's
    # reference
    rg_depth = min(
        train_depth(torch, "recurrentgemma-9b", 4096, GEMMA_BATCH),
        train_tp_depth(torch, "recurrentgemma-9b", 4096, GEMMA_BATCH,
                       TP_RANKS, share=_shard_backend(torch, TP_RANKS)[1]
                       is not None))
    tl["train-recurrentgemma-9b"], _, rg_stats = phase_train(
        torch, args.seed, "recurrentgemma-9b", n_layers=rg_depth,
        steps=GEMMA_STEPS, batch=GEMMA_BATCH, lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    # expert-parallel training's references on one rank (the narrowed MoE
    # checks, arctic-480b at every width and the expert count that fits),
    # and an expert count the group does not divide (the narrowed checks of
    # both branches, arctic-480b's stacks split over their ffn: the
    # unsharded run of that cut)
    ep = prepare_train_ep(torch, args.seed)
    tl["train-ep-unsharded-arctic-480b"] = ep["ref_launches"]
    torch.cuda.empty_cache()
    epu = prepare_train_ep_uneven(torch, args.seed)
    tl["train-ep-uneven-unsharded-arctic-480b"] = epu["ref_launches"]
    torch.cuda.empty_cache()
    moe_seq = seq_moe_inputs(torch, args.seed)
    tl["train-sharded-moe-unsharded-arctic-480b"] = moe_seq["ref_launches"]
    torch.cuda.empty_cache()
    # the recurrent families under a sequence group: mamba2-370m's
    # unsharded phase (MAMBA_TRAIN_LAYERS of 48 layers), the losses its
    # sharded run is held to, and recurrentgemma-9b's unsharded reference
    # at one griffin group (its forward and backward on one card)
    _, _, mamba_stats = phase_train(
        torch, args.seed, "mamba2-370m", n_layers=MAMBA_TRAIN_LAYERS,
        steps=GEMMA_STEPS, batch=MAMBA_BATCH, lr=1e-3, warmup=3)
    torch.cuda.empty_cache()
    rec_seq = [seq_rec_inputs(torch, args.seed, "mamba2-370m", mamba_stats),
               seq_rec_inputs(torch, args.seed, "recurrentgemma-9b")]
    tl["train-sharded-unsharded-recurrentgemma-9b"] = \
        rec_seq[1]["ref_launches"]
    # the VLM and the encoder-decoder under a sequence group: qwen2-vl-2b
    # at the depth 2 whole copies fit, against the unsharded run of that
    # cut; whisper-base at full size against its unsharded train phase
    fam_seq = [seq_fam_inputs(torch, args.seed, "qwen2-vl-2b"),
               seq_fam_inputs(torch, args.seed, "whisper-base",
                              whisper_stats)]
    for fam in fam_seq:
        if fam["ref_launches"] is not None:
            tl[f"train-sharded-unsharded-{fam['arch']}"] = \
                fam["ref_launches"]
    # one spawn of 2 ranks for every 2-rank phase (a spawn's ranks take ~20
    # s to start and warm up on the card): sequence-parallel serving (the
    # narrowed check, the bf16 slab at full width, then the int8 page-
    # sparse slab); sequence-parallel training (the narrowed checks, one of
    # them an MoE whose dispatch groups span the shards, two recurrent, one
    # at dilation 2, smollm-135m and longformer-4k at full size against the
    # unsharded train phases, smollm-135m at dilation 2 against its
    # unsharded run, arctic-480b's MoE layer against the unsharded run of
    # its cut, mamba2-370m against its unsharded phase,
    # recurrentgemma-9b's forward and backward against its reference,
    # qwen2-vl-2b and whisper-base against theirs);
    # data-parallel training (the narrowed check on both wires, smollm-135m
    # at full size with the f32 all_reduce against the unsharded train
    # phase, and the FSDP fallback: its check against train-dp-check's,
    # smollm-135m against train-dp's); tensor-parallel training (the
    # narrowed checks of every family, gemma-7b and recurrentgemma-9b at
    # full width against their unsharded train phases, the int8 checks and
    # gemma-7b on the int8 wire) and expert-parallel training (the narrowed
    # MoE check, arctic-480b against its reference, and the uneven expert
    # count's checks and run)
    seq_parts = train_sharded_parts(
        torch, args.seed, (("smollm-135m", full, 1),
                           ("longformer-4k", lf_stats, 1),
                           ("smollm-135m", d2_stats, SHARDED_DILATION)),
        moe=moe_seq, recs=rec_seq, fams=fam_seq)
    parts = dict([
        ("serve-sharded", serve_sharded_job(
            torch, args.seed, 2,
            (("serve-sharded", bf16_tokens, {}, SHARD_REQS),
             ("serve-sharded-int8", int8_tokens, INT8_SPARSE,
              SHARD_INT8_REQS)), with_check=True)),
        *seq_parts,
        ("train-dp-check", dp_check_job(torch, args.seed)),
        ("train-dp", train_dp_job(torch, args.seed, "train-dp", full,
                                  fsdp=fsdp_inputs(torch, args.seed, None))),
        ("train-tp", train_tp_job(torch, args.seed, (
            ("gemma-7b", gemma_stats, gemma_depth, None),
            ("recurrentgemma-9b", rg_stats, rg_depth, rg_depth)), ep=ep,
            epu=epu))])
    got = spawn_jobs(torch, args.seed, list(parts.items()))

    def report(name, **kw):
        (_, fn, st), (recs, wall) = parts[name], got[name]
        return fn(recs, st, wall, **kw)
    served = report("serve-sharded")
    launches_s2, launches_s4 = (served[w][0] for w in (
        "serve-sharded", "serve-sharded-int8"))
    for name, _ in seq_parts:
        tl.update(report(name))
    dpc_launches, dp_check = report("train-dp-check")
    tl.update(dpc_launches)
    tl["train-dp"], dp_losses, fsdp_launches = report("train-dp",
                                                      dp_check=dp_check)
    tl.update(fsdp_launches)
    tl.update(report("train-tp"))
    del moe_seq, rec_seq, fam_seq, seq_parts, parts, got, served, dp_check, ep, epu
    torch.cuda.empty_cache()
    # the int8 wire under the FSDP fallback and at (data 2, model 2) in
    # the train-dp-int8 spawn, after its data-parallel run: the narrowed
    # checks, then smollm-135m at full size against train-dp-int8's losses
    tl["train-dp-int8"], _, int8_launches = phase_train_dp(
        torch, args.seed, "train-dp-int8", full, dp_losses,
        fsdp=fsdp_inputs(torch, args.seed, None),
        tp=tp_int8_inputs(torch, args.seed))
    tl.update(int8_launches)

    def row(rec):
        return {"max_abs_err": rec["max_abs_err"], "ms": rec["kernel_ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"],
                **{k: rec[k] for k in ("n_split", "split_len") if k in rec}}

    # K4's main numbers are case (a), the bf16 serve phase's kernel; case
    # (d) is the int8 serve phase's (int8 slab + page statistics), (e) the
    # f32 state variant and (f) one request with a long cache
    k4_paths = {"serve": launches, "serve_int8": launches_int8,
                "serve_sharded": launches_s2,
                "serve_sharded_int8": launches_s4,
                "serve_ft": launches_ft, "serve_ft_int8": launches_ft8,
                "serve_gemma_7b": launches_gemma,
                **{f"serve_{MOE_TAGS[a]}": n for a, n in moe_k4.items()}}
    k5_paths = {"lockstep": launches_k5,
                "lockstep_recurrentgemma_9b": launches_rg,
                **{f"lockstep_{MOE_TAGS[a]}": n for a, n in moe_k5.items()},
                **{f"lockstep_{a}": n for a, n in fam_k5.items()}}
    kernels = [{
        "name": "salo_paged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/salo_paged_decode.cu",
        "replaces": "src/repro/kernels/salo_decode.py:238",
        "launches": sum(k4_paths.values()),
        "launches_by_path": {k.replace("-", "_"): v
                             for k, v in k4_paths.items()},
        "launches_per_call": 1, **row(k4["a"]),
        "variants": {"int8_page_stats_bf16": row(k4["d"]),
                     "state_page_stats_f32": row(k4["e"]),
                     "single_request_bf16": row(k4["f"]),
                     "gemma_7b_hd256_bf16": row(k4["g"]),
                     "arctic_480b_rep7_hd128_bf16": row(k4["l"]),
                     "shard_state_bf16": row(k4["s"])}}, {
        "name": "salo_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/salo_decode.cu",
        "replaces": "src/repro/kernels/salo_decode.py:173",
        "launches": sum(k5_paths.values()),
        "launches_by_path": {k.replace("-", "_"): v
                             for k, v in k5_paths.items()},
        "launches_per_call": 1, **row(k5["a"]),
        "variants": {"f32": row(k5["b"]), "ring_dilated_bf16": row(k5["c"]),
                     "recurrentgemma_9b_hd256_mqa_bf16": row(k5["k"]),
                     "arctic_480b_rep7_hd128_bf16": row(k5["l"]),
                     "qwen2_vl_2b_rep6_hd128_bf16": row(k5["m"]),
                     "whisper_base_rep1_hd64_bf16": row(k5["n"])}}]
    # launches_per_call: K3's wrapper runs two kernels (the row walk and
    # the owner-tile sum), and its count and its time cover both. The main
    # numbers are case (a), smollm-135m's train attention; the variants are
    # the other timed cases (ViL stages: K1 only)
    variants = {"f": "gemma_7b_hd256_bf16", "g": "gemma_7b_hd256_f32",
                "h": "longformer_4k_bf16", "b": "smollm_f32",
                "i": "vil_stage1_bf16", "j": "vil_stage2_bf16",
                "k": "recurrentgemma_9b_local_hd256_mqa_bf16",
                "l": "kimi_k2_hd128_gqa8_bf16",
                "m": "whisper_base_encoder_n1500_global_rows_bf16",
                "t": "shard_view_bf16", "tp": "gemma_7b_tp2_rank_heads_bf16",
                "ep": "arctic_480b_ep2_rank_heads_bf16",
                "k-tp": "recurrentgemma_9b_tp2_rank_heads_hd256_mqa_bf16",
                "t-k": "recurrentgemma_9b_shard_view_hd256_mqa_bf16",
                "t-v": "qwen2_vl_2b_shard_view_hd128_gqa6_bf16",
                "t-d": "smollm_dilation2_shard_view_bf16"}
    for name, key, src, replaces, per_call in (
            (K1, "K1", "salo_table_attention.cu",
             "src/repro/kernels/salo_attention.py:119", 1),
            (K2, "K2", "salo_table_backward.cu",
             "src/repro/kernels/salo_backward.py:144", 1),
            (K3, "K3", "salo_table_backward.cu",
             "src/repro/kernels/salo_backward.py:223", 2)):
        by_path = {path.replace("-", "_").replace(".", "_"): c[key]
                   for path, c in tl.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path, "launches_per_call": per_call,
            **row(trec["a"][name]),
            "variants": {
                **{v: row(trec[c][name]) for c, v in variants.items()
                   if name in trec[c]},
                **({"dynamic_smollm_keep4_bf16": row(drec[name])}
                   if name in drec else {})}})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(f"[wall] chip_smoke.py ran {time.perf_counter() - t_start:.1f} s "
        f"end to end, the kernels' build included")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
